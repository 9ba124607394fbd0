from .flat import (
    KIND_BINARY,
    KIND_CONST,
    KIND_PAD,
    KIND_UNARY,
    KIND_VAR,
    FlatTrees,
    flatten_trees,
    pad_bucket,
    unflatten_tree,
)
from .interp import eval_diff_trees, eval_grad_trees, eval_trees, eval_trees_with_ok
from .operators import (
    BINARY_OPS,
    UNARY_OPS,
    Operator,
    OperatorSet,
    default_operator_set,
    resolve_operators,
)

__all__ = [
    "KIND_BINARY",
    "KIND_CONST",
    "KIND_PAD",
    "KIND_UNARY",
    "KIND_VAR",
    "FlatTrees",
    "flatten_trees",
    "pad_bucket",
    "unflatten_tree",
    "eval_trees",
    "eval_trees_with_ok",
    "eval_grad_trees",
    "eval_diff_trees",
    "BINARY_OPS",
    "UNARY_OPS",
    "Operator",
    "OperatorSet",
    "default_operator_set",
    "resolve_operators",
]
