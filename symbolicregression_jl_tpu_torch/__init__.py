"""PyTorch port of the symbolic regression framework (first slice).

The lockstep ``equation_search`` / ``SRRegressor`` path of
``symbolicregression_jl_tpu`` in PyTorch: host regularized evolution over
island populations, batched scoring through a hand-written CUDA fused
eval+loss kernel (``csrc/fused_loss.cu``), batched constant optimization
through the interpreter's reverse-sweep gradient, and a complexity-indexed
hall of fame. Entry points run on ``cuda`` unless the caller asks for the
CPU (``Options(device="cpu")``). The package imports nothing of the JAX
package; ``convert.py`` carries state across from it as numpy arrays.
"""

from .dataset import Dataset
from .options import MutationWeights, Options
from .regressor import MultitargetSRRegressor, SRRegressor
from .search import SearchResult, equation_search
from .tree import Node, binary, constant, feature, unary
from .models.hall_of_fame import HallOfFame
from .models.population import Population
from .models.pop_member import PopMember
from .ops import (
    OperatorSet,
    eval_trees,
    eval_trees_with_ok,
    flatten_trees,
    resolve_operators,
)
from .ops.losses import loss_zoo, make_loss
from .analysis.ir_verify import FlatIRError, verify_flat_trees

__version__ = "0.1.0"

__all__ = [
    "Dataset",
    "MutationWeights",
    "MultitargetSRRegressor",
    "Options",
    "SRRegressor",
    "SearchResult",
    "equation_search",
    "Node",
    "binary",
    "constant",
    "feature",
    "unary",
    "HallOfFame",
    "Population",
    "PopMember",
    "OperatorSet",
    "eval_trees",
    "eval_trees_with_ok",
    "flatten_trees",
    "resolve_operators",
    "loss_zoo",
    "make_loss",
    "FlatIRError",
    "verify_flat_trees",
    "__version__",
]
