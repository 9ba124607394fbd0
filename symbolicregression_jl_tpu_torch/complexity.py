"""Expression complexity.

Reference: SymbolicRegression.jl/src/Complexity.jl:17-50 — default complexity is the
node count; custom per-operator/variable/constant complexities supported via
``Options(complexity_of_*)``.
"""

from __future__ import annotations

from .tree import Node

__all__ = ["compute_complexity", "past_complexity_limit"]


def _iter_nodes(tree: Node, unique: bool):
    return tree.iter_unique() if unique else iter(tree)


def compute_complexity(tree: Node, options) -> int:
    # GraphNode mode: shared subtrees count ONCE (reference:
    # shared-node-aware tree_mapreduce, Complexity.jl:17-50)
    unique = bool(getattr(options, "graph_nodes", False))
    mapping = options.complexity_mapping
    if mapping is None:
        return tree.count_unique_nodes() if unique else tree.count_nodes()
    total = 0.0
    for n in _iter_nodes(tree, unique):
        if n.degree == 0:
            if n.is_const:
                total += mapping["constant"]
            else:
                var = mapping["variable"]
                total += float(var) if var.ndim == 0 else float(var[n.feat])
        elif n.degree == 1:
            total += mapping["unaop"][n.op]
        else:
            total += mapping["binop"][n.op]
    return int(round(total))


def past_complexity_limit(tree: Node, options, limit: int) -> bool:
    return compute_complexity(tree, options) > limit
