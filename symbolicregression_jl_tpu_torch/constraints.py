"""Constraint checking for candidate trees.

Reference: SymbolicRegression.jl/src/CheckConstraints.jl:73-94 — a candidate is
rejected when it exceeds maxsize/maxdepth, violates per-operator subtree-size
caps, or contains an illegal operator-nesting combination.
"""

from __future__ import annotations

from .complexity import compute_complexity, past_complexity_limit
from .tree import Node

__all__ = ["check_constraints"]


def _subtree_sizes_violate(tree: Node, options) -> bool:
    """Per-operator caps on argument-subtree sizes (reference:
    flag_bin/una_operator_complexity, SymbolicRegression.jl/src/CheckConstraints.jl:9-38)."""
    bin_caps, una_caps = options.op_constraints
    if all(c == (-1, -1) for c in bin_caps) and all(c == -1 for c in una_caps):
        return False
    for n in tree:
        if n.degree == 1:
            cap = una_caps[n.op]
            if cap != -1 and past_complexity_limit(n.l, options, cap):
                return True
        elif n.degree == 2:
            lcap, rcap = bin_caps[n.op]
            if lcap != -1 and past_complexity_limit(n.l, options, lcap):
                return True
            if rcap != -1 and past_complexity_limit(n.r, options, rcap):
                return True
    return False


def _count_nest(node: Node, deg: int, op_idx: int) -> int:
    """Max nesting depth of (deg, op_idx) within `node`'s subtree (reference:
    count_max_nestedness, SymbolicRegression.jl/src/CheckConstraints.jl:40-52)."""
    best = 0
    stack = [(node, 0)]
    while stack:
        n, depth = stack.pop()
        d = depth + (1 if (n.degree == deg and n.op == op_idx) else 0)
        best = max(best, d)
        if n.degree >= 1:
            stack.append((n.l, d))
        if n.degree == 2:
            stack.append((n.r, d))
    return best


def _nesting_violates(tree: Node, options) -> bool:
    """Illegal nesting combos (reference: flag_illegal_nests,
    SymbolicRegression.jl/src/CheckConstraints.jl:55-70). An entry
    (outer_deg, outer_idx, [(inner_deg, inner_idx, max), ...]) means: under any
    `outer` node, `inner` may nest at most `max` times."""
    nested = options.nested_constraints_resolved
    if not nested:
        return False
    for n in tree:
        for odeg, oidx, inners in nested:
            if n.degree != odeg or n.op != oidx:
                continue
            subtrees = [n.l] if odeg == 1 else [n.l, n.r]
            for ideg, iidx, maxn in inners:
                nestedness = max(_count_nest(s, ideg, iidx) for s in subtrees)
                if nestedness > maxn:
                    return True
    return False


def check_constraints(
    tree: Node, options, maxsize: int | None = None, cursize: int | None = None
) -> bool:
    """True iff the tree satisfies every constraint
    (reference: SymbolicRegression.jl/src/CheckConstraints.jl:73-94)."""
    maxsize = options.maxsize if maxsize is None else maxsize
    size = compute_complexity(tree, options) if cursize is None else cursize
    if size > maxsize:
        return False
    # Hard raw-node cap: the device tensors are sized to options.max_nodes.
    # Load-bearing when per-node complexities < 1 (complexity cannot bound
    # node count; options.py sizes max_nodes accordingly) and in GraphNode
    # mode (complexity counts shared subtrees once but device flattening
    # EXPANDS sharing). Skipped otherwise: size <= maxsize implies the cap.
    if (options._needs_node_cap or options.graph_nodes) and (
        tree.count_nodes() > options.max_nodes
    ):
        return False
    if tree.count_depth() > options.maxdepth:
        return False
    if _subtree_sizes_violate(tree, options):
        return False
    if _nesting_violates(tree, options):
        return False
    return True
