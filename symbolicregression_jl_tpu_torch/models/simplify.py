"""Algebraic simplification of trees (host side).

Role-equivalent of DynamicExpressions' ``simplify_tree!`` + ``combine_operators``
as used by the reference's optimize_and_simplify_population
(SymbolicRegression.jl/src/SingleIteration.jl:107-132): constant folding plus
combining of constant operands through nested +,-,*,/ chains. Operates on
operator *names* so it works for any OperatorSet that includes the arithmetic
ops; unknown operators are left untouched.
"""

from __future__ import annotations

import cmath
import math

from ..ops.operators import COMPLEX_SCALAR_IMPLS, scalar_impl
from ..tree import Node, constant

__all__ = ["simplify_tree", "combine_operators"]


def _scalar_apply(op, *args):
    """Pure-host scalar application — never dispatches to the device (a
    single-scalar device round trip costs more than the whole fold).
    Complex constants fold through cmath counterparts."""
    if any(isinstance(a, complex) for a in args):
        fn = COMPLEX_SCALAR_IMPLS.get(op.name)
        if fn is None:
            return complex("nan")  # unfoldable: caller keeps the subtree
        try:
            return complex(fn(*[complex(a) for a in args]))
        except (ValueError, OverflowError, ZeroDivisionError):
            return complex("nan")
    try:
        return float(scalar_impl(op)(*[float(a) for a in args]))
    except (ValueError, OverflowError, ZeroDivisionError):
        return float("nan")


def _finite(v) -> bool:
    return cmath.isfinite(v) if isinstance(v, complex) else math.isfinite(v)


def simplify_tree(tree: Node, options) -> Node:
    """Bottom-up constant folding: any operator whose children are all
    constants becomes a constant (kept only when finite)."""
    ops = options.operators
    for n in tree.postorder():
        if n.degree == 1 and n.l.degree == 0 and n.l.is_const:
            v = _scalar_apply(ops.unary[n.op], n.l.val)
            if _finite(v):
                _to_const(n, v)
        elif (
            n.degree == 2
            and n.l.degree == 0
            and n.l.is_const
            and n.r.degree == 0
            and n.r.is_const
        ):
            v = _scalar_apply(ops.binary[n.op], n.l.val, n.r.val)
            if _finite(v):
                _to_const(n, v)
    return tree


def _to_const(n: Node, v: float) -> None:
    n.degree = 0
    n.is_const = True
    n.val = v
    n.feat = 0
    n.op = 0
    n.l = None
    n.r = None


def _op_name(options, idx: int) -> str:
    return options.operators.binary[idx].name


def combine_operators(tree: Node, options) -> Node:
    """Combine constants through nested chains of the same +,* operator and
    through +/- and */ mixed chains: e.g. (c1 + (x + c2)) -> (x + c3),
    (c1 * (c2 * x)) -> (c3 * x), (x - c1) + c2 -> x + c3."""
    changed = True
    guard = 0
    while changed and guard < 10:
        changed = _combine_pass(tree, options)
        guard += 1
    return tree


def _is_const(n: Node) -> bool:
    return n.degree == 0 and n.is_const


def _combine_pass(tree: Node, options) -> bool:
    changed = False
    for n in tree.postorder():
        if n.degree != 2:
            continue
        name = _op_name(options, n.op)
        if name in ("add", "mult"):
            changed |= _combine_assoc(n, name, options)
        elif name == "sub":
            changed |= _combine_sub(n, options)
    return changed


def _combine_assoc(n: Node, name: str, options) -> bool:
    """(c1 op inner) where inner = (c2 op x) | (x op c2) -> (c3 op x)."""
    for const_side, tree_side in (("l", "r"), ("r", "l")):
        c = getattr(n, const_side)
        sub = getattr(n, tree_side)
        if not _is_const(c) or sub.degree != 2 or sub.op != n.op:
            continue
        for inner_const_side, inner_tree_side in (("l", "r"), ("r", "l")):
            ic = getattr(sub, inner_const_side)
            if _is_const(ic):
                merged = c.val + ic.val if name == "add" else c.val * ic.val
                x = getattr(sub, inner_tree_side)
                n.l = constant(merged)
                n.r = x
                return True
    return False


def _combine_sub(n: Node, options) -> bool:
    """Collapse constant chains through subtraction:
    (c1 - (c2 - x)) -> (x + c3) form kept as (c3' - (0 - x))? We keep it
    simple and only fold the pure-constant-with-sub-chain cases:
      (c1 - (x - c2)) -> (c3 - x) with c3 = c1 + c2
      (c1 - (c2 - x)) -> ((c1-c2) + x) when `add` is available
      ((x - c1) - c2) -> (x - c3)
      ((c1 - x) - c2) -> (c3 - x)
    """
    ops = options.operators
    try:
        add_idx = ops.binary_index("add")
    except KeyError:
        add_idx = None
    sub_idx = n.op

    l, r = n.l, n.r
    if _is_const(l) and r.degree == 2 and _op_name(options, r.op) == "sub":
        if _is_const(r.r):  # c1 - (x - c2)
            n.l = constant(l.val + r.r.val)
            n.r = r.l
            n.op = sub_idx
            return True
        if _is_const(r.l) and add_idx is not None:  # c1 - (c2 - x)
            n.op = add_idx
            n.l = constant(l.val - r.l.val)
            n.r = r.r
            return True
    if _is_const(r) and l.degree == 2 and _op_name(options, l.op) == "sub":
        if _is_const(l.r):  # (x - c1) - c2
            n.l = l.l
            n.r = constant(l.r.val + r.val)
            return True
        if _is_const(l.l):  # (c1 - x) - c2
            n.l = constant(l.l.val - r.val)
            n.r = l.r
            return True
    return False
