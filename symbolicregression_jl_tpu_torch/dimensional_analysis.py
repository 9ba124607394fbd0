"""Dimensional analysis: unit-correctness of candidate expressions.

Re-design of the reference's WildcardQuantity abstract interpretation
(SymbolicRegression.jl/src/DimensionalAnalysis.jl:45-226): evaluate the tree ONCE on
a single sample column where each value carries (quantity, wildcard, violates)
— ``wildcard`` marks free constants that may still absorb any units, and
``violates`` latches the first dimensional inconsistency. Host-side and cold
(one tree-walk per candidate on one sample), exactly like the reference.

The hook into search: ``violates_dimensional_constraints`` gates a loss
penalty (``dimensional_constraint_penalty``, default 1000 like the
reference's dimensional regularization,
SymbolicRegression.jl/src/LossFunctions.jl:217-227) added by the scorer when the
dataset carries units. A copy of the JAX package's module over this
package's ``Node`` and scalar operator table; the device engine's batched,
structure-only counterpart is ``ops/evolve.dim_violates_batch``.
"""

from __future__ import annotations

import dataclasses
import math

from .tree import Node
from .units import DIMENSIONLESS, Dimensions, Quantity

__all__ = ["violates_dimensional_constraints", "WildcardQuantity"]


@dataclasses.dataclass(frozen=True)
class WildcardQuantity:
    """Quantity + wildcard flag (free constants absorb units) + violation
    latch (SymbolicRegression.jl/src/DimensionalAnalysis.jl:45-49)."""

    value: float
    dims: Dimensions
    wildcard: bool
    violates: bool

    @property
    def dimensionless(self) -> bool:
        return self.dims.dimensionless


def _violated() -> WildcardQuantity:
    return WildcardQuantity(math.nan, DIMENSIONLESS, False, True)


def _same_dims(a: Dimensions, b: Dimensions) -> bool:
    return a == b


def _combine_addsub(l: WildcardQuantity, r: WildcardQuantity, sign: float):
    """+/-: dims must agree, wildcards adapt
    (SymbolicRegression.jl/src/DimensionalAnalysis.jl:63-115)."""
    if _same_dims(l.dims, r.dims):
        return WildcardQuantity(
            l.value + sign * r.value, l.dims, l.wildcard and r.wildcard, False
        )
    if l.wildcard and not r.wildcard:
        return WildcardQuantity(l.value + sign * r.value, r.dims, False, False)
    if r.wildcard and not l.wildcard:
        return WildcardQuantity(l.value + sign * r.value, l.dims, False, False)
    if l.wildcard and r.wildcard:
        return WildcardQuantity(
            l.value + sign * r.value, DIMENSIONLESS, True, False
        )
    return _violated()


def _eval_node(
    node: Node,
    x_units: list[Quantity],
    sample: list[float],
    opset,
    allow_wildcards: bool = True,
) -> WildcardQuantity:
    if node.degree == 0:
        if node.is_const:
            # free constant: wildcard (may absorb any units) unless
            # dimensionless_constants_only forbids it
            # (SymbolicRegression.jl/src/DimensionalAnalysis.jl:108-116,204)
            return WildcardQuantity(
                float(node.val), DIMENSIONLESS, allow_wildcards, False
            )
        q = x_units[node.feat]
        # variables are NEVER wildcards, even with dimensionless units
        # (SymbolicRegression.jl/src/DimensionalAnalysis.jl:117-120)
        return WildcardQuantity(
            float(sample[node.feat]) * q.value, q.dims, False, False
        )

    if node.degree == 1:
        c = _eval_node(node.l, x_units, sample, opset, allow_wildcards)
        if c.violates:
            return c
        if not math.isfinite(c.value):
            return _violated()
        name = opset.unary[node.op].name
        if name in ("sqrt", "sqrt_abs"):
            return WildcardQuantity(
                math.sqrt(abs(c.value)), c.dims ** 0.5, c.wildcard, False
            )
        if name == "cbrt":
            from fractions import Fraction

            return WildcardQuantity(
                math.copysign(abs(c.value) ** (1 / 3), c.value),
                c.dims ** Fraction(1, 3),
                c.wildcard,
                False,
            )
        if name in ("abs", "neg"):
            v = abs(c.value) if name == "abs" else -c.value
            return WildcardQuantity(v, c.dims, c.wildcard, False)
        if name in ("square", "cube"):
            p = 2 if name == "square" else 3
            return WildcardQuantity(c.value**p, c.dims**p, c.wildcard, False)
        if name == "inv":
            return WildcardQuantity(
                1.0 / c.value if c.value != 0 else math.inf,
                c.dims**-1,
                c.wildcard,
                False,
            )
        # generic unary (cos, exp, log, ...): needs dimensionless input.
        # Deliberate deviation from the reference: we also accept a
        # dimensionless NON-wildcard input (the reference only applies such
        # ops through Julia method introspection on WildcardQuantity, which
        # effectively requires a wildcard,
        # SymbolicRegression.jl/src/DimensionalAnalysis.jl:132-141); custom ops
        # are torch callables we cannot abstractly interpret, and cos(x2) with
        # dimensionless x2 is semantically sound. The JAX package's copy of
        # this module makes the same choice.
        if c.dimensionless or c.wildcard:
            from .ops.operators import SCALAR_IMPLS

            try:
                impl = SCALAR_IMPLS.get(name)
                v = float(impl(c.value)) if impl is not None else c.value
            except Exception:  # noqa: BLE001 — value is advisory only
                v = c.value
            return WildcardQuantity(v, DIMENSIONLESS, False, False)
        return _violated()

    l = _eval_node(node.l, x_units, sample, opset, allow_wildcards)
    if l.violates:
        return l
    r = _eval_node(node.r, x_units, sample, opset, allow_wildcards)
    if r.violates:
        return r
    if not (math.isfinite(l.value) and math.isfinite(r.value)):
        return _violated()
    name = opset.binary[node.op].name
    if name in ("add", "+", "plus"):
        return _combine_addsub(l, r, 1.0)
    if name in ("sub", "-"):
        return _combine_addsub(l, r, -1.0)
    if name in ("mult", "*"):
        # wildcard propagates through * and / with OR — a free constant
        # times a unitful feature can still absorb units
        # (SymbolicRegression.jl/src/DimensionalAnalysis.jl:63-69)
        return WildcardQuantity(
            l.value * r.value, l.dims * r.dims, l.wildcard or r.wildcard, False
        )
    if name in ("div", "/"):
        return WildcardQuantity(
            l.value / r.value if r.value != 0 else math.inf,
            l.dims / r.dims,
            l.wildcard or r.wildcard,
            False,
        )
    if name in ("pow", "^", "safe_pow"):
        # BOTH base and exponent must be dimensionless (or wildcard);
        # a dimensionful base of ^ is a violation
        # (SymbolicRegression.jl/src/DimensionalAnalysis.jl:91-102)
        if (l.dimensionless or l.wildcard) and (r.dimensionless or r.wildcard):
            try:
                v = abs(l.value) ** r.value if l.value != 0 else 0.0
            except OverflowError:
                v = math.inf
            return WildcardQuantity(v, DIMENSIONLESS, False, False)
        return _violated()
    # generic binary: both sides must be dimensionless (or wildcard)
    if (l.dimensionless or l.wildcard) and (r.dimensionless or r.wildcard):
        return WildcardQuantity(l.value, DIMENSIONLESS, False, False)
    return _violated()


def violates_dimensional_constraints(
    tree: Node, dataset, options
) -> bool:
    """True iff the tree is dimensionally inconsistent with the dataset's
    X_units/y_units (reference: violates_dimensional_constraints,
    SymbolicRegression.jl/src/DimensionalAnalysis.jl:187-226)."""
    xq = getattr(dataset, "X_units_parsed", None)
    yq = getattr(dataset, "y_units_parsed", None)
    if xq is None and yq is None:
        return False
    n_feat = dataset.n_features
    if xq is None:
        xq = [Quantity(1.0, DIMENSIONLESS)] * n_feat
    sample = [float(dataset.X[f, 0]) for f in range(n_feat)]
    allow_wildcards = not getattr(options, "dimensionless_constants_only", False)
    out = _eval_node(tree, xq, sample, options.operators, allow_wildcards)
    if out.violates:
        return True
    if yq is not None:
        if out.wildcard:
            return False
        if not _same_dims(out.dims, yq.dims):
            return True
    return False
