"""Operator library with NaN-guarded "safe" semantics, in PyTorch.

Counterpart of ``symbolicregression_jl_tpu/ops/operators.py``: invalid math
returns ``NaN`` so that evaluation always completes and the finiteness check
at the root decides validity (SymbolicRegression.jl
src/InterfaceDynamicExpressions.jl:30-55).

Every operator is an elementwise torch function written with the
"double-where" pattern: the guarded input is replaced by a safe value before
the math runs, so autograd through an invalid lane yields a zero gradient
there instead of polluting valid lanes with NaN. Constant optimization
differentiates through the batched interpreter, so this matters.

``BUILTIN_UNARY`` / ``BUILTIN_BINARY`` fix the ids by which the fused CUDA
loss kernel (``csrc/fused_loss.cu``) names each built-in; the two lists must
stay in the kernel's enum order.
"""

from __future__ import annotations

import cmath as _cmath
import dataclasses
import math as _math
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = [
    "Operator",
    "OperatorSet",
    "UNARY_OPS",
    "BINARY_OPS",
    "BUILTIN_UNARY",
    "BUILTIN_BINARY",
    "resolve_operators",
    "default_operator_set",
    "is_builtin",
    "kernel_op_table",
    "scalar_impl",
    "complexify_operator_set",
]


@dataclasses.dataclass(frozen=True)
class Operator:
    """A primitive operator usable inside expression trees.

    Attributes:
      name: canonical name (used in serialization and printing).
      arity: 1 or 2.
      fn: the torch implementation (elementwise, NaN-guarded).
      display: infix symbol for binary operators (None -> function-call form).
    """

    name: str
    arity: int
    fn: Callable[..., torch.Tensor]
    display: str | None = None

    def __call__(self, *args):
        return self.fn(*args)

    # Hash/eq include fn identity: two differently-implemented operators that
    # share a name must not be mistaken for one another (the kernel gate
    # below keys on identity with the built-in table).
    def __hash__(self):
        return hash((self.name, self.arity, id(self.fn)))

    def __eq__(self, other):
        return (
            isinstance(other, Operator)
            and self.name == other.name
            and self.arity == other.arity
            and self.fn is other.fn
        )


_NAN = float("nan")


def _guard(invalid, safe_x, compute):
    """double-where: compute(compute-safe input) with NaN where invalid."""
    return torch.where(invalid, _NAN, compute(safe_x))


# ---------------------------------------------------------------------------
# Unary operators
# ---------------------------------------------------------------------------


def safe_log(x):
    bad = x <= 0
    return _guard(bad, torch.where(bad, 1.0, x), torch.log)


def safe_log2(x):
    bad = x <= 0
    return _guard(bad, torch.where(bad, 1.0, x), torch.log2)


def safe_log10(x):
    bad = x <= 0
    return _guard(bad, torch.where(bad, 1.0, x), torch.log10)


def safe_log1p(x):
    bad = x <= -1
    return _guard(bad, torch.where(bad, 0.0, x), torch.log1p)


def safe_sqrt(x):
    bad = x < 0
    return _guard(bad, torch.where(bad, 1.0, x), torch.sqrt)


def safe_acosh(x):
    bad = x < 1
    return _guard(bad, torch.where(bad, 1.0, x), torch.acosh)


def safe_asin(x):
    bad = torch.abs(x) > 1
    return _guard(bad, torch.where(bad, 0.0, x), torch.asin)


def safe_acos(x):
    bad = torch.abs(x) > 1
    return _guard(bad, torch.where(bad, 0.0, x), torch.acos)


def safe_atanh(x):
    bad = torch.abs(x) >= 1
    return _guard(bad, torch.where(bad, 0.0, x), torch.atanh)


def floored_mod(x, y):
    """Floored modulo with the sign of y (Julia ``mod``), as jnp.mod computes
    it: the truncated remainder, shifted by y where the signs disagree."""
    r = torch.fmod(x, y)
    shift = ((r < 0) != (y < 0)) & (r != 0)
    return torch.where(shift, r + y, r)


def atanh_clip(x):
    # atanh((x + 1) % 2 - 1), matching the reference's clipped variant
    # (SymbolicRegression.jl src/Operators.jl:17).
    wrapped = floored_mod(x + 1.0, torch.full_like(x, 2.0)) - 1.0
    return safe_atanh(wrapped)


def gamma_full(x):
    """Gamma with reflection for negative arguments, Inf->NaN."""
    ax = torch.where(x < 0, 1.0 - x, x)  # >= 1 region, lgamma-safe
    pos = torch.exp(torch.lgamma(torch.where(ax > 0, ax, 1.0)))
    sin_pix = torch.sin(_math.pi * x)
    refl = _math.pi / (sin_pix * pos)
    out = torch.where(x < 0, refl, torch.exp(torch.lgamma(torch.where(x > 0, x, 1.0))))
    out = torch.where(x == torch.floor(x), torch.where(x > 0, out, _NAN), out)
    out = torch.where(torch.isnan(x), _NAN, out)
    return torch.where(torch.isfinite(out), out, _NAN)


def square(x):
    return x * x


def cube(x):
    return x * x * x


def neg(x):
    return -x


def relu(x):
    # NaN -> 0, matching Julia's strong-zero `(x > 0) * x`
    # (SymbolicRegression.jl src/Operators.jl:90).
    return torch.where(x > 0, x, 0.0)


def sign_op(x):
    # torch.sign maps NaN to 0; jnp.sign and Julia's sign keep NaN
    return torch.where(torch.isnan(x), _NAN, torch.sign(x))


# ---------------------------------------------------------------------------
# Binary operators
# ---------------------------------------------------------------------------


def safe_pow(x, y):
    """Match the reference's safe_pow (SymbolicRegression.jl
    src/Operators.jl:28-36):

    integer y:      y < 0 and x == 0       -> NaN
    non-integer y:  y > 0 and x < 0        -> NaN
                    y < 0 and x <= 0       -> NaN
    otherwise x ** y (negative base allowed for integer exponents).
    """
    yi = torch.round(y)
    y_is_int = y == yi
    invalid = torch.where(
        y_is_int,
        (yi < 0) & (x == 0),
        torch.where(y > 0, x < 0, x <= 0),
    )
    ax = torch.abs(x)
    ax_safe = torch.where(invalid | (ax == 0), 1.0, ax)
    mag = torch.where(ax == 0, torch.where(y == 0, 1.0, 0.0), ax_safe**y)
    odd = floored_mod(torch.abs(yi), torch.full_like(yi, 2.0)) == 1.0
    signed = torch.where((x < 0) & odd, -mag, mag)
    return torch.where(invalid, _NAN, signed)


def plus(x, y):
    return x + y


def sub(x, y):
    return x - y


def mult(x, y):
    return x * y


def div(x, y):
    # IEEE: x/0 = +-Inf, 0/0 = NaN; the finiteness check at the root rejects
    # both.
    return x / y


def mod_op(x, y):
    return floored_mod(x, y)


def greater(x, y):
    # NaN operands -> 0 (comparison false), Julia strong-zero semantics.
    return torch.where(x > y, 1.0, 0.0) * torch.ones_like(x)


def cond_op(x, y):
    # cond(NaN, y) == 0 and cond(x<=0, NaN) == 0, per Julia `(x > 0) * y`
    # (SymbolicRegression.jl src/Operators.jl:88).
    return torch.where(x > 0, y, torch.zeros_like(y))


def logical_or(x, y):
    return torch.where((x > 0) | (y > 0), 1.0, 0.0) * torch.ones_like(x)


def logical_and(x, y):
    return torch.where((x > 0) & (y > 0), 1.0, 0.0) * torch.ones_like(x)


def max_op(x, y):
    return torch.maximum(x, y)


def min_op(x, y):
    return torch.minimum(x, y)


def _u(name, fn, display=None):
    return Operator(name=name, arity=1, fn=fn, display=display)


def _b(name, fn, display=None):
    return Operator(name=name, arity=2, fn=fn, display=display)


#: built-in unary operators, in the fused kernel's id order
BUILTIN_UNARY: tuple[Operator, ...] = (
    _u("neg", neg, "-"),
    _u("square", square),
    _u("cube", cube),
    _u("exp", torch.exp),
    _u("abs", torch.abs),
    _u("log", safe_log),
    _u("log2", safe_log2),
    _u("log10", safe_log10),
    _u("log1p", safe_log1p),
    _u("sqrt", safe_sqrt),
    _u("sin", torch.sin),
    _u("cos", torch.cos),
    _u("tan", torch.tan),
    _u("sinh", torch.sinh),
    _u("cosh", torch.cosh),
    _u("tanh", torch.tanh),
    _u("asin", safe_asin),
    _u("acos", safe_acos),
    _u("atan", torch.atan),
    _u("asinh", torch.asinh),
    _u("acosh", safe_acosh),
    _u("atanh", safe_atanh),
    _u("atanh_clip", atanh_clip),
    _u("erf", torch.special.erf),
    _u("erfc", torch.special.erfc),
    _u("gamma", gamma_full),
    _u("relu", relu),
    _u("round", torch.round),
    _u("floor", torch.floor),
    _u("ceil", torch.ceil),
    _u("sign", sign_op),
)

#: built-in binary operators, in the fused kernel's id order
BUILTIN_BINARY: tuple[Operator, ...] = (
    _b("add", plus, "+"),
    _b("sub", sub, "-"),
    _b("mult", mult, "*"),
    _b("div", div, "/"),
    _b("pow", safe_pow, "^"),
    _b("mod", mod_op),
    _b("greater", greater),
    _b("cond", cond_op),
    _b("logical_or", logical_or),
    _b("logical_and", logical_and),
    _b("max", max_op),
    _b("min", min_op),
)

UNARY_OPS: dict[str, Operator] = {op.name: op for op in BUILTIN_UNARY}
BINARY_OPS: dict[str, Operator] = {op.name: op for op in BUILTIN_BINARY}

# Aliases matching the reference's binopmap/unaopmap un-aliasing
# (SymbolicRegression.jl src/Options.jl:92-150): users may write the plain
# name and get the safe variant.
_ALIASES = {
    "+": "add",
    "-": "sub",
    "*": "mult",
    "/": "div",
    "^": "pow",
    "safe_pow": "pow",
    "safe_log": "log",
    "safe_log2": "log2",
    "safe_log10": "log10",
    "safe_log1p": "log1p",
    "safe_sqrt": "sqrt",
    "safe_acosh": "acosh",
    "safe_asin": "asin",
    "safe_acos": "acos",
    "safe_atanh": "atanh",
    "plus": "add",
    "mult": "mult",
}


class OperatorSet:
    """The chosen operator vocabulary of a search (reference: OperatorEnum).
    Immutable and hashable."""

    __slots__ = ("unary", "binary", "_hash")

    def __init__(self, binary: Sequence[Operator], unary: Sequence[Operator]):
        self.binary = tuple(binary)
        self.unary = tuple(unary)
        self._hash = hash((self.binary, self.unary))
        names = [op.name for op in self.binary + self.unary]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate operators in set: {names}")

    def __setattr__(self, k, v):
        if hasattr(self, "_hash"):
            raise AttributeError("OperatorSet is immutable")
        object.__setattr__(self, k, v)

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return (
            isinstance(other, OperatorSet)
            and self.binary == other.binary
            and self.unary == other.unary
        )

    def __repr__(self):
        return (
            "OperatorSet(binary=[" + ", ".join(o.name for o in self.binary) + "], "
            "unary=[" + ", ".join(o.name for o in self.unary) + "])"
        )

    @property
    def n_binary(self):
        return len(self.binary)

    @property
    def n_unary(self):
        return len(self.unary)

    def binary_index(self, name: str) -> int:
        name = _ALIASES.get(name, name)
        for i, op in enumerate(self.binary):
            if op.name == name:
                return i
        raise KeyError(name)

    def unary_index(self, name: str) -> int:
        name = _ALIASES.get(name, name)
        for i, op in enumerate(self.unary):
            if op.name == name:
                return i
        raise KeyError(name)


def _resolve_one(spec, table: dict[str, Operator], kind: str) -> Operator:
    if isinstance(spec, Operator):
        return spec
    if callable(spec):  # raw python/torch function -> wrap
        name = getattr(spec, "__name__", None) or repr(spec)
        name = _ALIASES.get(name, name)
        if name in table:
            return table[name]
        return Operator(name=name, arity=1 if kind == "unary" else 2, fn=spec)
    if isinstance(spec, str):
        name = _ALIASES.get(spec, spec)
        if name not in table:
            raise KeyError(f"unknown {kind} operator {spec!r}; known: {sorted(table)}")
        return table[name]
    raise TypeError(f"cannot interpret operator spec {spec!r}")


def resolve_operators(binary_operators, unary_operators) -> OperatorSet:
    """Build an OperatorSet from names / callables / Operator instances."""
    binary = [_resolve_one(s, BINARY_OPS, "binary") for s in binary_operators]
    unary = [_resolve_one(s, UNARY_OPS, "unary") for s in unary_operators]
    return OperatorSet(binary=binary, unary=unary)


def default_operator_set() -> OperatorSet:
    # Reference default: binary [+, -, /, *], no unary.
    return resolve_operators(["add", "sub", "div", "mult"], [])


def is_builtin(op: Operator) -> bool:
    """True when ``op`` IS a built-in (same callable), so the fused kernel's
    device function computes exactly its ``fn``."""
    table = UNARY_OPS if op.arity == 1 else BINARY_OPS
    return table.get(op.name) is op or (
        op.name in table and table[op.name].fn is op.fn
    )


def kernel_op_table(opset: OperatorSet) -> np.ndarray | None:
    """Kernel ids of the set's operators in fused-opcode order (unary then
    binary; binary ids are offset by the built-in unary count), or None when
    any operator is not a built-in and the kernel cannot run it."""
    if not all(is_builtin(op) for op in opset.unary + opset.binary):
        return None
    u_ids = [list(UNARY_OPS).index(op.name) for op in opset.unary]
    b_ids = [len(BUILTIN_UNARY) + list(BINARY_OPS).index(op.name) for op in opset.binary]
    return np.asarray(u_ids + b_ids, dtype=np.int32)


# ---------------------------------------------------------------------------
# Pure-Python scalar implementations (host-side constant folding & friends).
# Semantics match the torch table exactly, including the NaN guards.
# ---------------------------------------------------------------------------


def _s_pow(x, y):
    if _math.isnan(x) or _math.isnan(y):
        # IEEE pow exceptions: pow(x, 0) == 1 and pow(1, y) == 1 even for NaN
        return 1.0 if (x == 1.0 or y == 0.0) else _NAN
    if _math.isinf(y):
        # round(±inf) == ±inf, so the tensor fn takes the integer-y branch:
        # NaN only for x == 0 with y == -inf; otherwise IEEE pow semantics
        if x == 0 and y < 0:
            return _NAN
        return float(_math.pow(x, y))
    yi = round(y)
    if y == yi:
        if yi < 0 and x == 0:
            return _NAN
        try:
            return float(_math.pow(abs(x), y)) * (-1.0 if (x < 0 and yi % 2) else 1.0)
        except OverflowError:
            return float("inf")
    if (y > 0 and x < 0) or (y < 0 and x <= 0):
        return _NAN
    try:
        return float(_math.pow(x, y))
    except OverflowError:
        return float("inf")


def _s_mod(x, y):
    if y == 0 or _math.isnan(x) or _math.isnan(y) or _math.isinf(x):
        return _NAN
    if _math.isinf(y):
        # floored modulo takes y's sign: x when signs agree (or x == 0), else y
        return float(x) if (x == 0 or (x > 0) == (y > 0)) else y
    return _math.fmod(_math.fmod(x, y) + y, y)


def _s_gamma(x):
    try:
        v = _math.gamma(x)
    except (ValueError, OverflowError):
        return _NAN
    return v if _math.isfinite(v) else _NAN


def _s_div(x, y):
    if y == 0:
        if x == 0 or _math.isnan(x):
            return _NAN
        return _math.copysign(float("inf"), x) * _math.copysign(1.0, y)
    return x / y


def _guard_s(fn, cond):
    def impl(x):
        if _math.isnan(x) or cond(x):
            return _NAN
        return float(fn(x))

    return impl


SCALAR_IMPLS: dict[str, Callable] = {
    "neg": lambda x: -x,
    "square": lambda x: x * x,
    "cube": lambda x: x * x * x,
    "exp": lambda x: _NAN if _math.isnan(x) else (_math.exp(x) if x < 709 else float("inf")),
    "abs": abs,
    "log": _guard_s(_math.log, lambda x: x <= 0),
    "log2": _guard_s(_math.log2, lambda x: x <= 0),
    "log10": _guard_s(_math.log10, lambda x: x <= 0),
    "log1p": _guard_s(_math.log1p, lambda x: x <= -1),
    "sqrt": _guard_s(_math.sqrt, lambda x: x < 0),
    "sin": _math.sin,
    "cos": _math.cos,
    "tan": _math.tan,
    "sinh": lambda x: _NAN if _math.isnan(x) else (
        _math.sinh(x) if abs(x) < 710 else _math.copysign(float("inf"), x)
    ),
    "cosh": lambda x: _NAN if _math.isnan(x) else (
        _math.cosh(x) if abs(x) < 710 else float("inf")
    ),
    "tanh": _math.tanh,
    "asin": _guard_s(_math.asin, lambda x: abs(x) > 1),
    "acos": _guard_s(_math.acos, lambda x: abs(x) > 1),
    "atan": _math.atan,
    "asinh": _math.asinh,
    "acosh": _guard_s(_math.acosh, lambda x: x < 1),
    "atanh": _guard_s(_math.atanh, lambda x: abs(x) >= 1),
    "atanh_clip": lambda x: _guard_s(_math.atanh, lambda v: abs(v) >= 1)(
        _math.fmod(_math.fmod(x + 1.0, 2.0) + 2.0, 2.0) - 1.0
    ),
    "erf": _math.erf,
    "erfc": _math.erfc,
    "gamma": _s_gamma,
    "relu": lambda x: x if x > 0 else 0.0,
    "round": lambda x: float(np.round(x)),  # banker's rounding, like torch.round
    "floor": lambda x: _NAN if _math.isnan(x) else float(_math.floor(x)),
    "ceil": lambda x: _NAN if _math.isnan(x) else float(_math.ceil(x)),
    "sign": lambda x: _NAN if _math.isnan(x) else float(np.sign(x)),
    "add": lambda x, y: x + y,
    "sub": lambda x, y: x - y,
    "mult": lambda x, y: x * y,
    "div": _s_div,
    "pow": _s_pow,
    "mod": _s_mod,
    "greater": lambda x, y: 1.0 if x > y else 0.0,
    "cond": lambda x, y: y if x > 0 else 0.0,
    "logical_or": lambda x, y: 1.0 if (x > 0 or y > 0) else 0.0,
    "logical_and": lambda x, y: 1.0 if (x > 0 and y > 0) else 0.0,
    # NaN-propagating like torch.maximum/minimum
    "max": lambda x, y: _NAN if (_math.isnan(x) or _math.isnan(y)) else max(x, y),
    "min": lambda x, y: _NAN if (_math.isnan(x) or _math.isnan(y)) else min(x, y),
}

# ---------------------------------------------------------------------------
# Complex-plane variants (the JAX package's ``_COMPLEX_IMPLS``). The reference
# evaluates complex datasets with the RAW functions: the real-line NaN guards
# are unnecessary (log/sqrt/pow are total on the complex plane up to poles)
# and their ``<`` comparisons are undefined for complex inputs; its preflight
# rejects operators that are not complex-total or not type-stable (abs:
# complex -> real is rejected here too). The torch functions run on the card
# as well as on the CPU: unlike XLA:TPU, the card has complex arithmetic.
# ---------------------------------------------------------------------------

COMPLEX_IMPLS: dict[str, Callable] = {
    "add": lambda x, y: x + y,
    "sub": lambda x, y: x - y,
    "mult": lambda x, y: x * y,
    "div": lambda x, y: x / y,
    "pow": lambda x, y: x**y,
    "square": lambda x: x * x,
    "cube": lambda x: x * x * x,
    "neg": lambda x: -x,
    "inv": lambda x: 1.0 / x,
    "cos": torch.cos,
    "sin": torch.sin,
    "tan": torch.tan,
    "exp": torch.exp,
    "log": torch.log,
    "log2": lambda x: torch.log(x) / np.log(2.0),
    "log10": lambda x: torch.log(x) / np.log(10.0),
    "log1p": torch.log1p,
    "sqrt": torch.sqrt,
    "cosh": torch.cosh,
    "sinh": torch.sinh,
    "tanh": torch.tanh,
    "asin": torch.asin,
    "acos": torch.acos,
    "atan": torch.atan,
    "asinh": torch.asinh,
    "acosh": torch.acosh,
    "atanh": torch.atanh,
}

#: scalar (host) counterparts of COMPLEX_IMPLS, for simplify's constant
#: folding of complex constants: one scalar never pays a device dispatch
COMPLEX_SCALAR_IMPLS: dict[str, Callable] = {
    "add": lambda x, y: x + y,
    "sub": lambda x, y: x - y,
    "mult": lambda x, y: x * y,
    "div": lambda x, y: x / y if y != 0 else complex("nan"),
    "pow": lambda x, y: x**y if not (x == 0 and y.real < 0) else complex("nan"),
    "square": lambda x: x * x,
    "cube": lambda x: x * x * x,
    "neg": lambda x: -x,
    "inv": lambda x: 1.0 / x if x != 0 else complex("nan"),
    "cos": _cmath.cos,
    "sin": _cmath.sin,
    "tan": _cmath.tan,
    "exp": _cmath.exp,
    "log": _cmath.log,
    "log2": lambda x: _cmath.log(x) / _math.log(2.0),
    "log10": lambda x: _cmath.log(x) / _math.log(10.0),
    "log1p": lambda x: _cmath.log(1.0 + x),
    "sqrt": _cmath.sqrt,
    "cosh": _cmath.cosh,
    "sinh": _cmath.sinh,
    "tanh": _cmath.tanh,
    "asin": _cmath.asin,
    "acos": _cmath.acos,
    "atan": _cmath.atan,
    "asinh": _cmath.asinh,
    "acosh": _cmath.acosh,
    "atanh": _cmath.atanh,
}


def complexify_operator_set(opset: OperatorSet) -> OperatorSet:
    """Swap every operator for its complex-plane implementation; raises for
    operators with no complex-total, type-stable variant (mirrors the
    reference preflight's rejection)."""

    def conv(op: Operator) -> Operator:
        fn = COMPLEX_IMPLS.get(op.name)
        if fn is None:
            raise ValueError(
                f"operator {op.name!r} has no complex implementation "
                f"(complex-capable: {sorted(COMPLEX_IMPLS)})"
            )
        return Operator(name=op.name, arity=op.arity, fn=fn, display=op.display)

    return OperatorSet(
        binary=[conv(op) for op in opset.binary],
        unary=[conv(op) for op in opset.unary],
    )


def apply_np(fn: Callable, *args: np.ndarray) -> np.ndarray:
    """Run a torch operator on numpy operands on the CPU and return numpy."""
    out = fn(*[torch.from_numpy(np.ascontiguousarray(a)) for a in args])
    return out.detach().cpu().numpy()


def scalar_impl(op: Operator) -> Callable:
    """Host scalar implementation of an operator; falls back to the torch fn
    on a float64 CPU tensor for user-defined operators."""
    fn = SCALAR_IMPLS.get(op.name)
    if fn is not None:
        return fn
    return lambda *args: float(apply_np(op.fn, *[np.asarray(a, np.float64) for a in args]))
