"""Elementwise loss zoo — closed-form torch implementations.

Counterpart of ``symbolicregression_jl_tpu/ops/losses.py`` (LossFunctions.jl
as consumed by SymbolicRegression.jl src/LossFunctions.jl:13-33). Distance
losses take (pred, target); margin losses take (target, agreement) with
targets in {-1, +1}.

Every built-in loss carries a ``kernel_spec`` attribute, ``(kernel id,
params)``: the fused CUDA loss kernel (``csrc/fused_loss.cu``) evaluates the
same closed form selected by that id. The params are precomputed here in
double precision exactly as the Python expressions in each closure evaluate
them, so the kernel's f32 arithmetic sees the same constants.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import torch

__all__ = [
    "LOSSES", "resolve_loss", "weighted_mean_loss", "L2DistLoss",
    "LogisticLoss", "make_loss", "loss_zoo", "kernel_loss_spec",
]

# kernel ids, in the order of the LossId enum of csrc/fused_loss.cu
KERNEL_LOSS_IDS = (
    "L2DistLoss", "L1DistLoss", "LogisticLoss", "LogitDistLoss", "LogCoshLoss",
    "ZeroOneLoss", "PerceptronLoss", "L1HingeLoss", "L2HingeLoss", "ExpLoss",
    "SigmoidLoss", "L2MarginLoss", "ModifiedHuberLoss", "LogitMarginLoss",
    "HuberLoss", "L1EpsilonInsLoss", "L2EpsilonInsLoss", "PeriodicLoss",
    "QuantileLoss", "SmoothedL1HingeLoss", "DWDMarginLoss", "LPDistLoss",
)


def _spec(fn, name, params=()):
    fn.kernel_spec = (KERNEL_LOSS_IDS.index(name), tuple(float(p) for p in params))
    return fn


def _relu0(x):
    # jnp.maximum(x, 0.0): NaN-propagating
    return torch.maximum(x, torch.zeros_like(x))


# -- distance-based losses: f(difference) ------------------------------------


def L2DistLoss(pred, target):
    d = pred - target
    return d * d


def L1DistLoss(pred, target):
    return torch.abs(pred - target)


def LPDistLoss(p: float) -> Callable:
    def loss(pred, target):
        return torch.abs(pred - target) ** p

    loss.__name__ = f"LPDistLoss({p})"
    return _spec(loss, "LPDistLoss", (p,))


def HuberLoss(d: float = 1.0) -> Callable:
    half_d = 0.5 * d

    def loss(pred, target):
        a = torch.abs(pred - target)
        return torch.where(a <= d, 0.5 * a * a, d * (a - half_d))

    loss.__name__ = f"HuberLoss({d})"
    return _spec(loss, "HuberLoss", (d, half_d))


def L1EpsilonInsLoss(eps: float = 1.0) -> Callable:
    def loss(pred, target):
        return _relu0(torch.abs(pred - target) - eps)

    loss.__name__ = f"L1EpsilonInsLoss({eps})"
    return _spec(loss, "L1EpsilonInsLoss", (eps,))


def L2EpsilonInsLoss(eps: float = 1.0) -> Callable:
    def loss(pred, target):
        e = _relu0(torch.abs(pred - target) - eps)
        return e * e

    loss.__name__ = f"L2EpsilonInsLoss({eps})"
    return _spec(loss, "L2EpsilonInsLoss", (eps,))


_LOG4 = math.log(4.0)
_LOG2 = math.log(2.0)


def L2ComplexDistLoss(pred, target):
    """|pred - target|^2 with a REAL result: the default elementwise loss of
    complex searches (the loss type is the real base type, SymbolicRegression.jl
    src/Dataset.jl:165; the reference's complex test uses abs2)."""
    d = pred - target
    return (d * torch.conj(d)).real


def LogitDistLoss(pred, target):
    d = pred - target
    return -_LOG4 - d + 2.0 * torch.log1p(torch.exp(d))


def LogCoshLoss(pred, target):
    # log(cosh(d)) computed as |d| + log1p(exp(-2|d|)) - log(2): the naive
    # form overflows cosh at |d| ~ 45 in f32
    a = torch.abs(pred - target)
    return a + torch.log1p(torch.exp(-2.0 * a)) - _LOG2


def PeriodicLoss(c: float = 1.0) -> Callable:
    def loss(pred, target):
        return 2.0 * torch.sin(math.pi * (pred - target) / c) ** 2

    loss.__name__ = f"PeriodicLoss({c})"
    return _spec(loss, "PeriodicLoss", (c,))


def QuantileLoss(tau: float = 0.5) -> Callable:
    tau_m1 = tau - 1.0

    def loss(pred, target):
        d = target - pred
        return torch.where(d >= 0, tau * d, tau_m1 * d)

    loss.__name__ = f"QuantileLoss({tau})"
    return _spec(loss, "QuantileLoss", (tau, tau_m1))


def LogisticLoss(pred, target):
    """Binary cross-entropy on LOGITS with targets in {0, 1}, in the
    overflow-safe form ``max(p, 0) - p*t + log1p(exp(-|p|))``."""
    a = torch.abs(pred)
    return _relu0(pred) - pred * target + torch.log1p(torch.exp(-a))


# -- margin-based losses: f(agreement = pred * target), target in {-1, 1} ----


def _margin(fn, name):
    def loss(pred, target):
        return fn(pred * target)

    loss.__name__ = name
    return loss


ZeroOneLoss = _margin(lambda a: (a < 0).to(a.dtype), "ZeroOneLoss")
PerceptronLoss = _margin(lambda a: _relu0(-a), "PerceptronLoss")
L1HingeLoss = _margin(lambda a: _relu0(1.0 - a), "L1HingeLoss")
L2HingeLoss = _margin(lambda a: _relu0(1.0 - a) ** 2, "L2HingeLoss")
ExpLoss = _margin(lambda a: torch.exp(-a), "ExpLoss")
SigmoidLoss = _margin(lambda a: (1.0 - torch.tanh(a)), "SigmoidLoss")
L2MarginLoss = _margin(lambda a: (1.0 - a) ** 2, "L2MarginLoss")
ModifiedHuberLoss = _margin(
    lambda a: torch.where(a >= -1.0, _relu0(1.0 - a) ** 2, -4.0 * a),
    "ModifiedHuberLoss",
)
LogitMarginLoss = _margin(lambda a: torch.log1p(torch.exp(-a)), "LogitMarginLoss")


def SmoothedL1HingeLoss(gamma: float = 1.0) -> Callable:
    thresh, two_g, lin = 1.0 - gamma, 2.0 * gamma, 1.0 - gamma / 2.0

    def fn(a):
        return torch.where(a >= thresh, _relu0(1.0 - a) ** 2 / two_g, lin - a)

    loss = _margin(fn, f"SmoothedL1HingeLoss({gamma})")
    return _spec(loss, "SmoothedL1HingeLoss", (thresh, two_g, lin))


def DWDMarginLoss(q: float = 1.0) -> Callable:
    thresh = q / (q + 1.0)
    const = (q**q) / ((q + 1.0) ** (q + 1.0))

    def fn(a):
        safe = torch.where(a > 0, a, 1.0)
        return torch.where(a <= thresh, 1.0 - a, const / safe**q)

    loss = _margin(fn, f"DWDMarginLoss({q})")
    return _spec(loss, "DWDMarginLoss", (q, thresh, const))


for _fn in (
    L2DistLoss, L1DistLoss, LogisticLoss, LogitDistLoss, LogCoshLoss,
    ZeroOneLoss, PerceptronLoss, L1HingeLoss, L2HingeLoss, ExpLoss,
    SigmoidLoss, L2MarginLoss, ModifiedHuberLoss, LogitMarginLoss,
):
    _spec(_fn, _fn.__name__)
# on real data |d|^2 is d * d bit for bit, so the kernels' L2 computes it
# (a complex search never reaches a kernel: its dtype is not f32)
L2ComplexDistLoss.kernel_spec = L2DistLoss.kernel_spec


LOSSES: dict[str, Callable] = {
    "L2DistLoss": L2DistLoss,
    "L1DistLoss": L1DistLoss,
    "LogisticLoss": LogisticLoss,
    "LogitDistLoss": LogitDistLoss,
    "LogCoshLoss": LogCoshLoss,
    "L2ComplexDistLoss": L2ComplexDistLoss,
    "ZeroOneLoss": ZeroOneLoss,
    "PerceptronLoss": PerceptronLoss,
    "L1HingeLoss": L1HingeLoss,
    "L2HingeLoss": L2HingeLoss,
    "ExpLoss": ExpLoss,
    "SigmoidLoss": SigmoidLoss,
    "L2MarginLoss": L2MarginLoss,
    "ModifiedHuberLoss": ModifiedHuberLoss,
    "LogitMarginLoss": LogitMarginLoss,
    # parameterized factories, default-instantiated under their plain names:
    "HuberLoss": HuberLoss(1.0),
    "L1EpsilonInsLoss": L1EpsilonInsLoss(1.0),
    "L2EpsilonInsLoss": L2EpsilonInsLoss(1.0),
    "PeriodicLoss": PeriodicLoss(1.0),
    "QuantileLoss": QuantileLoss(0.5),
    "SmoothedL1HingeLoss": SmoothedL1HingeLoss(1.0),
    "DWDMarginLoss": DWDMarginLoss(1.0),
}

# aliases the reference re-exports (LossFunctions.jl names)
LOSSES["HingeLoss"] = LOSSES["L1HingeLoss"]
LOSSES["EpsilonInsLoss"] = LOSSES["L1EpsilonInsLoss"]

_FACTORIES = {
    "LPDistLoss": LPDistLoss,
    "EpsilonInsLoss": L1EpsilonInsLoss,
    "HuberLoss": HuberLoss,
    "L1EpsilonInsLoss": L1EpsilonInsLoss,
    "L2EpsilonInsLoss": L2EpsilonInsLoss,
    "PeriodicLoss": PeriodicLoss,
    "QuantileLoss": QuantileLoss,
    "SmoothedL1HingeLoss": SmoothedL1HingeLoss,
    "DWDMarginLoss": DWDMarginLoss,
}


@functools.lru_cache(maxsize=None)
def _cached_factory(name: str, arg: float) -> Callable:
    """Memoized parameterized-loss instantiation: two Options built from the
    same "HuberLoss(0.5)" spec share ONE closure, so identity comparisons of
    losses stay meaningful."""
    return _FACTORIES[name](arg)


def resolve_loss(spec) -> Callable:
    """name | callable | None -> elementwise loss fn(pred, target).
    Default: L2 (SymbolicRegression.jl src/Options.jl:534-535)."""
    if spec is None:
        return L2DistLoss
    if callable(spec):
        return spec
    if isinstance(spec, str):
        if spec in LOSSES:
            return LOSSES[spec]
        # parameterized form "HuberLoss(0.5)"
        if "(" in spec and spec.endswith(")"):
            name, argstr = spec.split("(", 1)
            if name in _FACTORIES:
                return _cached_factory(name, float(argstr[:-1]))
        raise KeyError(f"unknown loss {spec!r}; known: {sorted(LOSSES)}")
    raise TypeError(f"cannot interpret loss spec {spec!r}")


def kernel_loss_spec(loss_elem) -> tuple[int, tuple[float, ...]] | None:
    """(kernel id, params) of a built-in loss, or None for a user callable."""
    return getattr(loss_elem, "kernel_spec", None)


# -- the loss zoo: task-level heads over the elementwise losses ---------------

_ZOO: dict[str, tuple] = {
    # name -> (factory(*params) -> loss, param names, defaults, task)
    "l2": (lambda: L2DistLoss, (), (), "regression"),
    "l1": (lambda: L1DistLoss, (), (), "robust regression"),
    "huber": (HuberLoss, ("delta",), (1.0,), "robust regression"),
    "quantile": (QuantileLoss, ("tau",), (0.5,), "quantile regression"),
    "pinball": (QuantileLoss, ("tau",), (0.5,), "quantile regression"),
    "logistic": (lambda: LogisticLoss, (), (), "binary classification"),
    "logcosh": (lambda: LogCoshLoss, (), (), "robust regression"),
}


@functools.lru_cache(maxsize=None)
def _zoo_instance(key: str, args: tuple) -> Callable:
    return _ZOO[key][0](*args)


def make_loss(name: str, *params: float) -> Callable:
    """Loss-zoo factory: ``make_loss("quantile", 0.9)`` -> elementwise loss.

    Memoized per NORMALIZED (name, params): aliases and omitted defaults
    collapse onto one closure (``make_loss("pinball") is
    make_loss("quantile", 0.5)``)."""
    key = name.lower()
    if key == "pinball":  # alias — must share quantile's memoized closures
        key = "quantile"
    if key not in _ZOO:
        raise KeyError(f"unknown zoo loss {name!r}; known: {sorted(_ZOO)}")
    _, pnames, defaults, _ = _ZOO[key]
    if len(params) > len(pnames):
        raise TypeError(
            f"{name} takes at most {len(pnames)} parameter(s) {pnames}"
        )
    args = tuple(float(p) for p in params) + defaults[len(params):]
    return _zoo_instance(key, args)


def loss_zoo() -> dict[str, dict]:
    """Metadata for the zoo heads: parameters, task, and whether the fused
    CUDA loss kernel computes them (every zoo head is a built-in)."""
    return {
        name: {
            "params": dict(zip(pnames, defaults)),
            "task": task,
            "kernel": kernel_loss_spec(_ZOO[name][0](*defaults)) is not None,
        }
        for name, (_, pnames, defaults, task) in _ZOO.items()
    }


def weighted_mean_loss(elem, weights=None):
    """Weighted normalized mean (LossFunctions.jl ``AggMode.WeightedMean``,
    SymbolicRegression.jl src/LossFunctions.jl:27-28)."""
    if weights is None:
        return torch.mean(elem, dim=-1)
    return torch.sum(elem * weights, dim=-1) / torch.sum(weights, dim=-1)
