"""The port's package root against the JAX package's root.

The port exports what the JAX root exports, in the same order, except the
names of items not ported yet. ``_UNPORTED`` names each of those with the
ROADMAP.md item that brings it; it is empty since the multi-process slice
(``PeerLossError`` from ``parallel/distributed.py``). Every exported loss
builds the same elementwise values as the JAX one.
"""

import jax
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T

_UNPORTED: dict = {}

# (name, factory arguments or None for a plain loss): every loss the two
# roots export
LOSSES = [
    ("DWDMarginLoss", (2.0,)),
    ("ExpLoss", None),
    ("HuberLoss", (0.5,)),
    ("L1DistLoss", None),
    ("L1EpsilonInsLoss", (0.3,)),
    ("L1HingeLoss", None),
    ("L2DistLoss", None),
    ("L2EpsilonInsLoss", (0.3,)),
    ("L2HingeLoss", None),
    ("L2MarginLoss", None),
    ("LogCoshLoss", None),
    ("LogitDistLoss", None),
    ("LogitMarginLoss", None),
    ("LPDistLoss", (3.0,)),
    ("ModifiedHuberLoss", None),
    ("PerceptronLoss", None),
    ("PeriodicLoss", (2.0,)),
    ("QuantileLoss", (0.9,)),
    ("SigmoidLoss", None),
    ("SmoothedL1HingeLoss", (0.5,)),
    ("ZeroOneLoss", None),
    ("LogisticLoss", None),
]


@pytest.fixture(autouse=True, scope="module")
def _f32_jax():
    """Keep JAX in 32-bit mode: a test module run earlier in this process
    may have enabled x64."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", x64)


def test_all_equals_jax_root_minus_unported():
    assert set(_UNPORTED) <= set(J.__all__)
    assert not set(_UNPORTED) & set(T.__all__)
    assert T.__all__ == [n for n in J.__all__ if n not in _UNPORTED]
    for item in _UNPORTED.values():
        assert item.startswith(("slice 4", "slice 5")), item
    for name in T.__all__:
        assert hasattr(T, name), name
    assert T.PeerLossError.__module__ == "symbolicregression_jl_tpu_torch.parallel.distributed"


def test_root_imports():
    from symbolicregression_jl_tpu_torch import L1DistLoss, load_checkpoint  # noqa: F401

    assert T.CheckpointError.__module__ == "symbolicregression_jl_tpu_torch.utils.checkpoint"


def test_every_root_loss_is_listed():
    exported = {n for n in T.__all__ if n.endswith("Loss")}
    assert exported == {name for name, _ in LOSSES}


@pytest.mark.parametrize("name, args", LOSSES, ids=[n for n, _ in LOSSES])
def test_root_loss_matches_jax(name, args):
    """The same seeded vectors through the JAX root's loss and the port's:
    elementwise values equal within f32 tolerance (margin losses read a
    +-1 target)."""
    rng = np.random.default_rng(7)
    pred = rng.normal(scale=2.0, size=257).astype(np.float32)
    target = rng.normal(scale=2.0, size=257).astype(np.float32)
    target[::2] = np.sign(target[::2])
    jl, tl = getattr(J, name), getattr(T, name)
    if args is not None:
        jl, tl = jl(*args), tl(*args)
    want = np.asarray(jl(jax.numpy.asarray(pred), jax.numpy.asarray(target)), np.float64)
    got = tl(torch.from_numpy(pred), torch.from_numpy(target)).double().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)
