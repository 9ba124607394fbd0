"""PyTorch port vs JAX package: operators, losses and the plain interpreter.

Inputs come from numpy and reach both packages as the same arrays; trees are
generated in the JAX package and carried across by ``convert``.

Tolerances: operators and losses agree to rtol 1e-5 with atol 1e-6 for
results near zero (two f32 libm implementations differ by a few ulp, and
JAX's CPU fast-math flushes denormal results to zero where torch keeps
them); NaN positions must be equal. Interpreter values and constant
gradients agree to rtol 1e-4: errors of a few ulp per node compound along a
tree. Denormals: ``torch.set_flush_denormal(True)`` for this module, like
the JAX side's CPU fast-math.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu.models.mutation_functions import gen_random_tree as j_gen
from symbolicregression_jl_tpu.ops import losses as JL
from symbolicregression_jl_tpu.ops import operators as JO
from symbolicregression_jl_tpu.ops.interp import _Structure, _eval_one
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.ops import losses as TL
from symbolicregression_jl_tpu_torch.ops import operators as TO
from symbolicregression_jl_tpu_torch.ops.interp import eval_plan, make_plan

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _cpu_numerics():
    """Flush denormals, as the JAX side's CPU fast-math does, and keep JAX in
    32-bit mode: a test module run earlier in this process may have enabled
    x64, under which the JAX package computes in another precision."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    jax.config.update("jax_enable_x64", x64)


EDGES = np.array(
    [0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 1.5, -1.5, 2.0, -2.0, 2.5, -3.0, 1e-3, -1e-3,
     0.999, -0.999, 1.001, 7.3, -7.3, 30.0, -30.0, 100.0, -100.0, np.nan, np.inf, -np.inf],
    np.float32,
)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{what}: NaN positions")
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("name", list(TO.UNARY_OPS))
def test_unary_operator_matches(name):
    got = TO.UNARY_OPS[name].fn(torch.from_numpy(EDGES)).numpy()
    want = np.asarray(JO.UNARY_OPS[name].fn(jnp.asarray(EDGES)))
    _close(got, want, name)


@pytest.mark.parametrize("name", list(TO.BINARY_OPS))
def test_binary_operator_matches(name):
    a = np.repeat(EDGES, EDGES.size)
    b = np.tile(EDGES, EDGES.size)
    got = TO.BINARY_OPS[name].fn(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(JO.BINARY_OPS[name].fn(jnp.asarray(a), jnp.asarray(b)))
    _close(got, want, name)


def _loss_pairs():
    g = np.array([-3.0, -1.0, -0.5, 0.0, 0.3, 1.0, 2.0, 4.0], np.float32)
    return np.repeat(g, g.size), np.tile(g, g.size)


LOSS_SPECS = [k for k in TL.LOSSES] + [
    "LPDistLoss(3.0)", "HuberLoss(0.5)", "QuantileLoss(0.9)", "L1EpsilonInsLoss(0.25)",
    "L2EpsilonInsLoss(0.25)", "PeriodicLoss(2.0)", "SmoothedL1HingeLoss(0.5)",
    "DWDMarginLoss(2.0)",
]


@pytest.mark.parametrize("spec", LOSS_SPECS)
def test_loss_matches(spec):
    p, t = _loss_pairs()
    got = TL.resolve_loss(spec)(torch.from_numpy(p), torch.from_numpy(t)).numpy()
    want = np.asarray(JL.resolve_loss(spec)(jnp.asarray(p), jnp.asarray(t)))
    _close(got, want, spec)
    assert TL.kernel_loss_spec(TL.resolve_loss(spec)) is not None


def test_make_loss_identity_and_zoo():
    assert TL.make_loss("pinball") is TL.make_loss("quantile", 0.5)
    assert TL.resolve_loss("HuberLoss(0.5)") is TL.resolve_loss("HuberLoss(0.5)")
    assert set(TL.loss_zoo()) == set(JL.loss_zoo())
    assert all(v["kernel"] for v in TL.loss_zoo().values())


OPS_B = ["add", "sub", "mult", "div"]
OPS_U = ["cos", "exp", "abs", "sqrt", "log"]


def _corpus(n, seed, nfeat=3):
    jopts = J.Options(binary_operators=OPS_B, unary_operators=OPS_U, maxsize=20,
                      save_to_file=False)
    rng = np.random.default_rng(seed)
    trees = []
    while len(trees) < n:
        t = j_gen(int(rng.integers(1, 8)), jopts.operators, nfeat, rng)
        if t.count_nodes() <= jopts.max_nodes:
            trees.append(t)
    jflat = J.flatten_trees(trees, jopts.max_nodes)
    topset = TO.resolve_operators(OPS_B, OPS_U)
    return jopts, jflat, topset


def _data(n=97, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.2, 2.0, size=(3, n)).astype(np.float32)
    X[0, :8] = 0.0  # guard columns: abs kink, log/sqrt domain edges, 1/0
    X[1, 8:16] = -1e-3
    return X


def test_interpreter_values_match():
    jopts, jflat, topset = _corpus(128, seed=3)
    X = _data()
    want = np.asarray(J.eval_trees(jflat, jnp.asarray(X), jopts.operators))
    got, ok = T.eval_trees_with_ok(convert.flat_trees(jflat), X, topset)
    got = got.numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ok.numpy(), finite.all(-1))


def test_constant_gradients_match():
    jopts, jflat, topset = _corpus(64, seed=4)
    X = _data(seed=1)
    y = np.cos(X[1]).astype(np.float32)
    opset = jopts.operators

    # d mean L2 loss / d constants, per tree, through jax.grad of the custom VJP
    def loss(val, kind, op, lhs, rhs, feat, length):
        pred = _eval_one(opset, _Structure(kind, op, lhs, rhs, feat, length), val, jnp.asarray(X))
        return jnp.mean((pred - y) ** 2)

    jf = jax.vmap(jax.value_and_grad(loss))(
        jnp.asarray(jflat.val), *(jnp.asarray(getattr(jflat, k)) for k in
                                  ("kind", "op", "lhs", "rhs", "feat", "length"))
    )
    want_f, want_g = (np.asarray(a) for a in jf)
    tflat = convert.flat_trees(jflat)
    plan = make_plan(tflat, topset, "cpu")
    v = torch.from_numpy(tflat.val).requires_grad_(True)
    pred = eval_plan(plan, v, torch.from_numpy(X))
    f = ((pred - torch.from_numpy(y)) ** 2).mean(-1)
    (g,) = torch.autograd.grad(f.sum(), v)
    ok = np.isfinite(want_f) & np.isfinite(want_g).all(-1)
    assert ok.sum() > 20
    np.testing.assert_allclose(f.detach().numpy()[ok], want_f[ok], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g.numpy()[ok], want_g[ok], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("wrt", ["constants", "features"])
def test_eval_grad_trees_matches(wrt):
    jopts, jflat, topset = _corpus(24, seed=5)
    X = _data(n=31, seed=2)
    want = np.asarray(J.ops.eval_grad_trees(jflat, jnp.asarray(X), jopts.operators, wrt=wrt))
    got = T.ops.eval_grad_trees(convert.flat_trees(jflat), X, topset, wrt=wrt).numpy()
    assert got.shape == want.shape
    m = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), m)
    np.testing.assert_allclose(got[m], want[m], rtol=1e-4, atol=1e-4)
