"""PyTorch port vs JAX package: the fused-loss kernel's plain version,
scoring, and BatchScorer.

On the CPU the kernel wrapper ``fused_loss`` runs its plain version (the
kernel itself is checked against it on the card by chip_smoke.py). Here that
plain version is held to the JAX package's scan-interpreter scoring
(``batched_loss_jit``) at rtol 1e-5: the elementwise f32 values agree to a
few ulp and the plain version sums in f64 where JAX sums in f32, so the two
differ by f32 summation noise (~1e-6 relative over 777 rows). Denormals are
flushed here as the JAX side's CPU fast-math flushes them.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu.models.mutation_functions import gen_random_tree as j_gen
from symbolicregression_jl_tpu.models.scorer import BatchScorer as JBatchScorer
from symbolicregression_jl_tpu.ops.scoring import batched_loss_jit
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.models.scorer import BatchScorer as TBatchScorer
from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
    fused_loss,
    loss_kernel_eligible,
    pack_programs_fused,
)

BIN = ["add", "sub", "mult", "div"]
UNA = ["cos", "exp", "abs"]
RTOL = 1e-5


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


def _opts(**kw):
    base = dict(binary_operators=BIN, unary_operators=UNA, maxsize=20, save_to_file=False)
    base.update(kw)
    return J.Options(**base), T.Options(device="cpu", **base)


def _trees(jopts, n, seed, nfeat=5):
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        t = j_gen(int(rng.integers(1, 9)), jopts.operators, nfeat, rng)
        if t.count_nodes() <= jopts.max_nodes:
            out.append(t)
    return out


def _data(n=777, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(5, n)).astype(np.float32)
    X[0, :16] = 0.0  # guard columns: abs kink at 0, near-zero denominators
    X[1, 16:32] = 1e-3
    y = np.cos(X[1]).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return X, y, w


def _assert_losses(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    m = np.isfinite(want)
    np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_fused_loss_plain_matches_jax_scoring(weighted):
    jopts, topts = _opts()
    trees = _trees(jopts, 128, seed=1)
    X, y, w = _data()
    jflat = J.flatten_trees(trees, jopts.max_nodes)
    want = batched_loss_jit(jflat, jnp.asarray(X), jnp.asarray(y),
                            jnp.asarray(w) if weighted else None,
                            jopts.operators, jopts.loss)
    prog, vals = pack_programs_fused(convert.flat_trees(jflat), topts.operators)
    before = fused_loss.launches
    got = fused_loss(torch.from_numpy(prog), torch.from_numpy(vals), torch.from_numpy(X),
                     torch.from_numpy(y), torch.from_numpy(w) if weighted else None,
                     topts.operators, topts.loss)
    assert fused_loss.launches == before  # CPU tensors never launch the kernel
    assert got.dtype == torch.float32 and got.shape == (128,)
    assert np.isfinite(np.asarray(want)).sum() > 60
    _assert_losses(got.numpy(), want)


def test_fused_loss_plain_matches_pallas_interpret(monkeypatch):
    """One tiny case against the TPU kernel itself, emulated by the Pallas
    interpreter (same ok rule, same reduction semantics)."""
    monkeypatch.setenv("SR_PALLAS_INTERPRET", "1")
    from symbolicregression_jl_tpu.ops.interp_pallas import make_pallas_loss_fn

    jopts, topts = _opts()
    trees = _trees(jopts, 16, seed=2)
    X, y, w = _data(n=100, seed=3)
    jflat = J.flatten_trees(trees, jopts.max_nodes)
    t0 = time.perf_counter()
    want = np.asarray(make_pallas_loss_fn(X, y, w, jopts.operators, jopts.loss)(jflat))
    assert time.perf_counter() - t0 < 60
    prog, vals = pack_programs_fused(convert.flat_trees(jflat), topts.operators)
    got = fused_loss(torch.from_numpy(prog), torch.from_numpy(vals), torch.from_numpy(X),
                     torch.from_numpy(y), torch.from_numpy(w), topts.operators, topts.loss)
    _assert_losses(got.numpy(), want)


def test_fused_loss_ok_rule_zero_weight():
    """w_sum == 0 gives inf, as the TPU kernel's ok rule says."""
    _, topts = _opts()
    t = T.tree.binary(0, T.tree.feature(0), T.tree.constant(1.0))
    prog, vals = pack_programs_fused(T.flatten_trees([t], topts.max_nodes), topts.operators)
    X = torch.ones((5, 4))
    got = fused_loss(torch.from_numpy(prog), torch.from_numpy(vals), X, torch.zeros(4),
                     torch.zeros(4), topts.operators, topts.loss)
    assert torch.isinf(got).all()


def test_fused_loss_rejects_other_devices():
    _, topts = _opts()
    prog = torch.zeros((1, 4 * topts.max_nodes + 1), dtype=torch.int32, device="meta")
    vals = torch.zeros((1, topts.max_nodes), device="meta")
    X = torch.zeros((5, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_loss(prog, vals, X, torch.zeros(8, device="meta"), None,
                   topts.operators, topts.loss)


def test_kernel_gate_by_names():
    _, topts = _opts()
    assert loss_kernel_eligible(topts.operators, topts.loss, np.float32)
    assert not loss_kernel_eligible(topts.operators, topts.loss, np.float64)
    custom = T.Options(device="cpu", binary_operators=["+", lambda a, b: a * b + 1.0])
    assert not loss_kernel_eligible(custom.operators, custom.loss, np.float32)
    user_loss = T.Options(device="cpu", elementwise_loss=lambda p, t: (p - t) ** 4)
    assert not loss_kernel_eligible(user_loss.operators, user_loss.loss, np.float32)


@pytest.mark.parametrize("minibatch", [False, True], ids=["full", "minibatch"])
def test_batch_scorer_matches_jax(minibatch):
    jopts, topts = _opts(batching=minibatch, batch_size=64)
    X, y, w = _data(n=300, seed=4)
    pop = J.Population([J.PopMember(t, 0.0, 0.0) for t in _trees(jopts, 60, seed=5)])
    jflat = J.flatten_trees([m.tree for m in pop.members], jopts.max_nodes)
    ttrees = convert.trees_from_arrays(jflat)
    jsc = JBatchScorer(J.Dataset(X, y, weights=w), jopts)
    tsc = TBatchScorer(T.Dataset(X, y, weights=w), topts)
    assert tsc.use_kernel
    assert np.isclose(tsc.dataset.baseline_loss, jsc.dataset.baseline_loss, rtol=1e-6)
    idx = jsc.batch_indices(np.random.default_rng(0)) if minibatch else None
    want = jsc.loss_many([m.tree for m in pop.members], idx=idx)
    got = tsc.loss_many(ttrees, idx=idx)
    _assert_losses(got, want)
    assert tsc.num_evals == pytest.approx(jsc.num_evals)
    assert tsc.num_dispatches == 1
    comps = [T.complexity.compute_complexity(t, topts) for t in ttrees]
    np.testing.assert_allclose(
        tsc.score_of(got, np.asarray(comps)), jsc.score_of(want, np.asarray(comps)),
        rtol=RTOL,
    )


def _user_mult(a, b):
    return a * b


def test_batch_scorer_plain_interpreter_path():
    """A user operator is outside the kernel: the scorer takes the
    length-bucketed plain interpreter, with the same losses."""
    jopts, topts = _opts()
    user = T.Options(device="cpu", binary_operators=["add", "sub", _user_mult, "div"],
                     unary_operators=UNA, maxsize=20, save_to_file=False)
    X, y, _ = _data(n=200, seed=6)
    trees = convert.trees_from_arrays(
        J.flatten_trees(_trees(jopts, 40, seed=7), jopts.max_nodes))
    a = TBatchScorer(T.Dataset(X, y), topts)
    b = TBatchScorer(T.Dataset(X, y), user)
    assert a.use_kernel and not b.use_kernel
    _assert_losses(b.loss_many(trees), a.loss_many(trees))
