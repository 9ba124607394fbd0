"""PyTorch port vs JAX package: batched constant optimization.

Both packages draw the restart jitter from the same numpy generator state,
so they start every (tree, restart) from the same constants; BFGS then runs
in f32 in each, through different gradient code, so the final losses are
compared at rtol 1e-3 (or both below 1e-10, where relative error is
meaningless). Trees with one constant take Newton in both.
"""

import jax
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu.models.scorer import BatchScorer as JBatchScorer
from symbolicregression_jl_tpu.ops.constant_opt import (
    optimize_constants_batched as j_opt,
)
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.models.scorer import BatchScorer as TBatchScorer
from symbolicregression_jl_tpu_torch.ops.constant_opt import (
    _clamped_chunk,
    optimize_constants_batched as t_opt,
)

BIN = ["add", "sub", "mult", "div"]
UNA = ["cos", "exp"]
ADD, SUB, MUL, DIV = range(4)
COS, EXP = range(2)


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
    base = dict(binary_operators=BIN, unary_operators=UNA, maxsize=16, save_to_file=False)
    base.update(kw)
    return J.Options(**base), T.Options(device="cpu", **base)


def _data(n=120, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(2, n)).astype(np.float32)
    y = (2.5 * np.cos(1.3 * X[0]) + 0.7 * X[1] - 0.4).astype(np.float32)
    return X, y


def _corpus(jt):
    """Trees with 1..3 constants over the planted problem's ingredients."""
    c, f, b, u = jt.constant, jt.feature, jt.binary, jt.unary
    return [
        b(ADD, b(MUL, c(1.0), u(COS, b(MUL, c(1.0), f(0)))), c(0.0)),
        b(ADD, b(MUL, c(2.0), u(COS, f(0))), b(MUL, c(0.5), f(1))),
        b(MUL, c(1.7), f(1)),
        b(SUB, u(EXP, b(MUL, c(0.3), f(0))), c(1.0)),
        b(DIV, f(1), b(ADD, c(2.0), u(COS, f(0)))),
        b(ADD, b(MUL, c(0.9), f(1)), u(COS, b(MUL, c(1.1), f(0)))),
        b(ADD, f(0), f(1)),
    ]


def _run_both(jopts, topts, weights=None):
    X, y = _data()
    jtrees = _corpus(J.tree)
    jflat = J.flatten_trees(jtrees, jopts.max_nodes)
    ttrees = convert.trees_from_arrays(jflat)
    jsc = JBatchScorer(J.Dataset(X, y, weights=weights), jopts)
    tsc = TBatchScorer(T.Dataset(X, y, weights=weights), topts)
    jt, jl, ji = j_opt(jtrees, jsc, jopts, np.random.default_rng(3))
    tt, tl, ti = t_opt(ttrees, tsc, topts, np.random.default_rng(3))
    return (jt, jl, ji), (tt, tl, ti), tsc


def _assert_final(jl, tl):
    jl, tl = np.asarray(jl), np.asarray(tl)
    both_tiny = (jl < 1e-10) & (tl < 1e-10)
    np.testing.assert_allclose(tl[~both_tiny], jl[~both_tiny], rtol=1e-3)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_bfgs_final_losses_match_jax(weighted):
    jopts, topts = _opts()
    w = np.random.default_rng(1).uniform(0.5, 2, 120).astype(np.float32) if weighted else None
    (jt, jl, ji), (tt, tl, ti), _ = _run_both(jopts, topts, w)
    _assert_final(jl, tl)
    # the constant-free tree passes through untouched in both
    assert not ji[-1] and not ti[-1] and tt[-1] is not None


def test_planted_constants_recovered():
    """y = 2.5 cos(1.3 x0) + 0.7 x1 - 0.4 from nearby starting constants."""
    _, topts = _opts(optimizer_iterations=30)
    X, y = _data()
    c, f, b, u = T.tree.constant, T.tree.feature, T.tree.binary, T.tree.unary
    t = b(ADD, b(ADD, b(MUL, c(2.0), u(COS, b(MUL, c(1.2), f(0)))), b(MUL, c(0.5), f(1))),
          c(0.0))
    sc = TBatchScorer(T.Dataset(X, y), topts)
    new, loss, improved = t_opt([t], sc, topts, np.random.default_rng(0))
    assert improved[0] and loss[0] < 1e-8
    consts = np.asarray(new[0].get_constants())
    np.testing.assert_allclose(consts, [2.5, 1.3, 0.7, -0.4], rtol=1e-3, atol=1e-4)


def test_newton_single_constant_matches_jax():
    jopts, topts = _opts()
    X, y = _data()
    jtree = J.tree.binary(MUL, J.tree.constant(0.2), J.tree.feature(1))
    ttree = convert.trees_from_arrays(J.flatten_trees([jtree], 16))[0]
    y1 = (1.9 * X[1]).astype(np.float32)
    jsc = JBatchScorer(J.Dataset(X, y1), jopts)
    tsc = TBatchScorer(T.Dataset(X, y1), topts)
    _, jl, _ = j_opt([jtree], jsc, jopts, np.random.default_rng(0))
    tn, tl, _ = t_opt([ttree], tsc, topts, np.random.default_rng(0))
    _assert_final(jl, tl)
    assert tn[0].get_constants()[0] == pytest.approx(1.9, rel=1e-4)


def test_neldermead_final_losses_match_jax():
    jopts, topts = _opts(optimizer_algorithm="NelderMead")
    (_, jl, _), (_, tl, _), _ = _run_both(jopts, topts)
    _assert_final(jl, tl)


def test_minibatch_and_chunking(monkeypatch):
    """A row subset optimizes against those rows; a chunk of one tree gives
    the same result as the whole batch at once."""
    _, topts = _opts(batching=True, batch_size=40)
    X, y = _data()
    trees = convert.trees_from_arrays(J.flatten_trees(_corpus(J.tree), 16))
    sc = TBatchScorer(T.Dataset(X, y), topts)
    idx = sc.batch_indices(np.random.default_rng(0))
    _, l_all, _ = t_opt(trees, sc, topts, np.random.default_rng(5), idx=idx)
    monkeypatch.setenv("SR_CONSTOPT_CHUNK", "1")
    _, l_one, _ = t_opt(trees, sc, topts, np.random.default_rng(5), idx=idx)
    np.testing.assert_allclose(l_one, l_all, rtol=1e-5)
    assert _clamped_chunk(512, 3, 24, 10_000, np.float32, False) == 512
    assert _clamped_chunk(4096, 3, 24, 10_000, np.float32, False) == 694


@pytest.mark.parametrize("iters", [1, 8])
def test_engine_neldermead_matches_jax_single(iters):
    """The device engine's NelderMead (``ops.constant_opt._neldermead`` over
    ``_PackedObjective``, each value one call of B1's wrapper: its plain
    version here) against the JAX engine's per-tree
    ``_neldermead_single`` from the same constants: final losses within 1e-5
    relative (both sum the loss in their own order, in f32 and f64)."""
    from symbolicregression_jl_tpu.ops.constant_opt import _neldermead_single, remat_tree_loss
    from symbolicregression_jl_tpu.ops.interp import _Structure

    import symbolicregression_jl_tpu_torch.models.device_search as tds
    from symbolicregression_jl_tpu_torch.ops.treeops import Tree

    jopts, topts = _opts(optimizer_algorithm="NelderMead", scheduler="device")
    X, y = _data()
    flat = J.flatten_trees(_corpus(J.tree)[:-1], jopts.max_nodes)
    arrays = {f: np.asarray(getattr(flat, f)) for f in convert.FIELDS}
    mask = arrays["kind"] == 1
    rng = np.random.default_rng(4)
    v0 = (arrays["val"] * (1 + 0.5 * rng.normal(size=arrays["val"].shape))).astype(np.float32)
    v0 = np.where(mask, v0, arrays["val"]).astype(np.float32)

    jnp = jax.numpy
    loss_fn = remat_tree_loss(jopts.operators, jopts.loss, jnp.asarray(X), jnp.asarray(y),
                              jnp.zeros((), jnp.float32), False)
    struct = _Structure(*(jnp.asarray(arrays[f]) for f in
                          ("kind", "op", "lhs", "rhs", "feat", "length")))
    _, jf = jax.vmap(lambda v, s, m: _neldermead_single(
        loss_fn, v, s, None, None, None, False, m, iters))(
        jnp.asarray(v0), struct, jnp.asarray(mask))

    scorer = tds.EngineScorer(topts, use_kernel=True)
    batch = Tree(*(torch.from_numpy(arrays[f]) for f in convert.FIELDS))
    prog, _ = tds.pack_batch(batch, topts.operators)
    obj = tds._PackedObjective(scorer, prog, torch.from_numpy(X), torch.from_numpy(y), None)
    tv, tf = tds._neldermead(obj, torch.from_numpy(v0), torch.from_numpy(mask), iters, 0.0)
    assert scorer.grad_calls == 0 and scorer.score_calls == 1 + 4 * iters
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5)
    assert np.all(tf.numpy() <= obj.value(torch.from_numpy(v0)).numpy())
