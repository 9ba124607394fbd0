"""Full objectives (``Options.loss_function_jit``) in the PyTorch port
against the JAX package (``ops/scoring.objective_loss_jit``,
``tests/test_round5_fixes.py``'s search test, ``tests/test_engine_pipeline.py``'s
traceable-objective const-opt test).

The port's objective is a function on torch tensors, ``objective(preds
[P, R], y [R], w [R] | None) -> [P]``; the JAX package's the same function
in jnp. Both are written out here, each in its framework, and fed the same
numpy inputs. On the card the predictions come from B4 and the objective's
gradient from B2's seeded sweep; on the CPU both wrappers take their plain
versions, which is what runs here.

Tolerances: losses at rtol 1e-4 (f32; the objective's row sums run in
another order in the two frameworks) with equal inf positions (a tree with
a non-finite prediction scores inf whatever the objective returns);
gradients at rtol 1e-4 plus 1e-5 times the tree's largest gradient plus
1e-5 (a correlation is blind to a tree's additive constant, whose gradient
is 0 up to the rounding of a cancelling sum), on the trees whose
predictions the two packages agree on to 1e-6, keep below 1e3 and spread
by more than 1e-3 (tests/test_torch_lossgrad.py's rule); searches by the
JAX tests' own bars; a fleet lane bit for bit against its solo run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
import symbolicregression_jl_tpu_torch.models.device_search as tds
import symbolicregression_jl_tpu_torch.models.scorer as scorer_mod
from symbolicregression_jl_tpu.models.device_search import (
    device_mode_supported as j_device_mode_supported,
)
from symbolicregression_jl_tpu.models.mutation_functions import gen_random_tree as j_gen
from symbolicregression_jl_tpu.ops.constant_opt import _eval_one, remat_tree_loss
from symbolicregression_jl_tpu.ops.interp import _Structure
from symbolicregression_jl_tpu.ops.interp import eval_trees as j_eval_trees
from symbolicregression_jl_tpu.ops.scoring import objective_loss_jit
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.ops import interp_cuda as ic
from symbolicregression_jl_tpu_torch.ops.interp import eval_trees as t_eval_trees
from symbolicregression_jl_tpu_torch.ops.scoring import objective_loss_plain

RTOL = 1e-4
GRAD_RTOL, GRAD_SCALE_ATOL, GRAD_ATOL = 1e-4, 1e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu_numerics():
    """Keep JAX in 32-bit mode (an earlier test module in this process may
    have enabled x64) and use one torch thread (sums split by thread count
    would make the port's results depend on the machine)."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", x64)


# -- the objectives, once per framework ---------------------------------------------


def mse_t(preds, y, w):
    err = (preds - y[None, :]) ** 2
    if w is not None:
        return torch.sum(err * w[None, :], dim=-1) / torch.sum(w)
    return torch.mean(err, dim=-1)


def mse_j(preds, y, w):
    err = (preds - y[None, :]) ** 2
    if w is not None:
        return jnp.sum(err * w[None, :], axis=-1) / jnp.sum(w)
    return jnp.mean(err, axis=-1)


def corr_t(preds, y, w):
    """1 - corr(preds, y)^2, weighted by w when given: not separable over
    rows (a constant prediction scores 1, not 0 / 0)."""
    w = torch.ones_like(y) if w is None else w
    ws = torch.sum(w)
    pm = torch.sum(preds * w, dim=-1, keepdim=True) / ws
    ym = torch.sum(y * w) / ws
    dp, dy = preds - pm, y - ym
    cov = torch.sum(w * dp * dy, dim=-1)
    vp = torch.sum(w * dp * dp, dim=-1)
    vy = torch.sum(w * dy * dy)
    return 1.0 - cov * cov / (vp * vy + 1e-30)


def corr_j(preds, y, w):
    w = jnp.ones_like(y) if w is None else w
    ws = jnp.sum(w)
    pm = jnp.sum(preds * w, axis=-1, keepdims=True) / ws
    ym = jnp.sum(y * w) / ws
    dp, dy = preds - pm, y - ym
    cov = jnp.sum(w * dp * dy, axis=-1)
    vp = jnp.sum(w * dp * dp, axis=-1)
    vy = jnp.sum(w * dy * dy)
    return 1.0 - cov * cov / (vp * vy + 1e-30)


def mae_t(preds, y, w):
    return torch.mean(torch.abs(preds - y[None, :]), dim=-1)


def doubled_t(preds, y, w):
    err = (2.0 * preds - y[None, :]) ** 2
    if w is not None:
        return torch.sum(err * w[None, :], dim=-1) / torch.sum(w)
    return torch.mean(err, dim=-1)


OBJECTIVES = {"mse": (mse_t, mse_j), "corr": (corr_t, corr_j)}
BIN, UNA = ["add", "sub", "mult", "div"], ["cos", "exp", "log", "sqrt"]


def _corpus(n_rows=97, n_trees=80, seed=0):
    """Random trees over ops that make some predictions non-finite (log and
    sqrt of a difference that goes negative, exp overflowing): the JAX
    trees and flat batch, the port's packed programs, X [3, R] on [0.2, 2],
    y, w."""
    jopts = J.Options(binary_operators=BIN, unary_operators=UNA, maxsize=20,
                      save_to_file=False)
    topts = T.Options(binary_operators=BIN, unary_operators=UNA, maxsize=20,
                      save_to_file=False, device="cpu")
    rng = np.random.default_rng(seed)
    trees = []
    while len(trees) < n_trees:
        t = j_gen(int(rng.integers(1, 8)), jopts.operators, 3, rng)
        if t.count_nodes() <= jopts.max_nodes:
            trees.append(t)
    jflat = J.flatten_trees(trees, jopts.max_nodes)
    prog, vals = ic.pack_programs_fused(convert.flat_trees(jflat), topts.operators)
    X = rng.uniform(0.2, 2.0, size=(3, n_rows)).astype(np.float32)
    y = (np.cos(X[0]) + 0.5 * X[1]).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n_rows).astype(np.float32)
    return jopts, topts, jflat, prog, vals, X, y, w


def _well_conditioned(jopts, topts, jflat, X, rel_spread=0.0):
    """Trees whose predictions the two packages agree on to 1e-6 relative,
    all finite, below 1e3 and spread by more than 1e-3 (a near-constant
    prediction makes the correlation's 0 / 0 a matter of rounding) and by
    more than ``rel_spread`` times their largest magnitude (the rounding of
    the correlation's gradient grows as the inverse square of that spread)."""
    pj = np.asarray(j_eval_trees(jflat, jnp.asarray(X), jopts.operators), np.float64)
    pt = t_eval_trees(convert.flat_trees(jflat), torch.from_numpy(X),
                      topts.operators).double().numpy()
    with np.errstate(invalid="ignore"):
        close = np.abs(pj - pt) <= 1e-6 * np.maximum(np.abs(pj), 1e-3)
        good = (np.isfinite(pj) & close & (np.abs(pj) < 1e3)).all(axis=1)
        spread = np.ptp(pj, axis=1)
        spread_ok = (spread > 1e-3) & (spread > rel_spread * np.abs(pj).max(axis=1))
        return good & (spread_ok | (pj.shape[1] == 1))


def _assert_losses(got, want, keep):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[keep], want[keep], rtol=RTOL, atol=1e-6)


def _assert_grads(got, want, keep):
    got, want = np.asarray(got, np.float64)[keep], np.asarray(want, np.float64)[keep]
    scale = np.abs(want).max(axis=1, keepdims=True)
    err = np.abs(got - want)
    lim = GRAD_RTOL * np.abs(want) + GRAD_SCALE_ATOL * scale + GRAD_ATOL
    assert (err <= lim).all(), err.max()


# -- scoring ------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_objective_losses_match_jax(name, weighted):
    """``objective_losses`` (B4 and the objective; here B4's plain version)
    and ``objective_loss_plain`` against the JAX package's
    ``objective_loss_jit``: inf where a prediction is not finite."""
    obj_t, obj_j = OBJECTIVES[name]
    jopts, topts, jflat, prog, vals, X, y, w = _corpus()
    wt = w if weighted else None
    want = np.asarray(objective_loss_jit(jflat, jnp.asarray(X), jnp.asarray(y),
                                         None if wt is None else jnp.asarray(wt),
                                         jopts.operators, obj_j))
    tX, ty = torch.from_numpy(X), torch.from_numpy(y)
    tw = None if wt is None else torch.from_numpy(wt)
    got = ic.objective_losses(torch.from_numpy(prog), torch.from_numpy(vals), tX, ty, tw,
                              topts.operators, obj_t).numpy()
    plain = objective_loss_plain(convert.flat_trees(jflat), tX, ty, tw, topts.operators,
                                 obj_t).numpy()
    keep = _well_conditioned(jopts, topts, jflat, X)
    assert np.isinf(want).sum() >= 5 and keep.sum() >= 30
    np.testing.assert_array_equal(got, plain)
    _assert_losses(got, want, keep)


@pytest.mark.parametrize("n_rows", [1, 97])
def test_preds_vjp_matches_jax_vjp(n_rows):
    """``DiffPreds`` (B4 with the seeded sweep as its backward) and
    ``preds_vjp_reference`` against ``jax.vjp`` of the JAX package's scan
    interpreter on the same random cotangent; 0 for every slot of a tree
    with a non-finite prediction."""
    jopts, topts, jflat, prog, vals, X, y, w = _corpus(n_rows=n_rows)
    seed = np.random.default_rng(n_rows).normal(size=(len(prog), n_rows)).astype(np.float32)
    struct = _Structure(*(jnp.asarray(np.asarray(getattr(jflat, f))) for f in
                          ("kind", "op", "lhs", "rhs", "feat", "length")))
    _, vjp = jax.vjp(lambda v: jax.vmap(lambda vv, s: _eval_one(jopts.operators, s, vv,
                                                                jnp.asarray(X)))(v, struct),
                     jnp.asarray(jflat.val))
    (gj,) = vjp(jnp.asarray(seed))
    tp, tv, tX, ts = (torch.from_numpy(a) for a in (prog, vals, X, seed))
    gr = ic.preds_vjp_reference(tp, tv, tX, ts, topts.operators).numpy()
    v = tv.clone().requires_grad_(True)
    preds = ic.DiffPreds.apply(v, tp, tX, topts.operators)
    (gd,) = torch.autograd.grad(preds, v, ts)
    ok = torch.isfinite(preds.detach()).all(-1).numpy()
    assert (~ok).sum() >= 3
    np.testing.assert_array_equal(gd.numpy()[~ok], 0.0)
    np.testing.assert_array_equal(gd.numpy(), gr)
    keep = _well_conditioned(jopts, topts, jflat, X) & ok
    assert keep.sum() >= 20
    const = np.asarray(jflat.kind) == 1
    _assert_grads(np.where(const, gr, 0.0), np.asarray(gj), keep)


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_engine_objective_loss_and_grad_match_jax(name):
    """The device engine's scorer under an objective: ``packed_losses`` and
    ``packed_loss_grad`` (``DiffPreds`` here on its plain versions) against
    the JAX package's per-tree const-opt objective (``remat_tree_loss(
    objective=...)``) and ``jax.value_and_grad``; a tree with a
    non-finite prediction scores inf with zero gradients."""
    obj_t, obj_j = OBJECTIVES[name]
    jopts, topts, jflat, prog, vals, X, y, w = _corpus()
    topts = T.Options(binary_operators=BIN, unary_operators=UNA, maxsize=20,
                      loss_function_jit=obj_t, save_to_file=False, device="cpu")
    scorer = tds.EngineScorer(topts, use_kernel=True, device="cpu")
    args = [torch.from_numpy(a) for a in (prog, vals, X, y, w)]
    f, g = scorer.packed_loss_grad(*args)
    f2 = scorer.packed_losses(*args)
    assert scorer.grad_calls == 1 and scorer.score_calls == 1
    np.testing.assert_array_equal(f.numpy(), f2.numpy())
    loss_fn = remat_tree_loss(jopts.operators, jopts.loss, jnp.asarray(X), jnp.asarray(y),
                              jnp.asarray(w), True, objective=obj_j)
    struct = _Structure(*(jnp.asarray(np.asarray(getattr(jflat, f_))) for f_ in
                          ("kind", "op", "lhs", "rhs", "feat", "length")))
    fj, gj = jax.vmap(jax.value_and_grad(lambda v, s: loss_fn(v, s, None, None, None, None)))(
        jnp.asarray(jflat.val), struct)
    fj, gj = np.asarray(fj), np.asarray(gj)
    bad = np.isinf(f.numpy())
    assert bad.sum() >= 3 and (g.numpy()[bad] == 0).all()
    keep = _well_conditioned(jopts, T.Options(binary_operators=BIN, unary_operators=UNA,
                                              device="cpu"), jflat, X, rel_spread=0.1) & ~bad
    assert keep.sum() >= 15
    np.testing.assert_allclose(f.numpy()[keep], fj[keep], rtol=RTOL, atol=1e-6)
    const = np.asarray(jflat.kind) == 1
    _assert_grads(np.where(const, g.numpy(), 0.0), gj, keep & np.isfinite(gj).all(1))


def test_lockstep_scorer_takes_b4_or_the_plain_interpreter(monkeypatch):
    """The lockstep scorer under an objective: f32 built-in names go through
    ``objective_losses`` (B4), f64 through ``objective_loss_plain``; the
    elementwise loss plays no part in the choice; the two agree."""
    calls = []
    for name in ("objective_losses", "objective_loss_plain"):
        real = getattr(scorer_mod, name)

        def rec(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(scorer_mod, name, rec)
    jopts, topts, jflat, prog, vals, X, y, w = _corpus()
    trees = convert.trees_from_arrays(jflat)
    out = {}
    for dt in (np.float32, np.float64):
        o = T.Options(binary_operators=BIN, unary_operators=UNA, maxsize=20, dtype=dt,
                      elementwise_loss=lambda p, t: (p - t) ** 2, loss_function_jit=mse_t,
                      save_to_file=False, device="cpu")
        out[dt] = scorer_mod.BatchScorer(T.Dataset(X, y, weights=w), o).loss_many(trees)
    assert calls == ["objective_losses", "objective_loss_plain"]
    keep = np.isfinite(out[np.float64]) & (np.abs(out[np.float64]) < 1e6)
    np.testing.assert_array_equal(np.isinf(out[np.float32]), np.isinf(out[np.float64]))
    np.testing.assert_allclose(out[np.float32][keep], out[np.float64][keep], rtol=1e-3)


# -- searches -----------------------------------------------------------------------


def test_options_rules():
    with pytest.raises(ValueError, match="mutually exclusive"):
        T.Options(loss_function=lambda t, d, o: 0.0, loss_function_jit=mse_t, device="cpu")
    o = T.Options(loss_function_jit=mse_t, device="cpu", save_to_file=False)
    assert o.should_simplify  # the objective sees predictions, which simplify keeps
    jo = J.Options(loss_function_jit=mse_j, save_to_file=False)
    assert tds.device_mode_supported(o) is None is j_device_mode_supported(jo)


@pytest.mark.parametrize("scheduler", ["lockstep", "device"])
def test_loss_function_jit_drives_search(scheduler):
    """The JAX package's test on the port: the frontier's losses equal the
    objective (MAE) evaluated on the decoded trees (rtol 2e-4)."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(2, 90)).astype(np.float32)
    y = (2.0 * X[0] + np.cos(X[1])).astype(np.float32)
    opts = T.Options(binary_operators=["+", "*"], unary_operators=["cos"],
                     loss_function_jit=mae_t, populations=2, population_size=14,
                     ncycles_per_iteration=20, maxsize=10, seed=0, scheduler=scheduler,
                     save_to_file=False, device="cpu")
    assert tds.device_mode_supported(opts) is None
    res = T.equation_search(X, y, options=opts, niterations=3, verbosity=0)
    assert np.isfinite(min(m.loss for m in res.pareto_frontier))
    for m in res.pareto_frontier:
        want = float(np.mean(np.abs(m.tree.eval_np(X, opts.operators) - y)))
        assert np.isfinite(want)
        np.testing.assert_allclose(m.loss, want, rtol=2e-4)


@pytest.mark.parametrize("scheduler", ["lockstep", "device"])
def test_constant_optimization_follows_the_objective(scheduler):
    """The JAX package's ``test_copt_cache_key_distinguishes_traceable_
    objectives`` on both schedulers: under the doubled objective the best
    fit of c * x1 to y = 3.37 x1 is c = 1.685, a constant only constant
    optimization finds, so the loss falls below 1e-2 only when it tunes
    against the objective the search scores with."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(1, 80)).astype(np.float32)
    y = (3.37 * X[0]).astype(np.float32)
    best = {}
    for name, obj in (("mse", mse_t), ("doubled", doubled_t)):
        opts = T.Options(binary_operators=["*", "+"], loss_function_jit=obj, populations=4,
                         population_size=16, ncycles_per_iteration=40, maxsize=8,
                         save_to_file=False, seed=0, scheduler=scheduler,
                         optimizer_probability=1.0, device="cpu")
        res = T.equation_search(X, y, options=opts, niterations=4, verbosity=0)
        best[name] = min(m.loss for m in res.pareto_frontier)
    assert best["mse"] < 1e-2 and best["doubled"] < 1e-2, best


def test_engine_takes_the_event_leg_under_an_objective(monkeypatch):
    """The block reduces an elementwise loss in its pass, so an objective
    keeps the event leg even where the block is forced (the JAX package's
    gate, ``device_search.py:2025``)."""
    monkeypatch.setenv("SR_ENGINE_BLOCK", "1")
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 64)).astype(np.float32)
    y = (X[0] * X[1]).astype(np.float32)
    kw = dict(binary_operators=["+", "*"], populations=2, population_size=12,
              ncycles_per_iteration=5, maxsize=8, seed=0, scheduler="device",
              save_to_file=False, device="cpu")
    plain = T.equation_search(X, y, options=T.Options(**kw), niterations=1, verbosity=0)
    res = T.equation_search(X, y, options=T.Options(loss_function_jit=mse_t, **kw),
                            niterations=1, verbosity=0)
    assert plain.engine_stats["block"] == "plain" and res.engine_stats["block"] is None
    cfg = tds.build_evo_config(T.Options(**kw), 2, 1.0, True, 1)
    assert tds._block_mode(cfg, "cpu", True, 64) == "plain"
    assert tds._block_mode(cfg, "cpu", True, 64, objective=True) is None


def test_fleet_lanes_under_an_objective_equal_their_solo_runs():
    """Two lanes under one objective (event leg; B4 and the seeded sweep
    once per lane) end bit for bit where their solo runs end."""
    from symbolicregression_jl_tpu_torch.models.device_search import FleetLaneSpec, fleet_search

    rng = np.random.default_rng(7)
    X = rng.normal(size=(2, 80)).astype(np.float32)
    ys = [(X[0] * X[1]).astype(np.float32), (np.cos(X[0]) + X[1]).astype(np.float32)]

    def opts(seed):
        return T.Options(binary_operators=["+", "*"], unary_operators=["cos"],
                         loss_function_jit=corr_t, populations=2, population_size=12,
                         ncycles_per_iteration=8, maxsize=8, seed=seed, scheduler="device",
                         save_to_file=False, device="cpu")

    fleet = fleet_search([FleetLaneSpec(X=X, y=ys[k], options=opts(k), niterations=2)
                          for k in range(2)])
    for k in range(2):
        solo = T.equation_search(X, ys[k], options=opts(k), niterations=2, verbosity=0)
        assert fleet[k].num_evals == solo.num_evals
        got = [(m.loss, m.tree.string_tree(opts(k).operators)) for m in fleet[k].pareto_frontier]
        want = [(m.loss, m.tree.string_tree(opts(k).operators)) for m in solo.pareto_frontier]
        assert got == want
