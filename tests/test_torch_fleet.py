"""The fleet engine (``fleet_search``, ``FleetLaneSpec``,
``fleet_migrate_from_pool``), the lane axis of kernels B1, B2 and B3, and
``multitarget_search``, on the CPU.

- ``pad_rows_np`` and ``fleet_eligibility`` equal the JAX package's.
- The lane-axis plain versions of B1 and B2 equal one solo call per lane
  bit for bit, and the JAX package's functions under ``jax.vmap`` over the
  lanes within f32 tolerance (losses rtol 1e-5 as tests/test_torch_scoring.py,
  gradients as tests/test_torch_lossgrad.py: the two sum over rows in
  different orders and precisions).
- The lane-axis plain B3 equals ``run_block`` per lane bit for bit, and the
  fleet's block iteration is held to ``jax.vmap`` of the JAX block iteration
  as tests/test_torch_evolve_block.py holds the solo one (integers equal,
  floats to rtol 1e-5).
- Whole fleets, on the event leg and on the block's plain version
  (``SR_ENGINE_BLOCK=1``): each lane's frontier (complexity, loss, string)
  and ``num_evals`` equal the port's own solo run of the same lane, bit for
  bit. The JAX package's fleet tests are slow (35-45 s compiles), so the
  fleet is held to the port's solo engine, which tests/test_torch_engine.py
  and tests/test_torch_block_engine.py hold to the JAX engine by quality
  bands.
- ``fleet_migrate_from_pool`` leaves a lane with ``apply=False`` and its
  generator untouched; the lockstep BFGS freezes lane by lane at
  ``optimizer_g_tol``, and its fleet-wide line search changes no lane.
- ``multitarget_search`` equals per-target solo runs at ``seed + t`` and
  raises the JAX package's validation errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu.models import device_search as jds
from symbolicregression_jl_tpu.ops import evolve_block as jb
from symbolicregression_jl_tpu.ops import losses as jl
from symbolicregression_jl_tpu.ops.constant_opt import _eval_one
from symbolicregression_jl_tpu.ops.evolve import EvoConfig as JEvoConfig
from symbolicregression_jl_tpu.ops.interp import _Structure
from symbolicregression_jl_tpu.ops.scoring import batched_loss_jit
from symbolicregression_jl_tpu.ops.scoring import pad_rows_np as j_pad_rows_np
from symbolicregression_jl_tpu.stream import multitarget_search as j_multitarget_search
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.models import device_search as tds
from symbolicregression_jl_tpu_torch.models.device_search import (
    FleetLaneSpec,
    _bfgs_lockstep,
    fleet_eligibility,
    fleet_search,
)
from symbolicregression_jl_tpu_torch.ops import evolve_block as tb
from symbolicregression_jl_tpu_torch.ops import evolve_block_cuda as ebc
from symbolicregression_jl_tpu_torch.ops import interp_cuda as ic
from symbolicregression_jl_tpu_torch.ops.evolve import (
    EvoConfig as TEvoConfig,
    EvoContext,
    fleet_migrate_from_pool,
)
from symbolicregression_jl_tpu_torch.ops.scoring import pad_rows_np

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu_numerics():
    """JAX in 32-bit mode (an earlier module in this process may have turned
    x64 on) and one torch thread, as the evolve-block tests run."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", x64)


def _problem(n=64, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2, n)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    return X, y


def _opts(**kw):
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=2,
                population_size=12, ncycles_per_iteration=10, maxsize=10, seed=0,
                save_to_file=False, progress=False, scheduler="device", device="cpu")
    base.update(kw)
    return T.Options(**base)


def _sig(res):
    """Bitwise frontier signature: float equality on losses is bit equality
    (the engines put no NaN loss on the frontier)."""
    o = res.options
    return [(m.get_complexity(o), m.loss, m.tree.string_tree(o.operators, precision=17))
            for m in res.pareto_frontier]


def _solo(X, y, niterations=2, weights=None, **kw):
    return T.equation_search(X, y, weights=weights, options=_opts(**kw),
                             niterations=niterations, verbosity=0)


def _assert_same_run(got, want):
    assert _sig(got) == _sig(want)
    assert got.num_evals == want.num_evals


# --------------------------------------------------------------------------
# pad_rows_np, fleet_eligibility
# --------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("bucket", [60, 100])
def test_pad_rows_np_matches_jax(weighted, bucket):
    X, y = _problem(n=60)
    w = np.linspace(0.5, 2.0, 60).astype(np.float32) if weighted else None
    got = pad_rows_np(X, y, w, bucket)
    want = j_pad_rows_np(X, y, w, bucket)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    assert got[2].shape == (bucket,)  # weights always materialized
    with pytest.raises(ValueError, match="n_bucket"):
        pad_rows_np(X, y, w, 59)


# populations=3 is not divisible by the JAX test process's CPU device
# count, so JAX's multi-device reason stays out
ELIGIBILITY = [
    dict(),
    dict(scheduler="lockstep"),
    dict(use_recorder=True, crossover_probability=0.0),
    dict(use_recorder=True, crossover_probability=0.0, device_mutation_attempts=2),
    dict(fault_spec="peer_death@2"),
    dict(save_to_file=True),
    dict(checkpoint_every=1),
    dict(checkpoint_every_seconds=5.0),
    dict(dtype=np.float64),
    dict(batching=True, batch_size=20),
]


@pytest.mark.parametrize("kw", ELIGIBILITY, ids=lambda kw: ",".join(kw) or "default")
def test_fleet_eligibility_matches_jax(kw):
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=3,
                population_size=12, save_to_file=False, scheduler="device")
    base.update(kw)
    want = jds.fleet_eligibility(J.Options(**base))
    got = fleet_eligibility(T.Options(device="cpu", **base))
    assert got == want


# --------------------------------------------------------------------------
# B1 and B2 on the lane axis
# --------------------------------------------------------------------------


def _lane_inputs(weighted, L=3, P=16, R=64, seed=0):
    """L lanes of P random trees each, one X, a y (and w) per lane."""
    opts = J.Options(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"],
                     maxsize=12)
    rng = np.random.default_rng(seed)
    flats = []
    for _ in range(L):
        trees = []
        while len(trees) < P:
            t = J.models.mutation_functions.gen_random_tree(int(rng.integers(1, 8)),
                                                          opts.operators, 2, rng)
            if t.count_nodes() <= opts.max_nodes:
                trees.append(t)
        flats.append(J.flatten_trees(trees, opts.max_nodes))
    X = rng.normal(size=(2, R)).astype(np.float32)
    Y = np.stack([np.cos(X[0]) * (l + 1) + 0.5 * X[1] for l in range(L)]).astype(np.float32)
    W = rng.uniform(0.1, 2.0, (L, R)).astype(np.float32) if weighted else None
    topts = T.Options(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"],
                      maxsize=12, device="cpu")
    packed = [ic.pack_programs_fused(convert.flat_trees(f), topts.operators) for f in flats]
    prog = torch.from_numpy(np.concatenate([p for p, _ in packed]))
    vals = torch.from_numpy(np.concatenate([v for _, v in packed]))
    Xt = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(X, (L,) + X.shape)))
    return opts, topts, flats, X, Y, W, prog, vals, Xt


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_lane_axis_b1_equals_solo_calls_and_jax_vmap(weighted):
    opts, topts, flats, X, Y, W, prog, vals, Xt = _lane_inputs(weighted)
    L, P = Y.shape[0], prog.shape[0] // Y.shape[0]
    Wt = None if W is None else torch.from_numpy(W)
    before = ic.fused_loss.launches
    got = ic.fused_loss(prog, vals, Xt, torch.from_numpy(Y), Wt, topts.operators, topts.loss)
    assert ic.fused_loss.launches == before  # CPU tensors take the plain version
    solo = torch.cat([
        ic.fused_loss(prog[l * P:(l + 1) * P], vals[l * P:(l + 1) * P], Xt[l],
                      torch.from_numpy(Y[l]), None if Wt is None else Wt[l], topts.operators,
                      topts.loss)
        for l in range(L)
    ])
    assert torch.equal(got.view(torch.int32), solo.view(torch.int32))
    stacked = J.ops.flat.FlatTrees(*(np.stack([np.asarray(getattr(f, k)) for f in flats])
                                     for k in J.ops.flat.FlatTrees._fields))
    want = jax.vmap(
        lambda f, y, w: batched_loss_jit(f, jnp.asarray(X), y, w, opts.operators, opts.loss),
        in_axes=(0, 0, 0 if weighted else None),
    )(stacked, jnp.asarray(Y), None if W is None else jnp.asarray(W))
    want = np.asarray(want).reshape(-1)
    got = got.numpy().astype(np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.sum() > L * P // 2
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_lane_axis_b2_equals_solo_calls_and_jax_vmap(weighted):
    opts, topts, flats, X, Y, W, prog, vals, Xt = _lane_inputs(weighted, seed=1)
    L, P = Y.shape[0], prog.shape[0] // Y.shape[0]
    Wt = None if W is None else torch.from_numpy(W)
    Yt = torch.from_numpy(Y)
    before = ic.fused_loss_grad.launches
    gl, gg = ic.fused_loss_grad(prog, vals, Xt, Yt, Wt, topts.operators, topts.loss)
    assert ic.fused_loss_grad.launches == before
    solo = [ic.fused_loss_grad(prog[l * P:(l + 1) * P], vals[l * P:(l + 1) * P], Xt[l], Yt[l],
                               None if Wt is None else Wt[l], topts.operators, topts.loss)
            for l in range(L)]
    assert torch.equal(gl.view(torch.int32), torch.cat([s[0] for s in solo]).view(torch.int32))
    assert torch.equal(gg.view(torch.int32), torch.cat([s[1] for s in solo]).view(torch.int32))
    # jax.value_and_grad of the row sum of w * loss through the JAX scan
    # interpreter, per tree, per lane; divided by w_sum afterwards (B2's
    # convention, tests/test_torch_lossgrad.py)
    jloss = jl.resolve_loss("L2DistLoss")

    def total(v, s, y, w):
        return jnp.sum(jloss(_eval_one(opts.operators, s, v, jnp.asarray(X)), y) * w)

    per_tree = jax.vmap(jax.value_and_grad(total), in_axes=(0, 0, None, None))
    struct = _Structure(*(jnp.asarray(np.stack([np.asarray(getattr(f, k)) for f in flats]))
                          for k in ("kind", "op", "lhs", "rhs", "feat", "length")))
    vj = jnp.asarray(np.stack([np.asarray(f.val) for f in flats]))
    wj = jnp.asarray(W if weighted else np.ones_like(Y))
    lj, gj = jax.jit(jax.vmap(per_tree))(vj, struct, jnp.asarray(Y), wj)
    wsum = (W.astype(np.float64).sum(1) if weighted else np.full(L, float(X.shape[1])))
    lj = (np.asarray(lj) / wsum[:, None]).reshape(-1)
    gj = (np.asarray(gj) / wsum[:, None, None]).reshape(L * P, -1)
    lt, gt = gl.numpy(), gg.numpy()
    const = np.concatenate([np.asarray(f.kind) for f in flats]) == 1
    np.testing.assert_array_equal(gt[~const], 0.0)
    sel = np.isfinite(lt) & np.isfinite(lj) & (np.abs(lj) < 1e4)
    assert sel.sum() > L * P // 2
    np.testing.assert_allclose(lt[sel], lj[sel], rtol=1e-4, atol=1e-6)
    both = const & sel[:, None] & np.isfinite(gj)
    scale = np.max(np.where(both, np.abs(gj), 0.0), axis=1, keepdims=True)
    err = np.abs(gt - gj)
    assert not (both & (err > 1e-4 * np.abs(gj) + 1e-5 * scale)).any()


def test_over_lanes_rejects_a_ragged_batch():
    _, topts, _, _, Y, _, prog, vals, Xt = _lane_inputs(False)
    with pytest.raises(ValueError, match="do not split"):
        ic.fused_loss(prog[:-1], vals[:-1], Xt, torch.from_numpy(Y), None, topts.operators,
                      topts.loss)


# --------------------------------------------------------------------------
# B3 on the lane axis
# --------------------------------------------------------------------------

CFG = dict(
    n_islands=2, pop_size=8, n_slots=8, maxsize=7, maxdepth=6, nfeatures=2, n_unary=2,
    n_binary=3, tournament_n=3, tournament_weights=(0.6, 0.25, 0.15),
    mutation_weights=(0.2, 0.2, 0.1, 0.2, 0.1, 0.1, 0.05, 0.05), crossover_probability=0.0,
    annealing=True, alpha=0.1, parsimony=0.0032, use_frequency=True,
    use_frequency_in_tournament=True, adaptive_parsimony_scaling=20.0,
    perturbation_factor=0.076, probability_negate_constant=0.3, baseline_loss=1.0,
    use_baseline=True, ncycles=3, events_per_cycle=4, fraction_replaced=0.0,
    fraction_replaced_hof=0.0, migration=False, hof_migration=False, topn=4, niterations=4,
    warmup_maxsize_by=0.0,
)
BLOCK_OPSET = T.Options(binary_operators=["+", "-", "*"], unary_operators=["cos", "exp"],
                        device="cpu").operators


def _block_population(cfg, seed, X, y):
    """A scored random population of ``cfg``'s islands: the flat trees and
    the B3 inputs (words, consts, length, loss, score, birth)."""
    I, P, N = cfg.n_islands, cfg.pop_size, cfg.n_slots
    rng = np.random.default_rng(seed)
    trees = []
    while len(trees) < I * P:
        t = T.models.mutation_functions.gen_random_tree(int(rng.integers(1, 7)), BLOCK_OPSET,
                                                        2, rng)
        if t.count_nodes() <= N:
            trees.append(t)
    flat = T.flatten_trees(trees, N)
    loss = ic.plain_losses(flat, torch.from_numpy(flat.val), X, y, None, BLOCK_OPSET,
                           T.Options(device="cpu").loss).reshape(I, P)
    words, consts = tb.pack_state_words(*(torch.from_numpy(np.asarray(a)) for a in
                                          (flat.kind, flat.op, flat.feat, flat.val)))
    length = torch.from_numpy(np.asarray(flat.length)).reshape(I, P)
    birth = torch.from_numpy(rng.integers(0, 4, (I, P)).astype(np.int32))
    pop = (words.reshape(I, P, N), consts.reshape(I, P, N), length, loss,
           loss / 1.5 + length.float() * cfg.parsimony, birth)
    return flat, tuple(a.contiguous() for a in pop)


def test_lane_axis_b3_equals_run_block_per_lane():
    cfg = TEvoConfig(**CFG)
    L, S1 = 3, cfg.maxsize + 1
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(2, 64)).astype(np.float32))
    Y = torch.stack([torch.cos(X[0]) * (l + 1) + X[1] for l in range(L)])
    pops = [_block_population(cfg, l, X, Y[l])[1] for l in range(L)]
    fnorm = torch.from_numpy(rng.dirichlet(np.ones(S1), L).astype(np.float32))
    seed = torch.tensor([11, 12345, 7], dtype=torch.int64)
    step0 = torch.tensor([3, 0, 9], dtype=torch.int32)
    cms = torch.tensor([7, 5, 6], dtype=torch.int32)
    norm = torch.tensor([1.5, 1.0, 2.0])
    loss_elem = T.Options(device="cpu").loss
    Xl = X.expand(L, -1, -1).contiguous()
    before = ebc.evolve_block.launches
    got = ebc.evolve_block(*(torch.cat([p[k] for p in pops]) for k in range(6)), fnorm, seed,
                           step0, cms, norm, Xl, Y, None, cfg, BLOCK_OPSET, loss_elem)
    assert ebc.evolve_block.launches == before
    for l in range(L):
        want = tb.run_block(pops[l], seed[l], step0[l], cms[l], fnorm[l], norm[l], cfg,
                            tb.make_plain_eval(BLOCK_OPSET, loss_elem, X, Y[l], None))
        I = cfg.n_islands
        for k, (g, w) in enumerate(zip(got, want)):
            g = g[l * I:(l + 1) * I]
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            assert torch.equal(g, w), (l, convert.BLOCK_FIELDS[k])


def test_fleet_block_iteration_matches_jax_vmap():
    """One cycle of the fleet's block iteration over two lanes (one X, two
    y) from two JAX states: jax.vmap of the JAX package's block iteration
    with its reference evaluator against run_block_iteration_fleet with
    B3's plain version on the lane axis, each lane's seed passed as JAX
    derives it from that lane's key."""
    from symbolicregression_jl_tpu.ops.evolve import init_state as j_init
    from symbolicregression_jl_tpu.ops.flat import FlatTrees as JFlat
    from symbolicregression_jl_tpu.ops.interp_pallas import _reshape_rows
    from symbolicregression_jl_tpu.ops.operators import resolve_operators as j_ops

    d = dict(CFG, ncycles=1)
    jcfg, tcfg = JEvoConfig(**d), TEvoConfig(**d)
    rng = np.random.default_rng(0)
    R = 100
    Xn = rng.normal(size=(2, R)).astype(np.float32)
    Yn = np.stack([2 * np.cos(Xn[1]) + Xn[0] ** 2 - 2, Xn[0] * Xn[1] + 1]).astype(np.float32)
    tX = torch.from_numpy(Xn)
    loss_elem = T.Options(device="cpu").loss
    jstates, seeds = [], []
    for l in range(2):
        flat, _ = _block_population(tcfg, 10 + l, tX, torch.from_numpy(Yn[l]))
        losses = ic.plain_losses(flat, torch.from_numpy(flat.val), tX, torch.from_numpy(Yn[l]),
                                 None, BLOCK_OPSET, loss_elem).numpy()
        st = j_init(JFlat(*(np.asarray(a) for a in flat)), losses, jcfg, seed=l)
        _, k_blk = jax.random.split(st.key)
        kd = np.asarray(jax.random.key_data(k_blk) if not jnp.issubdtype(k_blk.dtype,
                                                                          jnp.integer)
                        else k_blk).reshape(-1).astype(np.uint32)
        seeds.append(int(kd[0] ^ kd[1]))
        jstates.append(st)
    jopset = j_ops(["+", "-", "*"], ["cos", "exp"])

    def j_loss(pred, yv):
        dd = pred - yv
        return dd * dd

    class Data:
        norm = jnp.float32(1.0)

    Xr, _, wr, _, _ = _reshape_rows(Xn, Yn[0], None)
    yrs = jnp.stack([jnp.asarray(_reshape_rows(Xn, Yn[l], None)[1]) for l in range(2)])

    def lane(st, yr):
        ev = jb.make_reference_eval(jopset, j_loss, Xr, yr, wr, R)
        return jb.run_block_iteration(st, Data(), jcfg, eval_fn=ev)

    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jstates)
    j_out = jax.jit(jax.vmap(lane))(stacked, yrs)

    class TData:
        norm = torch.tensor(1.0)

    tstates = [convert.evo_state_from_arrays(st) for st in jstates]
    ctxs = [EvoContext(tcfg, "cpu", torch.Generator().manual_seed(l), None) for l in range(2)]
    tY = torch.from_numpy(Yn)
    t_out = tb.run_block_iteration_fleet(
        tstates, [TData(), TData()], ctxs,
        lambda *a: ebc.evolve_block_reference(*a, tX.expand(2, -1, -1).contiguous(), tY, None,
                                              tcfg, BLOCK_OPSET, loss_elem),
        seeds=seeds,
    )
    for l in range(2):
        want = convert.evo_state_arrays(t_out[l])
        for name in convert.EVO_FIELDS:
            j = jax.tree_util.tree_map(lambda a: np.asarray(a)[l], getattr(j_out, name))
            if name == "bs_tree":
                for k, (a, b) in enumerate(zip(want[name], j)):
                    _assert_same(f"lane {l} bs_tree[{k}]", a, b)
            elif name != "key":
                _assert_same(f"lane {l} {name}", want[name], j)


def _assert_same(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype.kind == "f":
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=name)
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=1e-6, err_msg=name)
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64),
                                      err_msg=name)


# --------------------------------------------------------------------------
# Whole fleets against the port's solo engine
# --------------------------------------------------------------------------


@pytest.fixture(params=["event", "block"])
def leg(request, monkeypatch):
    """The event leg (SR_ENGINE_BLOCK=0), or the block's plain version
    (SR_ENGINE_BLOCK=1 on the CPU)."""
    monkeypatch.setenv("SR_ENGINE_BLOCK", "0" if request.param == "event" else "1")
    return request.param


def test_fleet_of_one_equals_solo(leg):
    X, y = _problem()
    solo = _solo(X, y)
    (fleet,) = fleet_search([FleetLaneSpec(X=X, y=y, options=_opts(), niterations=2)])
    _assert_same_run(fleet, solo)
    assert fleet.engine_stats["block"] == ("plain" if leg == "block" else None)
    assert fleet.engine_stats["iterations"] == 2


def test_fleet_mixed_rows_equal_padded_solo(leg):
    """64 + 40 rows in one fleet: the short lane equals its solo on its data
    padded with pad_rows_np; the mixed rows force explicit weights on the
    full lane too, so its solo carries ones."""
    Xa, ya = _problem(n=64, seed=0)
    Xb, yb = _problem(n=40, seed=1)
    res = fleet_search([FleetLaneSpec(X=Xa, y=ya, options=_opts(seed=0), niterations=2),
                        FleetLaneSpec(X=Xb, y=yb, options=_opts(seed=7), niterations=2)])
    _assert_same_run(res[0], _solo(Xa, ya, weights=np.ones(64, np.float32), seed=0))
    Xp, yp, wp = pad_rows_np(Xb, yb, None, 64)
    _assert_same_run(res[1], _solo(Xp, yp, weights=wp, seed=7))
    assert res[1].dataset.n == 64


def test_fleet_finished_lane_freezes(leg):
    """A 1-iteration lane beside 3- and 2-iteration lanes: each lane stops
    at its own budget and equals its solo run; on_lane_done fires in the
    order the lanes end."""
    X, y = _problem()
    _, y2 = _problem(seed=3)
    done = []
    res = fleet_search(
        [FleetLaneSpec(X=X, y=y, options=_opts(seed=0), niterations=1),
         FleetLaneSpec(X=X, y=y2, options=_opts(seed=3), niterations=3),
         FleetLaneSpec(X=X, y=y, options=_opts(seed=5), niterations=2)],
        on_lane_done=lambda l, r: done.append(l),
    )
    assert done == [0, 2, 1]
    assert [r.engine_stats["iterations"] for r in res] == [1, 3, 2]
    for r, (yy, seed, nit) in zip(res, [(y, 0, 1), (y2, 3, 3), (y, 5, 2)]):
        _assert_same_run(r, _solo(X, yy, niterations=nit, seed=seed))


def test_fleet_lane_bucket_changes_nothing(leg):
    X, y = _problem()
    _, y2 = _problem(seed=3)
    specs = [FleetLaneSpec(X=X, y=y, options=_opts(seed=0), niterations=2),
             FleetLaneSpec(X=X, y=y2, options=_opts(seed=1), niterations=2)]
    plain = fleet_search(specs)
    bucketed = fleet_search(specs, lane_bucket=4)
    for a, b in zip(plain, bucketed):
        _assert_same_run(b, a)
    assert bucketed[0].engine_stats["fleet"]["lane_bucket"] == 4


def test_fleet_legs_per_iteration(monkeypatch):
    """One evolve, one const-opt and one readback leg per iteration for the
    whole fleet; the batched const-opt makes no more gradient calls than
    one solo run."""
    monkeypatch.setenv("SR_ENGINE_BLOCK", "1")
    legs = []
    monkeypatch.setattr(tds, "_DISPATCH_HOOK", legs.append)
    X, y = _problem()
    _, y2 = _problem(seed=3)
    res = fleet_search([FleetLaneSpec(X=X, y=y, options=_opts(seed=0), niterations=2),
                        FleetLaneSpec(X=X, y=y2, options=_opts(seed=1), niterations=2)])
    assert legs == ["evolve", "const_opt", "readback"] * 2
    monkeypatch.setattr(tds, "_DISPATCH_HOOK", None)
    solo = _solo(X, y, seed=0)
    assert res[0].engine_stats["fleet"]["grad_calls"] <= solo.engine_stats["grad_calls"]


def test_fleet_rejects_what_it_does_not_take():
    X, y = _problem()
    with pytest.raises(ValueError, match="not fleet-eligible"):
        fleet_search([FleetLaneSpec(X=X, y=y, options=_opts(save_to_file=True))])
    with pytest.raises(ValueError, match="share one engine EvoConfig"):
        fleet_search([FleetLaneSpec(X=X, y=y, options=_opts()),
                      FleetLaneSpec(X=X, y=y, options=_opts(maxsize=12))])
    with pytest.raises(ValueError, match="init_trees"):
        fleet_search([FleetLaneSpec(X=X, y=y, options=_opts(), init_trees=[])])
    lanes = []

    def grown(it):
        data, ds = lanes[0].rebuild_score_data(X, y, None)
        return {0: tds.LaneDataUpdate(score_data=data._replace(X=torch.cat([data.X, data.X])),
                                      dataset=ds)}

    with pytest.raises(ValueError, match="ScoreData structure"):
        fleet_search([FleetLaneSpec(X=X, y=y, options=_opts())], data_update_hook=grown,
                     on_lanes_ready=lanes.extend)
    assert fleet_search([]) == []


# --------------------------------------------------------------------------
# Fleet migration and the lockstep BFGS across lanes
# --------------------------------------------------------------------------


def test_fleet_migrate_from_pool_apply_false_is_untouched():
    X, y = _problem()
    lanes = [tds._FleetLane(l, FleetLaneSpec(X=X, y=y, options=_opts(seed=l)), 64, False)
             for l in range(2)]
    pool = tuple(f[:4] for f in (*T.ops.evolve.state_tree(lanes[0].state), lanes[0].state.loss
                                 .reshape(-1)))
    gens = [ln.ctx.gen.get_state() for ln in lanes]
    before = [ln.state for ln in lanes]
    out = fleet_migrate_from_pool(before, [ln.ctx for ln in lanes], [pool, None],
                                  [True, False], 0.5, [ln.data.norm for ln in lanes])
    assert out[1] is before[1]
    assert torch.equal(lanes[1].ctx.gen.get_state(), gens[1])
    assert not torch.equal(lanes[0].ctx.gen.get_state(), gens[0])
    # the applied lane is the solo migrate_from_pool on the same generator state
    lanes[0].ctx.gen.set_state(gens[0])
    solo = T.ops.evolve.migrate_from_pool(before[0], lanes[0].ctx, pool, 0.5,
                                          lanes[0].data.norm)
    for a, b in zip(convert.evo_state_arrays(out[0]).values(),
                    convert.evo_state_arrays(solo).values()):
        if isinstance(a, tuple):
            assert all(np.array_equal(u, v) for u, v in zip(a, b))
        else:
            np.testing.assert_array_equal(a, b)


def _objective(a, b, c):
    """Per-instance f(x) = sum a (x - c)^2 + b (x - c)^4 and its gradient."""
    def vgrad(x):
        d = x - c
        return (a * d * d + b * d ** 4).sum(-1), 2 * a * d + 4 * b * d ** 3

    return (lambda x: vgrad(x)[0]), vgrad


@pytest.mark.parametrize("g_tol", [0.0, 1e-8], ids=["armijo", "g_tol"])
def test_bfgs_across_lanes_equals_each_lane_alone(g_tol):
    """Lane 0: quadratics, one instance already at its minimum (with g_tol
    the lane's max |g| is then 0 and it freezes at once, as its solo run
    does); lane 1: quartics far from theirs, which accept late Armijo steps
    that lane 0 never needs. One BFGS over both lanes gives each lane its
    solo result bit for bit."""
    N, B = 3, 4
    rng = np.random.default_rng(0)
    c = torch.from_numpy(rng.normal(size=(2 * B, N)))
    a = torch.from_numpy(rng.uniform(0.5, 2.0, (2 * B, N)))
    b = torch.zeros((2 * B, N), dtype=torch.float64)
    b[B:] = 1.0
    x0 = c.clone()
    if g_tol == 0:
        x0[:B] += torch.from_numpy(rng.normal(size=(B, N)))
    x0[B:] += 3.0
    mask = torch.ones((2 * B, N), dtype=torch.bool)
    mask[1, 2] = False
    vloss, vgrad = _objective(a, b, c)

    def masked(fn, m):
        def g(x):
            f, gr = fn(x)
            return f, torch.where(m, gr, 0.0)
        return g

    x, f, f0 = _bfgs_lockstep(x0, mask, vloss, masked(vgrad, mask), 8, g_tol, lanes=2)
    for l in range(2):
        sl = slice(l * B, (l + 1) * B)
        lv, lg = _objective(a[sl], b[sl], c[sl])
        xs, fs, f0s = _bfgs_lockstep(x0[sl], mask[sl], lv, masked(lg, mask[sl]), 8, g_tol)
        assert torch.equal(x[sl], xs) and torch.equal(f[sl], fs) and torch.equal(f0[sl], f0s)
    if g_tol:
        assert torch.equal(x[:B], x0[:B])  # the converged lane never moved
    assert not torch.equal(x[B:], x0[B:])


# --------------------------------------------------------------------------
# multitarget_search
# --------------------------------------------------------------------------


def test_multitarget_equals_solo_per_target():
    X, y0 = _problem()
    Y = np.stack([y0, (X[0] * X[1] + 1).astype(np.float32)])
    mt = T.MultitargetSearch(_opts(seed=4), niterations=2)
    res = mt.run(X, Y)
    assert len(res) == len(mt.frontiers) == 2
    for t in range(2):
        _assert_same_run(res[t], _solo(X, Y[t], seed=4 + t))


def test_multitarget_per_target_weights():
    X, y0 = _problem()
    Y = np.stack([y0, (X[0] - X[1]).astype(np.float32)])
    W = np.random.default_rng(2).uniform(0.5, 2.0, Y.shape).astype(np.float32)
    res = T.multitarget_search(X, Y, _opts(seed=0), niterations=2, weights=W)
    for t in range(2):
        _assert_same_run(res[t], _solo(X, Y[t], weights=W[t], seed=t))


def test_multitarget_ineligible_options_run_solo():
    """Options a fleet cannot take (the lockstep scheduler) run the same
    searches solo, in sequence."""
    X, y0 = _problem()
    Y = np.stack([y0, (X[0] * X[1] + 1).astype(np.float32)])
    opts = _opts(seed=1, scheduler="lockstep", populations=2, population_size=10)
    res = T.multitarget_search(X, Y, opts, niterations=1)
    for t in range(2):
        _assert_same_run(res[t], _solo(X, Y[t], niterations=1, seed=1 + t,
                                       scheduler="lockstep", population_size=10))


@pytest.mark.parametrize("bad", ["targets", "weights"])
def test_multitarget_validation_matches_jax(bad):
    X, _ = _problem(n=50)
    Y = np.zeros((2, 49 if bad == "targets" else 50), np.float32)
    kw = {} if bad == "targets" else {"weights": np.ones((3, 50), np.float32)}
    errors = []
    for mt, opts in ((j_multitarget_search, J.Options(scheduler="device", save_to_file=False)),
                     (T.multitarget_search, _opts())):
        with pytest.raises(ValueError, match=bad) as e:
            mt(X, Y, opts, **kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
