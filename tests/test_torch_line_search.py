"""The const-opt leg's line search (``models/device_search._bfgs_lockstep``)
on the CPU: all 13 trial steps scored at once and each instance's step
picked on the device, with no host sync.

- Held bit for bit (``torch.equal`` on x, f and f0) to the halving loop it
  replaced, kept below as ``_halving_bfgs_lockstep``, solo and as a
  two-lane fleet: instances satisfied at the first step, at a middle one and
  never (the untested 13th step), NaN and inf trial losses, a batch that
  converges under ``g_tol`` (the loop broke there; the new code freezes),
  one lane frozen while the other runs. Each case with the trials scored in
  13 calls and in one wide call.
- Whole searches, solo and as a two-lane fleet: frontier, final populations
  and ``num_evals`` equal those of the same search run with the halving
  loop.
- The engine's loss calls: each BFGS iteration makes exactly one trial
  call, on a lane axis of 13 x L with 13 x B programs (so P / lanes = B, a
  lane's solo launch shape); a rows axis and a full objective take the
  13-call fallback, and ``engine_stats["line_search"]`` counts both.
"""

import contextlib

import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu_torch.models import device_search as ds
from symbolicregression_jl_tpu_torch.models.device_search import (
    LINE_STEPS,
    FleetLaneSpec,
    LineSearchStats,
    _bfgs_lockstep,
    _lane_bmm,
    fleet_search,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the halving loop it replaced ------------------------------------------------


class _NoWaits:
    """Stands in for the leg's spans and the mesh's turn-taking around the
    halving loop's two host syncs, which hold no state of the BFGS."""

    @staticmethod
    def wait(site, name):
        return contextlib.nullcontext()

    host_wait = staticmethod(contextlib.nullcontext)


mesh_mod = _NoWaits


def _halving_bfgs_lockstep(x, mask_b, vloss, vgrad, iters: int, g_tol: float, lanes: int = 1,
                           tiles=None):
    """The engine's BFGS before the wide line search, as it was: one loss
    call per halving and a host sync at each stop test."""
    if tiles is None:
        tiles = _NoWaits()
    B, N = x.shape
    eye = torch.eye(N, dtype=x.dtype, device=x.device).expand(B, N, N)
    f, g = vgrad(x)
    f0 = f
    H = eye
    frozen = fz = None
    for _ in range(iters):
        if g_tol > 0:
            conv = g.abs().reshape(lanes, -1).amax(1) < g_tol
            frozen = conv if frozen is None else frozen | conv
            # under a mesh the other shards run while this one waits
            with tiles.wait("g_tol", "const_opt/sync"), mesh_mod.host_wait():
                if bool(frozen.all()):
                    break
            if lanes > 1:
                fz = torch.repeat_interleave(frozen, B // lanes)
        d = -_lane_bmm(H, g[:, :, None], lanes)[:, :, 0]
        d = torch.where(mask_b, d, 0.0)
        gtd = (g * d).sum(-1)
        bad = gtd >= 0
        d = torch.where(bad[:, None], -g, d)
        gtd = torch.where(bad, -(g * g).sum(-1), gtd)
        # Armijo backtracking (c1 = 1e-4, halving, <= 12 steps);
        # satisfied instances keep their step and value
        alpha = torch.ones((B,), dtype=x.dtype, device=x.device)
        f_new = vloss(x + d)
        for _ in range(12):
            armijo = f_new <= f + 1e-4 * alpha * gtd
            if fz is not None:
                armijo = armijo | fz
            with tiles.wait("armijo", "const_opt/sync"), mesh_mod.host_wait():
                if bool(armijo.all()):
                    break
            alpha = torch.where(armijo, alpha, alpha * 0.5)
            f_new = torch.where(armijo, f_new, vloss(x + alpha[:, None] * d))
        ok = torch.isfinite(f_new) & (f_new < f)
        if fz is not None:
            # a frozen lane keeps x (so s = 0 and H stays), f and g
            ok = ok & ~fz
        x_new = torch.where(ok[:, None], x + alpha[:, None] * d, x)
        f = torch.where(ok, f_new, f)
        _, g_new = vgrad(x_new)
        if fz is not None:
            g_new = torch.where(fz[:, None], g, g_new)
        s = x_new - x
        yk = g_new - g
        sy = (s * yk).sum(-1)
        good = sy > 1e-10
        rho = torch.where(good, 1.0 / torch.where(good, sy, 1.0), 0.0)
        I_rsy = eye - rho[:, None, None] * (s[:, :, None] * yk[:, None, :])
        H_new = _lane_bmm(_lane_bmm(I_rsy, H, lanes), I_rsy.transpose(1, 2), lanes) + (
            rho[:, None, None] * (s[:, :, None] * s[:, None, :])
        )
        H = torch.where(good[:, None, None], H_new, H)
        x, g = x_new, g_new
    return x, f, f0


# -- the BFGS alone on objectives of known steps ---------------------------------


def _objective(c, a, b, scale, nan_at=np.inf, inf_at=np.inf):
    """Per instance f(x) = sum a (x - c)^2 + b (x - c)^4, NaN where some
    |x - c| passes ``nan_at`` and inf where it passes ``inf_at``; the
    gradient handed to the BFGS is ``scale`` times the true one, which sets
    the first iteration's step: 0.5 lands a quadratic (a = 1, b = 0) on its
    minimum at k = 0, 50 overshoots it until k = 6, -1 points uphill, so no
    step holds (k* = 12). Shapes broadcast: x [B, N] or [13, B, N]."""

    def value(x):
        e = x - c
        f = (a * e * e + b * e ** 4).sum(-1)
        far = e.abs().amax(-1)
        return torch.where(far > nan_at, torch.nan, torch.where(far > inf_at, torch.inf, f))

    def grad(x):
        e = x - c
        return value(x), scale * (2 * a * e + 4 * b * e ** 3)

    return value, grad


def _masked(fn, m):
    def g(x):
        f, gr = fn(x)
        return f, torch.where(m, gr, 0.0)
    return g


def _batch(kind):
    """(x0, mask, c, a, b, scale, nan_at, inf_at) of one lane's 6
    instances, [6, 3] each (thresholds [6])."""
    B, N = 6, 3
    rng = np.random.default_rng({"steps": 0, "converge": 1, "quartic": 2}[kind])
    t = lambda v: torch.as_tensor(v, dtype=torch.float64)  # noqa: E731
    c = t(rng.normal(size=(B, N)))
    a = torch.ones((B, N), dtype=torch.float64)
    b = torch.zeros((B, N), dtype=torch.float64)
    scale = torch.ones((B, 1), dtype=torch.float64)
    nan_at = torch.full((B,), np.inf, dtype=torch.float64)
    inf_at = nan_at.clone()
    x0 = c + t(rng.choice([-1.0, 1.0], size=(B, N)))
    if kind == "steps":
        # k* = 0, 6, 12, 3 (after a NaN and an inf trial), 0 (a masked
        # slot), and a quartic far out (6)
        scale[:, 0] = t([0.5, 50.0, -1.0, 5.0, 0.5, 1.0])
        nan_at[3], inf_at[3] = 8.0, 3.0
        b[5] = 1.0
        x0[5] = c[5] + 4.0
    elif kind == "converge":
        # every instance isotropic: the second iteration lands on the
        # minimum to rounding, and the gate freezes the batch there
        scale[:, 0] = 50.0
    else:
        b[:] = 1.0
        x0 += t(rng.uniform(1.0, 3.0, size=(B, N)))
    mask = torch.ones((B, N), dtype=torch.bool)
    mask[4, 2] = False
    return x0, mask, c, a, b, scale, nan_at, inf_at


def _cat(*batches):
    return tuple(torch.cat(parts) for parts in zip(*batches))


def _run(fn, batch, iters, g_tol, lanes, wide=False, stats=None):
    x0, mask, c, a, b, scale, nan_at, inf_at = batch
    value, grad = _objective(c, a, b, scale, nan_at, inf_at)
    kw = {}
    if fn is _bfgs_lockstep:
        kw["stats"] = stats
        if wide:
            kw["vtrials"] = value  # broadcasts over the [13, B, N] trial points
    return fn(x0, mask, value, _masked(grad, mask), iters, g_tol, lanes=lanes, **kw)


CASES = {
    # name: (lanes' batch kinds, iterations, g_tol)
    "steps": (("steps",), 1, 0.0),
    "steps_8": (("steps",), 8, 0.0),
    "nan_inf_g_tol": (("steps",), 8, 1e-8),
    "converges": (("converge",), 8, 1e-6),
    "quartic": (("quartic",), 8, 1e-8),
    "fleet": (("steps", "quartic"), 8, 1e-8),
    "fleet_one_frozen": (("converge", "quartic"), 8, 1e-6),
}


@pytest.mark.parametrize("wide", [False, True], ids=["calls", "wide"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bfgs_equals_the_halving_loop(case, wide):
    kinds, iters, g_tol = CASES[case]
    batch = _cat(*(_batch(k) for k in kinds))
    stats = LineSearchStats()
    got = _run(_bfgs_lockstep, batch, iters, g_tol, len(kinds), wide, stats)
    want = _run(_halving_bfgs_lockstep, batch, iters, g_tol, len(kinds))
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g, w)
    assert stats.searches == iters and stats.wide == (iters if wide else 0)
    hist = stats.hist.tolist()
    assert sum(hist) == iters * batch[0].shape[0]
    if case == "steps":
        # the first iteration's accepted steps: 0, 6, 12, 3, 0 and the
        # far quartic's 6
        assert hist == [2, 0, 0, 1, 0, 0, 2, 0, 0, 0, 0, 0, 1, 0]
        x0, f0 = batch[0], got[2]
        assert torch.equal(got[0][2], x0[2]) and torch.equal(got[1][2], f0[2])  # no step held
    if case == "converges":
        # frozen from the third iteration on, where the halving loop broke
        assert hist[LINE_STEPS] == (iters - 2) * 6
    if case == "fleet_one_frozen":
        assert hist[LINE_STEPS] >= (iters - 2) * 6
        assert not torch.equal(got[0][6:], batch[0][6:])


def test_each_lane_equals_its_solo_run():
    """The two-lane BFGS gives each lane what its solo run gives."""
    kinds = ("converge", "steps")
    lanes = [_batch(k) for k in kinds]
    got = _run(_bfgs_lockstep, _cat(*lanes), 8, 1e-6, 2, wide=True)
    for l, one in enumerate(lanes):
        solo = _run(_bfgs_lockstep, one, 8, 1e-6, 1, wide=True)
        for g, s in zip(got, solo):
            assert torch.equal(g[l * 6:(l + 1) * 6], s)


# -- whole searches against the halving loop -------------------------------------


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2, 100)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    return X, y


def _opts(**kw):
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=2,
                population_size=16, ncycles_per_iteration=4, maxsize=12, seed=0,
                save_to_file=False, progress=False, scheduler="device", device="cpu")
    base.update(kw)
    return T.Options(**base)


def _outcome(res):
    o = res.options
    front = [(m.get_complexity(o), m.loss, m.tree.string_tree(o.operators, precision=17))
             for m in res.pareto_frontier]
    pops = [[(m.loss, m.tree.string_tree(o.operators, precision=17)) for m in p.members]
            for p in res.populations]
    return front, pops, res.num_evals


def _with_halving_loop(monkeypatch):
    def halving(x, mask_b, vloss, vgrad, iters, g_tol, lanes=1, tiles=None, vtrials=None,
                stats=None):
        return _halving_bfgs_lockstep(x, mask_b, vloss, vgrad, iters, g_tol, lanes=lanes)

    monkeypatch.setattr(ds, "_bfgs_lockstep", halving)


@pytest.mark.parametrize("block", ["0", "1"], ids=["event_leg", "block"])
def test_search_equals_the_halving_loop(block, monkeypatch):
    monkeypatch.setenv("SR_ENGINE_BLOCK", block)
    X, y = _problem()
    opts = _opts(optimizer_probability=0.5)
    res = T.equation_search(X, y, options=opts, niterations=3, verbosity=0)
    ls = res.engine_stats["line_search"]
    assert ls["searches"] == ls["wide"] == 3 * opts.optimizer_iterations
    assert res.engine_stats["host_syncs"].keys() <= {"readback"}
    _with_halving_loop(monkeypatch)
    ref = T.equation_search(X, y, options=opts, niterations=3, verbosity=0)
    assert _outcome(res) == _outcome(ref)


def test_fleet_equals_the_halving_loop(monkeypatch):
    X, y = _problem()

    def fleet():
        return fleet_search([FleetLaneSpec(X=X, y=y + s, options=_opts(seed=s), niterations=2)
                             for s in (0, 7)])

    got = fleet()
    _with_halving_loop(monkeypatch)
    want = fleet()
    assert [_outcome(r) for r in got] == [_outcome(r) for r in want]
    ls = got[0].engine_stats["line_search"]
    assert ls == got[1].engine_stats["line_search"]
    assert ls["searches"] == ls["wide"] == 2 * _opts().optimizer_iterations


# -- the engine's loss calls -------------------------------------------------------


def _spy(monkeypatch):
    """Every ``packed_losses`` call's (programs, lanes of X or 0)."""
    calls = []
    real = ds.EngineScorer.packed_losses

    def spy(self, prog, vals, X, y, w):
        calls.append((prog.shape[0], X.shape[0] if X.dim() == 3 else 0))
        return real(self, prog, vals, X, y, w)

    monkeypatch.setattr(ds.EngineScorer, "packed_losses", spy)
    return calls


def _instances(opts):
    K = max(1, int(round(opts.optimizer_probability * opts.populations * opts.population_size)))
    return K * (1 + opts.optimizer_nrestarts)


@pytest.mark.parametrize("engine", ["solo", "fleet"])
def test_one_wide_trial_call_per_bfgs_iteration(engine, monkeypatch):
    calls = _spy(monkeypatch)
    opts = _opts()
    X, y = _problem()
    if engine == "solo":
        res = T.equation_search(X, y, options=opts, niterations=2, verbosity=0)
        lanes = 1
    else:
        res = fleet_search([FleetLaneSpec(X=X, y=y, options=_opts(seed=s), niterations=2)
                            for s in (0, 7)])[0]
        lanes = 2
    B = _instances(opts)
    wide = [c for c in calls if c[1] == LINE_STEPS * lanes]
    assert len(wide) == 2 * opts.optimizer_iterations
    for progs, n_lanes in wide:
        assert progs == LINE_STEPS * lanes * B and progs // n_lanes == B
    ls = res.engine_stats["line_search"]
    assert ls["searches"] == ls["wide"] == len(wide) and ls["fallback"] == 0
    assert sum(ls["accepted_at"]) == len(wide) * lanes * B
    # no other call of the leg scores B instances a step at a time
    assert not [c for c in calls if c[0] == lanes * B]


def mse_t(preds, y, w):
    return torch.mean((preds - y[None, :]) ** 2, dim=-1)


@pytest.mark.parametrize("case", ["rows_axis", "objective"])
def test_fallback_scores_the_trials_in_13_calls(case, monkeypatch):
    calls = _spy(monkeypatch)
    X, y = _problem()
    if case == "rows_axis":
        opts = _opts(data_sharding="rows", mesh_devices=["cpu"] * 2)
        shards = 2
    else:
        opts = _opts(loss_function_jit=mse_t)
        shards = 1
    res = T.equation_search(X, y, options=opts, niterations=2, verbosity=0)
    if case == "rows_axis":
        assert res.engine_stats["mesh"]["shape"] == (1, 2)
    B = _instances(opts)
    n = 2 * opts.optimizer_iterations * shards
    ls = res.engine_stats["line_search"]
    assert ls["searches"] == ls["fallback"] == n and ls["wide"] == 0
    assert sum(ls["accepted_at"]) == n * B
    assert not [c for c in calls if c[1] >= LINE_STEPS]
    # each line search: 13 calls of the batch's B programs
    assert len([c for c in calls if c[0] == B]) >= LINE_STEPS * n
