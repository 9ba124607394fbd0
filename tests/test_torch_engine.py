"""The device engine (``scheduler="device"``) as a whole, on the CPU.

The port draws from a ``torch.Generator`` and the JAX package from
threefry, so the two engines never share a trajectory: parity is a band of
search quality. At this small budget a search on the README's planted
equation either finds the cos term (best loss 0 to ~0.7) or stalls on a
plateau near 1.1-1.4, in both engines, so the band is stated per seed and
per engine over three seeds:

- every best loss is below 0.7x the mean predictor's loss;
- at least one seed gets below 0.35x of it;
- the geometric means of the best losses (floored at 0.01) lie within a
  factor of 10 of each other.

The band was set from both engines' distributions over many seeds, which
running this file as a script prints
(``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_engine.py FIRST END``
from the repo root).
Constant optimization runs K = 16 members per iteration in both: the JAX
package's CPU path rounds K up to its chunk of 8, the port takes
round(p * I * P) as the JAX kernel path does, so ``optimizer_probability``
is 0.25 here. The port must be deterministic against itself: one seed, one
frontier.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
import symbolicregression_jl_tpu_torch.models.device_search as tds
from symbolicregression_jl_tpu_torch.ops import interp_cuda

OPS = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"])
BUDGET = dict(populations=4, population_size=16, ncycles_per_iteration=80, maxsize=14,
              save_to_file=False, progress=False, scheduler="device")


@pytest.fixture(autouse=True, scope="module")
def _cpu_numerics():
    """Keep JAX in 32-bit mode: a test module run earlier in this process may
    have enabled x64.

    One torch thread: tier-1 runs test files in parallel pytest-xdist
    workers, where per-process thread pools oversubscribe the cores, and
    CPU sums split by thread count would make the port's results depend
    on the machine."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", x64)


def _planted(n=100, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2, n)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    return X, y


def _opts(**kw):
    base = dict(OPS, **BUDGET)
    base.update(kw)
    return T.Options(device="cpu", **base)


def _best(res):
    return min(m.loss for m in res.pareto_frontier)


def _frontier(res):
    return [(m.get_complexity(res.options), m.loss, m.tree.string_tree(res.options.operators))
            for m in res.pareto_frontier]


EQUAL_K = dict(optimizer_probability=0.25)


def _best_of_both(X, y, seed):
    """(port, JAX) best losses of one seed on the band's budget."""
    rt = T.equation_search(X, y, options=_opts(seed=seed, **EQUAL_K), niterations=6,
                           verbosity=0)
    rj = J.equation_search(X, y, options=J.Options(seed=seed, **OPS, **BUDGET, **EQUAL_K),
                           niterations=6, verbosity=0)
    assert all(np.isfinite(m.loss) for m in rt.pareto_frontier)
    return _best(rt), _best(rj)


def test_engine_in_band_with_jax():
    X, y = _planted()
    baseline = float(np.mean((y - y.mean()) ** 2))
    bt, bj = [], []
    for seed in (0, 1, 2):
        t, j = _best_of_both(X, y, seed)
        bt.append(t)
        bj.append(j)
    assert max(bt) < 0.7 * baseline and max(bj) < 0.7 * baseline, (bt, bj)
    assert min(bt) < 0.35 * baseline and min(bj) < 0.35 * baseline, (bt, bj)
    gt, gj = (np.exp(np.mean(np.log(np.maximum(b, 1e-2)))) for b in (bt, bj))
    assert gj / 10 <= gt <= gj * 10, (bt, bj)


def test_same_seed_same_frontier():
    X, y = _planted()
    r1 = T.equation_search(X, y, options=_opts(seed=3, ncycles_per_iteration=30),
                           niterations=2, verbosity=0)
    r2 = T.equation_search(X, y, options=_opts(seed=3, ncycles_per_iteration=30),
                           niterations=2, verbosity=0)
    assert _frontier(r1) == _frontier(r2)


def test_legs_and_kernel_calls_per_iteration(monkeypatch):
    X, y = _planted()
    legs = []
    monkeypatch.setattr(tds, "_DISPATCH_HOOK", legs.append)
    calls = {"fused_loss": 0, "fused_loss_grad": 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(interp_cuda, "fused_loss", counting("fused_loss", interp_cuda.fused_loss))
    monkeypatch.setattr(tds, "fused_loss", interp_cuda.fused_loss)
    monkeypatch.setattr(interp_cuda, "fused_loss_grad",
                        counting("fused_loss_grad", interp_cuda.fused_loss_grad))
    res = T.equation_search(X, y, options=_opts(seed=0, ncycles_per_iteration=10, batching=True,
                                                batch_size=40),
                            niterations=3, verbosity=0)
    assert legs == ["evolve", "const_opt", "finalize", "readback"] * 3
    st = res.engine_stats
    assert st["iterations"] == 3 and res.use_kernel
    # every loss went through the B1 wrapper and every gradient through B2's
    assert calls["fused_loss"] == st["score_calls"] > 3 * 10
    assert calls["fused_loss_grad"] == st["grad_calls"] >= 3
    assert set(st["host_seconds"]) == {"evolve", "const_opt", "finalize", "readback"}


def test_evolve_leg_dispatches_one_fixed_op_sequence(monkeypatch):
    """The evolve leg enqueues the same torch ops in the same order every
    iteration, whatever the data: no host branch on a tensor picks its work,
    which is what lets a CUDA graph capture it. On the card each op is (about)
    one kernel launch, and the leg is launch-bound there (PERF.md), so the
    count per cycle is held under a bound. B1 is one launch on the card and
    runs the plain interpreter here, so its calls are left out of the count.
    At config3's operators and 100 members per island: ~2,000 ops per cycle."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.paused = [], 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not self.paused:
                self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    legs, active = [], []

    def leg_wrap(name):
        @contextlib.contextmanager
        def record():
            rec = Record()
            active.append(rec)
            with rec:
                yield
            active.pop()
            legs.append(rec.ops)
        return record() if name == "evolve" else contextlib.nullcontext()

    def b1_unrecorded(*args, **kwargs):
        for rec in active:
            rec.paused += 1
        try:
            return interp_cuda.fused_loss(*args, **kwargs)
        finally:
            for rec in active:
                rec.paused -= 1

    monkeypatch.setattr(tds, "_LEG_WRAP", leg_wrap)
    monkeypatch.setattr(tds, "fused_loss", b1_unrecorded)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(5, 60)).astype(np.float32)
    y = np.cos(X[0]).astype(np.float32)
    cycles = 4
    T.equation_search(X, y, options=T.Options(
        binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp", "abs"],
        populations=2, population_size=100, ncycles_per_iteration=cycles, maxsize=20, seed=0,
        save_to_file=False, progress=False, scheduler="device", device="cpu"),
        niterations=3, verbosity=0)
    assert len(legs) == 3 and legs[0] == legs[1] == legs[2]
    assert len(legs[0]) / cycles < 2500, len(legs[0]) / cycles


@pytest.mark.parametrize("async_readback", [None, False], ids=["pipelined", "sync"])
def test_regressor_fit_predict(async_readback):
    X, y = _planted(seed=1)
    model = T.SRRegressor(niterations=3, seed=0, device="cpu", async_readback=async_readback,
                          **dict(OPS, **dict(BUDGET, ncycles_per_iteration=40)))
    model.fit(X.T, y)
    rows = model.equations_
    assert rows and all(np.isfinite(r["loss"]) for r in rows)
    pred = model.predict(X.T)
    assert pred.shape == y.shape and np.all(np.isfinite(pred))
    baseline = float(np.mean((y - y.mean()) ** 2))
    assert float(np.mean((pred - y) ** 2)) < baseline


def test_warm_start_keeps_ground_and_rescores():
    X, y = _planted()
    r1 = T.equation_search(X, y, options=_opts(seed=0, ncycles_per_iteration=30),
                           niterations=2, verbosity=0)
    r2 = T.equation_search(X, y, options=_opts(seed=0, ncycles_per_iteration=30),
                           niterations=2, verbosity=0, saved_state=r1)
    assert _best(r2) <= _best(r1) + 1e-6
    # against a new target the saved hall of fame is rescored
    y2 = (-y + 10.0).astype(np.float32)
    r3 = T.equation_search(X, y2, options=_opts(seed=0, ncycles_per_iteration=1),
                           niterations=1, verbosity=0, saved_state=r1)
    for m in r3.hall_of_fame.members:
        if m is None:
            continue
        pred = m.tree.eval_np(X.astype(np.float64), r3.options.operators)
        assert m.loss == pytest.approx(float(np.mean((pred - y2) ** 2)), rel=1e-3, abs=1e-4)


def test_multi_output_and_regressor_warm_start():
    X, y = _planted()
    Y = np.stack([y, X[0] * 2], axis=0)
    results = T.equation_search(X, Y, options=_opts(seed=0, ncycles_per_iteration=20),
                                niterations=2, verbosity=0)
    assert len(results) == 2 and all(np.isfinite(_best(r)) for r in results)
    model = T.MultitargetSRRegressor(niterations=2, seed=0, device="cpu", warm_start=True,
                                     **dict(OPS, **dict(BUDGET, ncycles_per_iteration=20)))
    model.fit(X.T, Y.T)
    first = [min(r["loss"] for r in rows) for rows in model.equations_]
    model.fit(X.T, Y.T)
    again = [min(r["loss"] for r in rows) for rows in model.equations_]
    assert all(b <= a + 1e-6 for a, b in zip(first, again))
    assert model.predict(X.T).shape == (X.shape[1], 2)


@pytest.mark.parametrize("kw", [
    dict(dtype=np.float64),
    dict(weights=True),
    dict(constraints={"*": (3, 3)}, nested_constraints={"cos": {"cos": 0}},
         complexity_of_operators={"cos": 2}),
    dict(device_mutation_attempts=2, annealing=True, warmup_maxsize_by=0.5),
    dict(should_optimize_constants=False, should_simplify=False),
], ids=["float64", "weighted", "constraints_mapping", "attempts_annealing", "no_copt"])
def test_engine_options(kw):
    X, y = _planted()
    weights = None
    if kw.pop("weights", False):
        weights = np.random.default_rng(0).uniform(0.5, 2.0, y.shape).astype(np.float32)
    res = T.equation_search(X, y, weights=weights,
                            options=_opts(seed=0, ncycles_per_iteration=20, **kw),
                            niterations=2, verbosity=0)
    assert np.isfinite(_best(res))
    assert res.use_kernel == ("dtype" not in kw)
    assert all(m.tree.count_nodes() >= 1 for p in res.populations for m in p.members)


@pytest.mark.parametrize("kw", [
    dict(optimizer_algorithm="NelderMead"),
    dict(use_recorder=True, crossover_probability=0.0),
    dict(profile=True),
], ids=["neldermead", "recorder", "profile"])
def test_out_of_slice_options_name_their_item(kw, tmp_path):
    """These options raised here, naming their ROADMAP.md item, until the
    engine ran them; now each one runs and shows its effect."""
    X, y = _planted()
    opts = _opts(seed=0, ncycles_per_iteration=10, recorder_file=str(tmp_path / "r.json"), **kw)
    res = T.equation_search(X, y, options=opts, niterations=2, verbosity=0)
    assert np.isfinite(_best(res))
    if "optimizer_algorithm" in kw:
        assert res.engine_stats["grad_calls"] == 0 and res.engine_stats["score_calls"] > 0
    if "use_recorder" in kw:
        assert (tmp_path / "r.json").stat().st_size > 0
    if "profile" in kw:
        assert res.engine_profile["iterations"] == 2


def test_out_of_slice_entry_points_name_their_item():
    """The fleet is ported; the stream session's hooks into it are not yet,
    and name their item."""
    X, y = _planted()
    spec = tds.FleetLaneSpec(X=X, y=y, options=_opts(seed=0), niterations=1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, A, slice 5: stream/"):
        tds.fleet_search([spec], data_update_hook=lambda it: None)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, A, slice 5: stream/"):
        tds.fleet_search([spec], on_lanes_ready=lambda lanes: None)


def test_device_mode_supported():
    assert tds.device_mode_supported(_opts()) is None
    assert tds.device_mode_supported(_opts(dtype=np.float64)) is None
    assert tds.device_mode_supported(_opts(loss_function=lambda t, d, o: 0.0)) is not None
    with pytest.raises(ValueError, match="scheduler='lockstep'"):
        X, y = _planted()
        T.equation_search(X, y, options=_opts(loss_function=lambda t, d, o: 0.0),
                          niterations=1, verbosity=0)


def test_grad_wrapper_takes_the_plain_version_only_on_the_cpu():
    """A tensor on another device than the CPU launches the kernel or raises
    (on the card: tests/test_torch_cuda.py); it never takes the plain
    version."""
    with pytest.raises(ValueError, match="unsupported device"):
        interp_cuda.fused_loss_grad(
            torch.zeros((1, 5), dtype=torch.int32), torch.zeros((1, 1)),
            torch.zeros((1, 4), device="meta"), torch.zeros(4), None,
            _opts().operators, _opts().loss)


if __name__ == "__main__":
    # the distributions behind the band: best loss per seed in each engine
    # on the band's budget, their medians, and the share of seeds left on
    # the plateau (at or above half the mean predictor's loss)
    import sys

    torch.set_num_threads(1)
    jax.config.update("jax_enable_x64", False)
    X, y = _planted()
    baseline = float(np.mean((y - y.mean()) ** 2))
    seeds = range(int(sys.argv[1]), int(sys.argv[2]))
    both = np.array([_best_of_both(X, y, seed) for seed in seeds])
    for k, name in enumerate(("port", "jax")):
        b = both[:, k]
        print(f"{name}: seeds {seeds.start}-{seeds.stop - 1}, best losses "
              f"{np.round(b, 4).tolist()}, median {np.median(b):.4f}, plateau share "
              f"{np.mean(b >= baseline / 2):.3f} (mean predictor {baseline:.4f})")
