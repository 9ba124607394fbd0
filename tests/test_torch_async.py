"""PyTorch port vs JAX package: the async island scheduler
(``parallel/islands.py``, ``Options(scheduler="async")``).

The JAX package's ``tests/test_async_islands.py`` cases against the port,
on the CPU (where every scoring dispatch takes B1's plain version), each
search held against the JAX package's own run of the same X, y and
Options: the same populations and sizes, the same work units per island
and cycles per unit, and a best loss within a stated band of JAX's. With
several workers the completion order, and so the search, is not
reproducible in either package; with one worker both are, and both draw
their proposals from numpy, so after one iteration the two hold the same
populations and frontier. The head-occupancy accounting of
``utils/progress.py`` is held against JAX's reporter on the same
``head_work`` sequence, and the launch count B1's wrapper keeps is exact
when several threads launch at once.
"""

import collections
import threading

import jax
import numpy as np
import pytest

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu.parallel.islands as jax_islands
import symbolicregression_jl_tpu_torch as T
import symbolicregression_jl_tpu_torch.parallel.islands as port_islands
from symbolicregression_jl_tpu_torch import Options, equation_search

# the port's best within BAND_ADD of JAX's best under several workers (the
# completion order differs from run to run in both packages: on this
# problem JAX's best ranged 0.11-0.29 and the port's 0.07-0.75 over three
# runs each); with one worker, where both searches are reproducible, the
# losses agree within RTOL
BAND_ADD, RTOL = 1.0, 1e-5
PLANTED = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=6,
               population_size=20, ncycles_per_iteration=80, maxsize=15, save_to_file=False,
               seed=0, scheduler="async")


@pytest.fixture(autouse=True, scope="module")
def _jax_32_bit():
    """Keep JAX in 32-bit mode: a test module run earlier in this process
    may have enabled x64, under which the JAX package computes in another
    precision."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", x64)


def _planted_data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 100)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    return X, y


def _counted_search(pkg, islands, X, y, options, niterations):
    """``pkg.equation_search`` with each work unit's two parts recorded per
    island (an island is its own rng): [(part, cycles, evals added)], in
    the order the islands first ran. The evals are exact only with one
    worker, where no other unit scores meanwhile."""
    units, lock = collections.OrderedDict(), threading.Lock()
    real_cycle, real_opt = islands.s_r_cycle_lockstep, islands.optimize_and_simplify_populations

    def record(irng, entry):
        with lock:
            units.setdefault(id(irng), []).append(entry)

    def cycle(pops, scorer, ncycles, curmaxsize, stats, options, nfeatures, irng, **kw):
        before = scorer.num_evals
        out = real_cycle(pops, scorer, ncycles, curmaxsize, stats, options, nfeatures, irng, **kw)
        record(irng, ("cycles", ncycles, scorer.num_evals - before))
        return out

    def optimize(pops, scorer, options, irng, recorder=None):
        before = scorer.num_evals
        out = real_opt(pops, scorer, options, irng, recorder)
        record(irng, ("optimize", 0, scorer.num_evals - before))
        return out

    islands.s_r_cycle_lockstep, islands.optimize_and_simplify_populations = cycle, optimize
    try:
        res = pkg.equation_search(X, y, options=options, niterations=niterations, verbosity=0)
    finally:
        islands.s_r_cycle_lockstep, islands.optimize_and_simplify_populations = (real_cycle,
                                                                                 real_opt)
    return res, list(units.values())


def _shape(units):
    """Work units per island and the cycles of each, islands sorted."""
    return sorted(tuple(c for part, c, _ in u if part == "cycles") for u in units)


@pytest.fixture(scope="module")
def jax_planted():
    """The JAX package's async search of the planted-equation case, run
    once for the module."""
    X, y = _planted_data()
    return _counted_search(J, jax_islands, X, y, J.Options(**PLANTED), 6)


def _opts(**kw):
    kw.setdefault("save_to_file", False)
    kw.setdefault("seed", 0)
    kw.setdefault("scheduler", "async")
    kw.setdefault("device", "cpu")
    kw.setdefault("progress", False)
    return Options(**kw)


def test_async_recovers_planted_equation(jax_planted):
    X, y = _planted_data()
    res, units = _counted_search(T, port_islands, X, y, Options(device="cpu", **PLANTED), 6)
    jres, junits = jax_planted
    best, jbest = (min(m.loss for m in r.pareto_frontier) for r in (res, jres))
    # JAX's bar: solid progress over the ~4.0 baseline-predictor loss; and
    # the band around JAX's own run
    assert best < 1.5 and jbest < 1.5
    assert best <= jbest + BAND_ADD, (best, jbest)
    assert res.num_evals > 0
    assert len(res.populations) == len(jres.populations) == 6
    assert [p.n for p in res.populations] == [p.n for p in jres.populations] == [20] * 6
    # six work units per island, of 80 cycles each, in both packages
    assert _shape(units) == _shape(junits) == [(80,) * 6] * 6
    # every work unit's scoring is one dispatch of the port's scorer
    assert res.scoring_dispatches > 6 * 6 * 80
    assert res.stop_reason is None and jres.stop_reason is None
    assert 0.0 <= res.head_occupancy < 1.0


def test_async_one_worker_follows_jax():
    """With one worker the work units run in a fixed order in both
    packages. After one iteration every island's unit scored the same
    number of trees in its cycles and in its constant optimization, and
    every island (its unit's result with the head's hall-of-fame merge,
    quarantine, migration and hall-of-fame migration into it applied) and
    the frontier hold the same losses within RTOL (the two packages reduce
    in f32 in different orders; 1.6e-7 seen). Later iterations may part
    where a loss tie falls the other way."""
    X, y = _planted_data()
    kw = dict(PLANTED, async_workers=1)
    jres, junits = _counted_search(J, jax_islands, X, y, J.Options(**kw), 1)
    res, units = _counted_search(T, port_islands, X, y, Options(device="cpu", **kw), 1)
    assert [p.n for p in res.populations] == [p.n for p in jres.populations] == [20] * 6
    assert units == junits and _shape(units) == [(80,)] * 6
    for pop, jpop in zip(res.populations, jres.populations):
        np.testing.assert_allclose(sorted(m.loss for m in pop.members),
                                   sorted(m.loss for m in jpop.members), rtol=RTOL)
    front, jfront = ([(m.get_complexity(r.options), m.loss) for m in r.pareto_frontier]
                     for r in (res, jres))
    assert [c for c, _ in front] == [c for c, _ in jfront]
    np.testing.assert_allclose([l for _, l in front], [l for _, l in jfront], rtol=RTOL)


def test_async_early_stop():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(2, 80)).astype(np.float32)
    y = X[0].astype(np.float32)
    opts = _opts(binary_operators=["+", "-", "*"], populations=4, population_size=16,
                 ncycles_per_iteration=30, maxsize=10, early_stop_condition=1e-6)
    res = equation_search(X, y, options=opts, niterations=50, verbosity=0)
    assert res.stop_reason == "early_stop"


def test_unknown_scheduler_rejected():
    with pytest.raises(ValueError, match="unknown scheduler"):
        Options(scheduler="devive", device="cpu")
    with pytest.raises(ValueError, match="unknown scheduler"):
        J.Options(scheduler="devive")


def test_async_warm_start_rescores_on_changed_dataset():
    """The saved hall of fame is rescored against the new dataset, on
    copies."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 60)).astype(np.float32)
    y = (2 * X[0]).astype(np.float32)
    opts = _opts(binary_operators=["+", "-", "*"], populations=3, population_size=12,
                 ncycles_per_iteration=20, maxsize=10)
    r1 = equation_search(X, y, options=opts, niterations=2, verbosity=0)
    old_losses = {id(m): m.loss for m in r1.hall_of_fame.members if m is not None}
    y2 = (-y + 10.0).astype(np.float32)
    r2 = equation_search(X, y2, options=opts, niterations=1, verbosity=0, saved_state=r1)
    for m in r2.hall_of_fame.members:
        if m is None:
            continue
        pred = m.tree.eval_np(X.astype(np.float64), opts.operators)
        true_loss = float(np.mean((pred - y2) ** 2))
        assert m.loss == pytest.approx(true_loss, rel=1e-3, abs=1e-4)
        assert id(m) not in old_losses
    for m in r1.hall_of_fame.members:
        if m is not None:
            assert m.loss == old_losses[id(m)]


def test_async_workers_option_honored(monkeypatch):
    import symbolicregression_jl_tpu_torch.parallel.islands as isl

    captured = {}
    real = isl.ThreadPoolExecutor

    class Capture(real):
        def __init__(self, max_workers=None, **kw):
            captured["max_workers"] = max_workers
            super().__init__(max_workers=max_workers, **kw)

    monkeypatch.setattr(isl, "ThreadPoolExecutor", Capture)
    rng = np.random.default_rng(2)
    X = rng.normal(size=(2, 40)).astype(np.float32)
    y = X[0].astype(np.float32)
    opts = _opts(binary_operators=["+"], populations=6, population_size=8,
                 ncycles_per_iteration=5, maxsize=8, async_workers=3)
    equation_search(X, y, options=opts, niterations=1, verbosity=0)
    assert captured["max_workers"] == 3
    with pytest.raises(ValueError, match="async_workers"):
        Options(binary_operators=["+"], save_to_file=False, async_workers=0, device="cpu")


def test_head_occupancy_matches_jax_reporter(monkeypatch, capsys):
    """The same ``head_work`` sequence on the port's reporter and on JAX's
    gives the same occupancy and the same single warning."""
    from symbolicregression_jl_tpu.utils import progress as jprog
    from symbolicregression_jl_tpu_torch.utils import progress as tprog

    monkeypatch.delenv("SR_TEST", raising=False)
    clock = [1000.0]
    monkeypatch.setattr(jprog.time, "time", lambda: clock[0])
    reps = [tprog.ProgressReporter(10, None, use_bar=False, verbosity=1),
            jprog.ProgressReporter(10, None, use_bar=False, verbosity=1)]
    works = [0.2, 0.05, 1.5, 0.0, 0.7, 2.5, 0.3]
    for k, w in enumerate(works):
        clock[0] += 1.0
        for r in reps:
            r.head_work(w)
            r.maybe_warn_occupancy()
        assert reps[0].occupancy == reps[1].occupancy
    out = capsys.readouterr().out
    warnings = [ln for ln in out.splitlines() if "occupancy" in ln]
    assert len(warnings) == 2 and warnings[0] == warnings[1]
    assert reps[0]._warned_occupancy and reps[1]._warned_occupancy


def test_launch_count_exact_under_threads():
    """``count_launch`` loses no count when many threads add at once (the
    async scheduler's workers launch B1 together)."""
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import count_launch, fused_loss

    saved = fused_loss.launches
    fused_loss.launches = 0

    def bump():
        for _ in range(2000):
            count_launch(fused_loss)

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        assert fused_loss.launches == 16000
    finally:
        fused_loss.launches = saved
