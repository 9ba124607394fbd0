"""Spans and host-sync counts of the device engine
(``utils/profiling.SpanRecord``) and the benchmark's readers of them, on the
CPU.

A search's spans are on under ``Options.profile`` or a torch profiler that
records at its start; they must leave the frontier as it is. The const-opt
leg makes no host sync: ``_bfgs_lockstep`` reads no tensor on the host, seen
from a wrapped ``Tensor.__bool__`` (and ``item``, ``tolist``), and the
search's host-sync counts hold the readback's waits alone. On the
profiler's own clock the leg's sub-spans cover the leg, which is what lets
a trace reader lay the card's idle time in the leg to them.
"""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu_torch.models import device_search as ds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = os.path.join(REPO, "port_bench", "metrics")
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 100)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    return X, y


def _opts(**kw):
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=2,
                population_size=16, ncycles_per_iteration=4, maxsize=12, seed=0,
                save_to_file=False, progress=False, scheduler="device", device="cpu")
    base.update(kw)
    return T.Options(**base)


def _search(opts, niterations=3):
    X, y = _problem()
    return T.equation_search(X, y, options=opts, niterations=niterations, verbosity=0)


def _front(res):
    o = res.options
    return [(m.get_complexity(o), m.loss, m.tree.string_tree(o.operators, precision=17))
            for m in res.pareto_frontier]


def _legs(prof):
    """(name, start ns, end ns) of every ``leg:`` range the profiler saw."""
    return [(e.name()[4:], e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.name().startswith("leg:")]


@pytest.fixture(scope="module")
def traced():
    """One search with spans on: ``profile=True`` under a torch profiler."""
    with torch.profiler.profile(activities=CPU) as prof:
        res = _search(_opts(profile=True))
    return res, _legs(prof)


def test_spans_leave_the_frontier_bit_identical(traced):
    res, _ = traced
    plain = _search(_opts(async_readback=False))
    assert "spans" in res.engine_stats and "spans" not in plain.engine_stats
    assert _front(res) == _front(plain)
    # a profiler alone turns the spans on and keeps the pipelined readback
    with torch.profiler.profile(activities=CPU):
        piped = _search(_opts())
    assert "spans" in piped.engine_stats and not hasattr(piped, "engine_profile")
    assert _front(piped) == _front(_search(_opts()))


def test_const_opt_sub_spans_tile_the_leg(traced):
    res, legs = traced
    spans = res.engine_stats["spans"]
    legs_co = [(s, e) for name, s, e in legs if name == "const_opt"]
    subs = [(s, e) for name, s, e in legs if name.startswith("const_opt/")]
    assert len(legs_co) == 3 == spans["const_opt"]["count"]
    for s0, e0 in legs_co:
        covered = sum(min(e, e0) - max(s, s0) for s, e in subs if s < e0 and e > s0)
        assert covered >= 0.95 * (e0 - s0), (covered, e0 - s0)
    assert "const_opt/sync" not in spans and set(res.engine_stats["host_syncs"]) <= {"readback"}
    # one step per BFGS iteration of each leg: every iteration is enqueued
    assert spans["const_opt/step"]["count"] == 3 * res.options.optimizer_iterations
    assert spans["const_opt/prepare"]["count"] == spans["const_opt/finish"]["count"] == 3
    names = {name for name, _, _ in legs}
    assert {"prelude", "prelude/lane", "prelude/initial_scoring", "tail", "tail/drain",
            "tail/decode_populations", "tail/hof", "evolve", "readback"} <= names
    assert set(spans) == names
    assert res.setup_seconds == spans["prelude"]["seconds"]


@pytest.mark.parametrize("engine", ["solo", "fleet"])
def test_host_syncs_equal_an_independent_count(engine, monkeypatch):
    """No host read of a tensor inside ``_bfgs_lockstep``, counted from the
    tensor's side; the search's counts hold only the readback's waits."""
    code = ds._bfgs_lockstep.__code__
    seen = []

    def counting(name):
        real = getattr(torch.Tensor, name)

        def wrapped(self, *a, **k):
            if sys._getframe(1).f_code is code:
                seen.append((name, sys._getframe(1).f_lineno))
            return real(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, wrapped)

    for name in ("__bool__", "item", "tolist"):
        counting(name)
    if engine == "solo":
        res = _search(_opts())
        iterations = res.engine_stats["iterations"]
    else:
        X, y = _problem()
        out = ds.fleet_search([ds.FleetLaneSpec(X=X, y=y, options=_opts(seed=s), niterations=2)
                               for s in (0, 7)])
        res, iterations = out[0], 2
        assert out[1].engine_stats["host_syncs"] == res.engine_stats["host_syncs"]
    assert res.engine_stats["line_search"]["searches"] > 0  # the BFGS ran, watched
    assert seen == []
    syncs = dict(res.engine_stats["host_syncs"])
    # a readback's wait: once an iteration, and in a fleet once more for
    # each further lane that drains the same last readback
    assert iterations <= syncs.pop("readback") <= iterations + (engine == "fleet")
    assert syncs == {}
    assert "spans" not in res.engine_stats


# -- the benchmark's readers ----------------------------------------------------


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"span_reader_{name}",
                                                  os.path.join(METRICS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _run(engine_stats, idle=None, iterations=4):
    """What a reader reads of a traced run: ``port_bench.harness.Run``'s
    fields."""
    return types.SimpleNamespace(
        iterations=iterations, result=types.SimpleNamespace(engine_stats=engine_stats),
        trace=None if idle is None else {"idle_s_by_host": idle})


STATS = {"host_syncs": {"g_tol": 32, "armijo": 384, "readback": 4},
         "spans": {"const_opt/step": {"count": 420, "seconds": 0.21},
                   "prelude": {"count": 1, "seconds": 0.5},
                   "tail": {"count": 1, "seconds": 0.75}}}
IDLE = {"const_opt": 0.01, "const_opt/step": 0.1, "const_opt/sync": 0.09, "evolve": 5.0}


@pytest.mark.parametrize("name, want", [
    ("syncs_per_iter.const_opt", 104.0),
    ("idle_ms_per_iter.const_opt", 50.0),
    ("step_host_ms.const_opt", 0.5),
    ("call_prelude_ms", 500.0),
    ("call_tail_ms", 750.0),
])
def test_span_readers(name, want):
    read = _reader(name)
    assert read(_run(STATS, IDLE)) == pytest.approx(want, rel=1e-12)
    # a program without the spans and counters (or an untraced run)
    assert read(_run({"iterations": 4}, None)) is None
    assert read(_run({"iterations": 4}, {"evolve": 5.0})) is None
    assert read(_run(STATS, IDLE, iterations=0)) in (None, want)


def test_syncs_reader_reads_zero_where_the_leg_makes_none():
    """The program's counts hold the readback's waits alone: the reader
    reads 0.0, not nothing."""
    read = _reader("syncs_per_iter.const_opt")
    assert read(_run({"host_syncs": {"readback": 4}})) == 0.0
