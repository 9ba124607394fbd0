"""Spans and host-sync counts of the device engine
(``utils/profiling.SpanRecord``) and the benchmark's readers of them, on the
CPU.

A search's spans are on under ``Options.profile`` or a torch profiler that
records at its start; they must leave the frontier as it is. The counts of
the const-opt leg's two stop tests are held to an independent count: every
execution of the two ``bool(...)`` lines of ``_bfgs_lockstep``, seen from a
wrapped ``Tensor.__bool__``. On the profiler's own clock the leg's sub-spans
cover the leg, which is what lets a trace reader lay the card's idle time in
the leg to them.
"""

import importlib.util
import inspect
import os
import re
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
    syncs = res.engine_stats["host_syncs"]
    assert spans["const_opt/sync"]["count"] == syncs["g_tol"] + syncs["armijo"] > 0
    # one step more than the stop tests in each leg: from the BFGS's start
    # to the first, and from the last to its end
    assert spans["const_opt/step"]["count"] == spans["const_opt/sync"]["count"] + 3
    assert spans["const_opt/prepare"]["count"] == spans["const_opt/finish"]["count"] == 3
    names = {name for name, _, _ in legs}
    assert {"prelude", "prelude/lane", "prelude/initial_scoring", "tail", "tail/drain",
            "tail/decode_populations", "tail/hof", "evolve", "readback"} <= names
    assert set(spans) == names
    assert res.setup_seconds == spans["prelude"]["seconds"]


def _stop_lines():
    """The source lines of ``_bfgs_lockstep``'s two stop tests."""
    lines, first = inspect.getsourcelines(ds._bfgs_lockstep)
    found = {}
    for i, ln in enumerate(lines):
        m = re.search(r"bool\((frozen|armijo)\.all\(\)\)", ln)
        if m:
            found[first + i] = m.group(1)
    assert sorted(found.values()) == ["armijo", "frozen"]
    return found


@pytest.mark.parametrize("engine", ["solo", "fleet"])
def test_host_syncs_equal_an_independent_count(engine, monkeypatch):
    lines = _stop_lines()
    code = ds._bfgs_lockstep.__code__
    seen = {"frozen": 0, "armijo": 0}
    real = torch.Tensor.__bool__

    def counting(self):
        f = sys._getframe(1)
        if f.f_code is code and f.f_lineno in lines:
            seen[lines[f.f_lineno]] += 1
        return real(self)

    monkeypatch.setattr(torch.Tensor, "__bool__", counting)
    if engine == "solo":
        res = _search(_opts())
        iterations = res.engine_stats["iterations"]
    else:
        X, y = _problem()
        out = ds.fleet_search([ds.FleetLaneSpec(X=X, y=y, options=_opts(seed=s), niterations=2)
                               for s in (0, 7)])
        res, iterations = out[0], 2
        assert out[1].engine_stats["host_syncs"] == res.engine_stats["host_syncs"]
    syncs = dict(res.engine_stats["host_syncs"])
    assert seen["frozen"] > 0 and seen["armijo"] > 0
    # a readback's wait: once an iteration, and in a fleet once more for
    # each further lane that drains the same last readback
    assert iterations <= syncs.pop("readback") <= iterations + (engine == "fleet")
    assert syncs == {"g_tol": seen["frozen"], "armijo": seen["armijo"]}
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
