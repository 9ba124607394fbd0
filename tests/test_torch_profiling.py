"""The stage profiler (``utils/profiling.py``) and ``Options(profile=True)``
on the device engine, on the CPU.

The port's ``StageProfiler`` is the JAX package's with ``fence`` made a
``torch.cuda.synchronize``; driven through one sequence of calls on one
fake clock, both must give the same ``summary()``. On the engine the
stages sit where the leg timer sits, and the profile must not change the
run: the frontier equals that of the same search without it, in the
synchronous readback the profile forces.
"""

import itertools
import time

import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu.utils import profiling as jprof
from symbolicregression_jl_tpu_torch.utils import profiling as tprof

STAGES = {"evolve", "const_opt", "finalize", "readback_pack", "readback_d2h", "decode_hof",
          "migrate", "simplify", "checkpoint", "other"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _drive(mod, monkeypatch, capacity):
    ticks = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: 0.001 * next(ticks) ** 1.5)
    prof = mod.StageProfiler(capacity=capacity)
    for it in range(5):
        for name in ("evolve", "const_opt", "evolve") if it % 2 else ("evolve", "readback"):
            with prof.stage(name):
                prof.fence(None)
        prof.add_time("evolve/score", 0.002 * it)
        if it == 3:
            prof.add_time("checkpoint", 0.05)
        prof.set_counters("c", {"hits": it})
        prof.next_iteration()
    return prof.summary()


@pytest.mark.parametrize("capacity", [512, 3])
def test_summary_equals_jax_on_one_clock(monkeypatch, capacity):
    want = _drive(jprof, monkeypatch, capacity)
    got = _drive(tprof, monkeypatch, capacity)
    assert got == want
    assert got["iterations"] == min(capacity, 5) and got["counters"] == {"c": {"hits": 4}}


def test_null_profiler_is_inert(monkeypatch):
    def no_clock():
        raise AssertionError("the disabled profiler read the clock")

    monkeypatch.setattr(time, "perf_counter", no_clock)
    monkeypatch.setattr(torch.cuda, "synchronize", no_clock)
    p = tprof.NULL_PROFILER
    assert not p.enabled
    x = object()
    with p.stage("evolve") as ctx:
        assert p.fence(x) is x
    assert ctx is p.stage("const_opt")  # one shared no-op context
    p.add_time("evolve", 1.0)
    p.set_counters("c", {"n": 1})
    p.next_iteration()
    assert p.summary() == {"iterations": 0, "stages": {}, "iteration_mean_ms": 0.0}
    # enabled on the CPU: a fence has nothing to wait for
    assert tprof.StageProfiler(device="cpu").fence(x) is x


def _search(**kw):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 100)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    opts = T.Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=4,
                     population_size=16, ncycles_per_iteration=20, maxsize=14, seed=0,
                     save_to_file=False, progress=False, scheduler="device", device="cpu", **kw)
    res = T.equation_search(X, y, options=opts, niterations=3, verbosity=0)
    front = [(m.get_complexity(opts), m.loss, m.tree.string_tree(opts.operators, precision=17))
             for m in res.pareto_frontier]
    return res, front


@pytest.mark.parametrize("case", ["full", "batching", "checkpoint"])
def test_engine_profile_stages_and_unchanged_frontier(case, tmp_path):
    kw = {"full": {}, "batching": dict(batching=True, batch_size=30),
          "checkpoint": dict(checkpoint_every=1, checkpoint_file=str(tmp_path / "ck.pkl"))}[case]
    res, front = _search(profile=True, **kw)
    prof = res.engine_profile
    assert prof["iterations"] == 3
    stages = prof["stages"]
    assert set(stages) <= STAGES
    legs = {"evolve", "const_opt", "readback_pack", "readback_d2h", "decode_hof", "other"}
    legs |= {"batching": {"finalize"}, "checkpoint": {"checkpoint"}}.get(case, set())
    assert legs <= set(stages)
    total = sum(v["fraction"] for k, v in stages.items() if "/" not in k)
    assert 0.99 <= total <= 1.01
    plain, plain_front = _search(async_readback=False, **kw)
    assert not hasattr(plain, "engine_profile")
    assert front == plain_front


def test_profile_with_async_readback_is_rejected():
    with pytest.raises(ValueError, match="profile=True"):
        T.Options(device="cpu", scheduler="device", profile=True, async_readback=True)
