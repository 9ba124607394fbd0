"""The port's program cache (``serve/program_cache.py``) against the JAX
package's, on the CPU.

Mirrors the 11 tests of tests/test_program_cache.py. The unit tests are the
JAX ones run on the port's class; the engine tests hold what the port keeps
across searches (the ``score_data`` upload; the JAX package's compiled
programs have no counterpart, ROADMAP.md, C). Beyond the mirror:

- one get/put/evict trace gives equal ``stats()`` in both packages;
- the engine profile's ``program_cache`` block has the JAX package's keys
  (read from its source: running the JAX engine on the CPU compiles for two
  minutes);
- the operator tables and the kernel build: ``cached_optab`` goes through
  the cache once per search's scorer (the kernel layer does not import the
  serve layer), and ``build_all`` from two threads builds each library once;
- two searches on two threads at once: each equals its solo run bit for
  bit, and the engine's dispatch hook sees the legs of both.
"""

import os
import re
import stat
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu.serve.program_cache import ProgramCache as JProgramCache
from symbolicregression_jl_tpu_torch.models import device_search as ds
from symbolicregression_jl_tpu_torch.models.device_search import FleetLaneSpec, fleet_search
from symbolicregression_jl_tpu_torch.ops import interp_cuda as ic
from symbolicregression_jl_tpu_torch.serve.program_cache import (
    ProgramCache,
    global_program_cache,
    is_oom_error,
)

ROOT = Path(__file__).resolve().parent.parent


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


def _search(X, y, **kw):
    return T.equation_search(X, y, options=_opts(**kw), niterations=1, verbosity=0)


def _sig(res):
    o = res.options
    return [(m.get_complexity(o), m.loss, m.tree.string_tree(o.operators, precision=17))
            for m in res.pareto_frontier]


# -- unit: LRU, budgets, counters ---------------------------------------------


def test_put_has_setdefault_semantics():
    cache = ProgramCache(capacity=4)
    first = object()
    second = object()
    assert cache.put("optab", "k", first) is first
    # the build-race loser adopts the winner's value
    assert cache.put("optab", "k", second) is first
    assert cache.get("optab", "k") is first
    assert len(cache) == 1


def test_data_entries_bounded_by_bytes_not_count():
    cache = ProgramCache(capacity=2, data_budget_bytes=100)
    for i in range(5):
        cache.put("score_data", f"small{i}", i, nbytes=10)
    assert len(cache.keys("score_data")) == 5
    # one large dataset evicts smalls until the budget fits
    cache.put("score_data", "large", "L", nbytes=80)
    assert cache.stats()["data_bytes"] <= 100
    assert cache.get("score_data", "large") == "L"
    # tables are never displaced by data churn
    cache.put("optab", "p1", 1)
    cache.put("optab", "p2", 2)
    cache.put("score_data", "huge", "H", nbytes=100)
    assert cache.get("optab", "p1") == 1
    assert cache.get("optab", "p2") == 2


def test_oversized_data_entry_admitted_alone():
    cache = ProgramCache(capacity=2, data_budget_bytes=50)
    cache.put("score_data", "a", "a", nbytes=30)
    cache.put("score_data", "big", "B", nbytes=500)  # > whole budget
    assert cache.get("score_data", "big") == "B"
    assert cache.get("score_data", "a") is None  # evicted to make room


def test_counters_and_stats_shape():
    cache = ProgramCache(capacity=2)
    cache.get("optab", "missing")
    cache.put("optab", "k", 1)
    cache.get("optab", "k")
    st = cache.stats()
    assert st["hits"] == 1 and st["misses"] == 1 and st["evictions"] == 0
    assert st["hit_ratio"] == 0.5
    assert st["by_kind"]["optab"]["hits"] == 1
    cache.clear()
    st = cache.stats()
    assert st["hits"] == st["misses"] == st["entries"] == 0


def test_env_capacity_knob(monkeypatch):
    monkeypatch.setenv("SR_PROGRAM_CACHE_SIZE", "3")
    monkeypatch.setenv("SR_SCORE_DATA_CACHE_MB", "1")
    cache = ProgramCache()
    assert cache.capacity == 3
    assert cache.data_budget_bytes == 1 << 20


def test_thread_hammer_converges_on_one_value():
    """Concurrent builders for one key converge on the canonical value, and
    the cache never exceeds its capacity under churn."""
    cache = ProgramCache(capacity=8)
    results = []
    lock = threading.Lock()

    def build():
        time.sleep(0.005)  # widen the race window
        return object()

    def worker(i):
        for j in range(20):
            key = f"churn{i}-{j}" if j % 7 == 6 else f"k{j % 6}"
            v = cache.get_or_build("optab", key, build)
            with lock:
                results.append((key, v))
            assert len(cache) <= 8

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(cache) <= 8
    st = cache.stats()
    assert st["hits"] + st["misses"] == len(results)
    assert st["hits"] > 0


# -- unit: parity with the JAX cache -------------------------------------------


def _trace(cache):
    """One get/put/evict trace over every path of the cache (both classes,
    both budgets, the setdefault race, the fleet rollup, evict and its
    counters); returns the stats after each step."""
    out = []
    steps = [
        ("get", "aot", "s1"), ("put", "aot", "s1", 0), ("get", "aot", "s1"),
        ("get", "aot", "s2"), ("put", "fleet_aot", "f1", 0), ("get", "fleet_aot", "f1"),
        ("get", "fleet_aot", "f2"), ("get", "fleet_rb", "r1"),
        ("put", "score_data", "d1", 40), ("put", "score_data", "d2", 40),
        ("put", "score_data", "d3", 40), ("get", "score_data", "d1"),
        ("put", "score_data", "d3", 40), ("put", "aot", "s2", 0), ("put", "aot", "s3", 0),
        ("get", "aot", "s1"), ("put", "score_data", "big", 500), ("evict", "aot"),
        ("get", "score_data", "big"), ("evict", None),
    ]
    for step in steps:
        op, kind = step[:2]
        key = step[2] if len(step) > 2 else None
        if op == "get":
            cache.get(kind, key)
        elif op == "put":
            cache.put(kind, key, f"{kind}:{key}", nbytes=step[3])
        else:
            cache.evict(kind)
        out.append(cache.stats())
    return out


def test_trace_stats_equal_jax():
    assert _trace(ProgramCache(capacity=2, data_budget_bytes=100)) == _trace(
        JProgramCache(capacity=2, data_budget_bytes=100))


def test_fleet_rollup_equals_jax():
    # tests/test_fleet.py::test_program_cache_fleet_rollup, on both classes
    for cls in (ProgramCache, JProgramCache):
        cache = cls(capacity=8)
        cache.put("aot", "s1", object())
        cache.get("aot", "s1")
        cache.get("aot", "s2")
        cache.put("fleet_aot", "f1", object())
        cache.get("fleet_aot", "f1")
        cache.get("fleet_aot", "f2")
        cache.get("fleet_rb", "r1")
        assert cache.stats()["fleet"] == {
            "hits": 1, "misses": 2, "solo_hits": 1, "solo_misses": 1}


def test_is_oom_error():
    import torch

    from symbolicregression_jl_tpu_torch.utils import faults

    assert is_oom_error(faults.ResourceExhaustedInjected("fleet_aot", 1))
    assert is_oom_error(torch.OutOfMemoryError("CUDA out of memory. Tried to allocate"))
    assert is_oom_error(RuntimeError("RESOURCE_EXHAUSTED: Out of memory"))
    assert not is_oom_error(RuntimeError("fleet exploded"))


def test_oom_compile_fires_at_the_fleet_build(monkeypatch):
    """The ``oom_compile`` site fires at the fleet's lane-axis stack (kind
    "fleet_aot", the JAX package's name), only for a matching ``kind``."""
    from symbolicregression_jl_tpu_torch.utils import faults

    X, y = _problem()
    specs = [FleetLaneSpec(X=X, y=y, options=_opts(seed=s), niterations=1) for s in (0, 1)]
    monkeypatch.setattr(ds, "PROGRAM_CACHE", ProgramCache())
    try:
        faults.install("oom_compile@0:kind=score_data")
        fleet_search(specs)  # the rule's kind never matches: no raise
        faults.install("oom_compile@0:kind=fleet_aot")
        with pytest.raises(faults.ResourceExhaustedInjected) as e:
            fleet_search(specs)
        assert is_oom_error(e.value)
    finally:
        faults.install(None)
    # the site is no lookup: it counts nothing, and the stack is never stored
    assert "fleet_aot" not in ds.PROGRAM_CACHE.stats()["by_kind"]
    assert ds.PROGRAM_CACHE.keys("fleet_aot") == []


# -- unit: serve-level digests -------------------------------------------------


def test_options_digest_separates_configs():
    from symbolicregression_jl_tpu_torch.serve.queue import options_digest, shape_bucket

    d1 = options_digest(_opts())
    assert d1 == options_digest(_opts())  # deterministic
    assert d1 != options_digest(_opts(maxsize=12))
    assert d1 != options_digest(_opts(binary_operators=["+", "-"]))
    X, y = _problem()
    X2, y2 = _problem(n=60)
    b1 = shape_bucket(X, y, None, _opts())
    assert b1 == shape_bucket(X, y, None, _opts())
    assert b1 != shape_bucket(X2, y2, None, _opts())
    assert b1 != shape_bucket(X, y, np.ones_like(y), _opts())


# -- engine: the global cache holds the dataset uploads ------------------------


def test_warm_search_hits_cache_and_profiles_counters():
    """A repeat search on the same dataset is all hits (zero misses), and
    the per-search counter DELTA surfaces in SearchResult.engine_profile."""
    X, y = _problem(seed=5)
    _search(X, y, profile=True)
    res = _search(X, y, profile=True)
    pc = res.engine_profile["counters"]["program_cache"]
    assert pc["hits"] > 0
    assert pc["misses"] == 0  # fully warm: nothing uploaded again
    assert pc["entries"] >= 1 and pc["data_bytes"] > 0


def test_profile_block_has_jax_keys():
    """The ``program_cache`` counter block of a solo search and of a fleet
    has the keys the JAX package's engine writes (its
    ``models/device_search.py`` ``set_counters("program_cache", ...)``)."""
    src = (ROOT / "symbolicregression_jl_tpu/models/device_search.py").read_text()
    blocks = re.findall(r'set_counters\(\s*"program_cache",\s*\{(.*?)\},\s*\)', src, re.S)
    assert len(blocks) == 2  # the solo engine's, then the fleet's
    want = [set(re.findall(r'"(\w+)":', b)) for b in blocks]
    assert want[0] == {"hits", "misses", "evictions", "entries", "data_bytes"}
    X, y = _problem(seed=6)
    solo = _search(X, y, profile=True)
    assert set(solo.engine_profile["counters"]["program_cache"]) == want[0]
    fleet = fleet_search([FleetLaneSpec(X=X, y=y, options=_opts(seed=s, profile=True),
                                        niterations=1) for s in (0, 1)])
    assert set(fleet[0].engine_profile["counters"]["program_cache"]) == want[1]
    # the port caches no fleet kind (JAX's compiled fleet programs)
    pc = fleet[0].engine_profile["counters"]["program_cache"]
    assert (pc["fleet_hits"], pc["fleet_misses"]) == (0, 0)


def test_two_threads_same_dataset_share_uploads():
    """Two threads driving searches on one dataset share its upload: both
    runs are pure cache hits and equal the sequential result bit for bit."""
    X, y = _problem(seed=7)
    ref = _search(X, y)
    cache = global_program_cache()
    before = cache.stats()
    out = [None, None]
    errs = []

    def run(i):
        try:
            out[i] = _search(X, y)
        except BaseException as e:  # surfaced below; a bare thread would hide it
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errs, errs
    after = cache.stats()
    assert after["hits"] - before["hits"] >= 2
    assert after["misses"] == before["misses"]  # no thread uploaded again
    assert after["entries"] == before["entries"]  # no duplicate entries
    for res in out:
        assert _sig(res) == _sig(ref) and res.num_evals == ref.num_evals


def test_different_loss_never_collides():
    """A search whose score norm differs (another loss) uploads its own
    entry: it is never handed another config's ScoreData, and the hot
    entry stays warm."""
    X, y = _problem(seed=8)
    cache = global_program_cache()
    _search(X, y)
    before = cache.stats()
    keys_before = set(cache.keys())
    res = _search(X, y, elementwise_loss="L1DistLoss")
    assert min(m.loss for m in res.pareto_frontier) < 10.0  # sane search
    after = cache.stats()
    assert after["misses"] > before["misses"]  # a new upload
    assert keys_before < set(cache.keys())  # old keys intact, new keys added
    res2 = _search(X, y, profile=True)
    assert res2.engine_profile["counters"]["program_cache"]["misses"] == 0


def test_eviction_mid_search_reuploads_not_errors(monkeypatch):
    """With a 1-byte data budget every upload evicts the previous one while
    a two-lane fleet still holds it: the fleet completes from its held
    references, and the next run simply uploads again."""
    small = ProgramCache(capacity=1, data_budget_bytes=1)
    monkeypatch.setattr(ds, "PROGRAM_CACHE", small)
    X, y = _problem(seed=9)
    y2 = (X[0] * X[1]).astype(np.float32)
    specs = [FleetLaneSpec(X=X, y=yy, options=_opts(seed=s), niterations=1)
             for s, yy in ((0, y), (1, y2))]
    r1 = fleet_search(specs)
    st = small.stats()
    assert st["evictions"] > 0  # the first lane's upload churned out mid-search
    assert len(small.keys("score_data")) == 1
    r2 = fleet_search(specs)
    for a, b in zip(r1, r2):
        assert _sig(a) == _sig(b)
    assert small.stats()["misses"] > st["misses"]


# -- thread safety of what the server drives -----------------------------------


def test_optab_tensor_goes_through_the_cache():
    """The operator table lives in the program cache, looked up by each
    scorer once per search (not at every launch), and the kernel layer
    reaches no cache of its own and does not import the serve layer."""
    from symbolicregression_jl_tpu_torch.models.scorer import cached_optab
    from symbolicregression_jl_tpu_torch.ops.operators import kernel_op_table

    cache = global_program_cache()
    opset = _opts(binary_operators=["+", "-", "*", "/"], unary_operators=["exp"]).operators
    key = (kernel_op_table(opset).tobytes(), "cpu")
    cache.evict("optab")
    before = cache.stats()["by_kind"].get("optab", {"hits": 0, "misses": 0})
    a = cached_optab(opset, "cpu")
    b = cached_optab(opset, "cpu")
    assert a is b and a.tolist() == kernel_op_table(opset).tolist()
    assert a.tolist() == ic.optab_tensor(opset, "cpu").tolist()
    assert ("optab", key) in cache.keys("optab")
    st = cache.stats()["by_kind"]["optab"]
    assert (st["misses"] - before["misses"], st["hits"] - before["hits"]) == (1, 1)
    assert not hasattr(ic, "_OPTAB_CACHE") and not hasattr(ic, "_optab_tensor")
    src = (ROOT / "symbolicregression_jl_tpu_torch/ops/interp_cuda.py").read_text()
    assert not re.findall(r"^\s*(?:from|import)\s+\S*serve", src, re.M)
    # one lookup per scorer of a search, whatever its launch count: a solo
    # engine search has one scorer, a two-lane fleet one per lane and its own
    X, y = _problem(seed=11)
    for run, lookups in ((lambda: _search(X, y, binary_operators=["+", "-", "*", "/"],
                                          unary_operators=["exp"]), 1),
                         (lambda: fleet_search([FleetLaneSpec(
                             X=X, y=y, options=_opts(seed=s, binary_operators=["+", "-", "*", "/"],
                                                     unary_operators=["exp"]), niterations=1)
                             for s in (0, 1)]), 3)):
        before = cache.stats()["by_kind"]["optab"]
        calls = ic.fused_loss.launches  # the CPU path counts no launch
        run()
        st = cache.stats()["by_kind"]["optab"]
        assert st["hits"] + st["misses"] - before["hits"] - before["misses"] == lookups
        assert ic.fused_loss.launches == calls


_FAKE_NVCC = """\
#!{python}
# stands in for nvcc: logs the call, then builds a host library that
# exports the entry points the loader binds
import os, subprocess, sys, time
args = sys.argv[1:]
out, src = args[args.index("-o") + 1], args[-1]
name = os.path.basename(src)[:-3]
with open({log!r}, "a") as f:
    f.write(name + "\\n")
time.sleep(0.2)  # widen the window in which a second builder could start
c = out + ".c"
with open(c, "w") as f:
    f.write("int sr_%s(void) {{ return 0; }}\\n"
            "const char *sr_cuda_error_string(int e) {{ return \\"\\"; }}\\n" % name)
sys.exit(subprocess.call(["g++", "-x", "c", "-shared", "-fPIC", "-o", out, c]))
"""


def test_build_all_from_two_threads_builds_each_library_once(tmp_path, monkeypatch):
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no host compiler to stand in for nvcc")
    log = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"
    fake.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log)))
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("NVCC", str(fake))
    monkeypatch.setattr(ic, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(ic, "_LIBS", {})
    monkeypatch.setattr(ic, "BUILD_INFO", {})
    got, errs = [None, None], []
    go = threading.Barrier(2)

    def run(i):
        try:
            go.wait(timeout=60)
            got[i] = ic.build_all()
        except BaseException as e:
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errs, errs
    assert sorted(log.read_text().split()) == sorted(ic.SOURCES)  # one build each
    assert set(ic.BUILD_INFO) == set(ic.SOURCES)
    assert all(got[0][n] is got[1][n] for n in ic.SOURCES)
    assert not list((tmp_path / "build").glob("*.tmp.so"))


def test_concurrent_searches_keep_their_bits_and_the_hook_sums(monkeypatch):
    """Two engine searches on two threads at once: each equals its solo
    run bit for bit, and the process-wide dispatch hook sees the legs of
    both (the solos' counts summed)."""
    X, y = _problem(seed=10)
    legs = []
    lock = threading.Lock()

    def hook(name):
        with lock:
            legs.append(name)

    monkeypatch.setattr(ds, "_DISPATCH_HOOK", hook)
    solos = [_search(X, y, seed=s) for s in (0, 1)]
    solo_legs = len(legs)
    legs.clear()
    out, errs = [None, None], []

    def run(i):
        try:
            out[i] = _search(X, y, seed=i)
        except BaseException as e:
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errs, errs
    for got, want in zip(out, solos):
        assert _sig(got) == _sig(want) and got.num_evals == want.num_evals
    assert len(legs) == solo_legs > 0


def test_enable_persistent_compilation_cache_points_the_build_dir(tmp_path, monkeypatch):
    from symbolicregression_jl_tpu_torch.serve import enable_persistent_compilation_cache

    monkeypatch.setattr(ic, "BUILD_DIR", ic.BUILD_DIR)
    monkeypatch.delenv("SR_COMPILATION_CACHE_DIR", raising=False)
    assert enable_persistent_compilation_cache() is None
    d = str(tmp_path / "kernels")
    assert enable_persistent_compilation_cache(d) == d
    assert ic.BUILD_DIR == Path(d) and os.path.isdir(d)
    assert ic._lib_path("fused_loss").parent == Path(d)
