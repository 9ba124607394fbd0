"""The port's chaos harness (``utils/chaos.py``) and invariant auditor
(``utils/invariants.py``) on the CPU, against the JAX package's.

Mirrors the 19 tests of tests/test_chaos.py on the port (determinism,
routing, minimization, every auditor contract, and the
``SR_CHAOS_BREAK=shed_silently`` demo hook in the port's ``SearchServer``),
and holds the port to the JAX package: ``schedule_spec`` byte for byte for
seeds 0-49 across durations, two and three hosts and ``net`` on and off;
``host_env_spec`` and ``kill_events``; ``ddmin``'s subset on the same
predicates; the auditor's breach names and details on the same observation
streams.
"""

import os

import numpy as np
import pytest

import symbolicregression_jl_tpu.utils.chaos as jchaos
import symbolicregression_jl_tpu.utils.invariants as jinv
from symbolicregression_jl_tpu.utils import faults as jfaults
from symbolicregression_jl_tpu_torch.utils import chaos
from symbolicregression_jl_tpu_torch.utils import faults
from symbolicregression_jl_tpu_torch.utils.chaos import (
    KILL_SITE,
    ddmin,
    generate_schedule,
    host_env_spec,
    kill_events,
    parse_schedule,
    schedule_spec,
)
from symbolicregression_jl_tpu_torch.utils.faults import FaultRule
from symbolicregression_jl_tpu_torch.utils.invariants import InvariantAuditor


@pytest.fixture(autouse=True)
def _clean_injector():
    yield
    faults.install(None)
    jfaults.install(None)


# -- schedule generation -------------------------------------------------------


def test_same_seed_is_byte_identical():
    for seed in range(8):
        a = schedule_spec(generate_schedule(seed, 60.0))
        b = schedule_spec(generate_schedule(seed, 60.0))
        assert a == b and a


def test_different_seeds_differ():
    specs = {schedule_spec(generate_schedule(s, 60.0)) for s in range(8)}
    assert len(specs) > 1


def test_schedule_round_trips_through_spec_grammar():
    sched = generate_schedule(3, 45.0, hosts=("h0", "h1", "h2"))
    assert parse_schedule(schedule_spec(sched)) == sched


def test_coverage_floor_every_seed():
    for seed in range(10):
        sites = {r.site for r in generate_schedule(seed, 60.0)}
        assert {KILL_SITE, "disk_full", "kv_partition", "clock_skew",
                "oom_compile"} <= sites


def test_host_env_spec_routes_and_strips_host():
    sched = generate_schedule(0, 60.0)
    for host in ("h0", "h1"):
        spec = host_env_spec(sched, host)
        if not spec:
            continue
        rules = faults.parse_fault_spec(spec)
        assert all(r.site != KILL_SITE for r in rules)
        assert all("host" not in dict(r.params) for r in rules)
    total = sum(
        len(faults.parse_fault_spec(host_env_spec(sched, h)) if
            host_env_spec(sched, h) else ())
        for h in ("h0", "h1", "net")
    )
    assert total == sum(1 for r in sched if r.site != KILL_SITE)


def test_kill_events_sorted_by_time():
    sched = (
        FaultRule(KILL_SITE, 0, (("at_s", 20.0), ("down_s", 2.0), ("host", "h1"))),
        FaultRule(KILL_SITE, 1, (("at_s", 5.0), ("down_s", 3.0), ("host", "h0"))),
    )
    evs = kill_events(sched)
    assert [e["host"] for e in evs] == ["h0", "h1"]
    assert evs[0]["at_s"] == 5.0 and evs[1]["down_s"] == 2.0


# -- shrinker ------------------------------------------------------------------


def test_ddmin_finds_minimal_pair():
    entries = tuple(FaultRule("stall", i, ()) for i in range(8))

    def failing(subset):
        return {2, 5} <= {r.at for r in subset}

    assert {r.at for r in ddmin(entries, failing)} == {2, 5}


def test_ddmin_single_culprit_and_result_is_one_minimal():
    entries = tuple(FaultRule("stall", i, ()) for i in range(7))

    def failing(subset):
        return any(r.at == 4 for r in subset)

    out = ddmin(entries, failing)
    assert [r.at for r in out] == [4]
    for i in range(len(out)):
        rest = out[:i] + out[i + 1:]
        assert not rest or not failing(rest)


def test_ddmin_nonreproducing_returns_input_unshrunk():
    entries = tuple(FaultRule("stall", i, ()) for i in range(4))
    assert ddmin(entries, lambda s: False) == entries


# -- invariant auditor ---------------------------------------------------------


def test_auditor_flags_lost_job_and_exempts_shed():
    a = InvariantAuditor()
    a.note_submit("pj-kept", niterations=2)
    a.note_submit("pj-shed")
    a.note_submit("pj-lost")
    a.note_shed("pj-shed")
    a.observe_done("pj-kept", {"state": "done"})
    a.finalize()
    assert a.breach_names() == {"no_lost_jobs"}
    assert any("pj-lost" in b.detail for b in a.breaches)
    assert not any("pj-shed" in b.detail for b in a.breaches)


def test_auditor_flags_duplicates_once():
    a = InvariantAuditor()
    a.observe_host_stats("h0", {"duplicate_results": 0})
    assert a.ok
    a.observe_host_stats("h0", {"duplicate_results": 2})
    a.observe_host_stats("h0", {"duplicate_results": 2})
    assert [b.invariant for b in a.breaches] == ["exactly_once"]


def test_auditor_queue_and_buffer_bounds():
    a = InvariantAuditor(queue_max_depth=4, journal_buffer_max=10)
    a.observe_host_stats("h0", {"queue_depth": 4})
    assert a.ok
    a.observe_host_stats("h0", {"queue_depth": 5})
    a.observe_host_stats(
        "h1", {"server": {"queued": 1, "journal": {"buffered_records": 11}}}
    )
    assert sorted(b.invariant for b in a.breaches) == ["bounded", "bounded"]


def test_auditor_stream_contract():
    a = InvariantAuditor()
    a.check_stream("s", dup_dropped=0, next_index=3,
                   stored=[b"a", b"b", b"c"], tail=[b"a", b"b", b"c"])
    assert a.ok
    a.check_stream("s", dup_dropped=1, next_index=2,
                   stored=[b"a", b"b", b"c"], tail=[b"a", b"b"])
    assert a.breach_names() == {"frame_monotonic"}
    assert len(a.breaches) == 2


def test_auditor_stream_tail_divergence():
    a = InvariantAuditor()
    a.check_stream("s", dup_dropped=0, next_index=2,
                   stored=[b"a", b"b"], tail=[b"a", b"X"])
    assert a.breach_names() == {"frame_monotonic"}


def test_auditor_frame_index_gap():
    a = InvariantAuditor()
    a.observe_stream_frame("s", 0)
    a.observe_stream_frame("s", 1)
    a.observe_stream_frame("s", 3)
    assert a.breach_names() == {"frame_monotonic"}


def test_auditor_resume_budget():
    a = InvariantAuditor()
    a.note_submit("pj", niterations=10)
    a.observe_done("pj", {
        "state": "done", "resumed_from_iteration": 4,
        "iterations_done": 7, "stop_reason": None,
    })
    assert a.breach_names() == {"resume_exact"}
    b = InvariantAuditor()
    b.note_submit("pj", niterations=10)
    b.observe_done("pj", {
        "state": "done", "resumed_from_iteration": 4,
        "iterations_done": 7, "stop_reason": "timeout",
    })
    assert b.ok


def test_auditor_journal_check_real_journal(tmp_path):
    from symbolicregression_jl_tpu_torch.serve.journal import JOURNAL_MAGIC, JobJournal

    jdir = str(tmp_path / "j")
    j = JobJournal(jdir, fsync=False)
    j.append("submit", "job-1", seq=1, spec=None, kind="search", submitted_at=0.0)
    j.append("start", "job-1", attempt=1)
    j.close()
    path = os.path.join(jdir, "journal.log")
    with open(path, "ab") as f:
        f.write(b"\x40\x00\x00\x00garbage")
    a = InvariantAuditor()
    a.check_journal(jdir, context="test")
    assert a.ok, a.report()
    with open(path, "r+b") as f:
        f.write(b"X" * len(JOURNAL_MAGIC))
    a2 = InvariantAuditor()
    a2.check_journal(jdir, context="test")
    assert a2.ok, a2.report()


def test_auditor_journal_breach_when_replay_raises(tmp_path, monkeypatch):
    from symbolicregression_jl_tpu_torch.serve import journal as jmod

    class _Boom:
        def __init__(self, *a, **k):
            raise RuntimeError("replay exploded")

    monkeypatch.setattr(jmod, "JobJournal", _Boom)
    a = InvariantAuditor()
    a.check_journal(str(tmp_path), context="test")
    assert a.breach_names() == {"journal_replayable"}


# -- deliberate-regression demo hook -------------------------------------------


def test_chaos_break_hook_drops_shed_submit(tmp_path, monkeypatch):
    """SR_CHAOS_BREAK=shed_silently reverts the port server's disk-full shed
    to a silent drop: submit() hands back a job id for a job that no longer
    exists, and the auditor's no_lost_jobs invariant catches it."""
    import symbolicregression_jl_tpu_torch as T
    from symbolicregression_jl_tpu_torch.serve import JobSpec, SearchServer, ServerOverloaded

    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 32)).astype(np.float32)
    y = X[0].astype(np.float32)
    opts = T.Options(binary_operators=["+", "*"], populations=2, population_size=8,
                     ncycles_per_iteration=4, maxsize=8, seed=0, scheduler="lockstep",
                     save_to_file=False, progress=False, device="cpu")
    faults.install("disk_full@0:path=journal,clear=1")
    with SearchServer(max_concurrency=1, journal_dir=str(tmp_path / "j")) as srv:
        with pytest.raises(ServerOverloaded):
            srv.submit(JobSpec(X, y, options=opts, niterations=1))
        faults.install("disk_full@0:path=journal,clear=1")
        monkeypatch.setenv("SR_CHAOS_BREAK", "shed_silently")
        jid = srv.submit(JobSpec(X, y, options=opts, niterations=1))
        assert jid
        with pytest.raises(KeyError):
            srv.job(jid)
        a = InvariantAuditor()
        a.note_submit(jid)
        a.finalize()
        assert a.breach_names() == {"no_lost_jobs"}
        assert srv.stats()["shed"] == 1  # only the honest refusal counted


# -- parity with the JAX package -----------------------------------------------


_HOSTS = (("h0", "h1"), ("h0", "h1", "h2"))


@pytest.mark.parametrize("hosts", _HOSTS, ids=["2hosts", "3hosts"])
@pytest.mark.parametrize("net", [True, False], ids=["net", "nonet"])
@pytest.mark.parametrize("duration", [25.0, 60.0, 137.5])
def test_schedule_spec_equals_jax(duration, net, hosts):
    for seed in range(50):
        got = schedule_spec(generate_schedule(seed, duration, hosts=hosts, net=net))
        want = jchaos.schedule_spec(jchaos.generate_schedule(seed, duration, hosts=hosts,
                                                             net=net))
        assert got == want, seed


@pytest.mark.parametrize("hosts", _HOSTS, ids=["2hosts", "3hosts"])
def test_host_env_spec_and_kill_events_equal_jax(hosts):
    for seed in range(50):
        sched = generate_schedule(seed, 60.0, hosts=hosts)
        jsched = jchaos.generate_schedule(seed, 60.0, hosts=hosts)
        for h in (*hosts, chaos.NET_HOST):
            assert host_env_spec(sched, h) == jchaos.host_env_spec(jsched, h)
        assert kill_events(sched) == jchaos.kill_events(jsched)
        assert parse_schedule(schedule_spec(sched)) == sched


def test_chaos_names_equal_jax():
    assert chaos.__all__ == jchaos.__all__
    assert (chaos.KILL_SITE, chaos.NET_HOST) == (jchaos.KILL_SITE, jchaos.NET_HOST)
    assert chaos._POD_SITES == jchaos._POD_SITES and chaos._NET_SITES == jchaos._NET_SITES
    assert jinv.__all__ == __import__(
        "symbolicregression_jl_tpu_torch.utils.invariants", fromlist=["x"]).__all__
    from symbolicregression_jl_tpu_torch.utils.invariants import TERMINAL_POD_STATES

    assert TERMINAL_POD_STATES == jinv.TERMINAL_POD_STATES


@pytest.mark.parametrize("seed", range(8))
def test_ddmin_equals_jax(seed):
    """On a seeded schedule and a seeded predicate (a random culprit set,
    sometimes an "any of" set), both packages' ``ddmin`` return the same
    subset in the same order, with the same predicate calls."""
    rng = np.random.default_rng(seed)
    sched = generate_schedule(seed, 60.0, hosts=("h0", "h1", "h2"))
    jsched = jchaos.generate_schedule(seed, 60.0, hosts=("h0", "h1", "h2"))
    n = len(sched)
    culprits = set(rng.choice(n, size=int(rng.integers(1, 4)), replace=False).tolist())
    any_of = bool(rng.random() < 0.3)

    def pred(entries, calls):
        def failing(subset):
            idx = {entries.index(r) for r in subset}
            calls.append(tuple(sorted(idx)))
            return bool(idx & culprits) if any_of else culprits <= idx
        return failing

    calls, jcalls = [], []
    got = ddmin(sched, pred(list(sched), calls))
    want = jchaos.ddmin(jsched, pred(list(jsched), jcalls))
    assert schedule_spec(got) == jchaos.schedule_spec(want)
    assert calls == jcalls


def _observation_stream(seed):
    """A seeded stream of auditor calls: submits, sheds, frames (some
    indices skipped or repeated), done records (terminal, non-terminal,
    resumed under budget, stopped early), host stats over and under the
    bounds, and stream checks."""
    rng = np.random.default_rng(seed)
    ops = []
    pjids = [f"pj-{i:04d}" for i in range(int(rng.integers(4, 10)))]
    for p in pjids:
        ops.append(("note_submit", (p,), {"niterations": int(rng.integers(1, 6))}))
    for p in pjids:
        r = rng.random()
        if r < 0.15:
            ops.append(("note_shed", (p,), {}))
        elif r < 0.85:
            state = str(rng.choice(["done", "done", "done", "failed", "running"]))
            rec = {"state": state, "iterations_done": int(rng.integers(0, 6)),
                   "stop_reason": None if rng.random() < 0.7 else "timeout"}
            if rng.random() < 0.5:
                rec["resumed_from_iteration"] = int(rng.integers(1, 4))
            ops.append(("observe_done", (p, rec), {}))
    idx = 0
    for _ in range(int(rng.integers(3, 9))):
        idx += int(rng.choice([0, 1, 1, 1, 2]))
        ops.append(("observe_stream_frame", ("s0", idx), {}))
    for h in ("h0", "h1"):
        for _ in range(3):
            stats = {"duplicate_results": int(rng.integers(0, 3)),
                     "queue_depth": int(rng.integers(0, 8)),
                     "server": {"journal": {"buffered_records": int(rng.integers(0, 20))}}}
            if rng.random() < 0.5:
                stats["server"]["queued"] = int(rng.integers(0, 8))
            ops.append(("observe_host_stats", (h, stats), {}))
    stored = [b"a", b"b", b"c"][: int(rng.integers(0, 4))]
    tail = list(stored) if rng.random() < 0.6 else [b"x"] * len(stored)
    ops.append(("check_stream", ("s1", int(rng.integers(0, 2)),
                                 len(stored) + int(rng.integers(0, 2)), stored, tail), {}))
    return ops


@pytest.mark.parametrize("seed", range(10))
def test_auditor_equals_jax_on_observation_streams(seed):
    a = InvariantAuditor(queue_max_depth=5, journal_buffer_max=12)
    ja = jinv.InvariantAuditor(queue_max_depth=5, journal_buffer_max=12)
    for name, args, kw in _observation_stream(seed):
        getattr(a, name)(*args, **kw)
        getattr(ja, name)(*args, **kw)
    got, want = a.finalize(), ja.finalize()
    assert [(b.invariant, b.detail, b.context) for b in got] == \
        [(b.invariant, b.detail, b.context) for b in want]
    assert a.report() == ja.report()
    assert a.breach_names() == ja.breach_names()
