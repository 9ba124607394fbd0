"""The port's serve core (``serve/queue.py``, ``serve/server.py``) against
the JAX package's and against the port's own direct runs, on the CPU.

Mirrors tests/test_serve.py, the server tests of tests/test_fleet.py and
tests/test_stream.py, and the JAX ``serve.__all__``. Held exactly against
the JAX package:

- the queue's admission order for one submit/acquire script (priorities,
  tenants and quotas, warm buckets, head-of-line aging, releases);
- ``bucket_digest`` of the same inputs (the same 12 hex digits);
- the terminal states, frame counts and iterations of the same jobs run on
  both servers (the lockstep scheduler, which compiles nothing in JAX).

Held bit for bit against the port's direct runs (frontier and num_evals),
on the event leg and on the block's plain version (``SR_ENGINE_BLOCK=1``):
a served job, a coalesced fleet, a collapsed pair, and the survivor of a
fleet whose other lane was cancelled. A stream swap leaves the program
cache's ScoreData of the original dataset bit-identical, and a later job
on that dataset hits it and gives its direct run's frontier.

The JAX package's daemon tests run its device engine (35-45 s compiles
each); here the port's engine runs at a small size, so they are tier-1.
Every wait has a timeout.
"""

import copy
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu.serve as jserve
from symbolicregression_jl_tpu.utils.checkpoint import load_frontier_bytes as j_load_frontier_bytes
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu_torch import serve
from symbolicregression_jl_tpu_torch.models import device_search as ds
from symbolicregression_jl_tpu_torch.serve import (
    CANCELLED,
    DONE,
    EXPIRED,
    RUNNING,
    Job,
    JobQueue,
    JobSpec,
    SearchServer,
)
from symbolicregression_jl_tpu_torch.utils import faults
from symbolicregression_jl_tpu_torch.utils.checkpoint import load_frontier_bytes

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 300

# the JAX serve names the port has not ported yet, each with its ROADMAP item
# (none: serve/pod.py came last)
_UNPORTED: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread (as the fleet tests run) and no leftover fault."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    faults.install(None)


@pytest.fixture
def block(request, monkeypatch):
    """The evolve leg: "event" (unset) or "block" (B3's plain version)."""
    if request.param == "block":
        monkeypatch.setenv("SR_ENGINE_BLOCK", "1")
    else:
        monkeypatch.delenv("SR_ENGINE_BLOCK", raising=False)
    return request.param


LEGS = pytest.mark.parametrize("block", ["event", "block"], indirect=True)


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


def _spec(X, y, **kw):
    kw.setdefault("options", _opts())
    kw.setdefault("niterations", 1)
    return JobSpec(X, y, **kw)


def _direct(X, y, niterations=1, weights=None, **kw):
    return T.equation_search(X, y, weights=weights, options=_opts(**kw),
                             niterations=niterations, verbosity=0)


def _sig(res):
    o = res.options
    return [(m.get_complexity(o), m.loss, m.tree.string_tree(o.operators, precision=17))
            for m in res.pareto_frontier]


def _same_run(got, want):
    assert _sig(got) == _sig(want)
    assert got.num_evals == want.num_evals


# -- queue unit tests (no engine) ----------------------------------------------


def _mkjob(seq, **kw):
    X, y = _problem(n=20)
    return Job(f"j{seq}", _spec(X, y, **kw), seq=seq)


def test_admission_priority_then_warmth_then_fifo():
    q = JobQueue(default_quota=4)
    lo = _mkjob(1, priority=0)
    hi = _mkjob(2, priority=5)
    lo2 = _mkjob(3, priority=0)
    for j in (lo, hi, lo2):
        q.submit(j)
    assert q.acquire(timeout=0) is hi
    assert q.acquire(timeout=0) is lo
    assert q.acquire(timeout=0) is lo2
    assert q.acquire(timeout=0) is None


def test_admission_prefers_warm_bucket_within_priority():
    q = JobQueue(default_quota=4)
    cold = _mkjob(1)
    warm = Job("jw", _spec(*_problem(n=24)), seq=2)
    q.submit(cold)
    q.submit(warm)
    assert q.acquire(warm_buckets={warm.bucket}, timeout=0) is warm
    assert q.acquire(warm_buckets={warm.bucket}, timeout=0) is cold


def test_tenant_quota_bounds_concurrent_running():
    q = JobQueue(default_quota=1, quotas={"big": 2})
    a1 = _mkjob(1, tenant="a")
    a2 = _mkjob(2, tenant="a")
    b1 = _mkjob(3, tenant="big")
    b2 = _mkjob(4, tenant="big")
    for j in (a1, a2, b1, b2):
        q.submit(j)
    assert q.acquire(timeout=0) is a1
    assert q.acquire(timeout=0) is b1
    assert q.acquire(timeout=0) is b2
    assert q.acquire(timeout=0) is None
    q.release(a1)
    assert q.acquire(timeout=0) is a2


def test_take_expired_and_drain():
    q = JobQueue()
    expired = _mkjob(1, deadline_seconds=0.001)
    live = _mkjob(2)
    cancelled = _mkjob(3)
    cancelled.cancel_requested.set()
    for j in (expired, live, cancelled):
        q.submit(j)
    time.sleep(0.01)
    assert set(q.take_expired()) == {expired, cancelled}
    assert len(q) == 1
    assert q.drain() == [live]
    assert len(q) == 0


def test_deadline_none_never_expires():
    q = JobQueue()
    forever = _mkjob(1)
    assert forever.spec.deadline_seconds is None and forever.deadline_at is None
    q.submit(forever)
    assert q.take_expired(now=time.time() + 1e9) == []
    assert q.drain() == [forever]
    srv = SearchServer.__new__(SearchServer)
    opts = srv._lane_options(forever, fingerprint=(), now=time.time())
    assert opts.timeout_in_seconds is None
    assert opts.max_evals is None


def test_options_digest_ignores_seed():
    X, y = _problem()
    assert serve.options_digest(_opts(seed=0)) == serve.options_digest(_opts(seed=99))
    assert serve.shape_bucket(X, y, None, _opts(seed=0)) == serve.shape_bucket(
        X, y, None, _opts(seed=99))
    assert serve.options_digest(_opts()) != serve.options_digest(_opts(maxsize=12))


def _queue_job(q, X, y, seed=0, **kw):
    spec = JobSpec(X=X, y=y, options=_opts(seed=seed), niterations=1, **kw)
    job = Job(f"j{q.n}", spec, q.n)
    q.n += 1
    q.submit(job)
    return job


def _fleet_queue():
    q = JobQueue(default_quota=8)
    q.n = 0
    return q


def test_take_compatible_filters_and_charges_quota():
    X, y = _problem()
    X2, y2 = _problem(n=60, seed=1)
    q = _fleet_queue()
    _queue_job(q, X, y, seed=0)
    lead = q.acquire(timeout=0)
    mate = _queue_job(q, X, y, seed=1)
    _queue_job(q, X2, y2)  # another bucket: left queued
    _queue_job(q, X, y, seed=2, deadline_seconds=3600)  # runs solo: left
    cancelled = _queue_job(q, X, y, seed=3)
    cancelled.cancel_requested.set()
    assert q.take_compatible(lead, limit=8) == [mate]
    assert mate.state == RUNNING
    assert len(q) == 3
    assert q._running_by_tenant["default"] == 2
    q.release(lead)
    q.release(mate)


def test_take_compatible_respects_limit_and_fifo():
    X, y = _problem()
    q = _fleet_queue()
    _queue_job(q, X, y, seed=0)
    lead = q.acquire(timeout=0)
    mates = [_queue_job(q, X, y, seed=i) for i in range(1, 5)]
    assert q.take_compatible(lead, limit=2) == mates[:2]
    assert len(q) == 2


def test_queue_aging_promotes_cold_bucket_job(monkeypatch):
    monkeypatch.setenv("SR_QUEUE_AGE_S", "30")
    X, y = _problem()
    X2, y2 = _problem(n=60, seed=1)
    q = _fleet_queue()
    cold = _queue_job(q, X2, y2)
    warm = _queue_job(q, X, y)
    assert q.acquire(warm_buckets={warm.bucket}, timeout=0) is warm
    q.release(warm)
    q.resubmit(warm)
    cold.submitted_at -= 31
    assert q.acquire(warm_buckets={warm.bucket}, timeout=0) is cold
    q.release(cold)


def test_queue_aging_disabled(monkeypatch):
    monkeypatch.setenv("SR_QUEUE_AGE_S", "0")
    X, y = _problem()
    X2, y2 = _problem(n=60, seed=1)
    q = _fleet_queue()
    cold = _queue_job(q, X2, y2)
    warm = _queue_job(q, X, y)
    cold.submitted_at -= 3600
    assert q.acquire(warm_buckets={warm.bucket}, timeout=0) is warm
    q.release(warm)


def test_subscription_jobspec_validation():
    X, y = _problem(60)
    with pytest.raises(ValueError, match="deadline-less"):
        JobSpec(X=X, y=y, options=_opts(), kind="subscription", deadline_seconds=60)
    with pytest.raises(ValueError, match="kind"):
        JobSpec(X=X, y=y, options=_opts(), kind="nope")
    with pytest.raises(ValueError, match="subscription-only"):
        JobSpec(X=X, y=y, options=_opts(), stream_config={"window": 256})
    sub = JobSpec(X=X, y=y, options=_opts(), kind="subscription", preemptible=True)
    assert sub.preemptible is False
    assert sub.deadline_seconds is None


def test_take_compatible_skips_subscriptions():
    X, y = _problem()
    q = JobQueue(default_quota=8)
    q.submit(Job("lead", JobSpec(X=X, y=y, options=_opts(seed=0)), seq=0))
    lead = q.acquire(timeout=0)
    q.submit(Job("sub", JobSpec(X=X, y=y, options=_opts(seed=1), kind="subscription"),
                 seq=1))
    assert q.take_compatible(lead, limit=8) == []
    assert len(q) == 1
    q.release(lead)


def test_clone_result_does_not_alias_engine_profile():
    class _Res:
        pass

    res = _Res()
    res.hall_of_fame = None
    res.engine_profile = {"counters": {"fused_iter": 3}, "mode": "fleet"}
    srv = SearchServer.__new__(SearchServer)
    clone = srv._clone_result(res)
    assert clone.engine_profile == res.engine_profile
    assert clone.engine_profile is not res.engine_profile
    clone.engine_profile["counters"]["fused_iter"] = 99
    assert res.engine_profile["counters"]["fused_iter"] == 3
    bare = _Res()
    bare.hall_of_fame = None
    assert not hasattr(srv._clone_result(bare), "engine_profile")


# -- exact parity with the JAX package -----------------------------------------


def _admission_script(pkg, serve_mod):
    """One submit/acquire/release script on a package's JobQueue; returns
    the labels in admission order (None where nothing was admissible)."""
    def spec(n, **kw):
        X, y = _problem(n=n)
        o = pkg.Options(binary_operators=["+", "-", "*"], unary_operators=["cos"],
                        populations=2, population_size=12, maxsize=10,
                        save_to_file=False, seed=kw.pop("seed", 0))
        return serve_mod.JobSpec(X, y, options=o, niterations=1, **kw)

    q = serve_mod.JobQueue(default_quota=2, quotas={"big": 3, "one": 1})
    rows = {"a": 20, "b": 24, "c": 28}
    plan = [("p0a", 0, "default", "a"), ("p5a", 5, "default", "a"),
            ("p0b", 0, "big", "b"), ("p0c", 0, "one", "c"), ("p1b", 1, "big", "b"),
            ("p0c2", 0, "one", "c"), ("p0a2", 0, "default", "a"), ("p5b", 5, "big", "b"),
            ("p0b2", 0, "big", "b"), ("p1a", 1, "default", "a")]
    jobs = {}
    for seq, (label, prio, tenant, bucket) in enumerate(plan):
        jobs[label] = serve_mod.Job(label, spec(rows[bucket], priority=prio, tenant=tenant,
                                                seed=seq), seq=seq)
        q.submit(jobs[label])
    jobs["p0c2"].submitted_at -= 100  # aged past SR_QUEUE_AGE_S
    warm = {jobs["p0b"].bucket}
    out = []
    for step in range(14):
        got = q.acquire(warm_buckets=warm, timeout=0)
        out.append(None if got is None else got.id)
        if got is None or step % 3 == 2:
            for label in list(out):
                if label is not None and jobs[label].quota_held:
                    q.release(jobs[label])
                    break
    return out


def test_admission_order_equals_jax(monkeypatch):
    monkeypatch.setenv("SR_QUEUE_AGE_S", "30")
    got = _admission_script(T, serve)
    assert got == _admission_script(J, jserve)
    assert sum(x is not None for x in got) == 10  # every job admitted


BUCKETS = [
    dict(),
    dict(maxsize=14),
    dict(binary_operators=["+", "*"], unary_operators=["exp", "abs"]),
    dict(scheduler="lockstep"),
    dict(elementwise_loss="L1DistLoss"),
    dict(batching=True, batch_size=20),
    dict(populations=100, population_size=100, maxsize=20,
         binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp", "abs"]),
]


@pytest.mark.parametrize("kw", BUCKETS, ids=lambda kw: ",".join(kw) or "default")
@pytest.mark.parametrize("weighted", [False, True])
def test_bucket_digest_equals_jax(kw, weighted):
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=2,
                population_size=12, maxsize=10, seed=3, scheduler="device")
    base.update(kw)
    X, y = _problem(n=50)
    w = np.ones_like(y) if weighted else None
    got = serve.bucket_digest(serve.shape_bucket(X, y, w, T.Options(device="cpu", **base)))
    want = jserve.bucket_digest(jserve.shape_bucket(X, y, w, J.Options(**base)))
    assert got == want and len(got) == 12


def _same_jobs(pkg, serve_mod, load, spool):
    """The same lockstep jobs on a package's server: a blocker, a job whose
    deadline passes in the queue, a cancelled queued job, and two jobs
    streaming every iteration and every second one. Returns each job's
    (state, frames, iterations_done, started)."""
    X, y = _problem(n=60)

    def opts():
        return pkg.Options(binary_operators=["+", "-", "*"], unary_operators=["cos"],
                           populations=2, population_size=8, ncycles_per_iteration=8,
                           maxsize=10, save_to_file=False, seed=0, scheduler="lockstep",
                           **({"device": "cpu"} if pkg is T else {}))

    with serve_mod.SearchServer(max_concurrency=1, spool_dir=spool) as srv:
        srv.pause_admission()
        ids = [srv.submit(serve_mod.JobSpec(X, y, options=opts(), niterations=2)),
               srv.submit(serve_mod.JobSpec(X, y, options=opts(), niterations=1,
                                            deadline_seconds=0.05)),
               srv.submit(serve_mod.JobSpec(X, y, options=opts(), niterations=1)),
               srv.submit(serve_mod.JobSpec(X, y, options=opts(), niterations=3)),
               srv.submit(serve_mod.JobSpec(X, y, options=opts(), niterations=3,
                                            stream_every=2))]
        srv.cancel(ids[2])
        time.sleep(0.1)  # the deadline passes while queued
        srv.resume_admission()
        jobs = [srv.wait(i, timeout=TIMEOUT) for i in ids]
        out = []
        for j in jobs:
            frames = srv.frames(j.id)
            last = [(u.iteration, u.niterations) for u in map(load, frames[-1:])]
            out.append((j.state, len(frames), j.iterations_done, j.started_at is not None,
                        last))
        return out


def test_same_jobs_same_outcomes_on_both_servers(tmp_path):
    got = _same_jobs(T, serve, load_frontier_bytes, str(tmp_path / "port"))
    want = _same_jobs(J, jserve, j_load_frontier_bytes, str(tmp_path / "jax"))
    assert got == want
    assert [g[0] for g in got] == [DONE, EXPIRED, CANCELLED, DONE, DONE]


def test_serve_all_equals_jax_minus_unported():
    assert set(_UNPORTED) <= set(jserve.__all__)
    assert serve.__all__ == [n for n in jserve.__all__ if n not in _UNPORTED]
    for name in serve.__all__:
        assert hasattr(serve, name), name
    assert not set(serve.__all__) & set(T.__all__)  # the root exports no serve name
    assert not set(jserve.__all__) & set(J.__all__)


def test_serve_runs_with_jax_blocked():
    """The serve modules import, and a lockstep job runs to DONE with a
    decodable frame, in a process where importing jax or the JAX package
    fails."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "symbolicregression_jl_tpu"):
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        import symbolicregression_jl_tpu_torch as T
        from symbolicregression_jl_tpu_torch.serve import (
            journal, program_cache, queue, server, JobSpec, SearchServer)
        from symbolicregression_jl_tpu_torch.utils.checkpoint import load_frontier_bytes
        rng = np.random.default_rng(0)
        X = rng.normal(size=(2, 40)).astype(np.float32)
        y = (X[0] * X[1]).astype(np.float32)
        o = T.Options(binary_operators=["+", "*"], populations=2, population_size=8,
                      ncycles_per_iteration=5, maxsize=8, save_to_file=False,
                      scheduler="lockstep", device="cpu")
        with SearchServer(max_concurrency=1) as srv:
            job = srv.wait(srv.submit(JobSpec(X, y, options=o, niterations=1)), timeout=120)
            assert job.state == "done", job.summary()
            assert load_frontier_bytes(srv.frames(job.id)[-1]).members
        assert not any(m == "jax" or m.startswith(("jax.", "symbolicregression_jl_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# -- daemon tests (the port's engine on the CPU) -------------------------------


def test_jobs_run_stream_and_finish(tmp_path):
    X, y = _problem()
    with SearchServer(max_concurrency=2, spool_dir=str(tmp_path)) as srv:
        ids = [srv.submit(_spec(X, y, tenant="acme", niterations=2, label="a")),
               srv.submit(_spec(X, y, tenant="acme", niterations=2, label="b")),
               srv.submit(_spec(X, y, tenant="zeta", niterations=2, label="c"))]
        jobs = [srv.wait(i, timeout=TIMEOUT) for i in ids]
        for job in jobs:
            assert job.state == DONE, job.summary()
            assert job.ttff is not None and job.ttff > 0
            frames = srv.frames(job.id)
            assert len(frames) >= 2  # per iteration, plus the definitive final frame
            upd = load_frontier_bytes(frames[-1])
            assert upd.iteration == 2 and upd.niterations == 2
            assert len(upd.members) >= 1
            assert min(m.loss for m in upd.members) < 10.0
        st = srv.stats()
        assert st["jobs"][DONE] == 3
        assert st["program_cache"]["hits"] > 0  # the dataset's upload
        assert 0.0 <= st["warm_hit_ratio"] <= 1.0


def test_deadline_expires_while_queued(tmp_path):
    X, y = _problem()
    with SearchServer(max_concurrency=1, spool_dir=str(tmp_path)) as srv:
        blocker = srv.submit(_spec(X, y, niterations=2))
        doomed = srv.submit(_spec(X, y, deadline_seconds=0.05))
        job = srv.wait(doomed, timeout=TIMEOUT)
        assert job.state == EXPIRED
        assert job.started_at is None
        assert srv.wait(blocker, timeout=TIMEOUT).state == DONE


def test_cancel_queued_job(tmp_path):
    X, y = _problem()
    with SearchServer(max_concurrency=1, spool_dir=str(tmp_path)) as srv:
        blocker = srv.submit(_spec(X, y, niterations=2))
        victim = srv.submit(_spec(X, y))
        srv.cancel(victim)
        job = srv.wait(victim, timeout=TIMEOUT)
        assert job.state == CANCELLED
        assert job.started_at is None
        assert srv.wait(blocker, timeout=TIMEOUT).state == DONE


def test_preemption_checkpoints_and_resumes(tmp_path):
    """The low job is held at its first iteration boundary until the high
    job is submitted, so the preemption lands there: a spool snapshot, a
    requeue, the high job, then the low job's warm-started remainder."""
    X, y = _problem()
    arrived, go = threading.Event(), threading.Event()

    def hold(report):
        if report.iteration == 1 and not go.is_set():
            arrived.set()
            go.wait(TIMEOUT)
        return None

    with SearchServer(max_concurrency=1, spool_dir=str(tmp_path)) as srv:
        low = srv.submit(_spec(X, y, options=_opts(iteration_callback=hold), niterations=4,
                               priority=0, label="low", tenant="bulk"))
        assert arrived.wait(TIMEOUT), "low job never reached an iteration boundary"
        high = srv.submit(_spec(X, y, niterations=1, priority=5, label="high", tenant="vip"))
        go.set()
        hj = srv.wait(high, timeout=TIMEOUT)
        assert hj.state == DONE
        lj = srv.wait(low, timeout=TIMEOUT)
        assert lj.state == DONE, lj.summary()
        assert lj.preemptions == 1
        assert lj.resume_path is not None
        assert lj.iterations_done == 4
        last = load_frontier_bytes(srv.frames(low)[-1])
        assert last.iteration == 4 and last.niterations == 4
        assert hj.finished_at <= lj.finished_at
        assert lj.result.num_evals > load_frontier_bytes(srv.frames(low)[0]).num_evals


def test_stats_expose_degradation_counters(tmp_path):
    with SearchServer(max_concurrency=1, journal_dir=str(tmp_path / "j")) as srv:
        s = srv.stats()
        assert s["journal_read_only"] is False
        assert s["journal_shed"] == 0
        assert s["oom_downshifts"] == 0
        assert s["skew_suspects_suppressed"] == 0
        assert s["journal"]["shed_submits"] == 0


def test_clock_skew_suppresses_stall_watchdog(tmp_path):
    X, y = _problem()
    faults.install("clock_skew@3:offset_s=600")
    srv = SearchServer(max_concurrency=1, stall_seconds=1.5, poll_seconds=0.05,
                       spool_dir=str(tmp_path)).start()
    try:
        job = srv.wait(srv.submit(_spec(X, y, niterations=3)), timeout=TIMEOUT)
        assert job.state == DONE, job.summary()
        assert job.attempts == 1
        deadline = time.monotonic() + 30
        while srv.stats()["skew_suspects_suppressed"] < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert srv.stats()["skew_suspects_suppressed"] >= 1
    finally:
        srv.shutdown()
        faults.install(None)


# -- bit for bit against the port's direct runs --------------------------------


@LEGS
def test_served_job_equals_direct_run(block, tmp_path):
    X, y = _problem()
    want = _direct(X, y, niterations=2, seed=4)
    with SearchServer(max_concurrency=1, spool_dir=str(tmp_path)) as srv:
        job = srv.wait(srv.submit(_spec(X, y, options=_opts(seed=4), niterations=2)),
                       timeout=TIMEOUT)
        assert job.state == DONE, job.summary()
        _same_run(job.result, want)
        assert job.result.engine_stats["block"] == (None if block == "event" else "plain")
        final = load_frontier_bytes(srv.frames(job.id)[-1])
        assert sorted((m.loss for m in final.members)) == sorted(
            m.loss for m in want.pareto_frontier)


def test_pause_admission_holds_jobs_submitted_after_it():
    """Once ``pause_admission`` returns, no worker takes a job submitted
    after it, even a worker that was already waiting in the queue's
    acquire (a coalesced fleet's lead once started alone that way, its
    mates submitted after it); the job starts when admission resumes."""
    X, y = _problem(n=40)
    with SearchServer(max_concurrency=2, fleet=True, fleet_window_s=0.0,
                      default_quota=8) as srv:
        for k in range(4):
            time.sleep(0.05)  # both workers idle, one of them inside acquire
            srv.pause_admission()
            jid = srv.submit(_spec(X, y, options=_opts(scheduler="lockstep", seed=k)))
            time.sleep(3 * srv.poll_seconds)
            # a worker that took it while waiting in acquire hands it back
            # at once: it is queued again and never started
            deadline = time.monotonic() + 5.0
            while srv.job(jid).state != serve.QUEUED and time.monotonic() < deadline:
                time.sleep(0.01)
            assert srv.job(jid).state == serve.QUEUED and srv.job(jid).started_at is None
            srv.resume_admission()
            assert srv.wait(jid, timeout=TIMEOUT).state == DONE


@LEGS
def test_server_coalesces_same_bucket_jobs(block, tmp_path):
    """Same-bucket jobs with distinct seeds, queued together, run as ONE
    fleet; each equals its direct solo run bit for bit and streams its own
    frames."""
    X, y = _problem()
    seeds = (0, 11, 5)
    with SearchServer(max_concurrency=2, fleet=True, fleet_max=4, fleet_window_s=0.5,
                      default_quota=8, spool_dir=str(tmp_path)) as srv:
        srv.pause_admission()
        ids = [srv.submit(_spec(X, y, options=_opts(seed=s), niterations=2)) for s in seeds]
        srv.resume_admission()
        jobs = [srv.wait(i, timeout=TIMEOUT) for i in ids]
        assert all(j.state == DONE for j in jobs), [j.summary() for j in jobs]
        st = srv.stats()["fleet"]
        assert st["batches"] == 1 and st["coalesced_lanes"] == 3, st
        assert st["deduped_lanes"] == 0, st
        for j, s in zip(jobs, seeds):
            _same_run(j.result, _direct(X, y, niterations=2, seed=s))
            assert j.result.engine_stats["fleet"]["lanes"] == 3
            frames = srv.frames(j.id)
            assert len(frames) == 3  # two iterations, then the final frame
            assert load_frontier_bytes(frames[-1]).iteration == 2


@LEGS
def test_server_dedups_identical_jobs(block, tmp_path):
    """Identical jobs collapse onto ONE search: one coalesced batch, every
    rider DONE with its own result object equal to the direct run."""
    X, y = _problem()
    want = _direct(X, y, seed=2)
    with SearchServer(max_concurrency=1, fleet=True, fleet_max=4, fleet_window_s=0.5,
                      default_quota=8, spool_dir=str(tmp_path)) as srv:
        srv.pause_admission()
        ids = [srv.submit(_spec(X, y, options=_opts(seed=2))) for _ in range(4)]
        srv.resume_admission()
        jobs = [srv.wait(i, timeout=TIMEOUT) for i in ids]
        assert all(j.state == DONE for j in jobs), [j.summary() for j in jobs]
        st = srv.stats()["fleet"]
        assert st["batches"] == 1 and st["coalesced_lanes"] == 4, st
        assert st["deduped_lanes"] == 3, st
        for j in jobs:
            _same_run(j.result, want)
            assert len(srv.frames(j.id)) > 0
        assert len({id(j.result) for j in jobs}) == 4
        # one search ran: the riders' results carry the leader's engine stats
        assert "fleet" not in jobs[0].result.engine_stats


@LEGS
def test_cancelled_lane_leaves_the_survivor_its_bits(block, tmp_path):
    """Cancel one lane of a two-lane fleet at its first iteration boundary:
    it ends CANCELLED, and the fleet stops running it while the other lane
    goes on to equal its direct solo run bit for bit."""
    X, y = _problem()
    srv = SearchServer(max_concurrency=1, fleet=True, fleet_max=2, fleet_window_s=0.5,
                       spool_dir=str(tmp_path))
    ids = []

    def cancel_me(report):
        srv.cancel(ids[0])
        return None

    with srv:
        srv.pause_admission()
        ids.append(srv.submit(_spec(X, y, options=_opts(seed=1, iteration_callback=cancel_me),
                                    niterations=3)))
        ids.append(srv.submit(_spec(X, y, options=_opts(seed=7), niterations=3)))
        srv.resume_admission()
        gone, kept = (srv.wait(i, timeout=TIMEOUT) for i in ids)
        assert srv.stats()["fleet"]["batches"] == 1
        assert gone.state == CANCELLED and gone.iterations_done == 1
        assert gone.result.engine_stats["iterations"] == 1
        assert kept.state == DONE, kept.summary()
        assert kept.result.engine_stats["iterations"] == 3
        _same_run(kept.result, _direct(X, y, niterations=3, seed=7))


def test_fleet_oom_compile_downshifts_and_completes(tmp_path):
    """An injected out-of-memory error at the fleet's build (the
    ``oom_compile`` site, JAX kind ``fleet_aot``) halves the batch and
    finishes every lane: no failed jobs, no quarantine, no retry-budget
    burn, and each lane still equals its direct run."""
    X, y = _problem()
    faults.install("oom_compile@0:kind=fleet_aot")
    srv = SearchServer(max_concurrency=1, fleet=True, fleet_max=2, fleet_window_s=0.5,
                       spool_dir=str(tmp_path)).start()
    try:
        srv.pause_admission()
        ids = [srv.submit(_spec(X, y, options=_opts(seed=s))) for s in (0, 11)]
        srv.resume_admission()
        jobs = [srv.wait(i, timeout=TIMEOUT) for i in ids]
        assert all(j.state == DONE for j in jobs), [j.summary() for j in jobs]
        assert all(j.attempts == 1 for j in jobs)
        s = srv.stats()
        assert s["oom_downshifts"] >= 1, s
        assert s["quarantined"] == 0
        for j, seed in zip(jobs, (0, 11)):
            _same_run(j.result, _direct(X, y, seed=seed))
    finally:
        srv.shutdown()
        faults.install(None)


def test_server_subscription_stream_push_cancel(tmp_path):
    """A subscription streams frames, takes live row pushes (rows pushed
    before admission included), and ends DONE on client cancel with the
    final result attached."""
    X, y = _problem(n=60)
    with SearchServer(max_concurrency=1, spool_dir=str(tmp_path)) as srv:
        jid = srv.submit(JobSpec(X=X, y=y, options=_opts(), kind="subscription",
                                 stream_config={"row_bucket": 64}))
        Xn, yn = _problem(n=4, seed=3)
        srv.push_rows(jid, Xn, yn)  # staged: flushed when the session exists
        first = next(iter(srv.stream(jid, timeout=TIMEOUT)))
        assert first is not None
        job = srv.job(jid)
        assert job.session is not None
        deadline = time.monotonic() + TIMEOUT
        while job.session.stats.rows != 64:
            assert time.monotonic() < deadline, job.session.stats.summary()
            time.sleep(0.05)
        srv.cancel(jid)
        job = srv.wait(jid, timeout=TIMEOUT)
        assert job.state == DONE, job.summary()
        assert job.stop_reason == "cancelled"
        assert job.result is not None
        assert len(srv.frames(jid)) >= 1
        with pytest.raises(ValueError, match="not a subscription"):
            srv.push_rows(srv.submit(_spec(X, y)), Xn, yn)


def test_stream_swap_keeps_the_cached_score_data(tmp_path):
    """A subscription's lane starts from the program cache's ScoreData of
    its dataset; a replace_rows swap writes the lane's tensors (views of the
    fleet's stack) and leaves every cached entry bit-identical. A later job
    on the original dataset hits the entry and equals its direct run."""
    X, y = _problem(n=64, seed=2)
    w = np.ones_like(y)  # the session's explicit weights (64 rows = its bucket)
    want = _direct(X, y, niterations=1, weights=w, seed=3)  # uploads the entry
    cache = ds.PROGRAM_CACHE
    entries = {k: [None if t is None else t.clone() for t in cache.get(*k)]
               for k in cache.keys("score_data")}
    arrived, go = threading.Semaphore(0), threading.Semaphore(0)

    def gate(report):
        arrived.release()
        go.acquire(timeout=TIMEOUT)
        return None

    y_new = (X[0] * X[1]).astype(np.float32)
    with SearchServer(max_concurrency=1, spool_dir=str(tmp_path)) as srv:
        sub = srv.submit(JobSpec(X=X, y=y, options=_opts(seed=3, iteration_callback=gate),
                                 kind="subscription", stream_config={"row_bucket": 64}))
        assert arrived.acquire(timeout=TIMEOUT)
        before = cache.stats()["by_kind"]["score_data"]
        srv.replace_rows(sub, X, y_new)
        go.release()
        assert arrived.acquire(timeout=TIMEOUT)  # the swap landed at this boundary
        lane = srv.job(sub).session._lane
        assert torch.equal(lane.data.y, torch.from_numpy(y_new))
        srv.cancel(sub)
        go.release()
        assert srv.wait(sub, timeout=TIMEOUT).state == DONE
        for k, saved in entries.items():
            for a, b in zip(cache.get(*k), saved):
                assert (a is None and b is None) or torch.equal(a, b), k
        job = srv.wait(srv.submit(_spec(X, y, weights=w, options=_opts(seed=3))),
                       timeout=TIMEOUT)
        assert job.state == DONE, job.summary()
        after = cache.stats()["by_kind"]["score_data"]
        assert after["misses"] == before["misses"] and after["hits"] > before["hits"]
        _same_run(job.result, want)


def test_concurrent_served_jobs_keep_their_bits(tmp_path):
    """Two jobs on two workers at once (the card's case): each equals its
    direct run bit for bit."""
    X, y = _problem()
    X2, y2 = _problem(n=48, seed=9)
    with SearchServer(max_concurrency=2, spool_dir=str(tmp_path)) as srv:
        srv.pause_admission()
        a = srv.submit(_spec(X, y, options=_opts(seed=1), niterations=2))
        b = srv.submit(_spec(X2, y2, options=_opts(seed=2), niterations=2))
        srv.resume_admission()
        ja, jb = srv.wait(a, timeout=TIMEOUT), srv.wait(b, timeout=TIMEOUT)
        assert ja.state == DONE and jb.state == DONE
        _same_run(ja.result, _direct(X, y, niterations=2, seed=1))
        _same_run(jb.result, _direct(X2, y2, niterations=2, seed=2))


def test_journaled_specs_pickle():
    """A journaled spec must pickle to survive a crash: the port's Options
    (the device engine's, the subscription's) do."""
    X, y = _problem()
    jr = serve.JobJournal.__new__(serve.JobJournal)
    appended = []
    jr.append = lambda *a, **kw: appended.append(kw)
    jr._lock = threading.Lock()
    jr._undurable = 0
    for spec in (_spec(X, y), _spec(X, y, options=_opts(device="cuda")),
                 JobSpec(X=X, y=y, options=_opts(), kind="subscription",
                         stream_config={"row_bucket": 64})):
        assert jr.append_submit(Job("j", spec, seq=1)) is True
    assert all(kw["spec"] is not None for kw in appended)
    restored = __import__("pickle").loads(appended[0]["spec"])
    assert restored.options.operators == _opts().operators
    assert copy.deepcopy(restored).niterations == 1
