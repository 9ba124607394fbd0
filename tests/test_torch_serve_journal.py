"""The port's durable serve runtime (``serve/journal.py`` and the server's
journal, recovery, retry, supervision and backpressure paths) against the
JAX package's, on the CPU.

Mirrors the 20 tier-1 tests of tests/test_serve_journal.py (and its slow
SIGKILL drill) on the port. Engine-driving tests use tiny LOCKSTEP configs,
whose snapshots are exact, so resume assertions demand bit-exact
frontiers. Beyond the mirror, exact journal parity: one record sequence
written by either package replays to the same merged state in the other
(spec bytes aside: each package pickles its own JobSpec), and a torn tail
is cut at the same offset by both at every offset.
"""

import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import symbolicregression_jl_tpu.serve as jserve
from symbolicregression_jl_tpu_torch import Options, equation_search
from symbolicregression_jl_tpu_torch import serve
from symbolicregression_jl_tpu_torch.serve import (
    DONE,
    QUARANTINED,
    Job,
    JobJournal,
    JobSpec,
    SearchServer,
    ServerOverloaded,
)
from symbolicregression_jl_tpu_torch.serve.journal import JOURNAL_MAGIC
from symbolicregression_jl_tpu_torch.utils import faults
from symbolicregression_jl_tpu_torch.utils.checkpoint import (
    load_frontier_bytes,
    peek_checkpoint_meta,
)

ROOT = Path(__file__).resolve().parent.parent


def _problem(n=60, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2, n)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    return X, y


def _opts(**kw):
    base = dict(
        binary_operators=["+", "-", "*"],
        unary_operators=["cos"],
        populations=2,
        population_size=8,
        ncycles_per_iteration=8,
        maxsize=10,
        save_to_file=False,
        seed=0,
        scheduler="lockstep",
        device="cpu",
        progress=False,
    )
    base.update(kw)
    return Options(**base)


def _spec(X, y, **kw):
    kw.setdefault("options", _opts())
    kw.setdefault("niterations", 2)
    return JobSpec(X, y, **kw)


def _frontier(result, options):
    return sorted(
        (m.get_complexity(options), float(m.loss))
        for m in result.hall_of_fame.pareto_frontier()
    )


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    faults.install(None)


# -- journal unit tests (no engine) --------------------------------------------


def test_journal_roundtrip_and_merge(tmp_path):
    d = str(tmp_path / "jr")
    jr = JobJournal(d)
    assert jr.replay() == {}
    jr.append("submit", "j1", seq=1, submitted_at=1.5, spec=b"S", kind="search")
    jr.append("start", "j1", attempts=1, ckpt="/spool/j1.engine")
    jr.append("progress", "j1", fsync=False, iterations_done=7)
    jr.append("requeue", "j1", attempts=1, not_before=9.0, error="E",
              ckpt="/spool/j1.ckpt")
    jr.append("submit", "j2", seq=2, submitted_at=2.5, spec=b"T", kind="search")
    jr.append("terminal", "j2", state="done", error=None)
    jr.close()

    st = JobJournal(d).replay()
    assert set(st) == {"j1", "j2"}
    assert st["j1"]["state"] == "queued"  # requeue flipped it back
    assert st["j1"]["attempts"] == 1
    assert st["j1"]["not_before"] == 9.0
    assert st["j1"]["iterations_done"] == 7
    assert st["j1"]["ckpt"] == "/spool/j1.ckpt"  # requeue's ckpt wins
    assert st["j1"]["spec"] == b"S"
    assert st["j2"]["state"] == "done"


def test_journal_rotation_compacts_and_tombstones(tmp_path):
    d = str(tmp_path / "jr")
    jr = JobJournal(d)
    jr.append("submit", "live", seq=1, submitted_at=1.0, spec=b"L",
              kind="search")
    jr.append("submit", "dead", seq=2, submitted_at=2.0, spec=b"D",
              kind="search")
    jr.append("terminal", "dead", state="done", error=None)
    for i in range(50):  # heartbeat chatter the compaction should fold away
        jr.append("progress", "live", fsync=False, iterations_done=i)
    size_before = os.path.getsize(jr.path)
    jr.rotate()
    jr.close()
    st = JobJournal(d).replay()
    assert st["live"]["spec"] == b"L"  # live jobs keep their spec
    assert st["live"]["iterations_done"] == 49
    assert st["dead"]["state"] == "done" and st["dead"]["spec"] is None
    assert os.path.getsize(os.path.join(d, "journal.log")) < size_before


def test_journal_torn_tail_truncated_at_every_offset(tmp_path):
    """Truncate the log at EVERY byte offset inside the last record: replay
    must never raise, never invent a job, and always leave an appendable
    file behind."""
    d = str(tmp_path / "jr")
    jr = JobJournal(d)
    jr.append("submit", "j1", seq=1, submitted_at=1.0, spec=b"S",
              kind="search")
    committed = os.path.getsize(jr.path)
    jr.append("terminal", "j1", state="done", error=None)
    jr.close()
    full = open(jr.path, "rb").read()
    assert committed > len(JOURNAL_MAGIC) and committed < len(full)

    for cut in range(committed, len(full) + 1):
        d2 = str(tmp_path / f"cut{cut}")
        os.makedirs(d2)
        with open(os.path.join(d2, "journal.log"), "wb") as f:
            f.write(full[:cut])
        jr2 = JobJournal(d2)
        st = jr2.replay()  # must not raise at any offset
        assert set(st) == {"j1"}  # never invents, never loses the committed
        if cut == len(full):
            assert st["j1"]["state"] == "done"
        else:
            assert st["j1"]["state"] == "queued"
            # the torn tail is physically gone: the file ends on the last
            # good frame and appends land cleanly
            assert os.path.getsize(jr2.path) == committed
        jr2.append("progress", "j1", fsync=False, iterations_done=3)
        jr2.close()
        st3 = JobJournal(d2).replay()
        assert st3["j1"]["iterations_done"] == 3


def test_journal_torn_write_fault_site(tmp_path):
    d = str(tmp_path / "jr")
    jr = JobJournal(d)
    jr.append("submit", "j1", seq=1, submitted_at=1.0, spec=b"S",
              kind="search")
    faults.install("journal_torn_write@0")
    with pytest.raises(faults.FaultInjected):
        jr.append("terminal", "j1", state="done", error=None)
    faults.install(None)
    jr.close()
    st = JobJournal(d).replay()
    assert st["j1"]["state"] == "queued"  # half-written terminal discarded
    assert JobJournal(d).stats()["path"].endswith("journal.log")


def test_journal_rotation_races_concurrent_appends(tmp_path):
    """Rotation (forced by a tiny max_bytes AND called
    explicitly from a racing thread) must never drop a record appended
    concurrently — both serialize on the journal lock, so the merged state
    after replay accounts for every job."""
    import threading

    d = str(tmp_path / "jr")
    jr = JobJournal(d, fsync=False, max_bytes=2048)
    n_threads, n_jobs = 4, 12
    stop = threading.Event()

    def submitter(t):
        for i in range(n_jobs):
            jid = f"t{t}-j{i}"
            jr.append("submit", jid, seq=t * 100 + i, submitted_at=float(i),
                      spec=b"S", kind="search")
            jr.append("progress", jid, fsync=False, iterations_done=1)
            jr.append("terminal", jid, state="done", error=None)

    def rotator():
        while not stop.is_set():
            jr.rotate()

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(n_threads)]
    rot = threading.Thread(target=rotator)
    rot.start()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    stop.set()
    rot.join()
    assert jr.stats()["rotations"] > 0
    jr.close()
    st = JobJournal(d).replay()
    want = {f"t{t}-j{i}" for t in range(n_threads) for i in range(n_jobs)}
    assert set(st) == want  # zero lost, zero invented
    assert all(s["state"] == "done" for s in st.values())


# -- disk-full degradation ------------------------------------------------------


def test_journal_disk_full_sheds_submit_then_rearms(tmp_path):
    """The full ENOSPC protocol: emergency compaction + retry, running-job
    records buffered while read-only, submits refused with JournalDiskFull,
    and the first successful append re-arms and drains the buffer in order."""
    from symbolicregression_jl_tpu_torch.serve.journal import JournalDiskFull

    d = str(tmp_path / "jr")
    jr = JobJournal(d, fsync=False)
    jr.append("submit", "j1", seq=1, submitted_at=1.0, spec=b"S",
              kind="search")
    # clear=2: the firing append, the post-compaction retry, and one more
    # all see a full disk — the journal stays read-only across the window
    faults.install("disk_full@0:path=journal,clear=2")
    jr.append("progress", "j1", fsync=False, iterations_done=5)  # buffered
    s = jr.stats()
    assert s["read_only"] and s["buffered_records"] == 1
    assert s["enospc_events"] == 1 and s["emergency_compactions"] == 1
    with pytest.raises(JournalDiskFull):
        jr.append("submit", "j2", seq=2, submitted_at=2.0, spec=b"S",
                  kind="search")
    assert jr.stats()["shed_submits"] == 1
    # space returns: this append is the probe — it re-arms and drains the
    # buffered progress record FIRST so replay order matches append order
    jr.append("progress", "j1", fsync=False, iterations_done=9)
    s = jr.stats()
    assert not s["read_only"] and s["buffered_records"] == 0
    assert s["rearms"] == 1
    faults.install(None)
    jr.close()
    st = JobJournal(d).replay()
    assert set(st) == {"j1"}  # the shed submit is NOT in the journal
    assert st["j1"]["iterations_done"] == 9


def test_journal_enospc_partial_write_never_poisons_the_tail(tmp_path):
    """A REAL ENOSPC can cut a frame mid-write; the pre-write-offset
    truncation must remove the partial frame so later appends replay
    cleanly instead of being lost to torn-tail truncation."""
    import errno as _e

    d = str(tmp_path / "jr")
    jr = JobJournal(d, fsync=False)
    jr.append("submit", "j1", seq=1, submitted_at=1.0, spec=b"S",
              kind="search")

    class _HalfThenFail:
        def __init__(self, fh):
            self.fh = fh
            self.fail_next = False

        def write(self, b):
            if self.fail_next:
                self.fail_next = False
                self.fh.write(b[: max(1, len(b) // 2)])
                raise OSError(_e.ENOSPC, "No space left on device")
            return self.fh.write(b)

        def __getattr__(self, name):
            return getattr(self.fh, name)

    wrapped = _HalfThenFail(jr._fh)
    jr._fh = wrapped
    wrapped.fail_next = True
    # the first write tears mid-frame; the pre-write offset is truncated
    # back, the emergency-compaction retry succeeds, and the record lands
    jr.append("progress", "j1", fsync=False, iterations_done=3)
    s = jr.stats()
    assert s["enospc_events"] == 1 and not s["read_only"]
    jr.append("terminal", "j1", state="done", error=None)
    jr.close()
    st1 = JobJournal(d).replay()
    st2 = JobJournal(d).replay()
    assert st1 == st2  # no torn tail left behind
    assert st1["j1"]["state"] == "done"
    assert st1["j1"]["iterations_done"] == 3  # the buffered record survived


def test_server_submit_shed_on_disk_full_then_accepts(tmp_path):
    """SearchServer maps JournalDiskFull to ServerOverloaded (client
    retries later) and exposes the degradation in stats(); once space
    returns the SAME submit succeeds."""
    X, y = _problem()
    faults.install("disk_full@0:path=journal,clear=1")
    with SearchServer(
        max_concurrency=1, journal_dir=str(tmp_path / "j")
    ) as srv:
        with pytest.raises(ServerOverloaded):
            srv.submit(_spec(X, y, niterations=1))
        s = srv.stats()
        assert s["journal_shed"] == 1
        assert s["journal_read_only"] is True
        # space back: the resubmit is accepted and runs to DONE
        jid = srv.submit(_spec(X, y, niterations=1))
        assert srv.wait(jid, timeout=600).state == DONE
        s = srv.stats()
        assert s["journal_read_only"] is False
        assert s["journal"]["rearms"] == 1
    faults.install(None)


# -- crash recovery ------------------------------------------------------------


def test_recover_queued_job_runs_to_done(tmp_path):
    jdir = str(tmp_path / "journal")
    X, y = _problem()
    spec = _spec(X, y)
    jr = JobJournal(jdir)
    jr.append_submit(Job("job-00001", spec, seq=1))
    jr.close()

    with SearchServer(max_concurrency=1, journal_dir=jdir) as srv:
        st = srv.stats()
        assert st["journal"]["enabled"]
        assert st["journal"]["recovered"]["queued"] == 1
        job = srv.wait("job-00001", timeout=600)
        assert job.state == DONE, job.summary()
        assert len(srv.frames("job-00001")) >= 1
    # the journal dir (and its spool) survive shutdown for the NEXT restart
    assert os.path.exists(os.path.join(jdir, "journal.log"))


def test_recover_running_job_resumes_bit_exact(tmp_path):
    """A job that was RUNNING when the server died resumes from its latest
    engine spool checkpoint — and because lockstep engine snapshots are
    exact, the recovered job's final frontier is bit-identical to an
    uninterrupted run (the established resume semantics)."""
    jdir = str(tmp_path / "journal")
    spool = os.path.join(jdir, "spool")
    os.makedirs(spool)
    X, y = _problem()
    opts = _opts()
    niter = 4

    reference = equation_search(
        X, y, options=opts, niterations=niter, verbosity=0
    )

    # simulate the dying server's partial run: engine checkpoints into the
    # spool under the job's base, killed after iteration 2
    base = os.path.join(spool, "job-00001.engine")
    partial_opts = _opts(
        checkpoint_every=1,
        checkpoint_file=base,
        iteration_callback=lambda rep: rep.iteration >= 2,
    )
    equation_search(X, y, options=partial_opts, niterations=niter, verbosity=0)
    meta = peek_checkpoint_meta(base)
    assert meta["exact"] and meta["scheduler"] == "lockstep"
    assert 1 <= meta["iteration"] < niter

    jr = JobJournal(jdir)
    job = Job("job-00001", _spec(X, y, niterations=niter), seq=1)
    jr.append_submit(job)
    jr.append("start", "job-00001", attempts=1, ckpt=base)
    jr.close()

    with SearchServer(max_concurrency=1, journal_dir=jdir) as srv:
        st = srv.stats()
        assert st["journal"]["recovered"]["running"] == 1
        assert st["journal"]["recovered"]["resumed"] == 1
        job = srv.wait("job-00001", timeout=600)
        assert job.state == DONE, job.summary()
        assert job.resumed_from_iteration == meta["iteration"]
        assert job.iterations_done == niter  # full budget, not restarted
        final = load_frontier_bytes(srv.frames("job-00001")[-1])
        assert final.iteration == niter and final.niterations == niter
        assert _frontier(job.result, opts) == _frontier(reference, opts)


def test_recover_terminal_job_reported_once_not_rerun(tmp_path):
    jdir = str(tmp_path / "journal")
    X, y = _problem()
    jr = JobJournal(jdir)
    jr.append_submit(Job("job-00001", _spec(X, y), seq=1))
    jr.append("terminal", "job-00001", state="done", error=None)
    jr.close()

    with SearchServer(max_concurrency=1, journal_dir=jdir) as srv:
        assert srv.stats()["journal"]["recovered"]["terminal"] == 1
        job = srv.job("job-00001")
        assert job.state == DONE and job.done_event.is_set()
        assert job.result is None  # a shell: reported, never rerun
        time.sleep(0.3)
        assert srv.stats()["queued"] == 0 and srv.stats()["running"] == 0


def test_recovered_ids_do_not_collide_with_new_submits(tmp_path):
    jdir = str(tmp_path / "journal")
    X, y = _problem()
    jr = JobJournal(jdir)
    jr.append_submit(Job("job-00003", _spec(X, y), seq=3))
    jr.append("terminal", "job-00003", state="done", error=None)
    jr.close()
    with SearchServer(max_concurrency=1, journal_dir=jdir) as srv:
        new_id = srv.submit(_spec(X, y))
        assert new_id == "job-00004"  # seq resumed past the recovered job
        assert srv.wait(new_id, timeout=600).state == DONE


# -- retries / quarantine / backpressure ---------------------------------------


def test_transient_failure_retries_and_succeeds(tmp_path):
    X, y = _problem()
    faults.install("job_exception@0")
    with SearchServer(
        max_concurrency=1, spool_dir=str(tmp_path), retry_backoff_s=0.02
    ) as srv:
        jid = srv.submit(_spec(X, y))
        job = srv.wait(jid, timeout=600)
        assert job.state == DONE, job.summary()
        assert job.attempts == 2  # first run injected, retry succeeded
        st = srv.stats()
        assert st["retries"] == 1 and st["quarantined"] == 0


def test_persistent_failure_quarantines_with_traceback(tmp_path):
    X, y = _problem()
    # every attempt fails: 1 initial + SR_JOB_RETRIES=1 retry, then poison
    faults.install("job_exception@0;job_exception@1")
    with SearchServer(
        max_concurrency=1, spool_dir=str(tmp_path),
        job_retries=1, retry_backoff_s=0.02,
    ) as srv:
        jid = srv.submit(_spec(X, y))
        job = srv.wait(jid, timeout=600)
        assert job.state == QUARANTINED, job.summary()
        assert job.attempts == 2
        assert "FaultInjected" in job.error
        assert job.traceback is not None and "Traceback" in job.traceback
        assert job.summary()["traceback"] == job.traceback
        st = srv.stats()
        assert st["quarantined"] == 1 and st["retries"] == 1


def test_retry_budget_survives_crash_restart(tmp_path):
    """Attempts are journaled, so a crash-restart can't launder the
    SR_JOB_RETRIES budget: a job that burned attempt 1
    before the crash gets exactly its remaining retries after recovery,
    not a fresh budget."""
    jdir = str(tmp_path / "journal")
    X, y = _problem()
    jr = JobJournal(jdir)
    jr.append_submit(Job("job-00001", _spec(X, y), seq=1))
    jr.append("start", "job-00001", attempts=1)  # crashed mid-attempt 1
    jr.close()

    faults.install("job_exception@0")  # the recovered retry fails too
    with SearchServer(
        max_concurrency=1, journal_dir=jdir,
        job_retries=1, retry_backoff_s=0.02,
    ) as srv:
        job = srv.wait("job-00001", timeout=600)
        assert job.state == QUARANTINED, job.summary()
        assert job.attempts == 2  # 1 pre-crash + 1 post-recovery, not reset


def test_recovery_quarantines_exhausted_job_without_rerun(tmp_path):
    """A job that already exhausted its budget before the crash (crashed
    twice around a persistently failing job) must come back QUARANTINED
    from replay alone — recovery is not a retry-budget reset, and the
    poison job must not run even once more."""
    jdir = str(tmp_path / "journal")
    X, y = _problem()
    jr = JobJournal(jdir)
    jr.append_submit(Job("job-00001", _spec(X, y), seq=1))
    jr.append("start", "job-00001", attempts=1)  # attempt 1...
    jr.append("requeue", "job-00001", attempts=1, error="boom")  # ...failed
    jr.append("start", "job-00001", attempts=2)  # crashed mid-attempt 2
    jr.close()

    with SearchServer(
        max_concurrency=1, journal_dir=jdir, job_retries=1,
    ) as srv:
        assert srv.stats()["journal"]["recovered"]["quarantined"] == 1
        job = srv.job("job-00001")
        assert job.state == QUARANTINED
        assert job.attempts == 2
        assert job.result is None  # never reran
        assert job.error == "boom"  # the journaled cause survives replay
        time.sleep(0.3)
        assert srv.stats()["queued"] == 0 and srv.stats()["running"] == 0


def test_queue_depth_backpressure_sheds(tmp_path):
    X, y = _problem()
    with SearchServer(
        max_concurrency=1, spool_dir=str(tmp_path), queue_max_depth=1
    ) as srv:
        blocker = srv.submit(_spec(X, y, niterations=30))
        deadline = time.monotonic() + 600
        while srv.stats()["running"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        queued = srv.submit(_spec(X, y))
        with pytest.raises(ServerOverloaded):
            srv.submit(_spec(X, y))
        assert srv.stats()["shed"] == 1
        srv.cancel(blocker)
        assert srv.wait(queued, timeout=600).state == DONE


# -- supervision ---------------------------------------------------------------


def test_worker_crash_is_supervised_and_job_survives(tmp_path):
    X, y = _problem()
    faults.install("worker_crash@0")
    with SearchServer(max_concurrency=1, spool_dir=str(tmp_path)) as srv:
        jid = srv.submit(_spec(X, y))
        job = srv.wait(jid, timeout=600)
        assert job.state == DONE, job.summary()
        assert srv.stats()["worker_restarts"] >= 1


def test_stall_watchdog_stops_and_retries(tmp_path):
    X, y = _problem()
    faults.install("stall@0:delay_s=30")
    with SearchServer(
        max_concurrency=1, spool_dir=str(tmp_path),
        stall_seconds=0.3, retry_backoff_s=0.02, poll_seconds=0.05,
    ) as srv:
        jid = srv.submit(_spec(X, y, niterations=3))
        job = srv.wait(jid, timeout=600)
        assert job.state == DONE, job.summary()
        assert job.attempts == 2  # stalled run stopped, retry finished
        st = srv.stats()
        assert st["stalls"] == 1 and st["retries"] == 1
        assert job.iterations_done == 3  # resumed over the remainder


# -- fleet failure isolation (satellite: batch-wide catch-all) -----------------


def test_fleet_batch_failure_retries_every_member_solo(tmp_path, monkeypatch):
    """Regression: an exception inside a coalesced fleet batch used to
    finalize only the LEAD job, leaving take_compatible mates RUNNING
    forever. Every member must now retry solo (and stay solo)."""
    import symbolicregression_jl_tpu_torch.models.device_search as ds

    monkeypatch.setattr(ds, "fleet_eligibility", lambda o: None)

    def _boom(*a, **kw):
        raise RuntimeError("fleet exploded")

    monkeypatch.setattr(ds, "fleet_search", _boom)

    X, y = _problem()
    with SearchServer(
        max_concurrency=1, spool_dir=str(tmp_path),
        fleet=True, fleet_window_s=1.0, retry_backoff_s=0.02,
    ) as srv:
        # different seeds: same shape bucket (coalesce) but different
        # content keys (two groups -> the fleet program, which explodes)
        a = srv.submit(_spec(X, y, options=_opts(seed=0)))
        time.sleep(0.15)  # lead acquired, straggler window open
        b = srv.submit(_spec(X, y, options=_opts(seed=1)))
        ja = srv.wait(a, timeout=600)
        jb = srv.wait(b, timeout=600)
        assert ja.state == DONE, ja.summary()
        assert jb.state == DONE, jb.summary()
        st = srv.stats()
        assert st["fleet"]["batches"] == 1, "jobs never coalesced"
        assert ja.attempts == 2 and jb.attempts == 2
        assert ja.solo_only and jb.solo_only
        assert st["retries"] >= 2 and st["jobs"].get("failed", 0) == 0


def test_shutdown_interrupts_fleet_window(tmp_path, monkeypatch):
    """Satellite: the fleet admission window must be an interruptible wait —
    shutdown() cannot hang for fleet_window_s."""
    import symbolicregression_jl_tpu_torch.models.device_search as ds

    monkeypatch.setattr(ds, "fleet_eligibility", lambda o: None)
    X, y = _problem()
    srv = SearchServer(
        max_concurrency=1, spool_dir=str(tmp_path),
        fleet=True, fleet_window_s=30.0,
    ).start()
    srv.submit(_spec(X, y))
    time.sleep(0.3)  # worker is inside the 30s straggler window
    t0 = time.monotonic()
    srv.shutdown()
    assert time.monotonic() - t0 < 10.0


# -- full kill/restart drill (out of the tier-1 budget) ------------------------

_CHILD = r"""
import os, sys, time
import numpy as np
sys.path.insert(0, sys.argv[2])
from symbolicregression_jl_tpu_torch import Options
from symbolicregression_jl_tpu_torch.serve import JobSpec, SearchServer

jdir = sys.argv[1]
rng = np.random.default_rng(0)
X = rng.normal(size=(2, 60)).astype(np.float32)
y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
opts = Options(binary_operators=["+", "-", "*"], unary_operators=["cos"],
               populations=2, population_size=8, ncycles_per_iteration=8,
               maxsize=10, save_to_file=False, seed=0, scheduler="lockstep",
               device="cpu", progress=False)
srv = SearchServer(max_concurrency=1, journal_dir=jdir,
                   ckpt_every_s=0.1).start()
long_id = srv.submit(JobSpec(X, y, options=opts, niterations=400))
short = [srv.submit(JobSpec(X, y, options=opts, niterations=2))
         for _ in range(2)]
base = os.path.join(srv.spool_dir, long_id + ".engine")
from symbolicregression_jl_tpu_torch.utils.checkpoint import latest_checkpoint
deadline = time.time() + 300
while time.time() < deadline:
    if latest_checkpoint(base) is not None:
        print("MID", flush=True)
        break
    time.sleep(0.05)
time.sleep(600)  # hold everything mid-run until the parent SIGKILLs us
"""


@pytest.mark.slow
def test_sigkill_mid_run_recovers_everything(tmp_path):
    """The acceptance kill drill, in miniature: SIGKILL a journaled server
    mid-batch, restart on the same journal_dir, and every submitted job
    reaches a terminal state with no duplicates — the running job RESUMES
    from its spool checkpoint instead of restarting."""
    jdir = str(tmp_path / "journal")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD, jdir, str(ROOT)],
        stdout=subprocess.PIPE, text=True, env=env,
    )
    try:
        line = ""
        deadline = time.time() + 300
        while time.time() < deadline:
            line = proc.stdout.readline()
            if "MID" in line or not line:
                break
        assert "MID" in line, "child never reached mid-run"
    finally:
        proc.kill()
        proc.wait(timeout=60)

    with SearchServer(max_concurrency=1, journal_dir=jdir) as srv:
        rec = srv.stats()["journal"]["recovered"]
        assert rec["running"] + rec["queued"] == 3
        assert rec["resumed"] >= 1
        with srv._lock:
            ids = list(srv._jobs)
        assert len(ids) == len(set(ids)) == 3
        long_job = srv.job("job-00001")
        for jid in ids:
            job = srv.wait(jid, timeout=600)
            assert job.terminal and job.state == DONE, job.summary()
        assert long_job.resumed_from_iteration is not None
        assert long_job.resumed_from_iteration >= 1
        assert long_job.iterations_done == 400  # finished its FULL budget


# -- exact parity with the JAX package's journal --------------------------------

_PACKAGES = {"jax": jserve, "port": serve}


def _write_sequence(mod, d, X, y):
    """One record sequence through a package's journal: submits (real
    JobSpecs), a start, heartbeats, a requeue, a terminal and a rotation,
    then one more record after it."""
    jr = mod.JobJournal(d, fsync=False)
    jr.replay()
    opts = (_opts() if mod is serve else
            __import__("symbolicregression_jl_tpu").Options(
                binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=2,
                population_size=8, ncycles_per_iteration=8, maxsize=10,
                save_to_file=False, seed=0, scheduler="lockstep"))
    for seq in (1, 2, 3):
        job = mod.Job(f"job-{seq:05d}", mod.JobSpec(X, y, options=opts, niterations=2),
                      seq=seq)
        job.submitted_at = float(seq)
        assert jr.append_submit(job)
    jr.append("start", "job-00001", attempts=1, ckpt="/spool/job-00001.engine")
    for i in range(3):
        jr.append("progress", "job-00001", fsync=False, iterations_done=i)
    jr.append("requeue", "job-00001", attempts=1, not_before=5.0, error="E",
              ckpt="/spool/job-00001.ckpt")
    jr.append("start", "job-00002", attempts=1)
    jr.append("terminal", "job-00002", state="done", error=None)
    jr.rotate()
    jr.append("terminal", "job-00003", state="cancelled", error="client")
    jr.close()


def _merged(mod, d):
    jr = mod.JobJournal(d, fsync=False)
    st = jr.replay()
    jr.close()
    return {k: {f: v for f, v in rec.items() if f != "spec"} for k, rec in st.items()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_replays_the_same_in_both_packages(tmp_path, writer):
    X, y = _problem()
    d = str(tmp_path / "jr")
    _write_sequence(_PACKAGES[writer], d, X, y)
    got = {name: _merged(mod, str(shutil.copytree(d, tmp_path / name)))
           for name, mod in _PACKAGES.items()}
    assert got["jax"] == got["port"]
    st = got["port"]
    assert st["job-00001"]["state"] == "queued" and st["job-00001"]["not_before"] == 5.0
    assert st["job-00002"]["state"] == "done" and st["job-00003"]["state"] == "cancelled"
    # the live jobs' specs survive rotation and load in the writer's package
    spec = JobJournal(str(tmp_path / "port")).replay()["job-00001"]["spec"]
    assert spec is not None
    if writer == "port":
        assert __import__("pickle").loads(spec).niterations == 2


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torn_tail_cut_at_the_same_offset_in_both_packages(tmp_path, writer):
    """Cut one package's log at every byte offset of its last two records:
    both packages truncate it to the same length and replay the same state."""
    d = str(tmp_path / "jr")
    jr = _PACKAGES[writer].JobJournal(d, fsync=False)
    jr.append("submit", "j1", seq=1, submitted_at=1.0, spec=b"S", kind="search")
    committed = os.path.getsize(jr.path)
    jr.append("start", "j1", attempts=1, ckpt="/spool/j1.engine")
    jr.append("terminal", "j1", state="done", error=None)
    jr.close()
    full = open(jr.path, "rb").read()
    for cut in range(committed, len(full) + 1):
        sizes, states = {}, {}
        for name, mod in _PACKAGES.items():
            d2 = tmp_path / f"{name}{cut}"
            d2.mkdir()
            (d2 / "journal.log").write_bytes(full[:cut])
            j2 = mod.JobJournal(str(d2), fsync=False)
            states[name] = j2.replay()
            j2.close()
            sizes[name] = os.path.getsize(d2 / "journal.log")
        assert sizes["jax"] == sizes["port"] <= cut, cut
        assert states["jax"] == states["port"], cut
