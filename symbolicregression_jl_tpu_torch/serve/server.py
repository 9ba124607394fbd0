"""SR-as-a-service: a long-lived multi-tenant search daemon on one card.

Counterpart of ``symbolicregression_jl_tpu/serve/server.py``. One resident
process owns the card and multiplexes many concurrent ``equation_search``
jobs, coalesced fleets and stream subscriptions over a pool of worker
threads. The port compiles nothing per shape (its kernels are built once per
source), so warmth here is the program cache's dataset uploads and operator
tables (``program_cache.py``) and, for a bucket of equal shapes, the fleet
that runs its jobs as lanes of one engine:

- **admission** (queue.py): priority, then warm-bucket affinity, then FIFO,
  under per-tenant concurrency quotas;
- **budgets**: per-job wall-clock deadline (from submit; enforced while
  queued AND while running, via the engine's own timeout stop) and eval
  budget (``max_evals``);
- **streaming**: after each iteration the search's live Pareto frontier is
  encoded with the format-2 flat checkpoint codec
  (``utils/checkpoint.dump_frontier_bytes``, under the JAX package's class
  names) and appended to the job's frame list — the wire format clients
  decode with either package's ``load_frontier_bytes``;
- **preemption**: a higher-priority submission marks the lowest-priority
  running job; its iteration callback stops the search cooperatively at the
  next boundary, the server snapshots a format-2 checkpoint into the spool,
  and the job re-enters the queue — the next admission passes
  ``resume_from`` so the search warm-starts over its REMAINING iterations
  (the engine's resume is a rescored warm start; a lockstep resume from the
  engine's own exact snapshot is bit-exact);
- **warm restarts**: ``enable_persistent_compilation_cache`` points the
  kernel build directory at ``SR_COMPILATION_CACHE_DIR``, so a restarted
  server loads the libraries instead of building them;
- **fleet coalescing** (opt-in, ``fleet=True``): a worker that pops a
  fleet-eligible job gathers up to ``SR_FLEET_MAX - 1`` (default 8 lanes
  total) further queued jobs from the SAME shape bucket — at once, then
  waiting up to ``SR_FLEET_WINDOW_S`` (default 0.05s) for stragglers — and
  runs them as ONE ``models.device_search.fleet_search``: one B3 launch per
  iteration for every lane on the block, and one B1 or B2 launch per
  constant-optimization step. Each job keeps its own frontier stream, stop
  conditions and terminal state, and each lane ends bit for bit where its
  solo run ends. Cancel/preempt evicts a single lane (the fleet stops
  running it; the survivors keep their bits). Identical searches share one
  lane (request collapsing). Deadline-bearing jobs and preemption resumes
  run solo;
- **durability + self-healing** (opt-in, ``journal_dir=`` /
  ``SR_SERVE_JOURNAL_DIR``): every job transition is appended to a
  write-ahead ``JobJournal`` (journal.py) and running searches snapshot
  into the spool every ``SR_SERVE_CKPT_EVERY_S`` via the engine's own
  checkpointer, so a crashed/killed server restarted on the same
  ``journal_dir`` resubmits its queue and RESUMES its running jobs. Failed
  runs retry with exponential backoff up to ``SR_JOB_RETRIES`` then
  terminate QUARANTINED; a supervisor thread restarts dead workers and a
  ``SR_JOB_STALL_S`` watchdog stops+retries runs whose iteration heartbeat
  froze; ``SR_QUEUE_MAX_DEPTH`` sheds submits with ``ServerOverloaded``.
  All of it is inert (no locks, no I/O) when the journal is off;
- **subscriptions** (``kind="subscription"``): deadline-less streaming
  jobs backed by ``stream.StreamSession`` — the worker drives a long-lived
  lane whose dataset updates live (``push_rows``/``replace_rows``, written
  in place within the row bucket) and whose frontier frames flow through
  the same frame channel until the client ``cancel()``s (terminal DONE,
  final result attached).

Concurrent jobs share the card's default CUDA stream and the process: the
kernels' launch counters (``<wrapper>.launches``), the engine's test seams
(``models/device_search._DISPATCH_HOOK``, ``_LEG_WRAP``) and the
``torch.cuda.synchronize`` of its leg timer and profiler are process-wide,
so under ``max_concurrency > 1`` the counters sum over every running job
and one job's leg times include the other jobs' queued work. Each job's
own bits do not depend on the others: every engine draws from its own
``torch.Generator`` and every kernel and BFGS product runs at the job's own
shapes.

The server is in-process by design (remote transport is a thin shell over
``submit``/``frames``/``result``), but every interaction goes through the
queue's lock and the jobs' events, so a transport can drive it from any
thread.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import os
import pickle
import shutil
import tempfile
import threading
import time
import traceback as _tbmod

from . import queue as q
from .program_cache import (
    enable_persistent_compilation_cache,
    global_program_cache,
    is_oom_error,
)
from .journal import JournalDiskFull
from .queue import Job, JobQueue, JobSpec, ServerOverloaded

__all__ = ["SearchServer", "JobSpec", "ServerOverloaded"]


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _format_error(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"


def _format_traceback(
    e: BaseException, limit: int = 25, max_chars: int = 8192
) -> str:
    """Bounded formatted traceback: deep enough to debug a failed job,
    capped so a quarantined job cannot bloat summaries or the journal."""
    tb = "".join(
        _tbmod.format_exception(type(e), e, e.__traceback__, limit=limit)
    )
    return tb[-max_chars:]


class SearchServer:
    """Multi-tenant search daemon. Typical use::

        with SearchServer(max_concurrency=2) as srv:
            jid = srv.submit(JobSpec(X, y, options=opts, niterations=5,
                                     tenant="acme", priority=1))
            job = srv.wait(jid, timeout=300)
            for frame in srv.frames(jid):
                update = load_frontier_bytes(frame)   # streaming client side
            result = job.result                        # SearchResult

    ``max_concurrency`` bounds concurrently RUNNING searches (worker
    threads); per-tenant quotas bound each tenant's share of those slots.
    """

    def __init__(
        self,
        max_concurrency: int = 2,
        default_quota: int = 2,
        quotas: dict | None = None,
        spool_dir: str | None = None,
        compilation_cache_dir: str | None = None,
        poll_seconds: float = 0.2,
        fleet: bool = False,
        fleet_max: int | None = None,
        fleet_window_s: float | None = None,
        journal_dir: str | None = None,
        ckpt_every_s: float | None = None,
        job_retries: int | None = None,
        retry_backoff_s: float | None = None,
        stall_seconds: float | None = None,
        queue_max_depth: int | None = None,
    ):
        if max_concurrency < 1:
            raise ValueError("max_concurrency must be >= 1")
        self.max_concurrency = int(max_concurrency)
        self.poll_seconds = float(poll_seconds)
        # -- durability / self-healing knobs --
        self.journal_dir = journal_dir or os.environ.get(
            "SR_SERVE_JOURNAL_DIR"
        ) or None
        self.ckpt_every_s = (
            _env_float("SR_SERVE_CKPT_EVERY_S", 30.0)
            if ckpt_every_s is None
            else float(ckpt_every_s)
        )
        self.job_retries = (
            _env_int("SR_JOB_RETRIES", 2)
            if job_retries is None
            else int(job_retries)
        )
        self.retry_backoff_s = (
            _env_float("SR_JOB_RETRY_BACKOFF_S", 0.25)
            if retry_backoff_s is None
            else float(retry_backoff_s)
        )
        self.stall_s = (
            _env_float("SR_JOB_STALL_S", 0.0)
            if stall_seconds is None
            else float(stall_seconds)
        )
        self.queue_max_depth = (
            _env_int("SR_QUEUE_MAX_DEPTH", 0)
            if queue_max_depth is None
            else int(queue_max_depth)
        )
        self.fleet = bool(fleet)
        self.fleet_max = (
            int(os.environ.get("SR_FLEET_MAX", "8"))
            if fleet_max is None
            else int(fleet_max)
        )
        if self.fleet and self.fleet_max < 2:
            raise ValueError("fleet_max must be >= 2 when fleet mode is on")
        self.fleet_window_s = (
            float(os.environ.get("SR_FLEET_WINDOW_S", "0.05"))
            if fleet_window_s is None
            else float(fleet_window_s)
        )
        self._fleet_batches = 0
        self._fleet_lanes = 0
        self._fleet_max_seen = 0
        self._fleet_deduped = 0
        self.cache = global_program_cache()
        self.compilation_cache_dir = enable_persistent_compilation_cache(
            compilation_cache_dir
        )
        # with a journal, the spool must survive restarts (the engine's
        # periodic snapshots there ARE the resume state) — default it into
        # the journal dir instead of a shutdown-deleted tempdir
        self._own_spool = spool_dir is None and self.journal_dir is None
        if spool_dir is None and self.journal_dir is not None:
            spool_dir = os.path.join(self.journal_dir, "spool")
        self.spool_dir = spool_dir or tempfile.mkdtemp(prefix="sr-serve-spool-")
        os.makedirs(self.spool_dir, exist_ok=True)
        self._queue = JobQueue(default_quota=default_quota, quotas=quotas)
        self._lock = threading.Lock()
        self._frame_cond = threading.Condition(self._lock)
        # Monotone counter bumped on every frame append / terminal
        # transition; wait_activity() lets a single external bridge thread
        # (e.g. the NetServer fan-out) sleep on ALL jobs at once instead of
        # polling each stream.
        self._activity = 0
        self._jobs: dict[str, Job] = {}
        self._running: dict[str, Job] = {}
        self._warm_buckets: set = set()
        self._seq = 0
        self._stop_event = threading.Event()
        self._workers: list[threading.Thread] = []
        self._supervisor: threading.Thread | None = None
        self._started = False
        self._retries = 0
        self._quarantined = 0
        self._shed = 0
        self._stalls = 0
        self._worker_restarts = 0
        # -- degradation telemetry --
        self._journal_shed = 0  # submits refused while the journal is read-only
        self._oom_downshifts = 0  # fleet batches halved/solo'd on out-of-memory
        self._skew_suppressed = 0  # stall-watchdog passes suppressed on a
        #                            wall-clock jump (skew/NTP step)
        self._watch_clock = None  # (wall, monotonic) of the last watchdog pass
        self._admission_paused = threading.Event()
        self._admit_lock = threading.Lock()
        self._recovered = {
            "queued": 0, "running": 0, "resumed": 0, "terminal": 0,
            "dropped": 0, "quarantined": 0,
        }
        self.journal = None
        if self.journal_dir:
            from .journal import JobJournal

            self.journal = JobJournal(self.journal_dir)
            self._recover()

    @property
    def _stopping(self) -> bool:
        return self._stop_event.is_set()

    # -- crash recovery --------------------------------------------------------
    def _recover(self) -> None:
        """Replay the journal and rebuild the job table: terminal jobs come
        back as queryable shells (reported exactly once, never rerun),
        queued/running searches re-enter the queue — a running job that left
        an engine/preempt checkpoint in the spool resumes over it via the
        same ``resume_from`` machinery preemption uses — and in-flight
        subscriptions finalize CANCELLED (a live stream cannot be resumed
        on behalf of a disconnected client)."""
        state = self.journal.replay()
        for job_id, st in sorted(state.items(), key=lambda kv: kv[1]["seq"]):
            self._seq = max(self._seq, int(st.get("seq", 0)))
            spec = None
            if st.get("spec") is not None:
                try:
                    spec = pickle.loads(st["spec"])
                except Exception:
                    spec = None
            if spec is None:
                self._recovered["dropped"] += 1
                continue
            job = Job(job_id, spec, seq=int(st["seq"]))
            job.submitted_at = float(st.get("submitted_at") or job.submitted_at)
            job.deadline_at = (
                None
                if spec.deadline_seconds is None
                else job.submitted_at + spec.deadline_seconds
            )
            job.attempts = int(st.get("attempts", 0))
            job.iterations_done = int(st.get("iterations_done", 0))
            job.not_before = float(st.get("not_before", 0.0))
            job.error = st.get("error")
            with self._lock:
                self._jobs[job_id] = job
            if st["state"] in q.TERMINAL_STATES:
                job.state = st["state"]
                job.finished_at = job.submitted_at
                job.done_event.set()
                self._recovered["terminal"] += 1
                continue
            if spec.kind != "search":
                # a subscription's stream died with the old process; its
                # client must resubscribe
                job.error = job.error or "server restarted mid-subscription"
                self._finalize(job, q.CANCELLED, release=False)
                self._recovered["terminal"] += 1
                continue
            if job.attempts > self.job_retries:
                # the retry budget is journaled (start/requeue records carry
                # the attempt counter): a poison job that takes the whole
                # server down must not re-enter with a fresh budget after
                # every restart — quarantine it here, exactly where
                # _retry_or_quarantine would have
                job.error = job.error or (
                    f"quarantined on recovery: {job.attempts} attempt(s) "
                    f"exceed SR_JOB_RETRIES={self.job_retries}"
                )
                with self._lock:
                    self._quarantined += 1
                self._finalize(job, q.QUARANTINED, release=False)
                self._recovered["quarantined"] += 1
                continue
            was_running = st["state"] == "running"
            if self._adopt_checkpoint(job, st.get("ckpt")):
                self._recovered["resumed"] += 1
            self._recovered["running" if was_running else "queued"] += 1
            if was_running:
                # flip the journal's view back to queued (with the adopted
                # checkpoint) so a second crash before this job runs again
                # still recovers it
                self._jappend(
                    "requeue", job.id, attempts=job.attempts,
                    not_before=0.0, ckpt=job.resume_path,
                )
            self._queue.submit(job)
        self.journal.rotate()

    def _adopt_checkpoint(self, job: Job, recorded: str | None) -> bool:
        """Point ``job.resume_path`` at the freshest usable spool snapshot:
        the engine's periodic checkpoint base first (newest ``.NNNNNN``
        wins), then the journal-recorded path, then a preemption snapshot.
        Also decides the resume REPORTING mode: an exact lockstep snapshot
        resumes bit-exact and reports ABSOLUTE iterations (base 0), anything
        else warm-starts over the remainder and reports run-relative."""
        from ..utils.checkpoint import peek_checkpoint_meta

        candidates = [os.path.join(self.spool_dir, f"{job.id}.engine")]
        if recorded:
            candidates.append(recorded)
        candidates.append(os.path.join(self.spool_dir, f"{job.id}.ckpt"))
        seen = set()
        for cand in candidates:
            if not cand or cand in seen:
                continue
            seen.add(cand)
            try:
                meta = peek_checkpoint_meta(cand)
            except Exception:
                continue
            job.resume_path = meta["path"]
            job.resumed_from_iteration = int(meta["iteration"])
            job.iterations_done = max(
                job.iterations_done, int(meta["iteration"])
            )
            job.resume_absolute = (
                bool(meta["exact"])
                and meta["scheduler"] == "lockstep"
                and job.spec.options.scheduler == "lockstep"
            )
            return True
        return False

    def _jappend(self, type_: str, job_id: str, fsync: bool = True, **fields):
        """Journal append that never takes the serve path down: on any
        append failure (including an injected torn write) the log is
        re-replayed, which truncates the torn tail so later appends land on
        a clean frame boundary."""
        jr = self.journal
        if jr is None:
            return
        try:
            jr.append(type_, job_id, fsync=fsync, **fields)
        except Exception:
            try:
                jr.replay()
            except Exception:
                pass

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "SearchServer":
        if self._started:
            return self
        self._started = True
        for i in range(self.max_concurrency):
            t = threading.Thread(
                target=self._worker_loop, name=f"sr-serve-worker-{i}", daemon=True
            )
            t.start()
            self._workers.append(t)
        self._supervisor = threading.Thread(
            target=self._supervisor_loop, name="sr-serve-supervisor", daemon=True
        )
        self._supervisor.start()
        return self

    def shutdown(self, wait: bool = True, cancel_queued: bool = True) -> None:
        """Stop accepting work and stop running jobs at their next iteration
        boundary (cooperative; running jobs finalize as CANCELLED)."""
        self._stop_event.set()
        with self._lock:
            running = list(self._running.values())
        for job in running:
            job.cancel_requested.set()
            if job.session is not None:
                job.session.request_stop()
        if cancel_queued:
            for job in self._queue.drain():
                self._finalize(job, q.CANCELLED, release=False)
        self._queue.wake_all()
        if wait:
            if self._supervisor is not None:
                self._supervisor.join(timeout=60)
            for t in list(self._workers):
                t.join(timeout=60)
            if cancel_queued:
                # a preempted job may have re-entered between drain and join
                for job in self._queue.drain():
                    self._finalize(job, q.CANCELLED, release=False)
        if self.journal is not None:
            self.journal.close()
        if self._own_spool:
            shutil.rmtree(self.spool_dir, ignore_errors=True)

    def __enter__(self) -> "SearchServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- drain (graceful handoff) ---------------------------------------------
    def pause_admission(self) -> None:
        """Stop workers from picking up queued jobs; running jobs are
        unaffected. Reversible with :meth:`resume_admission`."""
        self._admission_paused.set()

    def resume_admission(self) -> None:
        self._admission_paused.clear()
        self._queue.wake_all()

    def drain(self, timeout: float = 60.0) -> bool:
        """Graceful-handoff drain (the SIGTERM shape): pause admission,
        ask every RUNNING search to yield at its next iteration boundary
        (the preemption path: a format-2 spool snapshot + a journaled
        ``requeue``), and wait until nothing is running. Queued jobs stay
        queued — with a journal they remain durably adoptable, which is the
        point: follow with ``shutdown(cancel_queued=False)`` and another
        host can take the journal over with zero loss. Subscriptions have
        no resumable budget and are stopped like a client cancel. Returns
        True when the server went idle within ``timeout``."""
        self.pause_admission()
        with self._lock:
            running = list(self._running.values())
        for job in running:
            if job.spec.kind == "search":
                job.preempt_requested.set()
            else:
                job.cancel_requested.set()
                if job.session is not None:
                    job.session.request_stop()
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            with self._lock:
                if not self._running:
                    return True
            time.sleep(min(0.02, self.poll_seconds))
        with self._lock:
            return not self._running

    # -- client surface -------------------------------------------------------
    def submit(self, spec: JobSpec) -> str:
        """Enqueue a job; returns its id. May trigger preemption: when every
        worker is busy and some RUNNING job has strictly lower priority (and
        is preemptible), the lowest-priority one is asked to yield."""
        if self._stopping:
            raise RuntimeError("server is shutting down")
        if not self._started:
            raise RuntimeError("server not started (use start() or a with-block)")
        if self.queue_max_depth and len(self._queue) >= self.queue_max_depth:
            with self._lock:
                self._shed += 1
            raise ServerOverloaded(
                f"queue depth at SR_QUEUE_MAX_DEPTH={self.queue_max_depth}; "
                "resubmit later"
            )
        with self._lock:
            self._seq += 1
            job_id = f"job-{self._seq:05d}"
            job = Job(job_id, spec, seq=self._seq)
            self._jobs[job_id] = job
        if self.journal is not None:
            try:
                self.journal.append_submit(job)
            except JournalDiskFull as exc:
                # disk-full shedding: a submit that cannot be made durable is
                # refused (the append itself is the probe — the first submit
                # after space returns re-arms the journal and is accepted).
                # Running jobs are untouched; the client retries later.
                with self._lock:
                    self._jobs.pop(job_id, None)
                    self._shed += 1
                    self._journal_shed += 1
                raise ServerOverloaded(
                    "journal is read-only (disk full); resubmit after "
                    f"retry-after={max(1.0, self.poll_seconds * 5):.1f}s"
                ) from exc
            except Exception:
                try:
                    self.journal.replay()
                except Exception:
                    pass
        self._queue.submit(job)
        self._maybe_preempt_for(job)
        return job_id

    def job(self, job_id: str) -> Job:
        with self._lock:
            return self._jobs[job_id]

    def wait(self, job_id: str, timeout: float | None = None) -> Job:
        """Block until the job reaches a terminal state (or timeout); returns
        the Job either way — check ``job.terminal``."""
        job = self.job(job_id)
        job.done_event.wait(timeout)
        return job

    def frames(self, job_id: str, start: int = 0) -> list[bytes]:
        """Snapshot of the job's frontier frames from index ``start`` —
        format-2 bytes for ``utils.checkpoint.load_frontier_bytes``."""
        job = self.job(job_id)
        with self._lock:
            return list(job.frames[start:])

    def frames_since(self, job_id: str, start: int = 0) -> tuple[list[bytes], bool]:
        """``(frames[start:], terminal)`` captured under ONE lock
        acquisition — the terminal flag is consistent with the frame
        snapshot, so a reader that sees ``terminal=True`` holds every frame
        the job will ever produce. This is the fan-out primitive for
        high-frequency network readers (``frames()`` + a separate terminal
        check would contend the server lock twice per batch and could race
        a frame appended between the two)."""
        with self._lock:
            job = self._jobs[job_id]
            return list(job.frames[start:]), job.terminal

    def wait_activity(self, last_seen: int = 0, timeout: float | None = None) -> int:
        """Block until the server-wide activity counter advances past
        ``last_seen`` (any frame append or terminal transition on any job),
        or until ``timeout``; returns the current counter. Lets one bridge
        thread multiplex wakeups for many streams."""
        with self._frame_cond:
            if self._activity == last_seen:
                self._frame_cond.wait(timeout)
            return self._activity

    def stream(self, job_id: str, timeout: float | None = None):
        """Generator over frontier frames as they arrive, ending when the job
        goes terminal (yields every frame exactly once)."""
        job = self.job(job_id)
        i = 0
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._frame_cond:
                while len(job.frames) <= i and not job.terminal:
                    remaining = (
                        None if deadline is None else deadline - time.monotonic()
                    )
                    if remaining is not None and remaining <= 0:
                        return
                    if not self._frame_cond.wait(
                        self.poll_seconds
                        if remaining is None
                        else min(self.poll_seconds, remaining)
                    ):
                        continue
                # One consistent snapshot: batch + terminal under the same
                # acquisition, so the post-yield exit check needs no re-lock.
                batch = list(job.frames[i:])
                terminal = job.terminal
            for frame in batch:
                yield frame
            i += len(batch)
            if terminal:
                return

    def cancel(self, job_id: str) -> None:
        """Request cancellation: queued jobs finalize on the next sweep,
        running jobs stop at the next iteration boundary. For a
        subscription this is the NORMAL way to end the stream — the job
        finalizes DONE with its final SearchResult attached."""
        job = self.job(job_id)
        job.cancel_requested.set()
        session = job.session
        if session is not None:
            session.request_stop()
        self._queue.wake_all()

    def push_rows(self, job_id: str, X, y, weights=None) -> None:
        """Append rows to a subscription's live dataset (applied at the
        next iteration boundary; an in-place write while the row count stays
        within the session's row bucket). Rows pushed before the job is
        admitted are staged and flushed when the session starts."""
        self._stage_rows(job_id, "push", X, y, weights)

    def replace_rows(self, job_id: str, X, y, weights=None) -> None:
        """Replace a subscription's whole dataset (same feature count) at
        the next iteration boundary."""
        self._stage_rows(job_id, "replace", X, y, weights)

    def _stage_rows(self, job_id: str, kind: str, X, y, weights) -> None:
        import numpy as np

        job = self.job(job_id)
        if job.spec.kind != "subscription":
            raise ValueError(f"{job_id} is not a subscription job")
        with self._lock:
            if job.terminal:
                raise RuntimeError(f"{job_id} is terminal ({job.state})")
            session = job.session
            if session is None:  # queued: stage until the session exists
                job.pending_rows.append(
                    (
                        kind,
                        np.asarray(X),
                        np.asarray(y),
                        None if weights is None else np.asarray(weights),
                    )
                )
                return
        if kind == "push":
            session.push_rows(X, y, weights)
        else:
            session.replace_rows(X, y, weights)

    def stats(self) -> dict:
        """Server + cache health: job states, warm buckets, and the unified
        program cache's hit/miss/eviction counters (the same block the
        engine surfaces per-search via ``engine_profile``)."""
        with self._lock:
            by_state: dict[str, int] = {}
            for job in self._jobs.values():
                by_state[job.state] = by_state.get(job.state, 0) + 1
            cache = self.cache.stats()
            journal = {"enabled": self.journal is not None}
            if self.journal is not None:
                journal.update(self.journal.stats())
                journal["dir"] = self.journal_dir
                journal["recovered"] = dict(self._recovered)
            return {
                "jobs": by_state,
                "queued": len(self._queue),
                "running": len(self._running),
                "admission_paused": self._admission_paused.is_set(),
                "warm_buckets": len(self._warm_buckets),
                "retries": self._retries,
                "quarantined": self._quarantined,
                "shed": self._shed,
                "stalls": self._stalls,
                "worker_restarts": self._worker_restarts,
                # -- degradation states: observers read these from here,
                #    never from private attributes --
                "journal_read_only": bool(journal.get("read_only", False)),
                "journal_shed": self._journal_shed,
                "oom_downshifts": self._oom_downshifts,
                "skew_suspects_suppressed": self._skew_suppressed,
                "journal": journal,
                "program_cache": cache,
                "warm_hit_ratio": cache["hit_ratio"],
                "compilation_cache_dir": self.compilation_cache_dir,
                "fleet": {
                    "enabled": self.fleet,
                    "max_lanes": self.fleet_max,
                    "window_s": self.fleet_window_s,
                    "batches": self._fleet_batches,
                    "coalesced_lanes": self._fleet_lanes,
                    "largest_batch": self._fleet_max_seen,
                    "deduped_lanes": self._fleet_deduped,
                },
            }

    # -- scheduling internals --------------------------------------------------
    def _maybe_preempt_for(self, incoming: Job) -> None:
        with self._lock:
            if len(self._running) < self.max_concurrency:
                return  # a free worker will pick the queue's best job up
            candidates = [
                j
                for j in self._running.values()
                if j.spec.preemptible
                and not j.preempt_requested.is_set()
                and j.spec.priority < incoming.spec.priority
            ]
            if not candidates:
                return
            victim = min(candidates, key=lambda j: (j.spec.priority, -j.seq))
            victim.preempt_requested.set()

    def _worker_loop(self) -> None:
        from ..utils import faults

        while not self._stopping:
            if self._admission_paused.is_set():
                # draining: running jobs keep their workers (they are past
                # this gate); idle workers stop picking the queue up
                self._stop_event.wait(self.poll_seconds)
                continue
            now = time.time()
            for job in self._queue.take_expired(now):
                state = (
                    q.CANCELLED if job.cancel_requested.is_set() else q.EXPIRED
                )
                self._finalize(job, state, release=False)
            with self._admit_lock:
                # acquire and the first sweep for fleet mates are one step
                # across workers: two idle workers cannot split a queued
                # bucket between two fleets
                job = self._queue.acquire(
                    warm_buckets=self._warm_snapshot(), timeout=self.poll_seconds
                )
                if job is None:
                    continue
                if self._stopping:
                    self._queue.release(job)
                    self._finalize(job, q.CANCELLED, release=False)
                    return
                if faults.active().fire("worker_crash") is not None:
                    # thread death between acquire and run: give the job (and
                    # the tenant's quota slot) back, then die — the
                    # supervisor must restart this worker
                    self._queue.release(job)
                    self._queue.resubmit(job)
                    return
                first = self._fleet_mates(job)
            batch = [job]
            try:
                if job.spec.kind == "subscription":
                    self._run_subscription(job)
                else:
                    batch += self._gather_fleet(job, first)
                    if len(batch) > 1:
                        self._run_fleet(batch)
                    else:
                        self._run_job(job)
            except BaseException as e:  # a worker must never die silently
                # EVERY member of a coalesced batch is accounted for: a
                # catch-all that finalized only the lead job would leave
                # take_compatible mates in limbo forever
                for member in batch:
                    self._handle_run_failure(
                        member, e, solo_retry=len(batch) > 1
                    )

    def _supervisor_loop(self) -> None:
        """Self-healing sweep: restart worker threads that died (injected
        ``worker_crash``, or a bug escaping the catch-all) and run the stall
        watchdog — a RUNNING search whose iteration heartbeat has been
        silent past ``SR_JOB_STALL_S`` gets a cooperative stop request and
        retries from its latest checkpoint. Jobs that have never produced a
        heartbeat are exempt (a first-touch kernel build legitimately takes
        minutes)."""
        interval = max(0.05, min(1.0, self.poll_seconds))
        while not self._stop_event.wait(interval):
            for i, t in enumerate(list(self._workers)):
                if not t.is_alive() and not self._stopping:
                    nt = threading.Thread(
                        target=self._worker_loop, name=t.name, daemon=True
                    )
                    nt.start()
                    self._workers[i] = nt
                    with self._lock:
                        self._worker_restarts += 1
            if self.stall_s > 0:
                from ..utils import faults

                # the watchdog reads the wall clock through the skewable
                # source: an injected (or real NTP-step) clock jump shows up
                # as wall time advancing far faster than the monotonic clock
                # between passes — in that window heartbeat ages are garbage,
                # so re-stamp them instead of stall-killing healthy runs
                now = faults.skewed_time(os.environ.get("SR_POD_HOST"))
                mono = time.monotonic()
                jumped = False
                if self._watch_clock is not None:
                    wall_d = now - self._watch_clock[0]
                    mono_d = mono - self._watch_clock[1]
                    jumped = abs(wall_d - mono_d) > max(1.0, 0.5 * self.stall_s)
                self._watch_clock = (now, mono)
                with self._lock:
                    running = list(self._running.values())
                if jumped:
                    with self._lock:
                        self._skew_suppressed += 1
                    for job in running:
                        if job.heartbeat is not None:
                            job.heartbeat = now
                    continue
                for job in running:
                    hb = job.heartbeat
                    if (
                        job.spec.kind == "search"
                        and hb is not None
                        and now - hb > self.stall_s
                        and not job.stall_stop.is_set()
                    ):
                        job.stall_stop.set()

    def _warm_snapshot(self) -> set:
        with self._lock:
            return set(self._warm_buckets)

    def _make_callback(self, job: Job, fingerprint: tuple, group=None):
        """Per-iteration engine hook. ``group`` is the dedup group sharing
        this run (leader first): a shared lane only stops on cancel when
        EVERY rider has cancelled — one tenant's cancel must not evict a
        search that other identical jobs are still waiting on. Preemption
        keys off the leader alone (a follower occupies no device lane, so
        evicting the shared run for it would waste everyone's progress)."""
        spec = job.spec
        # the server owns the engine's iteration_callback slot, so a
        # tenant-supplied callback is chained here instead of replaced
        # (dedup riders share the leader's lane; the leader's own callback
        # is the one that runs)
        user_cb = spec.options.iteration_callback

        def _on_iteration(report) -> bool | None:
            from ..utils import faults

            # stamped through the skewable clock so heartbeat and watchdog
            # agree once an injected skew latches (the jump itself is what
            # the watchdog's monotonic cross-check absorbs)
            job.heartbeat = faults.skewed_time(os.environ.get("SR_POD_HOST"))
            job.iterations_done = job.iteration_base + report.iteration
            user_stop = user_cb(report) if user_cb is not None else None
            hit = faults.active().fire("stall")
            if hit is not None:
                # a hung run: no heartbeat for delay_s — but poll the
                # watchdog's stop request so the stall resolves the moment
                # the supervisor notices it
                end = time.time() + float(hit.get("delay_s", 30.0))
                while time.time() < end:
                    if (
                        job.stall_stop.is_set()
                        or job.cancel_requested.is_set()
                        or self._stopping
                    ):
                        break
                    time.sleep(0.02)
            jr = self.journal
            if jr is not None and spec.kind == "search":
                nowt = time.time()
                every = self.ckpt_every_s if self.ckpt_every_s > 0 else 5.0
                if nowt - job.journal_progress_at >= every:
                    job.journal_progress_at = nowt
                    self._jappend(
                        "progress", job.id, fsync=False,
                        iterations_done=job.iterations_done,
                    )
            if (
                report.iteration % spec.stream_every == 0
                or job.iterations_done >= spec.niterations
            ):
                from ..utils.checkpoint import dump_frontier_bytes

                frame = dump_frontier_bytes(
                    report.hall_of_fame,
                    iteration=job.iterations_done,
                    niterations=spec.niterations,
                    num_evals=report.num_evals,
                    fingerprint=fingerprint,
                    wall_time=time.time() - job.submitted_at,
                )
                with self._frame_cond:
                    job.frames.append(frame)
                    if job.ttff is None:
                        job.ttff = time.time() - job.submitted_at
                    self._activity += 1
                    self._frame_cond.notify_all()
            cancelled = (
                all(j.cancel_requested.is_set() for j in group)
                if group
                else job.cancel_requested.is_set()
            )
            if (
                cancelled
                or job.preempt_requested.is_set()
                or job.stall_stop.is_set()
                or self._stopping
            ):
                return True
            return True if user_stop else None

        return _on_iteration

    def _run_job(self, job: Job, group=None) -> None:
        from ..search import equation_search
        from ..utils import faults
        from ..utils.checkpoint import options_fingerprint

        spec = job.spec
        now = time.time()
        if job.deadline_at is not None and now >= job.deadline_at:
            self._queue.release(job)
            self._finalize(job, q.EXPIRED, release=False)
            return
        with self._lock:
            self._running[job.id] = job
        job.started_at = job.started_at or now
        job.heartbeat = None
        job.stall_stop.clear()
        # exact lockstep resumes run [start_iter, niterations) and report
        # ABSOLUTE iterations; warm-start resumes run the remainder and
        # report run-relative — only the latter needs the base offset
        job.iteration_base = 0 if job.resume_absolute else job.iterations_done
        if group is None:
            job.attempts += 1

        ckpt_base = None
        if self.journal is not None:
            ckpt_base = os.path.join(self.spool_dir, f"{job.id}.engine")
            if group is None:
                self._jappend(
                    "start", job.id, attempts=job.attempts, ckpt=ckpt_base
                )
        fingerprint = options_fingerprint(spec.options)
        opts = self._lane_options(job, fingerprint, now, group, ckpt_base)
        try:
            if faults.active().fire("job_exception") is not None:
                raise faults.FaultInjected("injected job_exception")
            result = equation_search(
                spec.X,
                spec.y,
                weights=spec.weights,
                options=opts,
                niterations=spec.niterations,
                resume_from=job.resume_path,
                verbosity=0,
            )
        except BaseException as e:
            self._handle_run_failure(job, e)
            return

        self._complete_lane(job, result, fingerprint)

    def _lane_options(
        self, job: Job, fingerprint: tuple, now: float, group=None,
        ckpt_base: str | None = None,
    ):
        """The server's per-run Options replacement — shared by the solo and
        fleet paths so a coalesced job behaves exactly like a solo one.
        ``ckpt_base`` (journaled solo runs only) re-enables the engine's own
        periodic checkpointer pointed into the spool: those snapshots are
        what crash recovery resumes from, bounding work loss to one
        ``SR_SERVE_CKPT_EVERY_S`` interval."""
        spec = job.spec
        timeout = spec.options.timeout_in_seconds
        if job.deadline_at is not None:
            remaining = job.deadline_at - now
            timeout = remaining if timeout is None else min(timeout, remaining)
        return dataclasses.replace(
            spec.options,
            iteration_callback=self._make_callback(job, fingerprint, group),
            timeout_in_seconds=timeout,
            max_evals=(
                spec.max_evals
                if spec.max_evals is not None
                else spec.options.max_evals
            ),
            # the server owns persistence: no CSV sidecars, and the only
            # checkpoint cadence is the durability one the journal wires in
            # (preemption snapshots are written here either way)
            save_to_file=False,
            progress=False,
            checkpoint_every=None,
            checkpoint_every_seconds=(
                self.ckpt_every_s
                if ckpt_base and self.ckpt_every_s > 0
                else None
            ),
            checkpoint_file=(
                ckpt_base if ckpt_base else spec.options.checkpoint_file
            ),
            checkpoint_keep=2 if ckpt_base else spec.options.checkpoint_keep,
        )

    def _complete_lane(self, job: Job, result, fingerprint: tuple) -> None:
        """Post-run bookkeeping for one finished search — the identical
        terminal sequence whether the search ran solo or as a fleet lane."""
        job.result = result
        job.stop_reason = getattr(result, "stop_reason", None)
        self._release_running(job)

        if job.cancel_requested.is_set() or (
            self._stopping and job.stop_reason == "callback"
        ):
            self._finalize(job, q.CANCELLED, release=False)
            return
        if job.stop_reason == "callback" and job.preempt_requested.is_set():
            self._preempt_requeue(job, result, fingerprint)
            return
        if job.stop_reason == "callback" and job.stall_stop.is_set():
            # the stall watchdog stopped this run cooperatively: snapshot
            # what it had and send it through the retry path
            with self._lock:
                self._stalls += 1
            job.error = (
                "StallDetected: no iteration heartbeat for > "
                f"{self.stall_s:.2f}s"
            )
            job.resume_path = self._spool_snapshot(job, result, fingerprint)
            job.resume_absolute = False
            self._retry_or_quarantine(job, adopt=False)
            return
        # definitive final frame from the FINISHED result: the pipelined
        # device loop's per-iteration reports lag the hall of fame by one
        # iteration, so the last streamed frame may undersell (or, for a
        # 1-iteration job, miss) the final frontier
        self._push_final_frame(job, result, fingerprint)
        if (
            job.stop_reason == "timeout"
            and job.deadline_at is not None
            and time.time() >= job.deadline_at - 0.25
        ):
            # the engine's timeout stop was OUR deadline, not the tenant's own
            # timeout_in_seconds — terminal "expired", result still attached
            self._finalize(job, q.EXPIRED, release=False)
            return
        self._finalize(job, q.DONE, release=False)

    # -- subscriptions ---------------------------------------------------------
    def _run_subscription(self, job: Job) -> None:
        """Run a ``kind="subscription"`` job: a StreamSession driven inline
        on this worker thread (the session IS the job's lane; it occupies
        the worker slot until the client cancels or the engine stops on its
        own budget). Frames flow through the job's normal frame channel;
        pre-admission ``push_rows`` staging flushes into the live session
        the moment it exists."""
        from ..stream.session import StreamSession

        spec = job.spec
        with self._lock:
            self._running[job.id] = job
        job.started_at = job.started_at or time.time()
        job.iteration_base = job.iterations_done
        job.attempts += 1
        self._jappend("start", job.id, attempts=job.attempts)

        def _on_frame(frame: bytes) -> None:
            with self._frame_cond:
                job.frames.append(frame)
                if job.ttff is None:
                    job.ttff = time.time() - job.submitted_at
                self._activity += 1
                self._frame_cond.notify_all()

        user_cb = spec.options.iteration_callback

        def _cb(report):
            job.iterations_done = job.iteration_base + report.iteration
            stop = user_cb(report) if user_cb is not None else None
            if job.cancel_requested.is_set() or self._stopping:
                return True
            return stop

        cfg = dict(spec.stream_config or {})
        cfg.setdefault("stream_every", spec.stream_every)
        cfg.setdefault("label", job.id)
        try:
            session = StreamSession(
                spec.X,
                spec.y,
                dataclasses.replace(spec.options, iteration_callback=_cb),
                weights=spec.weights,
                on_frame=_on_frame,
                **cfg,
            )
        except BaseException as e:
            self._release_running(job)
            job.error = _format_error(e)
            job.traceback = _format_traceback(e)
            self._finalize(job, q.FAILED, release=False)
            return
        with self._lock:
            job.session = session
            pending, job.pending_rows = job.pending_rows, []
        for kind, X, y, w in pending:
            if kind == "push":
                session.push_rows(X, y, w)
            else:
                session.replace_rows(X, y, w)
        try:
            result = session.run()
        except BaseException as e:
            self._release_running(job)
            job.error = _format_error(e)
            job.traceback = _format_traceback(e)
            self._finalize(job, q.FAILED, release=False)
            return

        job.result = result
        job.iterations_done = session.stats.iterations
        self._release_running(job)
        if self._stopping:
            job.stop_reason = "cancelled"
            self._finalize(job, q.CANCELLED, release=False)
        elif job.cancel_requested.is_set():
            # client cancel is the normal end of a subscription: terminal
            # DONE, final result attached
            job.stop_reason = "cancelled"
            self._finalize(job, q.DONE, release=False)
        else:
            job.stop_reason = getattr(result, "stop_reason", None)
            self._finalize(job, q.DONE, release=False)

    # -- fleet coalescing ------------------------------------------------------
    def _fleet_mates(self, lead: Job) -> list[Job] | None:
        """Coalescing admission, first sweep (under the admission lock):
        given a just-acquired lead job, take up to ``fleet_max - 1``
        compatible queued jobs (same shape bucket, no deadline, no resume
        checkpoint). Returns None when the lead itself must run solo."""
        if not self.fleet or self._stopping or lead.spec.kind != "search":
            return None
        if (
            lead.deadline_at is not None
            or lead.resume_path is not None
            or lead.solo_only
            or lead.cancel_requested.is_set()
        ):
            # deadline-urgent jobs bypass coalescing (their wall budget must
            # not be hostage to fleet drain); preemption resumes warm-start
            # solo (fleet lanes take no saved_state); a job retried after a
            # fleet failure is isolated from coalescing for good
            return None
        from ..models.device_search import fleet_eligibility

        probe = dataclasses.replace(
            lead.spec.options,
            save_to_file=False,
            checkpoint_every=None,
            checkpoint_every_seconds=None,
        )
        if fleet_eligibility(probe) is not None:
            return None
        return self._queue.take_compatible(lead, self.fleet_max - 1)

    def _gather_fleet(self, lead: Job, first: list[Job] | None) -> list[Job]:
        """Coalescing admission, straggler window: when the first sweep
        (``_fleet_mates``) came back short, wait one admission window for
        more jobs of the lead's bucket. Returns the mates, [] when the lead
        runs solo."""
        if first is None:
            return []
        mates = list(first)
        limit = self.fleet_max - 1
        if len(mates) < limit and self.fleet_window_s > 0 and not self._stopping:
            # interruptible admission window: shutdown must not hang a
            # worker for the full straggler wait
            self._stop_event.wait(self.fleet_window_s)
            mates += self._queue.take_compatible(lead, limit - len(mates))
        return mates

    def _content_key(self, job: Job) -> tuple:
        """Full search identity: options digest WITH seed, iteration/eval
        budget, and the dataset bytes. Jobs with equal keys are the SAME
        deterministic search and share one lane (request collapsing)."""
        from ..utils.checkpoint import options_fingerprint

        import numpy as np

        spec = job.spec
        h = hashlib.sha1()
        h.update(np.ascontiguousarray(spec.X).tobytes())
        h.update(np.ascontiguousarray(spec.y).tobytes())
        if spec.weights is not None:
            h.update(np.ascontiguousarray(spec.weights).tobytes())
        return (
            options_fingerprint(spec.options),
            spec.niterations,
            spec.max_evals,
            h.hexdigest(),
        )

    def _clone_result(self, result):
        """Per-rider result object for a dedup group: a fresh shell with its
        OWN hall of fame (what frames/frontier/stop bookkeeping touch) —
        the decoded populations and dataset arrays are shared read-only
        across riders (a full deepcopy costs ~10ms/rider and nothing in
        the serve path mutates them). ``engine_profile`` IS mutable —
        fleet_search attaches the same summary dict (with its live
        "counters" block) to every lane result — so it gets its own deep
        copy per rider (aliasing pinned by tests/test_fleet.py)."""
        clone = copy.copy(result)
        clone.hall_of_fame = copy.deepcopy(result.hall_of_fame)
        profile = getattr(result, "engine_profile", None)
        if profile is not None:
            clone.engine_profile = copy.deepcopy(profile)
        return clone

    def _fan_out(self, leader: Job, followers: list[Job], fingerprint) -> None:
        """Deliver a dedup group's shared result: each follower finishes
        with a clone of the leader's result (the engine is
        deterministic, so this IS the result its own run would produce).
        If the shared run stopped early through no fault of a follower
        (eviction, failure), live followers go back to the queue."""
        ok = (
            leader.result is not None
            and leader.state != q.FAILED
            and leader.stop_reason != "callback"
        )
        for f in followers:
            f.started_at = f.started_at or leader.started_at
            f.iterations_done = max(f.iterations_done, leader.iterations_done)
            if f.cancel_requested.is_set():
                self._release_running(f)
                self._finalize(f, q.CANCELLED, release=False)
            elif ok:
                self._complete_lane(f, self._clone_result(leader.result), fingerprint)
            elif leader.state == q.FAILED:
                self._release_running(f)
                f.error = leader.error
                f.traceback = leader.traceback
                self._finalize(f, q.FAILED, release=False)
            else:
                self._release_running(f)
                if leader.error is not None:
                    # the shared run broke: riders rerun solo, isolated
                    f.solo_only = True
                self._queue.resubmit(f)

    def _run_fleet(self, jobs: list[Job]) -> None:
        """Run coalesced jobs as one fleet. Jobs are first deduplicated by
        content (dataset + options incl. seed + budget): duplicates ride
        the leader's lane and fan out deep-copied results. Each unique lane
        finalizes through the same terminal sequence as a solo run the
        moment it finishes (``on_lane_done``) — a cancelled/preempted lane
        leaves the fleet early while the surviving lanes drain unchanged.
        A batch that collapses to ONE unique search skips the fleet and
        runs the solo path."""
        from ..utils.checkpoint import options_fingerprint

        grouped: dict = {}
        for job in jobs:
            grouped.setdefault(self._content_key(job), []).append(job)
        groups = list(grouped.values())

        now = time.time()
        with self._lock:
            for job in jobs:
                self._running[job.id] = job
            self._fleet_batches += 1
            self._fleet_lanes += len(jobs)
            self._fleet_max_seen = max(self._fleet_max_seen, len(jobs))
            self._fleet_deduped += len(jobs) - len(groups)
        for job in jobs:
            job.started_at = job.started_at or now
            job.heartbeat = None
            job.stall_stop.clear()
            job.iteration_base = job.iterations_done
            job.attempts += 1
            self._jappend("start", job.id, attempts=job.attempts)

        if len(groups) == 1:
            leader, followers = jobs[0], jobs[1:]
            fp = options_fingerprint(leader.spec.options)
            self._run_job(leader, group=jobs)
            self._fan_out(leader, followers, fp)
            return

        self._run_fleet_groups(groups, now)

    def _run_fleet_groups(self, groups: list, now: float) -> None:
        """Run unique-content groups as one fleet, degrading on running out
        of device memory: an out-of-memory error from the batch (real, or the
        injected ``oom_compile`` site) halves the lane set and retries each
        half; a single group that still OOMs at fleet width falls back to
        the SOLO path (a strictly smaller allocation). Jobs consume no
        retry attempt for the downshift itself — quarantine is reached only
        if the solo run fails too. Non-OOM failures keep the failure isolation:
        every incomplete member retries solo with ``solo_only``."""
        from ..models.device_search import FleetLaneSpec, fleet_search
        from ..utils.checkpoint import options_fingerprint

        leaders = [g[0] for g in groups]
        specs, fingerprints = [], []
        for group in groups:
            leader = group[0]
            fp = options_fingerprint(leader.spec.options)
            fingerprints.append(fp)
            specs.append(
                FleetLaneSpec(
                    X=leader.spec.X,
                    y=leader.spec.y,
                    options=self._lane_options(leader, fp, now, group),
                    weights=leader.spec.weights,
                    niterations=leader.spec.niterations,
                    label=leader.id,
                )
            )
        completed = [False] * len(groups)

        def _lane_done(idx: int, result) -> None:
            completed[idx] = True
            self._complete_lane(leaders[idx], result, fingerprints[idx])
            self._fan_out(leaders[idx], groups[idx][1:], fingerprints[idx])

        try:
            fleet_search(
                specs,
                on_lane_done=_lane_done,
                coalesce_wait_s=self.fleet_window_s,
                lane_bucket=self.fleet_max,
            )
        except BaseException as e:
            pending = [
                g for flag, g in zip(completed, groups) if not flag
            ]
            if is_oom_error(e) and not self._stopping:
                with self._lock:
                    self._oom_downshifts += 1
                if len(pending) > 1:
                    # halve the batch: fewer lanes stack smaller tensors —
                    # each half re-enters this path and can halve again
                    # until it fits (or collapses to the solo leg)
                    mid = (len(pending) + 1) // 2
                    for half in (pending[:mid], pending[mid:]):
                        if half:
                            self._run_fleet_groups(half, now)
                    return
                for group in pending:
                    leader = group[0]
                    fp = options_fingerprint(leader.spec.options)
                    try:
                        self._run_job(leader, group=group)
                        self._fan_out(leader, group[1:], fp)
                    except BaseException as e2:
                        for job in group:
                            self._handle_run_failure(job, e2, solo_retry=True)
                return
            # fleet failure isolation: an exception in the coalesced batch
            # must not FAIL every incomplete lane — each member retries solo
            # (solo_only, so it never re-enters a coalesced batch)
            for group in pending:
                for job in group:
                    self._handle_run_failure(job, e, solo_retry=True)

    def _push_final_frame(self, job: Job, result, fingerprint: tuple) -> None:
        from ..utils.checkpoint import dump_frontier_bytes

        frame = dump_frontier_bytes(
            result.hall_of_fame,
            iteration=max(job.iterations_done, 1),
            niterations=job.spec.niterations,
            num_evals=float(getattr(result, "num_evals", 0.0)),
            fingerprint=fingerprint,
            wall_time=time.time() - job.submitted_at,
        )
        with self._frame_cond:
            job.frames.append(frame)
            if job.ttff is None:
                job.ttff = time.time() - job.submitted_at
            self._activity += 1
            self._frame_cond.notify_all()

    def _release_running(self, job: Job) -> None:
        with self._lock:
            self._running.pop(job.id, None)
            # the bucket's programs are resident from this run on — admission
            # prefers jobs that can reuse them
            self._warm_buckets.add(job.bucket)
        self._queue.release(job)

    def _spool_snapshot(self, job: Job, result, fingerprint: tuple) -> str:
        """Write a format-2 snapshot of a cooperatively-stopped run into the
        spool (atomic tmp+fsync+rename): the resume artifact for preemption
        and for stall retries. ``exact=False``: a decoded observation, so the
        next run rescores and warm-starts over the remaining budget."""
        from ..utils.checkpoint import SearchCheckpoint, dump_checkpoint_bytes

        ck = SearchCheckpoint(
            iteration=int(job.iterations_done),
            niterations=int(job.spec.niterations),
            scheduler=job.spec.options.scheduler,
            exact=False,  # decoded observation -> rescored warm start
            populations=result.populations,
            hall_of_fame=result.hall_of_fame,
            num_evals=float(result.num_evals),
            options_fingerprint=fingerprint,
            wall_time=time.time() - job.submitted_at,
            out_j=1,
        )
        path = os.path.join(self.spool_dir, f"{job.id}.ckpt")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(dump_checkpoint_bytes(ck))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    def _preempt_requeue(self, job: Job, result, fingerprint: tuple) -> None:
        """Snapshot the evicted job's state (format-2, atomic write) and
        re-enqueue it: the next admission resumes via ``resume_from`` over
        the remaining ``niterations - iterations_done`` budget."""
        job.resume_path = self._spool_snapshot(job, result, fingerprint)
        job.resume_absolute = False
        job.preemptions += 1
        job.preempt_requested.clear()
        with self._lock:
            job.state = q.PREEMPTED
        self._jappend(
            "requeue", job.id, attempts=job.attempts, not_before=0.0,
            ckpt=job.resume_path,
        )
        self._queue.resubmit(job)

    def _handle_run_failure(
        self, job: Job, exc: BaseException, solo_retry: bool = False
    ) -> None:
        """Route one job whose run raised ``exc``: cancelled/stopping jobs
        finalize, subscriptions FAIL (a live stream has no resumable
        budget), searches go through retry-with-backoff escalating to
        QUARANTINED. No-op for jobs already finalized or already requeued —
        the worker loop's batch-wide catch-all may revisit members an inner
        handler dealt with."""
        if job.terminal or job.state in (q.QUEUED, q.PREEMPTED):
            return
        job.error = _format_error(exc)
        job.traceback = _format_traceback(exc)
        self._release_running(job)
        if job.cancel_requested.is_set():
            self._finalize(job, q.CANCELLED, release=False)
            return
        if self._stopping or job.spec.kind != "search":
            self._finalize(job, q.FAILED, release=False)
            return
        self._retry_or_quarantine(job, solo_only=solo_retry)

    def _retry_or_quarantine(
        self, job: Job, solo_only: bool = False, adopt: bool = True
    ) -> None:
        """Requeue a failed search with exponential backoff, resuming from
        the freshest spool checkpoint when one exists; once its attempts
        exceed ``SR_JOB_RETRIES`` the job is a poison job and terminates
        QUARANTINED."""
        if job.attempts > self.job_retries:
            with self._lock:
                self._quarantined += 1
            self._finalize(job, q.QUARANTINED, release=False)
            return
        with self._lock:
            self._retries += 1
        if solo_only:
            job.solo_only = True
        job.stall_stop.clear()
        job.heartbeat = None
        job.not_before = time.time() + self.retry_backoff_s * (
            2 ** max(0, job.attempts - 1)
        )
        if adopt and not self._adopt_checkpoint(job, job.resume_path):
            # nothing to resume from: the retry is a clean restart
            job.resume_path = None
            job.resume_absolute = False
            job.iterations_done = 0
        self._jappend(
            "requeue", job.id, attempts=job.attempts,
            not_before=job.not_before, error=job.error, ckpt=job.resume_path,
        )
        self._queue.resubmit(job)
        self._queue.wake_all()

    def _finalize(self, job: Job, state: str, release: bool = True) -> None:
        if release:
            self._queue.release(job)
        with self._frame_cond:
            job.state = state
            job.finished_at = time.time()
            self._activity += 1
            self._frame_cond.notify_all()
        if self.journal is not None:
            self._jappend("terminal", job.id, state=state, error=job.error)
            self._clean_spool(job)
        job.done_event.set()

    def _clean_spool(self, job: Job) -> None:
        """Drop a terminal job's spool artifacts (preempt snapshot + the
        engine checkpoint chain) — nothing will ever resume them."""
        from ..utils.checkpoint import _list_snapshots

        base = os.path.join(self.spool_dir, f"{job.id}.engine")
        paths = [p for _, p in _list_snapshots(base)]
        paths.append(os.path.join(self.spool_dir, f"{job.id}.ckpt"))
        for p in paths:
            try:
                os.remove(p)
            except OSError:
                pass
