"""Job model + admission queue for the multi-tenant search server.

Counterpart of ``symbolicregression_jl_tpu/serve/queue.py``, with the same
names, states, admission order and bucket digest (``bucket_digest`` of equal
inputs is the same 12 hex digits in both packages).

A job is one single-output ``equation_search`` with a tenant, a priority,
and optional budgets (wall-clock deadline from SUBMIT time, eval budget).
The queue admits jobs to workers by, in order:

1. **priority** (higher first) — the preemption total order;
2. **shape-bucket warmth** — among equal priorities, jobs whose
   (shapes, Options-digest) bucket the server has already run go first, so
   a mixed backlog batches same-bucket jobs (the fleet coalesces them, and
   their datasets' uploads are already in the program cache) instead of
   interleaving buckets;
3. **submit order** (FIFO) — fairness within a warm bucket.

Warmth ordering alone can starve a cold-bucket job indefinitely under a
steady same-priority warm stream, so warmth is bounded by **submit-age
escalation**: once a queued job has waited longer than ``SR_QUEUE_AGE_S``
(seconds, default 30; ``0`` disables aging), its warmth term is forced to
the warm value — an aged cold-bucket job competes on FIFO order alone and
the warm stream can no longer leapfrog it. Priority still dominates: aging
never promotes a job past a higher-priority one.

Per-tenant quotas bound how many of a tenant's jobs RUN concurrently (queued
jobs are unlimited): a tenant flooding the queue cannot starve others of
worker slots, only of its own.

Everything here is host-side: the queue never touches torch or the card.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any

import numpy as np

__all__ = [
    "JobSpec", "Job", "JobQueue", "ServerOverloaded", "shape_bucket",
    "options_digest", "bucket_digest", "queue_age_seconds",
]


# -- terminal + transient job states ------------------------------------------
QUEUED = "queued"
RUNNING = "running"
PREEMPTED = "preempted"  # transient: evicted by a higher-priority tenant,
#                          checkpointed, about to re-enter the queue
DONE = "done"
FAILED = "failed"
EXPIRED = "expired"  # deadline elapsed (queued or mid-run)
CANCELLED = "cancelled"
QUARANTINED = "quarantined"  # poison job: failed on every retry attempt

TERMINAL_STATES = frozenset(
    {DONE, FAILED, EXPIRED, CANCELLED, QUARANTINED}
)


class ServerOverloaded(RuntimeError):
    """submit() rejected: the queue is at ``SR_QUEUE_MAX_DEPTH``. The job was
    never created — resubmit later (load shedding is the backpressure
    contract; an unbounded queue under sustained overload only converts
    every deadline into an expiry)."""


def queue_age_seconds() -> float:
    """SR_QUEUE_AGE_S: queued age past which a job's effective admission
    priority rises past shape-bucket warmth (head-of-line aging). 0 disables
    aging. Read per admission pass — a live server honors changes."""
    try:
        return float(os.environ.get("SR_QUEUE_AGE_S", "30"))
    except ValueError:
        return 30.0


def options_digest(options) -> tuple:
    """Hashable digest of the Options axes that decide whether two searches
    can share one engine (a fleet's lanes must share one engine config): the
    JAX package's digest, whose axes select its compiled programs."""
    from ..utils.checkpoint import options_fingerprint

    # The checkpoint fingerprint ends with options.seed; the seed is runtime
    # data (EvoConfig carries no seed), so it is sliced off here — jobs
    # differing only by seed share a bucket and can coalesce into one fleet.
    return (
        options_fingerprint(options)[:-1],
        options.scheduler,
        str(np.dtype(options.dtype)),
        int(options.maxsize),
        getattr(options.loss, "__name__", repr(options.loss)),
        bool(options.batching) and int(options.batch_size),
    )


def shape_bucket(X, y, weights, options) -> tuple:
    """The admission bucket: jobs in one bucket can run as lanes of one
    fleet (equal shapes and dtypes, equal Options digest)."""
    X = np.asarray(X)
    y = np.asarray(y)
    return (
        X.shape,
        str(X.dtype),
        y.shape,
        str(y.dtype),
        weights is not None,
        options_digest(options),
    )


def bucket_digest(bucket: tuple) -> str:
    """12-hex digest of a :func:`shape_bucket` tuple — the warmth currency
    pod hosts advertise over the CoordStore. The full tuple is big (it
    embeds the Options digest) and only equality matters cross-process;
    every element reprs deterministically (shapes, dtype strings, ints,
    bools, operator/loss *names*), so equal buckets digest equally in any
    process running the same code."""
    import hashlib

    return hashlib.sha1(repr(bucket).encode()).hexdigest()[:12]


@dataclasses.dataclass
class JobSpec:
    """What a tenant submits. ``options.scheduler`` picks the engine;
    ``deadline_seconds`` is a wall budget measured from SUBMIT (covering
    queue wait — an expired job is terminal even if it never ran).
    ``deadline_seconds=None`` means **never expires**: queue-side sweeps and
    mid-run checks alike must skip deadline-less jobs (pinned by
    tests/test_torch_serve.py).

    ``kind="subscription"`` is the streaming job type: a deadline-less
    search over a live dataset (``stream.StreamSession``) that emits
    format-2 frontier frames indefinitely until the client cancels.
    Subscriptions are necessarily deadline-less and non-preemptible (there
    is no finite remaining-iterations budget for a preemption checkpoint to
    resume over), and never coalesce into fleets (each owns its own
    long-lived lane). ``stream_config`` passes StreamSession knobs through
    (row_bucket, window, drift=..., ...); ``niterations`` is ignored."""

    X: Any
    y: Any
    options: Any
    weights: Any = None
    niterations: int = 10
    tenant: str = "default"
    priority: int = 0  # higher runs (and preempts) first
    deadline_seconds: float | None = None
    max_evals: int | None = None
    preemptible: bool = True
    stream_every: int = 1  # frontier frame cadence, in iterations
    label: str = ""
    kind: str = "search"  # "search" | "subscription"
    stream_config: dict | None = None  # StreamSession kwargs (subscriptions)

    def __post_init__(self):
        self.X = np.asarray(self.X)
        self.y = np.asarray(self.y)
        if self.weights is not None:
            self.weights = np.asarray(self.weights)
        if self.y.ndim != 1:
            raise ValueError(
                "serve jobs are single-output (y must be 1-D); submit one "
                "job per output row"
            )
        if self.kind not in ("search", "subscription"):
            raise ValueError(
                f"unknown job kind {self.kind!r} (search | subscription)"
            )
        if self.kind == "subscription":
            if self.deadline_seconds is not None:
                raise ValueError(
                    "subscription jobs are deadline-less "
                    "(deadline_seconds must be None)"
                )
            self.preemptible = False
        elif self.stream_config is not None:
            raise ValueError("stream_config is subscription-only")
        if self.niterations < 1:
            raise ValueError("niterations must be >= 1")
        if self.deadline_seconds is not None and self.deadline_seconds <= 0:
            raise ValueError("deadline_seconds must be > 0 (or None)")
        if self.stream_every < 1:
            raise ValueError("stream_every must be >= 1")


class Job:
    """One submitted search: spec + lifecycle state + streaming channel.

    State transitions::

        queued -> running -> done | failed | expired | cancelled
        running -> preempted -> queued            (checkpoint + requeue)
        queued -> expired | cancelled             (never ran)

    ``frames`` accumulates format-2 frontier frames (bytes); ``ttff`` is the
    submit-to-first-frame wall (the serving latency metric). ``resume_path``
    points at the preemption checkpoint consumed by ``resume_from`` on the
    next admission."""

    def __init__(self, job_id: str, spec: JobSpec, seq: int):
        self.id = job_id
        self.spec = spec
        self.seq = seq  # FIFO tiebreak
        self.bucket = shape_bucket(spec.X, spec.y, spec.weights, spec.options)
        self.state = QUEUED
        self.result = None
        self.error: str | None = None
        self.stop_reason: str | None = None
        self.submitted_at = time.time()
        self.started_at: float | None = None
        self.finished_at: float | None = None
        self.deadline_at = (
            None
            if spec.deadline_seconds is None
            else self.submitted_at + spec.deadline_seconds
        )
        self.ttff: float | None = None
        self.frames: list[bytes] = []  # guarded by the owning queue's lock
        self.iterations_done = 0
        self.iteration_base = 0  # completed iterations before the current run
        self.preemptions = 0
        self.resume_path: str | None = None
        # -- durability / self-healing state --
        self.attempts = 0  # run attempts consumed (retry accounting)
        self.not_before = 0.0  # backoff: not admissible before this wall time
        self.solo_only = False  # retried fleet mate: never coalesce again
        self.traceback: str | None = None  # bounded formatted traceback
        self.heartbeat: float | None = None  # wall time of last iteration tick
        self.stall_stop = threading.Event()  # watchdog's cooperative stop
        self.quota_held = False  # tenant quota slot charged (idempotent release)
        self.resume_absolute = False  # exact lockstep resume: callback reports
        #                               ABSOLUTE iterations, not run-relative
        self.resumed_from_iteration: int | None = None
        self.journal_progress_at = 0.0  # last progress-record wall time
        self.preempt_requested = threading.Event()
        self.cancel_requested = threading.Event()
        self.done_event = threading.Event()
        # subscription plumbing: rows pushed before the session exists are
        # staged here (guarded by the server lock) and flushed on start;
        # ``session`` is the live StreamSession once the job is admitted
        self.pending_rows: list = []
        self.session = None

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def summary(self) -> dict:
        return {
            "id": self.id,
            "tenant": self.spec.tenant,
            "label": self.spec.label,
            "kind": self.spec.kind,
            "state": self.state,
            "priority": self.spec.priority,
            "iterations_done": self.iterations_done,
            "preemptions": self.preemptions,
            "attempts": self.attempts,
            "ttff_seconds": self.ttff,
            "stop_reason": self.stop_reason,
            "error": self.error,
            "traceback": self.traceback,
            "frames": len(self.frames),
        }


class JobQueue:
    """Priority + warm-bucket + quota admission over a condition variable.

    ``acquire`` blocks a worker until an admissible job exists (or timeout);
    ``release`` returns a tenant's quota slot when its job leaves RUNNING.
    All mutation happens under one lock — the queue is the serialization
    point the serve layer hangs its bookkeeping off."""

    def __init__(self, default_quota: int = 2, quotas: dict | None = None):
        if default_quota < 1:
            raise ValueError("default_quota must be >= 1")
        self.default_quota = int(default_quota)
        self.quotas = dict(quotas or {})
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: list[Job] = []
        self._running_by_tenant: dict[str, int] = {}

    def _quota(self, tenant: str) -> int:
        return int(self.quotas.get(tenant, self.default_quota))

    # -- submit side ----------------------------------------------------------
    def submit(self, job: Job) -> None:
        with self._cond:
            job.state = QUEUED
            self._pending.append(job)
            self._cond.notify_all()

    def resubmit(self, job: Job) -> None:
        """Re-enqueue a preempted job. Keeps the ORIGINAL submit seq, so a
        preempted job re-enters ahead of later arrivals of its priority."""
        self.submit(job)

    # -- worker side ----------------------------------------------------------
    def _admissible(self, warm_buckets) -> Job | None:
        # caller holds the lock
        best = None
        best_key = None
        age_s = queue_age_seconds()
        now = time.time()
        for job in self._pending:
            if job.cancel_requested.is_set():
                continue
            if job.not_before > now:
                continue  # retry backoff: deferred, not admissible yet
            tenant = job.spec.tenant
            if self._running_by_tenant.get(tenant, 0) >= self._quota(tenant):
                continue
            # head-of-line aging: a job queued past SR_QUEUE_AGE_S competes
            # as if its bucket were warm, so a steady warm stream cannot
            # starve cold-bucket submissions (priority still dominates)
            aged = age_s > 0 and now - job.submitted_at >= age_s
            key = (
                -job.spec.priority,
                0 if aged or job.bucket in warm_buckets else 1,
                job.seq,
            )
            if best is None or key < best_key:
                best, best_key = job, key
        return best

    def acquire(self, warm_buckets=(), timeout: float | None = None) -> Job | None:
        """Pop the best admissible job and charge its tenant's quota. Returns
        None on timeout (or immediately when timeout=0 and nothing fits)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                job = self._admissible(warm_buckets)
                if job is not None:
                    self._pending.remove(job)
                    t = job.spec.tenant
                    self._running_by_tenant[t] = (
                        self._running_by_tenant.get(t, 0) + 1
                    )
                    job.state = RUNNING
                    job.quota_held = True
                    return job
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(remaining):
                        return None

    def take_compatible(self, lead: Job, limit: int) -> list[Job]:
        """Pop up to ``limit`` further queued jobs coalescible with ``lead``
        into one fleet batch, charging each tenant's quota like ``acquire``.

        Compatible means: identical shape bucket (so the lanes share one
        engine config and need no row padding), no deadline (deadline-
        urgent jobs run solo so their wall budget is not hostage to fleet
        drain), no resume checkpoint (a preempted job warm-starts solo), and
        not cancelled. FIFO within the bucket; never blocks."""
        out: list[Job] = []
        now = time.time()
        with self._cond:
            taken = []
            for job in sorted(self._pending, key=lambda j: j.seq):
                if len(out) >= limit:
                    break
                if job.cancel_requested.is_set():
                    continue
                if job.spec.kind != "search":
                    # subscriptions own a long-lived lane of their own; they
                    # never ride a finite fleet batch
                    continue
                if job.bucket != lead.bucket:
                    continue
                if job.deadline_at is not None or job.resume_path is not None:
                    continue
                if job.solo_only or job.not_before > now:
                    # a job retried after a fleet failure is isolated: it
                    # never re-enters a coalesced batch, and backoff-deferred
                    # jobs are not admissible yet
                    continue
                tenant = job.spec.tenant
                if self._running_by_tenant.get(tenant, 0) >= self._quota(tenant):
                    continue
                taken.append(job)
                self._running_by_tenant[tenant] = (
                    self._running_by_tenant.get(tenant, 0) + 1
                )
                job.state = RUNNING
                job.quota_held = True
                out.append(job)
            for job in taken:
                self._pending.remove(job)
        return out

    def release(self, job: Job) -> None:
        """Return the tenant's quota slot when a job leaves RUNNING (to a
        terminal state or back to the queue via preemption). Idempotent:
        keyed on ``job.quota_held`` so a failure path that releases in its
        handler AND in the worker loop's catch-all cannot double-credit the
        tenant."""
        with self._cond:
            if not job.quota_held:
                return
            job.quota_held = False
            t = job.spec.tenant
            n = self._running_by_tenant.get(t, 0) - 1
            if n > 0:
                self._running_by_tenant[t] = n
            else:
                self._running_by_tenant.pop(t, None)
            self._cond.notify_all()

    # -- maintenance ----------------------------------------------------------
    def take_expired(self, now: float | None = None) -> list[Job]:
        """Remove and return queued jobs whose deadline passed while waiting
        (plus cancelled ones) — they are terminal without ever running."""
        now = time.time() if now is None else now
        out = []
        with self._cond:
            keep = []
            for job in self._pending:
                if job.cancel_requested.is_set():
                    out.append(job)
                elif job.deadline_at is not None and now >= job.deadline_at:
                    out.append(job)
                else:
                    keep.append(job)
            self._pending = keep
        return out

    def drain(self) -> list[Job]:
        """Remove and return ALL pending jobs regardless of quota/warmth
        (shutdown path — quota-blocked jobs must still reach a terminal
        state)."""
        with self._cond:
            out = self._pending
            self._pending = []
            self._cond.notify_all()
        return out

    def remove(self, job: Job) -> bool:
        with self._cond:
            try:
                self._pending.remove(job)
                return True
            except ValueError:
                return False

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)

    def wake_all(self) -> None:
        """Unblock every waiting worker (shutdown path)."""
        with self._cond:
            self._cond.notify_all()
