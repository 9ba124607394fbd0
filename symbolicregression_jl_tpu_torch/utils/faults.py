"""Deterministic fault injection for the fault-tolerant search runtime.

Copy of ``symbolicregression_jl_tpu/utils/faults.py``: the grammar, the 18
sites and the injector are the same, so a spec parses to the same rules in
both packages. The port consults four of the sites so far: ``peer_death``
and ``nan_flood`` in the lockstep scheduler (``search.py``) and in the
device engine (``models/device_search.py``), ``ckpt_crash`` and
``disk_full`` in the checkpoint writer (``utils/checkpoint.py``). The other
14 come with the modules that consult them (ROADMAP.md, A: slice 4 for the
exchange and membership sites, slice 5 for the serve, net and fleet
sites); until then a rule naming one of them parses and never fires.

Production-scale searches on preemptible pods die in specific, reproducible
ways: a peer stops posting to the per-iteration exchange, a host is killed
mid-checkpoint-write, a population's loss vector goes NaN after an optimizer
excursion. This module lets tests and the CI smoke *schedule* those failures
deterministically instead of waiting for them: a spec names a fault site and
the 0-based call count at which it fires, so the same run always fails at the
same place.

Spec grammar (``Options.fault_spec`` or the ``SR_FAULT_SPEC`` env var)::

    spec   := rule (';' rule)*
    rule   := site '@' count [':' key '=' value (',' key '=' value)*]

e.g. ``"nan_flood@2:frac=0.9;ckpt_crash@1"`` — flood the populations with
NaNs on the third ``nan_flood`` site call, crash the second checkpoint write.

Fault sites (each scheduler documents which it consults):

- ``exchange_timeout`` — the KV-store allgather treats a peer (param
  ``peer``; default: the highest-id other live process) as having never
  posted, exercising the deadline/peer-loss path without waiting for a real
  network failure.
- ``peer_death`` — the process exits hard (``os._exit``, param ``code``,
  default 43), simulating preemption; ``mode=raise`` raises
  :class:`FaultInjected` instead, for in-process kill/resume tests.
- ``ckpt_crash`` — :class:`~.checkpoint.SearchCheckpointer` dies AFTER the
  tmp write but BEFORE ``os.replace`` (the classic torn-write window);
  raises :class:`CheckpointWriteCrash` (``mode=exit`` hard-exits, param
  ``code``, default 44).
- ``nan_flood`` — a fraction (param ``frac``, default 0.75) of every
  population's losses is overwritten with NaN, the storm the non-finite
  quarantine must absorb.
- ``peer_join`` — a joiner delays its elastic-membership announcement by
  ``defer_ms`` (default 0) before attaching, exercising the admission
  window (survivors must keep searching while a join is pending).
- ``kv_flap`` — one poll attempt in the KV gather's retry loop is forced to
  fail as if the coordination service flapped, exercising the
  ``SR_KV_BACKOFF_MS`` schedule at an exact attempt count.
- ``slow_peer`` — the process sleeps ``delay_ms`` (default 1000) before
  posting its exchange payload, a straggler rather than a death: peers
  must absorb it inside the shared deadline with no membership change.
- ``worker_crash`` — a ``SearchServer`` worker thread dies at the top of
  its loop (after acquiring a job, before running it); the job is requeued
  and the supervisor thread must restart the worker.
- ``job_exception`` — the serve layer's per-job run raises
  :class:`FaultInjected` just before the engine is entered, exercising the
  transient-retry / quarantine escalation path.
- ``journal_torn_write`` — the serve ``JobJournal`` writes only HALF of one
  CRC-framed record (flushed) and raises, leaving exactly the torn tail
  that replay must truncate cleanly.
- ``stall`` — the serve iteration callback blocks for ``delay_s`` (default
  30) without a heartbeat, simulating a hung run; the ``SR_JOB_STALL_S``
  watchdog must detect the frozen ``iterations_done``, request cooperative
  stop, and retry the job (the sleep polls the stop request, so the stall
  resolves the moment the watchdog fires).
- ``net_drop`` — the ``NetServer`` connection aborts (RST, nothing
  flushed) just before writing the Nth pushed stream frame: the
  kill-a-connection-mid-stream drill. Clients must reconnect and resume
  from their frame index with zero lost or duplicated frames.
- ``slow_client`` — the SDK's reader sleeps ``delay_ms`` (default 1000)
  before each receive, modelling a client that stops draining its socket;
  the server's bounded send queue / ``SR_NET_SLOW_CLIENT_S`` drain timeout
  must shed the connection instead of buffering without bound.
- ``torn_frame`` — the ``NetServer`` writes only HALF of one pushed wire
  frame (flushed) and aborts the connection — the network analogue of
  ``journal_torn_write``. The client codec must discard the torn tail on
  reconnect and the index-based resume must replay exactly.
- ``disk_full`` — an ``OSError(ENOSPC)`` raised from a durable write path
  (param ``path``: ``journal`` fires in ``JobJournal.append``, ``ckpt`` in
  ``SearchCheckpointer.save``; default fires at both). The journal must
  degrade to read-only shedding (``ServerOverloaded`` with retry-after,
  running jobs unaffected) and re-arm when space returns (param ``clear``:
  appends until the condition clears, default 1); a checkpoint ENOSPC must
  keep the previous snapshot intact — the tmp write dies, the promote
  never runs.
- ``oom_compile`` — a simulated ``RESOURCE_EXHAUSTED`` compile failure
  (:class:`ResourceExhaustedInjected`) raised at a program-cache build
  (param ``kind``: restrict to one cache kind, e.g. ``fleet_aot``). The
  serve fleet path must downshift — halve the lane batch, then fall back
  to solo — before quarantining anything.
- ``clock_skew`` — a per-host wall-clock offset (param ``offset_s``,
  default 120; param ``host``: restrict to one pod host) applied by
  :func:`skewed_time` to pod heartbeat/suspect stamps and the serve stall
  watchdog. Peers must suppress suspicion of hosts whose ads are merely
  skewed (stamped in the future) rather than stale.
- ``kv_partition`` — the CoordStore wrapper starts dropping reads/writes
  between named host groups (param ``block``: ``|``-separated substrings
  of keys to sever; param ``ops``: heal after that many further store
  operations, default 50), then heals. After heal the pod must converge
  with zero duplicate results via the write-once done ledger.

One injector is active per process at a time: ``install()`` (called by the
schedulers when ``Options.fault_spec`` is set, resetting call counts) takes
precedence over the ``SR_FAULT_SPEC`` env injector used by subprocess rigs,
where process-lifetime counting is the right semantics. The env injector is
rebuilt whenever the env var's value changes (tests that set/unset
``SR_FAULT_SPEC`` after the first ``active()`` call are honored), and
``reset_env_injector()`` drops it explicitly.
"""

from __future__ import annotations

import dataclasses
import os
import threading

__all__ = [
    "FAULT_SITES",
    "FaultInjected",
    "CheckpointWriteCrash",
    "ResourceExhaustedInjected",
    "FaultRule",
    "FaultInjector",
    "parse_fault_spec",
    "format_fault_spec",
    "install",
    "active",
    "reset_env_injector",
    "skewed_time",
]

FAULT_SITES = (
    "exchange_timeout",
    "peer_death",
    "ckpt_crash",
    "nan_flood",
    "peer_join",
    "kv_flap",
    "slow_peer",
    "worker_crash",
    "job_exception",
    "journal_torn_write",
    "stall",
    "net_drop",
    "slow_client",
    "torn_frame",
    "disk_full",
    "oom_compile",
    "clock_skew",
    "kv_partition",
)


class FaultInjected(RuntimeError):
    """An injected fault fired (``mode=raise`` variants)."""


class CheckpointWriteCrash(FaultInjected):
    """Injected ``ckpt_crash``: the snapshot's tmp file was written and
    fsynced, but the atomic promote never ran."""


class ResourceExhaustedInjected(FaultInjected):
    """Injected ``oom_compile``: a program-cache build failed for want of
    device memory. The message starts with the ``RESOURCE_EXHAUSTED`` marker
    of the JAX package's error, so one predicate classifies a real
    out-of-memory failure and this simulation alike."""

    def __init__(self, kind: str, key: object):
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected compile OOM at program-cache "
            f"build kind={kind!r} key={key!r}"
        )


@dataclasses.dataclass(frozen=True)
class FaultRule:
    site: str
    at: int  # 0-based call count at the site when the rule fires
    params: tuple  # ((key, value), ...) — hashable, dict'ed at fire time


def _coerce(value: str):
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        return value


def parse_fault_spec(
    spec: str, extra_sites: tuple[str, ...] = ()
) -> tuple[FaultRule, ...]:
    """Parse the spec grammar above; raises ValueError on malformed input
    (Options.__post_init__ calls this to validate ``fault_spec`` eagerly).

    ``extra_sites`` admits harness-level pseudo-sites beyond FAULT_SITES —
    the chaos orchestrator serializes whole schedules (kills, restarts) in
    this grammar so a shrunk repro is one copy-pasteable string."""
    rules = []
    for chunk in spec.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        head, _, tail = chunk.partition(":")
        site, sep, count = head.partition("@")
        site = site.strip()
        if site not in FAULT_SITES and site not in extra_sites:
            raise ValueError(
                f"unknown fault site {site!r} in {chunk!r}; "
                f"expected one of {FAULT_SITES}"
            )
        if not sep or not count.strip().isdigit():
            raise ValueError(
                f"fault rule {chunk!r} needs 'site@N' with integer N"
            )
        params = []
        if tail:
            for kv in tail.split(","):
                key, sep2, value = kv.partition("=")
                if not sep2 or not key.strip():
                    raise ValueError(f"malformed fault param {kv!r} in {chunk!r}")
                params.append((key.strip(), _coerce(value.strip())))
        rules.append(FaultRule(site, int(count.strip()), tuple(params)))
    return tuple(rules)


def format_fault_spec(rules) -> str:
    """Inverse of :func:`parse_fault_spec`: render rules back to the spec
    grammar (``parse(format(rules)) == tuple(rules)`` for coercible params).
    The chaos shrinker emits minimal repros through this."""
    chunks = []
    for r in rules:
        head = f"{r.site}@{r.at}"
        if r.params:
            head += ":" + ",".join(f"{k}={v}" for k, v in r.params)
        chunks.append(head)
    return ";".join(chunks)


class FaultInjector:
    """Per-site call counter + rule matcher. Thread-safe: the async island
    scheduler fires sites from worker threads."""

    def __init__(self, rules: tuple[FaultRule, ...] = ()):
        self._rules = tuple(rules)
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def armed(self, site: str) -> bool:
        """Any rule targets this site? (Cheap pre-check so un-faulted runs
        skip the counting lock entirely.)"""
        return any(r.site == site for r in self._rules)

    def fire(self, site: str) -> dict | None:
        """Count one call at ``site``; return the matching rule's params
        (a fresh dict) when a rule's count is reached, else None."""
        if not self._rules:
            return None
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
        for r in self._rules:
            if r.site == site and r.at == n:
                return dict(r.params)
        return None

    def maybe_die(self, site: str = "peer_death") -> None:
        """Fire ``site``; on a hit, exit hard (simulated preemption) or, for
        ``mode=raise`` rules, raise FaultInjected."""
        hit = self.fire(site)
        if hit is None:
            return
        if hit.get("mode") == "raise":
            raise FaultInjected(f"injected {site}")
        os._exit(int(hit.get("code", 43)))


_NULL = FaultInjector()
_installed: FaultInjector | None = None
_env_injector: FaultInjector | None = None
_env_spec: str | None = None  # the SR_FAULT_SPEC value _env_injector was built from


def install(spec: str | None) -> FaultInjector:
    """Install a process-wide injector from a spec (``Options.fault_spec``),
    resetting call counts; ``None`` clears back to the env/null injector."""
    global _installed
    _installed = FaultInjector(parse_fault_spec(spec)) if spec else None
    return _installed if _installed is not None else active()


def reset_env_injector() -> None:
    """Drop the cached env injector so the next :func:`active` re-reads
    ``SR_FAULT_SPEC`` and restarts its call counts (rig/test hook)."""
    global _env_injector, _env_spec
    _env_injector = None
    _env_spec = None


def active() -> FaultInjector:
    """The process's active injector: the installed one, else one built from
    SR_FAULT_SPEC, else a null injector that never fires. The env injector
    is rebuilt whenever the env var's VALUE differs from the one it was
    built from — changing or unsetting SR_FAULT_SPEC mid-process takes
    effect at the next call instead of being silently ignored (call counts
    restart with the new spec; an unchanged spec keeps its counts)."""
    global _env_injector, _env_spec
    if _installed is not None:
        return _installed
    spec = os.environ.get("SR_FAULT_SPEC", "")
    if _env_injector is None or spec != _env_spec:
        _env_spec = spec
        _env_injector = FaultInjector(parse_fault_spec(spec)) if spec else _NULL
    return _env_injector


def skewed_time(host: str | None = None) -> float:
    """``time.time()`` plus any injected per-host clock skew. Pod heartbeat
    stamps, suspect scans, and the serve stall watchdog read the wall clock
    through this, so a ``clock_skew`` rule shifts ONE host's notion of
    "now" while the rest of the pod stays honest. The skew latches: once
    the rule's call count is reached the offset applies to every later
    call (a skewed clock stays skewed until the injector is replaced)."""
    import time

    inj = active()
    if inj.armed("clock_skew"):
        hit = inj.fire("clock_skew")
        if hit is not None:
            want = hit.get("host")
            if want is None or host is None or str(want) == str(host):
                inj._skew_offset = float(hit.get("offset_s", 120.0))
        off = getattr(inj, "_skew_offset", 0.0)
        if off:
            return time.time() + off
    return time.time()
