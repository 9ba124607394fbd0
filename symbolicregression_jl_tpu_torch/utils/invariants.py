"""Global invariant auditor for the chaos harness.

Copy of ``symbolicregression_jl_tpu/utils/invariants.py``: the same
breach names and details on the same observations. Its two lazy imports
are the port's (``utils/checkpoint.load_frontier_bytes``, which reads
frames of either package, and ``serve/journal.JobJournal``).

Each serving subsystem promises a local contract — the journal truncates
torn tails, the done ledger is write-once, the net codec replays frames by
index. The chaos soak composes faults ACROSS subsystems, so what must be
checked is the global contracts those local ones are supposed to add up to.
:class:`InvariantAuditor` is the single place they are written down:

- ``exactly_once`` — zero ``duplicate_results`` on every pod host, ever
  (the write-once done ledger holds under kills, partitions, and skew);
- ``no_lost_jobs`` — every job the rig submitted (and that was not shed by
  backpressure, which the client knows about) reaches a terminal state in
  the done ledger by the end of the soak;
- ``frame_monotonic`` — per net stream, frame indices arrive contiguously
  (``0,1,2,...``) with no gap or duplicate across reconnects and server
  reboots;
- ``frames_decode`` — every published frontier frame decodes and
  CRC-verifies (torn frames never escape the truncation discipline);
- ``journal_replayable`` — after every kill, the dead generation's journal
  replays without raising, and replaying twice is idempotent (the torn
  tail truncates once, deterministically);
- ``resume_exact`` — an adopted lockstep job that resumed from iteration k
  still finishes its full budget (``iterations_done >= niterations`` in
  its terminal record); the BIT-exactness of the resumed lane is pinned by
  the dedicated pod kill drill (``chip_smoke.py`` phase 15 (a) on the
  card, ``tests/test_torch_pod.py`` on the CPU) — the soak checks budget
  integrity, which is what composition can break;
- ``bounded`` — queue depth stays within ``SR_QUEUE_MAX_DEPTH`` and the
  journal's read-only buffer within its cap (degradation sheds load, it
  does not hoard it).

The auditor is rig-agnostic: the soak's orchestrator feeds it
observations (``note_submit``/``observe_*``/``check_journal``) while it
polls the rig, then calls :meth:`finalize`. Breaches accumulate with
context instead of raising, so one soak reports every violated contract at
once — the chaos shrinker then minimizes the schedule against
``breach_names()``.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Breach", "InvariantAuditor", "TERMINAL_POD_STATES"]

# terminal job states as published in pod done records (mirrors
# serve.queue.TERMINAL_STATES without importing the serve stack — the
# auditor must stay importable in thin monitor processes)
TERMINAL_POD_STATES = frozenset(
    {"done", "failed", "expired", "cancelled", "quarantined"}
)


@dataclasses.dataclass
class Breach:
    invariant: str
    detail: str
    context: dict


class InvariantAuditor:
    """Accumulates rig observations and records invariant breaches.

    Not thread-safe by design: one monitor loop owns it (the soak's
    orchestrator polls the rig from a single thread)."""

    def __init__(self, queue_max_depth: int = 0, journal_buffer_max: int = 4096):
        self.queue_max_depth = int(queue_max_depth)
        self.journal_buffer_max = int(journal_buffer_max)
        self.breaches: list[Breach] = []
        self._submitted: set[str] = set()
        self._shed: set[str] = set()
        self._done: dict[str, dict] = {}
        self._budget: dict[str, int] = {}
        self._stream_next: dict[str, int] = {}
        self._frames_seen = 0
        self._max_queue_seen = 0
        self._duplicates_seen = 0

    # -- breach plumbing ------------------------------------------------------
    def _breach(self, invariant: str, detail: str, **context) -> None:
        self.breaches.append(Breach(invariant, detail, context))

    @property
    def ok(self) -> bool:
        return not self.breaches

    def breach_names(self) -> set[str]:
        return {b.invariant for b in self.breaches}

    # -- submission ledger ----------------------------------------------------
    def note_submit(self, pjid: str, niterations: int | None = None) -> None:
        self._submitted.add(pjid)
        if niterations is not None:
            self._budget[pjid] = int(niterations)

    def note_shed(self, pjid: str) -> None:
        """The rig's submit was refused (ServerOverloaded / read-only
        journal): the client KNOWS the job does not exist, so it is exempt
        from no_lost_jobs."""
        self._shed.add(pjid)
        self._submitted.discard(pjid)

    # -- streaming ------------------------------------------------------------
    def observe_stream_frame(self, stream_id: str, index: int) -> None:
        """Net-layer frame delivery: indices per stream must be exactly
        0,1,2,... across reconnects (the SDK's resume-from-index contract)."""
        want = self._stream_next.get(stream_id, 0)
        if index != want:
            self._breach(
                "frame_monotonic",
                f"stream {stream_id}: got frame index {index}, wanted {want}",
                stream=stream_id, index=index, expected=want,
            )
        self._stream_next[stream_id] = max(want, index + 1)

    def check_stream(
        self,
        stream_id: str,
        dup_dropped: int,
        next_index: int,
        stored: list,
        tail: list,
    ) -> None:
        """End-of-soak audit of one net subscription against the server's
        stored frame list: zero duplicates delivered, cursor exactly at the
        stored count, and the delivered tail byte-equal to the stored
        frames (exact replay across reconnects/boots)."""
        if dup_dropped:
            self._breach(
                "frame_monotonic",
                f"stream {stream_id}: {dup_dropped} duplicate frame(s) "
                "delivered",
                stream=stream_id, dup_dropped=dup_dropped,
            )
        if next_index != len(stored):
            self._breach(
                "frame_monotonic",
                f"stream {stream_id}: cursor {next_index} != stored frame "
                f"count {len(stored)}",
                stream=stream_id, next_index=next_index, stored=len(stored),
            )
        elif stored and tail[-len(stored):] != stored:
            self._breach(
                "frame_monotonic",
                f"stream {stream_id}: delivered frames diverge from the "
                "server's stored stream (lost or reordered replay)",
                stream=stream_id,
            )

    def observe_frame_bytes(self, pjid: str, frame: bytes) -> None:
        """Any published frontier frame must decode + CRC-verify."""
        from .checkpoint import load_frontier_bytes

        self._frames_seen += 1
        try:
            load_frontier_bytes(frame)
        except Exception as e:  # noqa: BLE001 — any decode failure is the breach
            self._breach(
                "frames_decode",
                f"frame for {pjid} failed to decode: {e!r}",
                pjid=pjid, error=repr(e),
            )

    # -- pod-level observations -----------------------------------------------
    def observe_done(self, pjid: str, rec: dict) -> None:
        self._done[pjid] = rec
        state = rec.get("state")
        if state not in TERMINAL_POD_STATES:
            self._breach(
                "no_lost_jobs",
                f"done record for {pjid} has non-terminal state {state!r}",
                pjid=pjid, state=state,
            )
        frame = rec.get("final_frame")
        if frame is not None:
            self.observe_frame_bytes(pjid, frame)
        resumed = rec.get("resumed_from_iteration")
        budget = self._budget.get(pjid)
        if (
            resumed is not None
            and state == "done"
            # early stops (timeout/early_stop/callback/...) legitimately end
            # under budget; natural completion has stop_reason None
            and rec.get("stop_reason") is None
            and budget is not None
            and int(rec.get("iterations_done", 0)) < budget
        ):
            self._breach(
                "resume_exact",
                f"{pjid} resumed from iter {resumed} but finished at "
                f"{rec.get('iterations_done')} < budget {budget}",
                pjid=pjid, rec={k: rec[k] for k in rec if k != "final_frame"},
            )

    def observe_host_stats(self, host: str, stats: dict) -> None:
        """Per-host ad/stats block: duplicate ledger, queue bound, journal
        buffer bound. Accepts either a PodNode.stats() dict or a heartbeat
        ad (both carry ``duplicate_results``)."""
        dups = int(stats.get("duplicate_results", 0))
        if dups > 0 and dups > self._duplicates_seen:
            self._duplicates_seen = dups
            self._breach(
                "exactly_once",
                f"host {host} counted {dups} duplicate result publications",
                host=host, duplicates=dups,
            )
        server = stats.get("server") or {}
        queued = int(server.get("queued", stats.get("queue_depth", 0)))
        self._max_queue_seen = max(self._max_queue_seen, queued)
        if self.queue_max_depth and queued > self.queue_max_depth:
            self._breach(
                "bounded",
                f"host {host} queue depth {queued} exceeds "
                f"SR_QUEUE_MAX_DEPTH={self.queue_max_depth}",
                host=host, queued=queued,
            )
        journal = server.get("journal") or {}
        buffered = int(journal.get("buffered_records", 0))
        if buffered > self.journal_buffer_max:
            self._breach(
                "bounded",
                f"host {host} journal read-only buffer at {buffered} "
                f"(cap {self.journal_buffer_max})",
                host=host, buffered=buffered,
            )

    # -- journals -------------------------------------------------------------
    def check_journal(self, journal_dir: str, context: str = "") -> None:
        """Post-kill replayability: the journal must replay without raising
        and a second replay must be idempotent (same merged state — the torn
        tail truncates exactly once)."""
        from ..serve.journal import JobJournal

        try:
            j = JobJournal(journal_dir)
            first = j.replay()
            second = j.replay()
            j.close()
        except Exception as e:  # noqa: BLE001 — replay must never raise
            self._breach(
                "journal_replayable",
                f"journal {journal_dir} ({context}) raised on replay: {e!r}",
                journal=journal_dir, error=repr(e), context=context,
            )
            return
        if first != second:
            self._breach(
                "journal_replayable",
                f"journal {journal_dir} ({context}) replay not idempotent",
                journal=journal_dir, context=context,
            )

    # -- finalization ---------------------------------------------------------
    def finalize(self) -> list[Breach]:
        """End-of-soak checks: every accepted submit must be terminal."""
        missing = sorted(self._submitted - set(self._done))
        for pjid in missing:
            self._breach(
                "no_lost_jobs",
                f"{pjid} was accepted but never reached a terminal state",
                pjid=pjid,
            )
        return self.breaches

    def report(self) -> str:
        lines = [
            f"invariants: submitted={len(self._submitted)} "
            f"shed={len(self._shed)} done={len(self._done)} "
            f"frames={self._frames_seen} max_queue={self._max_queue_seen}"
        ]
        if self.ok:
            lines.append("OK: all invariants held")
        for b in self.breaches:
            lines.append(f"BREACH [{b.invariant}] {b.detail}")
        return "\n".join(lines)
