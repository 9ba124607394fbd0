"""Write-ahead job journal for the durable serve runtime.

Counterpart of ``symbolicregression_jl_tpu/serve/journal.py`` with the same
file layout (magic, frames, record dicts), so a journal written by either
package replays to the same merged state in the other (spec bytes aside:
each package pickles its own JobSpec).

Every job lifecycle transition the :class:`~.server.SearchServer` must be
able to reconstruct after a crash is appended here as one CRC-framed
record: ``submit`` (with the pickled JobSpec — the payload a restarted
server needs to resubmit the job), ``start`` (attempt count + the spool
checkpoint base the engine snapshots into), ``progress`` (throttled
iteration heartbeats, informational), ``requeue`` (retry/preempt with
backoff ``not_before`` and the checkpoint to resume from), and ``terminal``
(final state + error). Replaying the journal yields one merged record per
job — the exact worklist crash recovery resubmits.

Durability discipline (the checkpoint writer's rules, applied to a log):

- **Appends are framed**: ``u32 length | u32 crc32 | pickle payload`` after
  an 8-byte file magic. A crash mid-append leaves a *torn tail* — a frame
  whose length/CRC/pickle cannot validate — and :meth:`replay` truncates
  the file back to the last good frame instead of raising: a torn tail can
  lose at most the record being written, never a committed one, and replay
  can never invent a job from garbage bytes.
- **Records that gate correctness are fsynced** (submit/start/requeue/
  terminal); ``progress`` heartbeats flush without fsync — losing them
  costs nothing (the engine checkpoint carries the authoritative
  iteration).
- **Rotation is atomic**: when the log outgrows ``max_bytes`` (default
  ``SR_SERVE_JOURNAL_MAX_MB`` = 64), the merged state is compacted into
  ``snapshot`` records written tmp-first, fsynced, and promoted with
  ``os.replace`` — the same tmp+fsync+rename window the checkpointer uses,
  so a crash mid-rotation keeps the previous log intact. Terminal jobs
  survive one rotation as slim tombstones (spec dropped) so a restarted
  server still reports them exactly once, and the oldest tombstones are
  pruned past ``keep_terminal``.

The journal is entirely optional: with no ``journal_dir`` the server never
constructs one and every call site is a ``None`` guard — zero locks, zero
I/O on the undurable hot path.

The ``journal_torn_write`` fault site (``utils/faults.py``) deterministically
produces a half-written frame for the torn-tail drills.

**Disk-full degradation:** an ``ENOSPC`` from the append path — real,
or injected via the ``disk_full`` fault site — must not crash the worker
that happened to hold the pen. The journal instead (1) attempts an
emergency compaction (rotation drops terminal tombstones — on a genuinely
full disk this is the only write that can *shrink* the footprint), (2)
retries the append once, and (3) on a second failure enters **read-only
shedding mode**: ``submit`` records raise :class:`JournalDiskFull` (the
server surfaces it as ``ServerOverloaded`` with a retry-after hint — a job
whose submit cannot be made durable is refused, not silently undurable),
while records for jobs ALREADY running (start/progress/requeue/terminal)
are buffered in memory (bounded) and the jobs keep running. Every later
append probes the disk; the first success **re-arms** the journal, flushing
the buffered records in order before the probe record. A crash while
read-only loses only the buffered records — never a committed frame, and
never a submit (those were shed, so the client knows to resubmit).
"""

from __future__ import annotations

import errno
import os
import pickle
import struct
import threading
import time
import zlib

__all__ = ["JobJournal", "JournalDiskFull", "JOURNAL_MAGIC"]

# read-only mode buffers at most this many records for running jobs; past it,
# progress records are dropped first (they are informational), then oldest
_PENDING_MAX = 4096

JOURNAL_MAGIC = b"SRJRNL01"
_HDR = struct.Struct("<II")  # payload length, crc32(payload)
_MAX_RECORD = 1 << 27  # 128 MB: a length field past this is corruption


def _journal_max_bytes() -> int:
    try:
        mb = float(os.environ.get("SR_SERVE_JOURNAL_MAX_MB", "64"))
    except ValueError:
        mb = 64.0
    return int(mb * (1 << 20))


class JournalDiskFull(OSError):
    """A ``submit`` append was shed because the journal is in read-only
    (disk-full) mode: the job was NOT made durable and must be resubmitted
    once space returns. The server maps this to ``ServerOverloaded``."""

    def __init__(self, msg: str):
        super().__init__(errno.ENOSPC, msg)


def _fresh_state(job_id: str) -> dict:
    return {
        "job": job_id,
        "seq": 0,
        "state": "queued",
        "attempts": 0,
        "spec": None,  # pickled JobSpec bytes, or None (undurable)
        "kind": "search",
        "submitted_at": 0.0,
        "not_before": 0.0,
        "ckpt": None,  # checkpoint base/path to resume from
        "iterations_done": 0,
        "error": None,
    }


class JobJournal:
    """Append-only, CRC-framed, crash-truncating job journal.

    Thread-safe: submit-side and worker threads append concurrently. The
    journal also maintains the merged per-job state map as records are
    appended/replayed, so rotation can compact from its own view and crash
    recovery reads one dict per job instead of re-merging."""

    def __init__(
        self,
        directory: str,
        fsync: bool = True,
        max_bytes: int | None = None,
        keep_terminal: int = 1000,
    ):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.path = os.path.join(directory, "journal.log")
        self.fsync = bool(fsync)
        self.max_bytes = _journal_max_bytes() if max_bytes is None else int(max_bytes)
        self.keep_terminal = int(keep_terminal)
        self._lock = threading.RLock()
        self._state: dict[str, dict] = {}
        self._fh = None
        self._appended = 0
        self._rotations = 0
        self._torn_bytes = 0
        self._undurable = 0
        # -- disk-full degradation state --
        self._read_only = False
        self._pending: list[tuple[bytes, dict, bool]] = []  # (frame, rec, fsync)
        self._enospc_events = 0
        self._emergency_compactions = 0
        self._rearms = 0
        self._shed_submits = 0
        self._dropped_buffered = 0
        self._simulated_enospc = 0  # injected: this many appends still see ENOSPC

    # -- record merge ---------------------------------------------------------
    def _merge(self, rec: dict) -> None:
        job_id = rec.get("job")
        if not isinstance(job_id, str):
            return
        st = self._state.setdefault(job_id, _fresh_state(job_id))
        t = rec.get("type")
        if t in ("submit", "snapshot"):
            for key in (
                "seq", "state", "attempts", "spec", "kind", "submitted_at",
                "not_before", "ckpt", "iterations_done", "error",
            ):
                if key in rec:
                    st[key] = rec[key]
        elif t == "start":
            st["state"] = "running"
            st["attempts"] = int(rec.get("attempts", st["attempts"]))
            if rec.get("ckpt") is not None:
                st["ckpt"] = rec["ckpt"]
        elif t == "requeue":
            st["state"] = "queued"
            st["attempts"] = int(rec.get("attempts", st["attempts"]))
            st["not_before"] = float(rec.get("not_before", 0.0))
            if rec.get("ckpt") is not None:
                st["ckpt"] = rec["ckpt"]
            if rec.get("error") is not None:
                st["error"] = rec["error"]
        elif t == "progress":
            st["iterations_done"] = int(
                rec.get("iterations_done", st["iterations_done"])
            )
        elif t == "terminal":
            st["state"] = rec.get("state", "failed")
            st["error"] = rec.get("error")

    # -- replay ---------------------------------------------------------------
    def replay(self) -> dict[str, dict]:
        """Read the log, truncate any torn tail, and return the merged
        per-job state (a deep-enough copy: one fresh dict per job). Never
        raises on a torn/corrupt tail — the first frame that fails the
        length/CRC/pickle checks ends the replay and the file is truncated
        back to the last committed frame."""
        with self._lock:
            self._close()
            self._state = {}
            if not os.path.exists(self.path):
                self._reset_file()
                self._open_append()
                return {}
            with open(self.path, "rb") as f:
                data = f.read()
            if data[: len(JOURNAL_MAGIC)] != JOURNAL_MAGIC:
                # not our log (or torn inside the magic): start fresh
                self._torn_bytes += len(data)
                self._reset_file()
                self._open_append()
                return {}
            good = len(JOURNAL_MAGIC)
            off = good
            records: list[dict] = []
            while True:
                if off + _HDR.size > len(data):
                    break
                length, crc = _HDR.unpack_from(data, off)
                if length == 0 or length > _MAX_RECORD:
                    break
                end = off + _HDR.size + length
                if end > len(data):
                    break
                payload = data[off + _HDR.size : end]
                if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    break
                try:
                    rec = pickle.loads(payload)
                except Exception:
                    break
                if not isinstance(rec, dict) or "type" not in rec:
                    break
                records.append(rec)
                off = good = end
            if good < len(data):
                self._torn_bytes += len(data) - good
                with open(self.path, "r+b") as f:
                    f.truncate(good)
            for rec in records:
                self._merge(rec)
            self._open_append()
            return {k: dict(v) for k, v in self._state.items()}

    # -- append ---------------------------------------------------------------
    def append(self, type_: str, job_id: str, fsync: bool = True, **fields) -> None:
        """Append one record. ``fsync=False`` (progress heartbeats) flushes
        to the OS but skips the disk barrier. ENOSPC degrades instead of
        propagating: see the module docstring (raises :class:`JournalDiskFull`
        only for shed ``submit`` records)."""
        from ..utils import faults

        rec = {"type": type_, "job": job_id, "t": time.time(), **fields}
        payload = pickle.dumps(rec, protocol=pickle.HIGHEST_PROTOCOL)
        frame = _HDR.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload
        with self._lock:
            if self._fh is None:
                self._open_append()
            inj = faults.active()
            hit = inj.fire("journal_torn_write")
            if hit is not None:
                # half a frame, flushed: exactly the crash-mid-append tail
                cut = max(1, len(frame) // 2)
                self._fh.write(frame[:cut])
                self._fh.flush()
                os.fsync(self._fh.fileno())
                raise faults.FaultInjected("injected journal_torn_write")
            if inj.armed("disk_full"):
                df = inj.fire("disk_full")
                if df is not None and str(df.get("path", "both")) in (
                    "journal", "both",
                ):
                    # this append plus the next `clear` see a full disk
                    self._simulated_enospc = 1 + max(0, int(df.get("clear", 1)))
            try:
                self._write_frame_locked(frame, fsync)
            except OSError as exc:
                if exc.errno != errno.ENOSPC:
                    raise
                self._enospc_locked(rec, frame, fsync, exc)
                return
            if self._read_only:
                # the probe write succeeded: space is back — re-arm, flushing
                # the records buffered for running jobs (they precede the
                # probe in the file because _write_frame_locked drains them
                # first; reaching here means the whole drain committed)
                self._read_only = False
                self._rearms += 1
            self._merge(rec)
            self._appended += 1
            if self.max_bytes and self._fh.tell() > self.max_bytes:
                self._rotate_locked()

    def _write_one_locked(self, frame: bytes, fsync: bool) -> None:
        """Write exactly one frame. On ENOSPC — injected or real — truncate
        back to the pre-write offset so a PARTIAL frame never poisons the
        tail (later successful appends would land after it and be lost to
        replay's torn-tail truncation), then re-raise."""
        if self._simulated_enospc > 0:
            self._simulated_enospc -= 1
            raise OSError(errno.ENOSPC, "No space left on device (injected)")
        pos = self._fh.tell()
        try:
            self._fh.write(frame)
            self._fh.flush()
            if fsync and self.fsync:
                os.fsync(self._fh.fileno())
        except OSError:
            try:
                self._fh.truncate(pos)
            except OSError:
                pass
            raise

    def _write_frame_locked(self, frame: bytes, fsync: bool) -> None:
        """Write one frame, draining any read-only buffer first (oldest
        first, so replay order matches append order). Raises OSError(ENOSPC)
        without touching merged state."""
        while self._pending:
            pframe, _prec, pfsync = self._pending[0]
            self._write_one_locked(pframe, pfsync)
            self._pending.pop(0)
            self._appended += 1
        self._write_one_locked(frame, fsync)

    def _enospc_locked(self, rec, frame, fsync, exc) -> None:
        """Degrade on a full disk: emergency-compact once, retry, then shed
        submits / buffer running-job records. Never propagates ENOSPC for
        non-submit records — the job keeps running undurably."""
        self._enospc_events += 1
        first = not self._read_only
        self._read_only = True
        if first:
            # emergency compaction: tombstones are the only mass we can shed
            # without losing live state; on a real full disk the tmp-file
            # write may itself fail — that's fine, stay read-only
            try:
                self._rotate_locked()
                self._emergency_compactions += 1
            except OSError:
                pass
            # one immediate retry: compaction may have freed enough
            try:
                self._write_frame_locked(frame, fsync)
            except OSError as exc2:
                if exc2.errno != errno.ENOSPC:
                    raise
            else:
                self._read_only = False
                self._rearms += 1
                self._merge(rec)
                self._appended += 1
                return
        if rec.get("type") == "submit":
            # durability IS the submit contract: refuse rather than accept a
            # job that would vanish on crash
            self._shed_submits += 1
            raise JournalDiskFull(
                f"journal read-only (disk full): submit {rec.get('job')!r} "
                f"shed after {self._enospc_events} ENOSPC events"
            ) from exc
        # running jobs keep going: buffer (bounded, progress dropped first)
        if len(self._pending) >= _PENDING_MAX:
            idx = next(
                (i for i, (_, r, _) in enumerate(self._pending)
                 if r.get("type") == "progress"),
                0,
            )
            self._pending.pop(idx)
            self._dropped_buffered += 1
        self._pending.append((frame, rec, fsync))
        self._merge(rec)

    def append_submit(self, job) -> bool:
        """Journal a submit, pickling the JobSpec so a restarted server can
        resubmit it. Specs that cannot pickle (closures in Options) are
        journaled spec-less — the job's lifecycle is still accounted, but it
        cannot be resurrected. Returns whether the job is durable."""
        try:
            spec_bytes = pickle.dumps(job.spec, protocol=pickle.HIGHEST_PROTOCOL)
        except Exception:
            spec_bytes = None
            with self._lock:
                self._undurable += 1
        self.append(
            "submit",
            job.id,
            seq=job.seq,
            submitted_at=job.submitted_at,
            spec=spec_bytes,
            kind=job.spec.kind,
        )
        return spec_bytes is not None

    # -- rotation -------------------------------------------------------------
    def rotate(self) -> None:
        """Compact the log to one ``snapshot`` record per job (atomic
        tmp+fsync+rename). Live jobs keep their spec bytes; terminal jobs
        become slim tombstones (spec dropped) and only the newest
        ``keep_terminal`` of them are retained."""
        with self._lock:
            self._rotate_locked()

    def _rotate_locked(self) -> None:
        from .queue import TERMINAL_STATES

        terminal = sorted(
            (st for st in self._state.values() if st["state"] in TERMINAL_STATES),
            key=lambda st: st["seq"],
        )
        for st in terminal[: -self.keep_terminal] if self.keep_terminal else terminal:
            del self._state[st["job"]]
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(JOURNAL_MAGIC)
            for st in sorted(self._state.values(), key=lambda s: s["seq"]):
                rec = {"type": "snapshot", "t": time.time(), **st}
                if st["state"] in TERMINAL_STATES:
                    rec["spec"] = None  # tombstone: reported once, never rerun
                payload = pickle.dumps(rec, protocol=pickle.HIGHEST_PROTOCOL)
                f.write(
                    _HDR.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
                    + payload
                )
            f.flush()
            os.fsync(f.fileno())
        self._close()
        os.replace(tmp, self.path)
        self._rotations += 1
        self._open_append()

    # -- plumbing -------------------------------------------------------------
    def _reset_file(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(JOURNAL_MAGIC)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def _open_append(self) -> None:
        if not os.path.exists(self.path):
            self._reset_file()
        self._fh = open(self.path, "ab")

    def _close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    def close(self) -> None:
        with self._lock:
            self._close()

    @property
    def read_only(self) -> bool:
        """Disk-full shedding mode: submits are refused until a probe append
        succeeds (the server's submit() turns this into ServerOverloaded)."""
        with self._lock:
            return self._read_only

    def stats(self) -> dict:
        with self._lock:
            return {
                "path": self.path,
                "records": len(self._state),
                "appended": self._appended,
                "rotations": self._rotations,
                "torn_bytes_truncated": self._torn_bytes,
                "undurable_specs": self._undurable,
                "read_only": self._read_only,
                "enospc_events": self._enospc_events,
                "emergency_compactions": self._emergency_compactions,
                "rearms": self._rearms,
                "shed_submits": self._shed_submits,
                "buffered_records": len(self._pending),
                "dropped_buffered": self._dropped_buffered,
            }
