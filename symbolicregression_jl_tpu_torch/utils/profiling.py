"""Stage-level engine profiler.

Counterpart of ``symbolicregression_jl_tpu/utils/profiling.py``. The device
engine runs one iteration as a few legs (evolve, const-opt, finalize,
readback) enqueued on the card plus host-side work (decode, hall of fame,
simplify, snapshot). ``StageProfiler`` segments one engine iteration into
named stage walls, so an iteration's wall can be attributed to its stages —
the device-engine counterpart of the reference's hot-loop accounting
(SymbolicRegression.jl/src/SingleIteration.jl:24-105).

Design constraints:

- **Near-zero overhead when disabled.** ``Options.profile=False`` routes all
  call sites through ``NULL_PROFILER``, whose ``stage()`` returns a shared
  no-op context manager and whose ``fence()`` returns its argument untouched
  — no timestamps, no dict writes, no synchronization.
- **Fencing only when enabled.** CUDA launches are asynchronous: without a
  fence a "stage wall" only measures the host's enqueue. When profiling is
  on, call sites ``fence()`` at the end of each stage, which synchronizes
  the profiler's CUDA device, so each stage wall includes its device
  execution. This serializes the pipeline — which is exactly why the
  profiler must never fence when disabled, and why ``Options.profile=True``
  forces the synchronous readback path. On the CPU a fence does nothing.
- **Ring buffer.** Per-iteration stage walls land in a bounded deque so a
  long search cannot grow host memory; ``summary()`` aggregates whatever
  the window holds (mean/p50/p90 per stage + fraction of iteration wall).

Spans and host-sync counts (``SpanRecord``, one per search). A span is a
named stretch of host code: each one adds its host wall and a count to the
search's record, and while a torch profiler records it also opens a
profiler range ``leg:<name>``, so the span stands on kineto's clock, the
clock of the device trace, and a trace reader can lay each idle gap on the
card to the innermost span over it. Names with a ``/`` are sub-spans
(``const_opt/step`` inside the leg ``const_opt``). The record is on when
``Options.profile`` is, or when a torch profiler records at the search's
start; a span then reads the clock twice and, under a profiler, opens and
closes one range. A span never fences and never adds a sync. Off, ``span()``
returns the shared no-op context and reads no clock. ``tiles()`` gives
spans that follow one another with no gap (one clock reading ends one and
starts the next), so that sub-spans cover their parent whole.

The host-sync counts are always on: a plain integer add at each deliberate
sync (``SpanRecord.count_sync``, by site), per search, so concurrent
searches never mix their counts.
"""

from __future__ import annotations

import time
from collections import deque

import torch

__all__ = ["StageProfiler", "NULL_PROFILER", "SpanRecord", "profiler_recording"]


class _NullCtx:
    """Shared no-op context manager — the disabled profiler's only cost is
    one attribute load and one method call per stage."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def begin(self):
        return self

    def end(self) -> float:
        return 0.0


_NULL_CTX = _NullCtx()


class _StageCtx:
    __slots__ = ("_prof", "_name", "_t0")

    def __init__(self, prof: "StageProfiler", name: str):
        self._prof = prof
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        cur = self._prof._current
        cur[self._name] = cur.get(self._name, 0.0) + dt
        return False


class StageProfiler:
    """Per-iteration stage timer with a bounded ring buffer.

    Usage (one engine iteration)::

        with prof.stage("evolve"):
            state = run_step(state, data)
            prof.fence(state)          # include device wall, not just enqueue
        ...
        prof.next_iteration()          # close the iteration record

    ``stage`` may be entered multiple times per iteration for the same name
    (times accumulate). ``summary()`` reports per-stage mean/p50/p90 ms and
    the fraction of the mean iteration wall, where the iteration wall is the
    host time between consecutive ``next_iteration`` calls — so dispatch
    overhead and unattributed host work show up as ``other``.
    """

    __slots__ = ("enabled", "_ring", "_current", "_iter_t0", "_counters", "_cuda")

    def __init__(self, enabled: bool = True, capacity: int = 512, device=None):
        self.enabled = enabled
        # the CUDA devices ``fence`` synchronizes (none: nothing to wait for);
        # ``device`` is one device or a list (a mesh's)
        devices = device if isinstance(device, (list, tuple)) else [device]
        self._cuda = [torch.device(d) for d in devices
                      if d is not None and torch.device(d).type == "cuda"]
        self._ring: deque = deque(maxlen=capacity)
        self._current: dict = {}
        self._iter_t0: float | None = None
        self._counters: dict = {}

    # -- recording ----------------------------------------------------------
    def stage(self, name: str):
        if not self.enabled:
            return _NULL_CTX
        if self._iter_t0 is None:
            self._iter_t0 = time.perf_counter()
        return _StageCtx(self, name)

    def fence(self, x=None):
        """``torch.cuda.synchronize`` of the profiler's devices when enabled
        (the engine runs one stream, so this waits for ``x`` and everything
        enqueued before it); nothing when disabled or on the CPU. Returns
        ``x`` either way."""
        if self.enabled:
            for d in self._cuda:
                torch.cuda.synchronize(d)
        return x

    def add_time(self, name: str, seconds: float):
        """Accumulate an externally measured duration into the current
        iteration's record — for stages the caller cannot bracket with
        ``stage()`` (e.g. estimated sub-timings of one stage). Sub-stage names containing ``/`` (``"fused_iter/const_opt"``)
        are reported by ``summary()`` but EXCLUDED from the attributed sum, so
        a derived decomposition of a parent stage never double-counts against
        ``other``."""
        if not self.enabled:
            return
        if self._iter_t0 is None:
            self._iter_t0 = time.perf_counter()
        cur = self._current
        cur[name] = cur.get(name, 0.0) + seconds

    def set_counters(self, name: str, values: dict):
        """Attach a named block of event COUNTERS (not timings) to the
        summary — e.g. the program-cache hits/misses/evictions of this
        search. Last write per name wins; no-op when disabled."""
        if not self.enabled:
            return
        self._counters[name] = dict(values)

    def next_iteration(self):
        """Close the current iteration's record and push it to the ring."""
        if not self.enabled:
            return
        now = time.perf_counter()
        if self._iter_t0 is not None:
            rec = self._current
            rec["_wall"] = now - self._iter_t0
            self._ring.append(rec)
        self._current = {}
        self._iter_t0 = now

    # -- reporting ----------------------------------------------------------
    @staticmethod
    def _pct(sorted_vals, q):
        if not sorted_vals:
            return 0.0
        i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
        return sorted_vals[i]

    def summary(self) -> dict:
        """Aggregate the ring buffer: per-stage ms stats + fraction of the
        mean iteration wall, plus the unattributed remainder (``other``)."""
        iters = list(self._ring)
        n = len(iters)
        counters = {k: dict(v) for k, v in self._counters.items()}
        if n == 0:
            out = {"iterations": 0, "stages": {}, "iteration_mean_ms": 0.0}
            if counters:
                out["counters"] = counters
            return out
        walls = [r.get("_wall", 0.0) for r in iters]
        wall_mean = sum(walls) / n
        names = []
        for r in iters:
            for k in r:
                if k != "_wall" and k not in names:
                    names.append(k)
        stages = {}
        attributed = 0.0
        for name in names:
            vals = [r.get(name, 0.0) for r in iters]
            sv = sorted(vals)
            mean = sum(vals) / n
            if "/" not in name:  # sub-stages decompose a parent, not the wall
                attributed += mean
            stages[name] = {
                "mean_ms": mean * 1e3,
                "p50_ms": self._pct(sv, 0.50) * 1e3,
                "p90_ms": self._pct(sv, 0.90) * 1e3,
                "total_ms": sum(vals) * 1e3,
                "fraction": (mean / wall_mean) if wall_mean > 0 else 0.0,
            }
        other = max(0.0, wall_mean - attributed)
        stages["other"] = {
            "mean_ms": other * 1e3,
            "p50_ms": other * 1e3,
            "p90_ms": other * 1e3,
            "total_ms": other * n * 1e3,
            "fraction": (other / wall_mean) if wall_mean > 0 else 0.0,
        }
        out = {
            "iterations": n,
            "iteration_mean_ms": wall_mean * 1e3,
            "iteration_p50_ms": self._pct(sorted(walls), 0.50) * 1e3,
            "iteration_p90_ms": self._pct(sorted(walls), 0.90) * 1e3,
            "stages": stages,
        }
        if counters:
            out["counters"] = counters
        return out


NULL_PROFILER = StageProfiler(enabled=False, capacity=1)


# -- spans and host-sync counts ---------------------------------------------

# the profiler range a span opens: ``record_function``'s event, through the
# C++ range at about a tenth of its cost
_RANGE = torch._C._profiler._RecordFunctionFast


def profiler_recording() -> bool:
    """Whether a torch profiler is recording in this process."""
    return torch._C._autograd._profiler_enabled()


def _open_range(name: str):
    rng = _RANGE(f"leg:{name}")
    rng.__enter__()
    return rng


class _Span:
    """One span: ``begin``/``end`` (or a ``with`` block). ``seconds`` is its
    last wall."""

    __slots__ = ("_rec", "_name", "_t0", "_rng", "seconds")

    def __init__(self, rec: "SpanRecord", name: str):
        self._rec = rec
        self._name = name
        self._rng = None
        self.seconds = 0.0

    def begin(self):
        if self._rec.enabled and profiler_recording():
            self._rng = _open_range(self._name)
        self._t0 = time.perf_counter()
        return self

    def end(self) -> float:
        self.seconds = time.perf_counter() - self._t0
        if self._rng is not None:
            self._rng.__exit__(None, None, None)
            self._rng = None
        if self._rec.enabled:
            self._rec.add(self._name, self.seconds)
        return self.seconds

    def __enter__(self):
        return self.begin()

    def __exit__(self, *exc):
        self.end()
        return False


class _Tiles:
    """Spans that follow one another on one thread with no gap: ``to(name)``
    ends the open span and starts ``name`` at the same clock reading,
    ``close()`` ends the last."""

    __slots__ = ("_rec", "_on", "_name", "_t0", "_rng")

    def __init__(self, rec: "SpanRecord"):
        self._rec = rec
        self._on = rec.enabled
        self._name = self._rng = None

    def _switch(self, name):
        now = time.perf_counter()
        # the next range opens before the last one closes: no instant
        # between two tiles lies outside both on the profiler's clock
        rng = _open_range(name) if name is not None and profiler_recording() else None
        if self._rng is not None:
            self._rng.__exit__(None, None, None)
        self._rng = rng
        if self._name is not None:
            self._rec.add(self._name, now - self._t0)
        self._name, self._t0 = name, now

    def to(self, name: str) -> None:
        if self._on:
            self._switch(name)

    def close(self) -> None:
        if self._on:
            self._switch(None)


class SpanRecord:
    """One search's spans and host-sync counts.

    ``spans``: name -> [count, host seconds], filled only when ``enabled``;
    ``syncs``: site -> count, always. ``for_search(profile)`` is on where
    ``Options.profile`` is or a torch profiler records at the search's
    start. ``span(name)`` is a ``with`` block (the shared no-op context when
    off; ``timed=True`` gives a span that reads the clock even when off, for
    a wall the search reports either way); ``tiles()`` gives gapless spans
    (``_Tiles``)."""

    __slots__ = ("enabled", "spans", "syncs")

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.spans: dict = {}
        self.syncs: dict = {}

    @classmethod
    def for_search(cls, profile: bool) -> "SpanRecord":
        return cls(bool(profile) or profiler_recording())

    def span(self, name: str, timed: bool = False):
        if not (self.enabled or timed):
            return _NULL_CTX
        return _Span(self, name)

    def tiles(self) -> _Tiles:
        return _Tiles(self)

    def count_sync(self, site: str) -> None:
        self.syncs[site] = self.syncs.get(site, 0) + 1

    def add(self, name: str, seconds: float) -> None:
        acc = self.spans.get(name)
        if acc is None:
            self.spans[name] = [1, seconds]
        else:
            acc[0] += 1
            acc[1] += seconds

    def summary(self) -> dict:
        """name -> {"count", "seconds"} of every span entered."""
        return {name: {"count": n, "seconds": s} for name, (n, s) in self.spans.items()}
