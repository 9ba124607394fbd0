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
"""

from __future__ import annotations

import time
from collections import deque

import torch

__all__ = ["StageProfiler", "NULL_PROFILER"]


class _NullCtx:
    """Shared no-op context manager — the disabled profiler's only cost is
    one attribute load and one method call per stage."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


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
        # the CUDA device ``fence`` synchronizes, or None (nothing to wait for)
        self._cuda = (
            torch.device(device) if device is not None
            and torch.device(device).type == "cuda" else None
        )
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
        """``torch.cuda.synchronize`` of the profiler's device when enabled
        (the engine runs one stream, so this waits for ``x`` and everything
        enqueued before it); nothing when disabled or on the CPU. Returns
        ``x`` either way."""
        if self.enabled and self._cuda is not None:
            torch.cuda.synchronize(self._cuda)
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
