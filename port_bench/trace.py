"""The traced run's instruments: torch.profiler over the window, the legs
named on the host's side of its trace, and the launch records of the
kernels' wrappers.

Nothing here runs in an untraced run. ``Tracer`` opens before the window's
call and closes after it; ``read`` reduces the profiler's raw events (no
``key_averages``: the window holds hundreds of thousands of events) to

- ``busy_s``: the union of the intervals in which a kernel, copy or set ran
  on the card; ``window_s``: the host's time from the profiler's start to
  its stop;
- device seconds by kernel name;
- idle gaps on the card, each laid to the innermost leg span (``leg:<name>``,
  opened by the program's leg seam) that covers its middle, else to "host
  outside the legs".
"""

from __future__ import annotations

import bisect
import importlib
import json
import time
from pathlib import Path

__all__ = ["Tracer", "KernelRecorder", "load_kernels"]

HERE = Path(__file__).resolve().parent


def load_kernels() -> dict:
    """kernel id -> its file (``kernels/<id>.json``)."""
    return {p.stem: json.loads(p.read_text()) for p in sorted((HERE / "kernels").glob("*.json"))}


class _Recording:
    """A kernel entry point that records each call's arguments. Attribute
    reads and writes go to the original function, so the program's launch
    counter (``count_launch(fused_loss, ...)`` resolves the module's name at
    call time) still counts on the original."""

    def __init__(self, orig, record, sink):
        object.__setattr__(self, "_orig", orig)
        object.__setattr__(self, "_record", record)
        object.__setattr__(self, "_sink", sink)

    def __call__(self, *args, **kwargs):
        out = self._orig(*args, **kwargs)
        self._sink.append(self._record(args, kwargs))
        return out

    def __getattr__(self, name):
        return getattr(self._orig, name)

    def __setattr__(self, name, value):
        setattr(self._orig, name, value)


class KernelRecorder:
    """Wraps each kernel's entry points (the module attributes its file
    names) so that every launch in the window leaves a record of its
    arguments; ``close`` puts the originals back."""

    def __init__(self, kernels: dict):
        from . import workcounts

        self.records = {k: [] for k in kernels}
        self.batches = 0
        workcounts.BATCH_SUMS.reset()
        self._saved = []
        self._counts = {}
        for kid, spec in kernels.items():
            record, counts = workcounts.RECORDERS[spec["recorder"]]
            self._counts[kid] = counts
            for mod_name, attr in spec["wrap"]:
                mod = importlib.import_module(mod_name)
                orig = getattr(mod, attr)
                self._saved.append((mod, attr, orig))
                setattr(mod, attr, _Recording(orig, record, self.records[kid]))

    def close(self) -> None:
        from . import workcounts

        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved = []
        self.batches = workcounts.BATCH_SUMS.batches
        workcounts.BATCH_SUMS.reset()

    def work(self) -> dict:
        """kernel id -> {launches, per_launch: [(operations, bytes)]},
        reading the records' device sums (after the window)."""
        out = {}
        for kid, recs in self.records.items():
            per = [self._counts[kid](r) for r in recs]
            out[kid] = {
                "launches": len(per),
                "per_launch": [(c["operations"], c["bytes"]) for c in per],
            }
        return out


class Tracer:
    """torch.profiler over the window, with the program's legs named as
    ``leg:<name>`` spans through ``device_search._LEG_WRAP``."""

    def __init__(self, leg_module):
        import torch

        self._torch = torch
        self._leg_module = leg_module
        self._saved_wrap = leg_module._LEG_WRAP
        leg_module._LEG_WRAP = lambda name: torch.profiler.record_function(f"leg:{name}")
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.t0 = self.t1 = None
        self.parse_s = None

    def __enter__(self):
        self._torch.cuda.synchronize()
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        try:
            self.prof.__exit__(*exc)
        finally:
            self._leg_module._LEG_WRAP = self._saved_wrap
        return False

    def read(self) -> dict:
        """busy_s, window_s, device seconds by kernel name and idle seconds
        by host activity."""
        t_parse = time.perf_counter()
        cuda_type = self._torch.autograd.DeviceType.CUDA
        dev, legs = [], []
        for e in self.prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            name = e.name()
            if name.startswith("leg:"):
                # a span opened on the host is mirrored on the card's
                # timeline as an annotation; only the host's copy is a leg
                if e.device_type() != cuda_type:
                    legs.append((start, end, name[4:]))
            elif e.device_type() == cuda_type:
                dev.append((start, end, name))
        dev.sort()
        by_name: dict = {}
        busy = 0
        gaps = []
        cur_s = cur_e = None
        for s, e, name in dev:
            by_name[name] = by_name.get(name, 0) + (e - s)
            if cur_e is None:
                cur_s, cur_e = s, e
            elif s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        legs.sort()
        starts = [l[0] for l in legs]
        idle_by: dict = {}
        for gs, ge in gaps:
            mid = (gs + ge) // 2
            label = "host outside the legs"
            best = None
            i = bisect.bisect_right(starts, mid)
            for j in range(max(0, i - 64), i):
                s, e, name = legs[j]
                if s <= mid <= e and (best is None or e - s < best):
                    best, label = e - s, name
            idle_by[label] = idle_by.get(label, 0) + (ge - gs)
        self.parse_s = time.perf_counter() - t_parse
        window_s = self.t1 - self.t0
        return {
            "busy_s": busy / 1e9,
            "window_s": window_s,
            "device_s_by_name": {k: v / 1e9 for k, v in by_name.items()},
            "idle_s_by_host": {k: v / 1e9 for k, v in idle_by.items()},
            "events": len(dev),
            "parse_s": self.parse_s,
        }
