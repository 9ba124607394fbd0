"""A kernel's share of its roofline: the least time the chip could take for
the launches recorded in the traced window (per launch the larger of its
operations over the f32 peak and its bytes over the HBM peak, ``peaks.json``)
over the device time of the kernel's own device functions in the same
window. None where the window launched it never or the trace shows no time
for it: a share is never made up."""

from __future__ import annotations

from .trace import load_kernels

__all__ = ["roofline_pct"]


def roofline_pct(run, kid: str):
    if run.trace is None or run.work is None or not run.work[kid]["per_launch"]:
        return None
    names = load_kernels()[kid]["device_kernels"]
    dev_s = sum(v for name, v in run.trace["device_s_by_name"].items()
                if any(k in name for k in names))
    if dev_s <= 0:
        return None
    flops, bw = float(run.peaks["f32_flops"]), float(run.peaks["hbm_bytes_per_s"])
    least = sum(max(ops / flops, b / bw) for ops, b in run.work[kid]["per_launch"])
    return 100.0 * least / dev_s
