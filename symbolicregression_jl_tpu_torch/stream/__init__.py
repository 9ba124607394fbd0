"""The streaming and multi-target runtime (the JAX package's ``stream/``).

- :class:`StreamSession`: a long-lived fleet lane whose rows are pushed or
  replaced between iterations, written in place into the lane's resident
  tensors, with drift-aware frontier upkeep and format-2 frontier frames;
- :class:`DriftDetector` / :class:`DriftConfig`: the loss on the new rows
  against the frontier-loss EMA;
- :class:`MultitargetSearch` / :func:`multitarget_search`: one search per
  target over a shared X, run as one fleet (``models/device_search.
  fleet_search``).
"""

from .drift import DriftConfig, DriftDetector
from .multitarget import MultitargetSearch, multitarget_search
from .session import StreamSession, StreamStats, next_row_bucket

__all__ = [
    "DriftConfig",
    "DriftDetector",
    "MultitargetSearch",
    "multitarget_search",
    "StreamSession",
    "StreamStats",
    "next_row_bucket",
]
