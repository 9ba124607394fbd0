"""Drift detection for streaming sessions: pure host arithmetic.

Counterpart of ``symbolicregression_jl_tpu/stream/drift.py``. The signal is
the ratio between the CURRENT best expression's loss on the incoming rows and
an exponential moving average of the frontier's best loss on the data it was
evolved against. While the generating process is stationary, the best member
generalizes and the probe ratio stays near 1; when the process shifts, the
frontier is suddenly wrong on the new rows and the ratio jumps. The detector
compares LOSSES, not residual distributions: a probe is one scoring call of
the lane's scorer (one B1 launch on the card).

On drift the session responds with (both optional, on by default):

- frontier rescoring: every hall-of-fame member's loss is recomputed on the
  swapped rows, so the streamed frames report honest losses and stale
  members stop blocking their complexity slots;
- a parsimony-frequency reset: the lane's complexity histogram
  (``EvoState.freq``) returns to the ``init_state`` uniform, forgetting the
  size distribution learned on the old regime.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["DriftConfig", "DriftDetector"]


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Knobs for :class:`DriftDetector`.

    ``ratio``: a probe loss must exceed ``ratio * ema`` to count as drift.
    ``ema_decay``: smoothing of the frontier-loss EMA (per observed
    iteration). ``min_obs``: EMA observations needed before a probe can
    trigger (the first iterations of a session have a noisy, falling best
    loss, and every push would read as drift). ``rescore``: rescore the hall
    of fame on the new rows on drift. ``reset_freq``: reset the lane's
    parsimony-frequency histogram on drift.
    """

    ratio: float = 2.0
    ema_decay: float = 0.9
    min_obs: int = 3
    eps: float = 1e-12
    rescore: bool = True
    reset_freq: bool = True

    def __post_init__(self):
        if not self.ratio > 0:
            raise ValueError("drift ratio must be > 0")
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError("ema_decay must be in [0, 1)")
        if self.min_obs < 1:
            raise ValueError("min_obs must be >= 1")


class DriftDetector:
    """EMA of the frontier's best loss, and the probe-ratio drift test."""

    def __init__(self, config: DriftConfig | None = None):
        self.config = config or DriftConfig()
        self.ema: float | None = None
        self.observations = 0
        self.drifts = 0

    def observe(self, frontier_best_loss: float) -> None:
        """Fold one iteration's frontier best loss into the EMA. Non-finite
        values are skipped: a frontier being rescored can report inf for a
        moment, which would poison the average for good."""
        v = float(frontier_best_loss)
        if not math.isfinite(v):
            return
        d = self.config.ema_decay
        self.ema = v if self.ema is None else d * self.ema + (1.0 - d) * v
        self.observations += 1

    def probe(self, loss_on_new_rows: float) -> bool:
        """Drift decision for one incoming batch: is the current best
        member's loss on the new rows out of line with the frontier EMA? A
        non-finite probe loss IS drift (the new rows left the best
        expression's domain, e.g. a log argument went negative)."""
        if self.ema is None or self.observations < self.config.min_obs:
            return False
        v = float(loss_on_new_rows)
        if not math.isfinite(v):
            self.drifts += 1
            return True
        if v > self.config.ratio * max(self.ema, self.config.eps):
            self.drifts += 1
            return True
        return False

    def rebase(self, frontier_best_loss: float) -> None:
        """Reset the EMA to the best loss after a rescore, so that the
        iterations right after an acknowledged drift do not trigger again on
        the same change."""
        v = float(frontier_best_loss)
        self.ema = v if math.isfinite(v) else None
        if self.ema is None:
            self.observations = 0
