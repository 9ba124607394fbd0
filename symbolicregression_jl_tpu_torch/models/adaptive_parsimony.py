"""Adaptive complexity-frequency parsimony statistics.

Reference: RunningSearchStatistics (SymbolicRegression.jl/src/AdaptiveParsimony.jl):
a per-complexity frequency histogram with a decaying window, used to bias
tournaments and mutation acceptance toward under-represented complexities.
"""

from __future__ import annotations

import numpy as np

__all__ = ["RunningSearchStatistics"]


class RunningSearchStatistics:
    def __init__(self, maxsize: int, window_size: int = 100000):
        self.window_size = window_size
        # index c-1 holds complexity c, for c in 1..maxsize
        # (reference inits all-ones, SymbolicRegression.jl/src/AdaptiveParsimony.jl:20-34)
        self.frequencies = np.ones(maxsize, dtype=np.float64)
        self.normalized_frequencies = self.frequencies / self.frequencies.sum()

    def copy(self) -> "RunningSearchStatistics":
        new = RunningSearchStatistics.__new__(RunningSearchStatistics)
        new.window_size = self.window_size
        new.frequencies = self.frequencies.copy()
        new.normalized_frequencies = self.normalized_frequencies.copy()
        return new

    def update(self, size: int) -> None:
        """Record an accepted member's complexity
        (reference: update_frequencies!, :42-49)."""
        if 0 < size <= len(self.frequencies):
            self.frequencies[size - 1] += 1.0

    def move_window(self) -> None:
        """Decay total mass back to window_size, preferring to remove from
        over-represented sizes (reference: move_window!, :57-89 — proportional
        smoothing variant)."""
        total = self.frequencies.sum()
        if total > self.window_size:
            self.frequencies *= self.window_size / total

    def normalize(self) -> None:
        """(reference: normalize_frequencies!, :91-95)"""
        total = self.frequencies.sum()
        if total > 0:
            self.normalized_frequencies = self.frequencies / total

    def frequency_of(self, size: int) -> float:
        if 0 < size <= len(self.normalized_frequencies):
            return float(self.normalized_frequencies[size - 1])
        return 0.0
