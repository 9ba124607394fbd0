"""Terminal progress reporting: live bar + Pareto table.

Reference: WrappedProgressBar with multiline postfix showing evals/sec, head
occupancy and the dominating Pareto curve
(SymbolicRegression.jl/src/ProgressBars.jl:6-35,
SymbolicRegression.jl/src/SearchUtils.jl:286-355); non-progress mode prints the full
search state at most every 5 seconds
(SymbolicRegression.jl/src/SymbolicRegression.jl:1026-1048). Silenced when the
``SR_TEST`` env var is set (the reference uses SYMBOLIC_REGRESSION_TEST)."""

from __future__ import annotations

import os
import sys
import time

__all__ = ["ProgressReporter"]


class ProgressReporter:
    """Handles both modes: progress bar (``progress=True``) and periodic
    plain-state printing (default, at most every 5s)."""

    def __init__(self, total_units: int, options, use_bar: bool, verbosity: int):
        self.total = max(total_units, 1)
        self.done = 0
        self.use_bar = use_bar and verbosity > 0 and not os.environ.get("SR_TEST")
        self.verbosity = 0 if os.environ.get("SR_TEST") else verbosity
        self.options = options
        self.start = time.time()
        self._last_print = 0.0
        self._monitor_work = 0.0  # head-node occupancy accounting
        self._monitor_total = 1e-9
        self._warned_occupancy = False

    # -- head occupancy (reference: ResourceMonitor,
    # SymbolicRegression.jl/src/SearchUtils.jl:217-284) -----------------------

    def head_work(self, seconds: float) -> None:
        self._monitor_work += seconds

    @property
    def occupancy(self) -> float:
        self._monitor_total = time.time() - self.start
        return self._monitor_work / max(self._monitor_total, 1e-9)

    def maybe_warn_occupancy(self) -> None:
        if (
            not self._warned_occupancy
            and time.time() - self.start > 5.0
            and self.occupancy > 0.4
            and self.verbosity > 0
        ):
            self._warned_occupancy = True
            print(
                f"warning: head-node occupancy {self.occupancy:.0%} > 40% — "
                "the scheduler loop is a bottleneck "
                "(reference warns at the same threshold)"
            )

    # -- updates --------------------------------------------------------------

    def update(
        self, hof, num_evals: float, variable_names=None, force=False,
        y_variable_name=None,
    ) -> None:
        self.done += 1
        if self.verbosity <= 0:
            return
        now = time.time()
        elapsed = now - self.start
        evals_s = num_evals / max(elapsed, 1e-9)
        if self.use_bar:
            width = 28
            frac = self.done / self.total
            fill = int(width * frac)
            bar = "#" * fill + "-" * (width - fill)
            sys.stdout.write(
                f"\r[{bar}] {self.done}/{self.total} "
                f"evals/s={evals_s:.3g} elapsed={elapsed:.0f}s\n"
            )
            print(hof.render(self.options, variable_names, y_variable_name))
            sys.stdout.flush()
        else:
            # plain mode: full state at most every 5 seconds (:1026-1048)
            if not force and now - self._last_print < 5.0:
                return
            self._last_print = now
            print(
                f"[{self.done}/{self.total}] evals={num_evals:.3g} "
                f"elapsed={elapsed:.1f}s evals/s={evals_s:.3g}"
            )
            print(hof.render(self.options, variable_names, y_variable_name))
