"""Search-trajectory recorder.

Reference: the @recorder subsystem (SymbolicRegression.jl/src/Recorder.jl:6-12) with
mutate/death events keyed by member ref (lineage) recorded inside the evolve
loop (SymbolicRegression.jl/src/RegularizedEvolution.jl:55-83), per-population
per-iteration snapshots (SymbolicRegression.jl/src/Population.jl:184-199), the full
options dump, and a JSON file written at teardown
(ext/SymbolicRegressionJSON3Ext.jl:6-11). Schema matches the reference's
recorder test (SymbolicRegression.jl/test/test_recorder.jl:27-50): top-level
``options`` (string), ``out{j}_pop{i}`` iteration snapshots, and
``mutations`` keyed by ref with {events, score, loss, tree, parent}.

Like the reference, recording is incompatible with crossover (events are not
set up to track two-parent lineage); Options validation enforces
crossover_probability == 0 when use_recorder is on.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Any

__all__ = ["Recorder"]


def _sanitize(obj: Any):
    """JSON with allow_inf=true semantics (reference JSON3 ext): inf/nan pass
    through as strings so the file stays loadable everywhere."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return obj


class Recorder:
    """Collects search events when enabled; no-ops (cheaply) otherwise."""

    def __init__(self, options, enabled: bool | None = None):
        self.enabled = options.use_recorder if enabled is None else enabled
        self.path = options.recorder_file
        self.data: dict = {}
        # the async island scheduler records from worker threads
        self._lock = threading.Lock()
        if self.enabled:
            self.data["options"] = repr(options) if repr(options).startswith(
                "Options"
            ) else f"Options({options!r})"

    # -- population snapshots -------------------------------------------------

    def record_population(self, out_j: int, pop_i: int, iteration: int, pop, options):
        if not self.enabled:
            return
        key = f"out{out_j}_pop{pop_i}"
        # one recorder is shared across concurrent per-output search threads
        # (parallel_outputs), same as the other record_* methods
        with self._lock:
            self.data.setdefault(key, {})[f"iteration{iteration}"] = pop.record(
                options
            )

    # -- mutation lineage -----------------------------------------------------

    def _member_entry(self, member, options) -> dict:
        return {
            "events": [],
            "tree": member.tree.string_tree(options.operators),
            "score": float(member.score),
            "loss": float(member.loss),
            "parent": member.parent,
        }

    def record_mutation(self, parent, baby, kind: str, accepted: bool, options):
        """One mutate event on the winner's lineage + a death event for the
        replaced member (reference: RegularizedEvolution.jl:55-83)."""
        if not self.enabled:
            return
        with self._lock:
            muts = self.data.setdefault("mutations", {})
            for m in (parent, baby):
                if str(m.ref) not in muts:
                    muts[str(m.ref)] = self._member_entry(m, options)
            muts[str(parent.ref)]["events"].append(
                {
                    "type": "mutate",
                    "mutation": kind,
                    "accepted": bool(accepted),
                    "child": baby.ref,
                }
            )

    def record_death(self, member, options):
        if not self.enabled:
            return
        with self._lock:
            muts = self.data.setdefault("mutations", {})
            if str(member.ref) not in muts:
                muts[str(member.ref)] = self._member_entry(member, options)
            muts[str(member.ref)]["events"].append({"type": "death"})

    def record_tuning(self, member, improved: bool, options):
        """Constant-optimization 'tuning' events
        (reference: SingleIteration.jl:140-171)."""
        if not self.enabled:
            return
        with self._lock:
            muts = self.data.setdefault("mutations", {})
            if str(member.ref) not in muts:
                muts[str(member.ref)] = self._member_entry(member, options)
            muts[str(member.ref)]["events"].append(
                {"type": "tuning", "improved": bool(improved)}
            )

    # -- teardown -------------------------------------------------------------

    def dump(self):
        if not self.enabled:
            return
        # tmp + atomic promote (the export_csv pattern): a crash mid-dump
        # must not corrupt an existing record file
        import os

        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(_sanitize(self.data), fh)
        os.replace(tmp, self.path)
