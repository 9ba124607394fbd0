"""Hall-of-fame CSV output with crash-safe double write.

Reference: save_to_file (SymbolicRegression.jl/src/SearchUtils.jl:410-450) —
``Complexity,Loss,Equation`` rows of the current Pareto frontier, written to a
``.bkup`` file first then atomically promoted.
"""

from __future__ import annotations

import json
import os

__all__ = ["save_hall_of_fame"]


def save_hall_of_fame(
    path: str, hof, options, variable_names=None, num_evals=None
) -> None:
    # precision 17: constants round-trip float64 exactly, so a saved CSV can
    # seed a bit-faithful warm start (utils/checkpoint.load_saved_state)
    rows = hof.format(options, variable_names, precision=17)
    lines = ["Complexity,Loss,Equation"]
    for r in rows:
        eq = r["equation"].replace('"', '""')
        lines.append(f'{r["complexity"]},{r["loss"]:.16g},"{eq}"')
    content = "\n".join(lines) + "\n"
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(content)
    os.replace(tmp, path)
    # persistent .bkup copy survives a crash mid-write of the main file
    with open(path + ".bkup", "w") as f:
        f.write(content)
    if num_evals is not None:
        # sidecar metadata: load_saved_state restores the eval budget so
        # warm-started runs report totals spanning the whole lineage
        meta_tmp = path + ".meta.json.tmp"
        with open(meta_tmp, "w") as f:
            json.dump({"num_evals": float(num_evals)}, f)
        os.replace(meta_tmp, path + ".meta.json")
