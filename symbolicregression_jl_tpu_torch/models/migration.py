"""Migration between island populations.

Reference: SymbolicRegression.jl/src/Migration.jl:16-38 — Poisson-sample the number
of members to replace (mean = frac * pop size), draw candidates with
replacement, overwrite random members, reset birth.
"""

from __future__ import annotations

import numpy as np

from .pop_member import PopMember
from .population import Population

__all__ = ["migrate"]


def migrate(
    candidates: list[PopMember],
    pop: Population,
    options,
    frac: float,
    rng: np.random.Generator,
) -> None:
    if not candidates or frac <= 0:
        return
    mean = frac * pop.n
    num_replace = int(rng.poisson(mean))
    num_replace = min(num_replace, pop.n)
    if num_replace == 0:
        return
    locations = rng.choice(pop.n, size=num_replace, replace=False)
    picks = rng.integers(0, len(candidates), size=num_replace)
    for loc, pick in zip(locations, picks):
        migrant = candidates[pick].copy()
        migrant.reset_birth()
        pop.members[loc] = migrant
