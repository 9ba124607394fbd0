"""Island population + tournament selection.

Reference: SymbolicRegression.jl/src/Population.jl. Tournament: sample
``tournament_selection_n`` members without replacement, adjust scores by
``exp(adaptive_parsimony_scaling * frequency(size))``, then pick the k-th best
with geometric probability p(1-p)^k using the precomputed weights
(SymbolicRegression.jl/src/Population.jl:110-160).
"""

from __future__ import annotations

import numpy as np

from .adaptive_parsimony import RunningSearchStatistics
from .mutation_functions import gen_random_tree
from .pop_member import PopMember

__all__ = ["Population"]


class Population:
    def __init__(self, members: list[PopMember]):
        self.members = members

    @property
    def n(self) -> int:
        return len(self.members)

    def copy(self) -> "Population":
        return Population([m.copy() for m in self.members])

    @staticmethod
    def random_trees(
        population_size: int, options, nfeatures: int, rng: np.random.Generator, nlength: int = 3
    ):
        """The random initial trees of a population (scored by the caller in
        one device batch; reference inits with nlength=3,
        SymbolicRegression.jl/src/Population.jl:36-62)."""
        return [
            gen_random_tree(
                nlength, options.operators, nfeatures, rng, dtype=options.dtype
            )
            for _ in range(population_size)
        ]

    def sample_members(
        self, n: int, rng: np.random.Generator
    ) -> list[PopMember]:
        idx = rng.choice(self.n, size=min(n, self.n), replace=False)
        return [self.members[i] for i in idx]

    def best_of_sample(
        self,
        stats: RunningSearchStatistics,
        options,
        rng: np.random.Generator,
    ) -> PopMember:
        sample = self.sample_members(options.tournament_selection_n, rng)
        scores = np.empty(len(sample))
        if options.use_frequency_in_tournament:
            scaling = options.adaptive_parsimony_scaling
            for i, m in enumerate(sample):
                freq = stats.frequency_of(m.get_complexity(options))
                scores[i] = m.score * np.exp(scaling * freq)
        else:
            for i, m in enumerate(sample):
                scores[i] = m.score
        p = options.tournament_selection_p
        if p == 1.0:
            return sample[int(np.argmin(scores))]
        w = options.tournament_weights[: len(sample)]
        place = rng.choice(len(w), p=w / w.sum())
        order = np.argsort(scores, kind="stable")
        return sample[int(order[place])]

    def best_sub_pop(self, topn: int = 10) -> "Population":
        """Top-n members by score (migration candidates; reference:
        SymbolicRegression.jl/src/Population.jl:179-182)."""
        order = sorted(range(self.n), key=lambda i: self.members[i].score)
        return Population([self.members[i] for i in order[:topn]])

    def oldest_index(self) -> int:
        """argmin birth — regularized evolution replaces the oldest
        (SymbolicRegression.jl/src/RegularizedEvolution.jl:53,85)."""
        return min(range(self.n), key=lambda i: self.members[i].birth)

    def record(self, options) -> dict:
        """Snapshot for the recorder (reference: record_population,
        SymbolicRegression.jl/src/Population.jl:184-199)."""
        return {
            "population": [
                {
                    "id": m.ref,
                    "parent": m.parent,
                    "score": m.score,
                    "loss": m.loss,
                    "complexity": m.get_complexity(options),
                    "birth": m.birth,
                    "tree": m.tree.string_tree(options.operators),
                }
                for m in self.members
            ]
        }
