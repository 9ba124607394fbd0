"""Regularized evolution: tournament -> mutate/crossover -> replace oldest.

Reference: SymbolicRegression.jl/src/RegularizedEvolution.jl:14-109. One evolve pass
runs ``ceil(pop.n / tournament_selection_n)`` events; each event either
mutates a tournament winner (probability 1 - crossover_probability) replacing
the oldest member, or crosses two winners replacing the two oldest.

Restructured for batched scoring: the pass is split into propose / score / apply so the
scoring of all events (across all islands — see single_iteration) happens in
one device batch.
"""

from __future__ import annotations

import math

import numpy as np

from .adaptive_parsimony import RunningSearchStatistics
from .mutate import (
    CrossoverProposal,
    Proposal,
    accept_crossover,
    accept_mutation,
    propose_crossover,
    propose_mutation,
)
from .population import Population

__all__ = ["propose_pass", "collect_candidates", "apply_pass"]


def propose_pass(
    pop: Population,
    temperature: float,
    curmaxsize: int,
    stats: RunningSearchStatistics,
    options,
    nfeatures: int,
    rng: np.random.Generator,
) -> list:
    """Generate one evolve pass worth of events from the current snapshot."""
    n_evol = int(math.ceil(pop.n / options.tournament_selection_n))
    events = []
    for _ in range(n_evol):
        if rng.random() > options.crossover_probability:
            parent = pop.best_of_sample(stats, options, rng)
            events.append(
                propose_mutation(parent, temperature, curmaxsize, options, nfeatures, rng)
            )
        else:
            p1 = pop.best_of_sample(stats, options, rng)
            p2 = pop.best_of_sample(stats, options, rng)
            events.append(propose_crossover(p1, p2, curmaxsize, options, rng))
    return events


def collect_candidates(events: list) -> list:
    """Trees awaiting scoring, in deterministic order."""
    trees = []
    for ev in events:
        if isinstance(ev, Proposal):
            if ev.needs_score and not ev.failed:
                trees.append(ev.tree)
        elif isinstance(ev, CrossoverProposal):
            if not ev.failed:
                trees.append(ev.child1)
                trees.append(ev.child2)
    return trees


def fill_scores(events: list, scores: np.ndarray, losses: np.ndarray) -> None:
    """Write batch-computed scores back into the events (same order as
    collect_candidates)."""
    k = 0
    for ev in events:
        if isinstance(ev, Proposal):
            if ev.needs_score and not ev.failed:
                ev.score, ev.loss = float(scores[k]), float(losses[k])
                k += 1
        elif isinstance(ev, CrossoverProposal):
            if not ev.failed:
                ev.score1, ev.loss1 = float(scores[k]), float(losses[k])
                ev.score2, ev.loss2 = float(scores[k + 1]), float(losses[k + 1])
                k += 2


def apply_pass(
    pop: Population,
    events: list,
    temperature: float,
    stats: RunningSearchStatistics,
    options,
    rng: np.random.Generator,
    recorder=None,
) -> list:
    """Accept/reject each scored event and replace oldest members.
    Returns the list of newly inserted members. With a recorder, logs
    mutate events on the winner's lineage and death events for replaced
    members (reference: SymbolicRegression.jl/src/RegularizedEvolution.jl:55-83)."""
    new_members = []
    for ev in events:
        if isinstance(ev, Proposal):
            baby, accepted = accept_mutation(ev, temperature, stats, options, rng)
            oldest = pop.oldest_index()
            if recorder is not None:
                recorder.record_mutation(ev.parent, baby, ev.kind, accepted, options)
                recorder.record_death(pop.members[oldest], options)
            pop.members[oldest] = baby
            new_members.append(baby)
        else:
            c1, c2, _accepted = accept_crossover(ev, options)
            pop.members[pop.oldest_index()] = c1
            pop.members[pop.oldest_index()] = c2
            new_members.append(c1)
            new_members.append(c2)
    return new_members
