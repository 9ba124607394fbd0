"""One search iteration over a set of island populations, in lockstep.

Reference: s_r_cycle + optimize_and_simplify_population
(SymbolicRegression.jl/src/SingleIteration.jl:24-174). The reference runs each
population's ``ncycles_per_iteration`` evolve cycles independently (async
tasks); the lockstep design steps ALL islands together so that every cycle's
candidate scoring — and the end-of-iteration constant optimization — is one
large batched device program (islands x events candidates per call).

Temperature anneals 1 -> 0 across the cycles when annealing is on, else stays
1 (SymbolicRegression.jl/src/SingleIteration.jl:36-62).
"""

from __future__ import annotations

import numpy as np

from ..complexity import compute_complexity
from ..ops.constant_opt import optimize_constants_batched
from .adaptive_parsimony import RunningSearchStatistics
from .hall_of_fame import HallOfFame
from .mutate import Proposal
from .population import Population
from .regularized_evolution import (
    apply_pass,
    collect_candidates,
    fill_scores,
    propose_pass,
)
from .scorer import BatchScorer
from .simplify import combine_operators, simplify_tree

__all__ = ["s_r_cycle_lockstep", "optimize_and_simplify_populations"]


def s_r_cycle_lockstep(
    pops: list[Population],
    scorer: BatchScorer,
    ncycles: int,
    curmaxsize: int,
    stats_list: list[RunningSearchStatistics],
    options,
    nfeatures: int,
    rng: np.random.Generator,
    pipeline_depth: int = 4,
    recorder=None,
) -> list[HallOfFame]:
    """Run `ncycles` evolve passes on every island; returns per-island
    best-seen halls of fame (the reference's `return_best_seen` path).

    Latency-hiding pipeline: each cycle's candidate batch is dispatched to the
    device asynchronously and its accept/apply step runs `pipeline_depth`
    cycles later, so device compute and host<->device readback overlap with
    host-side evolution. Proposals therefore see a population that is up to
    `pipeline_depth` cycles stale — the same kind of staleness the reference's
    fully-async islands already embrace (migration reads "whatever snapshot is
    current", SymbolicRegression.jl/src/SymbolicRegression.jl:933-943). With
    pipeline_depth=1 the behaviour is the strict lockstep sequence.
    """
    best_seen = [HallOfFame(options.maxsize) for _ in pops]

    if options.annealing and ncycles > 1:
        temperatures = np.linspace(1.0, 0.0, ncycles)
    else:
        temperatures = np.ones(ncycles)
    if options.deterministic:
        pipeline_depth = max(1, pipeline_depth)  # deterministic for fixed depth

    for s in stats_list:
        s.normalize()
    for bs, pop in zip(best_seen, pops):
        bs.update_many(pop.members, options)

    in_flight: list[tuple] = []  # (all_events, offsets, materialize_fn, T)

    def drain_one():
        all_events, offsets, materialize, T = in_flight.pop(0)
        losses = materialize()
        comps = np.array(
            [compute_complexity(t, options) for ev_trees in offsets for t in ev_trees[2]]
        )
        scores = scorer.score_of(losses, comps) if len(losses) else losses
        for (start, count, _trees), events, pop, stats, bs in zip(
            offsets, all_events, pops, stats_list, best_seen
        ):
            fill_scores(
                events, scores[start : start + count], losses[start : start + count]
            )
            new_members = apply_pass(pop, events, T, stats, options, rng, recorder)
            # best-seen update: newly inserted members may set a
            # per-complexity record (reference tracks best_seen during the
            # cycle, SymbolicRegression.jl/src/SingleIteration.jl:42-101)
            bs.update_many(new_members, options)

    for cycle in range(ncycles):
        T = float(temperatures[cycle])
        all_events = [
            propose_pass(pop, T, curmaxsize, stats, options, nfeatures, rng)
            for pop, stats in zip(pops, stats_list)
        ]
        # "optimize" mutations run the batched constant optimizer on their
        # trees before scoring (reference runs Optim inline per member,
        # SymbolicRegression.jl/src/Mutate.jl optimize branch; default weight 0).
        opt_props = [
            ev
            for events in all_events
            for ev in events
            if isinstance(ev, Proposal) and ev.kind == "optimize" and not ev.failed
        ]
        if opt_props:
            new_trees, _, _ = optimize_constants_batched(
                [ev.tree for ev in opt_props], scorer, options, rng,
                idx=scorer.batch_indices(rng),
            )
            for ev, tree in zip(opt_props, new_trees):
                ev.tree = tree
        # ONE async device dispatch for every candidate of every island.
        trees = []
        offsets = []
        for events in all_events:
            cand = collect_candidates(events)
            offsets.append((len(trees), len(cand), cand))
            trees.extend(cand)
        idx = scorer.batch_indices(rng)
        materialize = scorer.loss_many_async(trees, idx=idx)
        in_flight.append((all_events, offsets, materialize, T))
        if len(in_flight) >= pipeline_depth:
            drain_one()

    while in_flight:
        drain_one()

    return best_seen


def optimize_and_simplify_populations(
    pops: list[Population],
    scorer: BatchScorer,
    options,
    rng: np.random.Generator,
    recorder=None,
) -> None:
    """Simplify every member, then constant-optimize a
    `optimizer_probability` subset — batched across all islands — then
    restore exact scores (reference: optimize_and_simplify_population,
    SymbolicRegression.jl/src/SingleIteration.jl:107-174)."""
    # 1) simplify (semantics-preserving; keeps stored scores, like the
    #    reference which only re-scores after optimization)
    if options.should_simplify:
        for pop in pops:
            for m in pop.members:
                tree = simplify_tree(m.tree, options)
                tree = combine_operators(tree, options)
                m.set_tree(tree)
                m.get_complexity(options)

    # 2) batched constant optimization
    if options.should_optimize_constants:
        selected = []  # (pop, member_index)
        for pop in pops:
            for k, m in enumerate(pop.members):
                if m.tree.has_constants() and rng.random() < options.optimizer_probability:
                    selected.append((pop, k))
        if selected:
            trees = [pop.members[k].tree for pop, k in selected]
            idx = scorer.batch_indices(rng)
            new_trees, losses, improved = optimize_constants_batched(
                trees, scorer, options, rng, idx=idx
            )
            # re-apply dimensional regularization: the optimizer's device
            # losses are raw elementwise losses
            losses = scorer.apply_units_penalty(new_trees, losses)
            comps = [compute_complexity(t, options) for t in new_trees]
            scores = scorer.score_of(losses, np.asarray(comps))
            for (pop, k), tree, loss, score, imp in zip(
                selected, new_trees, losses, scores, improved
            ):
                m = pop.members[k]
                if imp:
                    m.set_tree(tree)
                    m.loss = float(loss)
                    m.score = float(score)
                    m.get_complexity(options)
                    m.reset_birth()
                if recorder is not None:
                    # constant-opt "tuning" events
                    # (reference: SingleIteration.jl:140-171)
                    recorder.record_tuning(m, bool(imp), options)

    # 3) finalize: full-data rescore when batching (reference: finalize_scores,
    #    SymbolicRegression.jl/src/Population.jl:162-176)
    if options.batching:
        all_members = [m for pop in pops for m in pop.members]
        trees = [m.tree for m in all_members]
        comps = [m.get_complexity(options) for m in all_members]
        scores, losses = scorer.score_trees(trees, comps, idx=None)
        for m, s, l in zip(all_members, scores, losses):
            m.score = float(s)
            m.loss = float(l)
