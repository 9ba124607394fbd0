"""Async island scheduler (Options.scheduler="async").

Counterpart of ``symbolicregression_jl_tpu/parallel/islands.py``, and of
the reference's fully-async island model
(SymbolicRegression.jl/src/SymbolicRegression.jl:837-1064): each island runs
its own work unit — one full iteration (``ncycles_per_iteration`` evolve
passes + simplify + constant optimization, the unit shipped by
``@sr_spawner``) — and the head loop merges results as they complete:
update the hall of fame and search statistics, save the CSV, migrate from
the freshest snapshots, and immediately re-spawn that island's next work
unit. Islands therefore evolve asynchronously — no barrier between them;
migration reads "whatever snapshot is current" exactly like the reference
(:933-943).

Concurrency model: a thread pool plays the role of Julia's Task scheduler.
Host-side evolution interleaves under the GIL while every island's batched
scoring goes through the port's ``BatchScorer``: on the card each work
unit's scoring dispatch is a B1 launch (``ops/interp_cuda.fused_loss``) on
the current stream, so several threads launch B1 at once; the launch
counts and the scorer's dispatch and eval counts are kept under locks.
Per-island RunningSearchStatistics are deep copies; the head merges them by
re-accumulating completed members into the shared histogram.

Like the reference's async mode, results depend on completion order — use
scheduler="lockstep" with deterministic=True for reproducibility.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import numpy as np

from ..models.adaptive_parsimony import RunningSearchStatistics
from ..models.hall_of_fame import HallOfFame
from ..models.migration import migrate
from ..models.population import Population
from ..models.scorer import BatchScorer
from ..models.single_iteration import (
    optimize_and_simplify_populations,
    s_r_cycle_lockstep,
)

__all__ = ["async_search_one_output"]


def async_search_one_output(
    dataset,
    options,
    niterations: int,
    rng: np.random.Generator,
    saved_state=None,
    verbosity: int = 1,
    output_file: str | None = None,
    stdin_reader=None,
    recorder=None,
    out_j: int = 1,
    checkpoint_base: str | None = None,
):
    """Async-island counterpart of search._search_one_output (same contract)."""
    from ..search import (
        SearchResult,
        _init_population,
        _poison_populations,
        _quarantine_nonfinite,
        _rescore_population,
        get_cur_maxsize,
    )
    from ..utils import faults
    from ..utils.checkpoint import (
        SearchCheckpoint,
        SearchCheckpointer,
        options_fingerprint,
    )
    from ..utils.export_csv import save_hall_of_fame

    scorer = BatchScorer(dataset, options)
    nfeatures = dataset.n_features
    n_islands = options.populations
    injector = (
        faults.install(options.fault_spec)
        if options.fault_spec
        else faults.active()
    )
    ckptr = (
        SearchCheckpointer.from_options(options, checkpoint_base)
        if checkpoint_base
        else None
    )

    hof = HallOfFame(options.maxsize)
    if saved_state is not None:
        # eval totals span the whole lineage (checkpoint .meta.json sidecar)
        scorer.num_evals = float(getattr(saved_state, "num_evals", 0.0) or 0.0)
        pops = []
        for pop in saved_state.populations[:n_islands]:
            pop = pop.copy()
            if pop.n != options.population_size:
                pops.append(_init_population(scorer, options, nfeatures, rng))
            else:
                pops.append(_rescore_population(pop, scorer, options))
        while len(pops) < n_islands:
            pops.append(_init_population(scorer, options, nfeatures, rng))
        # rescore saved hof members against THIS dataset, on copies — same
        # contract as lockstep/device warm start (reference:
        # SymbolicRegression.jl/src/SymbolicRegression.jl:727-744)
        saved_members = [
            m.copy()
            for m in saved_state.hall_of_fame.members
            if m is not None
        ]
        if saved_members:
            losses = scorer.loss_many([m.tree for m in saved_members])
            comps = [m.get_complexity(options) for m in saved_members]
            scores = scorer.score_of(losses, np.asarray(comps))
            for m, l, s in zip(saved_members, losses, scores):
                m.loss, m.score = float(l), float(s)
                hof.update(m, options)
    else:
        pops = [
            _init_population(scorer, options, nfeatures, rng)
            for _ in range(n_islands)
        ]

    from ..utils.recorder import Recorder

    # shared when a multi-output equation_search owns the (single) recorder
    # file; private for standalone callers (see search._search_one_output)
    own_recorder = recorder is None
    if own_recorder:
        recorder = Recorder(options)
    shared_stats = RunningSearchStatistics(options.maxsize)
    # independent RNG stream per island (thread-safe, reproducible spawn)
    seeds = np.random.SeedSequence(
        options.seed if options.seed is not None else rng.integers(2**31)
    ).spawn(n_islands)
    island_rngs = [np.random.default_rng(s) for s in seeds]

    lock = threading.Lock()  # guards hof / stats / pops / scorer counters
    early_stop = options.early_stop_fn()
    if options.jit_warmup:
        from ..models.warmup import warmup_host_programs

        warmup_host_programs(scorer, options)
    from ..utils.stdin_reader import StdinReader

    # injected reader: shared by concurrent per-output searches, owner-closed
    own_stdin = stdin_reader is None
    if own_stdin:
        stdin_reader = StdinReader()
    start_time = time.time()
    stop_reason: list = [None]
    cycles_left = [niterations] * n_islands
    completed = [0]  # finished work units (dispatch-loop thread only)

    def work_unit(i: int, iteration: int):
        """One island's iteration: the reference's _dispatch_s_r_cycle
        (SymbolicRegression.jl/src/SymbolicRegression.jl:1088-1129)."""
        # simulated preemption; counts one call per work unit
        injector.maybe_die("peer_death")
        if injector.armed("slow_peer"):
            # a straggler, not a death: the work unit stalls delay_ms before
            # doing any work, exercising the dispatch loop's tolerance
            hit = injector.fire("slow_peer")
            if hit is not None:
                time.sleep(float(hit.get("delay_ms", 1000.0)) / 1000.0)
        with lock:
            pop = pops[i].copy()
            stats = shared_stats.copy()  # deep copy per work unit
            curmaxsize = get_cur_maxsize(iteration, niterations, options)
        irng = island_rngs[i]
        best_seen = s_r_cycle_lockstep(
            [pop],
            scorer,
            options.ncycles_per_iteration,
            curmaxsize,
            [stats],
            options,
            nfeatures,
            irng,
            recorder=recorder if recorder.enabled else None,
        )[0]
        optimize_and_simplify_populations(
            [pop], scorer, options, irng,
            recorder if recorder.enabled else None,
        )
        if recorder.enabled:
            with lock:
                recorder.record_population(out_j, i + 1, iteration, pop, options)
        return i, pop, best_seen

    from ..utils.progress import ProgressReporter

    reporter = ProgressReporter(
        niterations * n_islands, options, use_bar=bool(options.progress),
        verbosity=verbosity,
    )

    def on_complete(i: int, pop: Population, best_seen: HallOfFame):
        """Head-side merge (reference main loop :896-1006). Runs ONLY on the
        dispatch-loop thread; the lock exists for the work_unit threads that
        read pops/stats, so it guards just the shared-state mutations — CSV
        writes and progress rendering happen after release (hof is mutated
        nowhere else, so reading it lock-free here is safe)."""
        t_head = time.time()
        hit = injector.fire("nan_flood")
        if hit is not None:
            _poison_populations([pop], float(hit.get("frac", 0.75)))
        with lock:
            pops[i] = pop
            hof.merge(best_seen, options)
            hof.update_many(pop.members, options)
            for m in pop.members:
                shared_stats.update(m.get_complexity(options))
            shared_stats.move_window()
            shared_stats.normalize()
            # non-finite quarantine: a majority-NaN/Inf island is re-seeded
            # from the hall of fame before it can wedge the tournaments
            _quarantine_nonfinite([pop], hof, options)
            # migration into THIS island from current snapshots
            if options.migration:
                all_best = [
                    m
                    for p in pops
                    for m in p.best_sub_pop(options.topn).members
                ]
                migrate(all_best, pops[i], options, options.fraction_replaced, rng)
            if options.hof_migration:
                frontier = hof.pareto_frontier()
                if frontier:
                    migrate(
                        frontier, pops[i], options, options.fraction_replaced_hof, rng
                    )
        if output_file and options.save_to_file:
            save_hall_of_fame(
                output_file, hof, options, dataset.variable_names,
                num_evals=scorer.num_evals,
            )
        completed[0] += 1
        if ckptr is not None:
            # iteration-equivalents: n_islands completed work units ~ one
            # lockstep iteration (the wall-clock cadence fires regardless).
            # Best-effort snapshot (exact=False): island states are copied
            # under the lock, resume rescore-warm-starts from them.
            it_eq, rem = divmod(completed[0], n_islands)
            if (rem == 0 and ckptr.due(it_eq)) or (rem != 0 and ckptr.due(0)):
                with lock:
                    ck = SearchCheckpoint(
                        iteration=it_eq,
                        niterations=niterations,
                        scheduler="async",
                        exact=False,
                        populations=[p.copy() for p in pops],
                        hall_of_fame=hof.copy(),
                        num_evals=float(scorer.num_evals),
                        options_fingerprint=options_fingerprint(options),
                        wall_time=time.time() - start_time,
                        out_j=out_j,
                    )
                ckptr.save(ck)
        reporter.update(
            hof, scorer.num_evals, dataset.variable_names,
            y_variable_name=dataset.y_variable_name,
        )
        # stop conditions (reference :1053-1060); stop_reason writes are
        # idempotent, so no lock is needed around them
        if options.iteration_callback is not None:
            from ..search import IterationReport

            # iteration-equivalents, like the checkpoint cadence above: the
            # async scheduler has no global iteration boundary, so the
            # callback fires once per completed work unit with the
            # equivalent count
            if options.iteration_callback(
                IterationReport(
                    iteration=completed[0] // n_islands,
                    niterations=niterations,
                    hall_of_fame=hof,
                    num_evals=scorer.num_evals,
                    elapsed=time.time() - start_time,
                )
            ):
                stop_reason[0] = "callback"
        if early_stop is not None and any(
            early_stop(m.loss, m.get_complexity(options))
            for m in hof.pareto_frontier()
        ):
            stop_reason[0] = "early_stop"
        if (
            options.timeout_in_seconds is not None
            and time.time() - start_time > options.timeout_in_seconds
        ):
            stop_reason[0] = "timeout"
        if options.max_evals is not None and scorer.num_evals >= options.max_evals:
            stop_reason[0] = "max_evals"
        if stdin_reader.check_for_user_quit():
            stop_reason[0] = "user_quit"
        # head-node occupancy (reference: ResourceMonitor + >40% warning,
        # SymbolicRegression.jl/src/SearchUtils.jl:217-284)
        reporter.head_work(time.time() - t_head)
        reporter.maybe_warn_occupancy()

    max_workers = (
        options.async_workers
        if options.async_workers is not None
        else min(n_islands, 8)
    )
    max_workers = min(max_workers, n_islands)
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        pending = {}
        for i in range(n_islands):
            fut = pool.submit(work_unit, i, niterations - cycles_left[i])
            pending[fut] = i
        while pending:
            done, _ = wait(pending, return_when=FIRST_COMPLETED)
            for fut in done:
                i = pending.pop(fut)
                idx, pop, best_seen = fut.result()
                cycles_left[idx] -= 1
                on_complete(idx, pop, best_seen)
                if stop_reason[0] is None and cycles_left[idx] > 0:
                    nfut = pool.submit(
                        work_unit, idx, niterations - cycles_left[idx]
                    )
                    pending[nfut] = idx
            if stop_reason[0] is not None:
                # drain without re-spawning
                for fut in list(pending):
                    i = pending.pop(fut)
                    idx, pop, best_seen = fut.result()
                    cycles_left[idx] -= 1
                    on_complete(idx, pop, best_seen)
                break

    iteration_seconds = time.time() - start_time
    if own_stdin:
        stdin_reader.close()
    if own_recorder:
        recorder.dump()
    result = SearchResult(
        hall_of_fame=hof,
        populations=pops,
        dataset=dataset,
        options=options,
        num_evals=scorer.num_evals,
    )
    result.stop_reason = stop_reason[0]
    result.iteration_seconds = iteration_seconds
    result.scoring_dispatches = scorer.num_dispatches
    result.use_kernel = scorer.use_kernel
    result.head_occupancy = reporter.occupancy
    return result
