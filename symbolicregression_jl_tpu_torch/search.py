"""equation_search: the top-level search driver.

Counterpart of ``symbolicregression_jl_tpu/search.py`` for the lockstep
scheduler (below) and the device-resident engine (``scheduler="device"``,
models/device_search.py); checkpoint/resume, fault injection and the async
scheduler are later slices of the port and raise NotImplementedError.

Reference: SymbolicRegression.jl/src/SymbolicRegression.jl:360-1129. Keeps the
6-phase driver shape (validate -> create -> initialize -> warmup -> main loop
-> teardown) but replaces the async per-island task scheduler with the
**lockstep island scheduler**: all islands of an output advance together so
that every cycle's candidate scoring, and every iteration's constant
optimization, is one large batched device dispatch.

Budget semantics match the reference: ``niterations`` full iterations per
output, each = ``ncycles_per_iteration`` evolve passes per island
(SymbolicRegression.jl/src/SymbolicRegression.jl:575).
"""

from __future__ import annotations

import dataclasses
import time
import typing
from typing import Any

import numpy as np

from .dataset import Dataset
from .models.adaptive_parsimony import RunningSearchStatistics
from .models.hall_of_fame import HallOfFame
from .models.migration import migrate
from .models.pop_member import PopMember
from .models.population import Population
from .models.scorer import BatchScorer
from .models.single_iteration import (
    optimize_and_simplify_populations,
    s_r_cycle_lockstep,
)
from .options import Options
from .utils.export_csv import save_hall_of_fame
from .complexity import compute_complexity

__all__ = ["equation_search", "SearchResult", "IterationReport"]


class IterationReport(typing.NamedTuple):
    """What ``Options.iteration_callback`` sees after each completed
    iteration — enough for the serving layer to stream the frontier, enforce
    deadlines, and decide preemption, without exposing scheduler internals.
    ``hall_of_fame`` is the LIVE object: callbacks must copy before mutating
    or crossing a thread boundary."""

    iteration: int  # iterations COMPLETED (1-based)
    niterations: int  # this run's total budget
    hall_of_fame: HallOfFame
    num_evals: float
    elapsed: float  # seconds since the scheduler's main loop started


@dataclasses.dataclass
class SearchResult:
    """Per-output search output: hall of fame + final island populations
    (the reference's return_state tuple, SymbolicRegression.jl/src/SymbolicRegression.jl:1079-1086)."""

    hall_of_fame: HallOfFame
    populations: list[Population]
    dataset: Dataset
    options: Options
    num_evals: float

    @property
    def pareto_frontier(self):
        return self.hall_of_fame.pareto_frontier()

    def report(self):
        return self.hall_of_fame.format(self.options, self.dataset.variable_names)

    def best(self) -> PopMember:
        """Best expression by the reference's selection rule: highest score
        among frontier members with loss <= 1.5x min loss
        (SymbolicRegression.jl/src/MLJInterface.jl:399-408)."""
        rows = self.report()
        if not rows:
            raise ValueError("empty hall of fame")
        min_loss = min(r["loss"] for r in rows)
        eligible = [r for r in rows if r["loss"] <= 1.5 * min_loss]
        return max(eligible, key=lambda r: r["score"])["member"]


def get_cur_maxsize(iteration: int, niterations: int, options: Options) -> int:
    """Warmup schedule 3 -> maxsize over `warmup_maxsize_by` fraction of the
    budget (reference: get_cur_maxsize, SymbolicRegression.jl/src/SearchUtils.jl:458-470)."""
    if options.warmup_maxsize_by <= 0:
        return options.maxsize
    fraction = iteration / max(niterations, 1)
    in_warmup = fraction / options.warmup_maxsize_by
    cur = 3 + int(in_warmup * (options.maxsize - 3))
    return min(cur, options.maxsize)


def _init_population(
    scorer: BatchScorer, options: Options, nfeatures: int, rng: np.random.Generator
) -> Population:
    trees = Population.random_trees(options.population_size, options, nfeatures, rng)
    comps = [compute_complexity(t, options) for t in trees]
    scores, losses = scorer.score_trees(trees, comps)
    members = []
    for t, s, l, c in zip(trees, scores, losses, comps):
        m = PopMember(t, s, l, complexity=c)
        members.append(m)
    return Population(members)


def _rescore_population(
    pop: Population, scorer: BatchScorer, options: Options
) -> Population:
    trees = [m.tree for m in pop.members]
    comps = [m.get_complexity(options) for m in pop.members]
    scores, losses = scorer.score_trees(trees, comps)
    for m, s, l in zip(pop.members, scores, losses):
        m.score, m.loss = float(s), float(l)
    return pop


def _quarantine_nonfinite(
    pops: list[Population], hof: HallOfFame, options: Options
) -> int:
    """Non-finite quarantine: a population whose loss vector went
    majority-NaN/Inf in one iteration (optimizer excursion, poisoned data
    batch) would wedge the tournament — every comparison against inf/NaN
    keeps the poisoned members alive forever. Reset the non-finite members
    of such populations from the hall-of-fame Pareto frontier (fresh
    PopMember copies: new ref/birth, finite losses) and return the number
    reset. Populations with only a minority of non-finite members are left
    alone — inf is the routine marker for invalid candidates and ordinary
    selection handles it. The hall of fame itself never admits non-finite
    losses (HallOfFame.update), so the frontier is always a safe donor."""
    frontier = hof.pareto_frontier()
    if not frontier:
        return 0
    n_reset = 0
    for pop in pops:
        bad = [
            k for k, m in enumerate(pop.members) if not np.isfinite(m.loss)
        ]
        if 2 * len(bad) <= pop.n:
            continue
        for j, k in enumerate(bad):
            src = frontier[j % len(frontier)]
            pop.members[k] = PopMember(
                src.tree.copy(),
                src.score,
                src.loss,
                complexity=src.get_complexity(options),
                parent=src.ref,
            )
            n_reset += 1
    return n_reset


def _search_one_output(
    dataset: Dataset,
    options: Options,
    niterations: int,
    rng: np.random.Generator,
    saved_state: SearchResult | None = None,
    verbosity: int = 1,
    output_file: str | None = None,
    stdin_reader=None,
    recorder=None,
    out_j: int = 1,
) -> SearchResult:
    scorer = BatchScorer(dataset, options)
    nfeatures = dataset.n_features
    from .utils.recorder import Recorder

    # a multi-output equation_search owns ONE shared recorder (dumped once,
    # after every output finishes — concurrent per-output dumps to the same
    # recorder_file would race); standalone callers get a private one
    own_recorder = recorder is None
    if own_recorder:
        recorder = Recorder(options)

    # -- initialize (warm start re-scores saved members: reference
    #    _initialize_search!, SymbolicRegression.jl/src/SymbolicRegression.jl:722-795)
    hof = HallOfFame(options.maxsize)
    if saved_state is not None:
        # best-effort continuation: the eval budget spans the whole lineage
        scorer.num_evals = float(getattr(saved_state, "num_evals", 0.0) or 0.0)
        pops = []
        for pop in saved_state.populations:
            pop = pop.copy()
            if pop.n != options.population_size:
                pops.append(_init_population(scorer, options, nfeatures, rng))
            else:
                pops.append(_rescore_population(pop, scorer, options))
        while len(pops) < options.populations:
            pops.append(_init_population(scorer, options, nfeatures, rng))
        pops = pops[: options.populations]
        saved_members = [m.copy() for m in saved_state.hall_of_fame.members if m is not None]
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
            for _ in range(options.populations)
        ]

    stats = RunningSearchStatistics(options.maxsize)
    stats_list = [stats] * len(pops)  # shared: lockstep updates at barriers only
    early_stop = options.early_stop_fn()
    if options.jit_warmup:
        from .models.warmup import warmup_host_programs

        warmup_host_programs(scorer, options)
    from .utils.stdin_reader import StdinReader

    # an injected reader is SHARED by concurrent per-output searches ('q'
    # quits the whole fit) and is closed by its owner, not here
    own_stdin = stdin_reader is None
    if own_stdin:
        stdin_reader = StdinReader()
    start_time = time.time()
    stop_reason = None
    from .utils.progress import ProgressReporter

    reporter = ProgressReporter(
        niterations, options, use_bar=bool(options.progress), verbosity=verbosity
    )

    for iteration in range(niterations):
        curmaxsize = get_cur_maxsize(iteration, niterations, options)

        best_seen = s_r_cycle_lockstep(
            pops,
            scorer,
            options.ncycles_per_iteration,
            curmaxsize,
            stats_list,
            options,
            nfeatures,
            rng,
            recorder=recorder,
        )
        optimize_and_simplify_populations(pops, scorer, options, rng, recorder)
        if recorder.enabled:
            for i, pop in enumerate(pops):
                recorder.record_population(out_j, i + 1, iteration, pop, options)

        # merge halls of fame + frequency stats (head-side merge in the
        # reference main loop, SymbolicRegression.jl/src/SymbolicRegression.jl:916-926)
        for bs in best_seen:
            hof.merge(bs, options)
        for pop in pops:
            hof.update_many(pop.members, options)
            for m in pop.members:
                stats.update(m.get_complexity(options))
        stats.move_window()
        stats.normalize()

        n_quarantined = _quarantine_nonfinite(pops, hof, options)
        if n_quarantined and verbosity > 0:
            print(
                f"[quarantine] iteration {iteration + 1}: reset "
                f"{n_quarantined} non-finite members from the hall of fame"
            )

        # migration (reference: SymbolicRegression.jl/src/SymbolicRegression.jl:933-943)
        if options.migration:
            all_best = [
                m
                for pop in pops
                for m in pop.best_sub_pop(options.topn).members
            ]
            for pop in pops:
                migrate(all_best, pop, options, options.fraction_replaced, rng)
        if options.hof_migration:
            frontier = hof.pareto_frontier()
            for pop in pops:
                migrate(frontier, pop, options, options.fraction_replaced_hof, rng)

        if output_file and options.save_to_file:
            save_hall_of_fame(
                output_file, hof, options, dataset.variable_names,
                num_evals=scorer.num_evals,
            )

        reporter.update(
            hof,
            scorer.num_evals,
            dataset.variable_names,
            force=iteration == niterations - 1,
            y_variable_name=dataset.y_variable_name,
        )

        # stop conditions (reference: SymbolicRegression.jl/src/SearchUtils.jl:190-212)
        if options.iteration_callback is not None and options.iteration_callback(
            IterationReport(
                iteration=iteration + 1,
                niterations=niterations,
                hall_of_fame=hof,
                num_evals=scorer.num_evals,
                elapsed=time.time() - start_time,
            )
        ):
            stop_reason = "callback"
            break
        if early_stop is not None and any(
            early_stop(m.loss, m.get_complexity(options))
            for m in hof.pareto_frontier()
        ):
            stop_reason = "early_stop"
            break
        if (
            options.timeout_in_seconds is not None
            and time.time() - start_time > options.timeout_in_seconds
        ):
            stop_reason = "timeout"
            break
        if options.max_evals is not None and scorer.num_evals >= options.max_evals:
            stop_reason = "max_evals"
            break
        if stdin_reader.check_for_user_quit():
            stop_reason = "user_quit"
            break

    iteration_seconds = time.time() - start_time
    if own_stdin:
        stdin_reader.close()
    if own_recorder:
        recorder.dump()
    if output_file and options.save_to_file:
        # final write: the saved file must match the returned frontier
        save_hall_of_fame(
            output_file, hof, options, dataset.variable_names,
            num_evals=scorer.num_evals,
        )
    result = SearchResult(
        hall_of_fame=hof,
        populations=pops,
        dataset=dataset,
        options=options,
        num_evals=scorer.num_evals,
    )
    result.iteration_seconds = iteration_seconds
    result.stop_reason = stop_reason
    result.scoring_dispatches = scorer.num_dispatches
    result.use_kernel = scorer.use_kernel
    return result


#: reference parallelism names -> scheduler (``parallelism`` resolution,
#: SymbolicRegression.jl/src/SymbolicRegression.jl:465-488). The async
#: scheduler is not ported and raises in Options.
_PARALLELISM_TO_SCHEDULER = {
    "serial": "lockstep",
    "multithreading": "async",
    "multiprocessing": "lockstep",
    "lockstep": "lockstep",
    "async": "async",
    "device": "device",
}


def equation_search(
    X,
    y,
    *,
    weights=None,
    options: Options | None = None,
    niterations: int = 10,
    variable_names: list[str] | None = None,
    y_variable_names=None,
    saved_state=None,
    resume_from: str | None = None,
    verbosity: int | None = None,
    parallelism: str | None = None,
    X_units=None,
    y_units=None,
) -> Any:
    """Top-level API, mirroring the reference's
    ``equation_search(X, y; kws...)`` (SymbolicRegression.jl/src/SymbolicRegression.jl:360-428).

    X: (n_features, n). y: (n,) or (n_outputs, n) — multi-output runs one
    independent search per output row (reference: construct_datasets,
    SymbolicRegression.jl/src/SearchUtils.jl:472-511). Returns SearchResult, or a
    list of SearchResult for multi-output — state (populations + hall of
    fame) is always included, so there is no ``return_state`` flag.

    ``parallelism`` accepts the reference mode names (``"serial"``,
    ``"multithreading"``, ``"multiprocessing"``) or a scheduler name and
    overrides ``options.scheduler``; ``None`` keeps the options value.
    ``y_variable_names`` names the output variable(s) for rendering (str, or
    list with one entry per output row).

    ``resume_from`` (checkpoint resume) is not ported yet and raises
    NotImplementedError.
    """
    options = options or Options()
    if resume_from is not None:
        raise NotImplementedError(
            "resume_from (checkpoint resume) is not ported to the PyTorch "
            "package yet (ROADMAP.md, A, slice 3: utils/checkpoint.py)"
        )
    if parallelism is not None:
        try:
            scheduler = _PARALLELISM_TO_SCHEDULER[parallelism]
        except KeyError:
            raise ValueError(
                f"unknown parallelism {parallelism!r}; expected one of "
                f"{sorted(_PARALLELISM_TO_SCHEDULER)}"
            ) from None
        if scheduler != options.scheduler:
            options = dataclasses.replace(options, scheduler=scheduler)
    X = np.asarray(X)
    y = np.asarray(y)
    multi_output = y.ndim == 2
    ys = y if multi_output else y[None, :]
    nout = ys.shape[0]
    if weights is not None:
        weights = np.asarray(weights)
        if weights.ndim == 2:
            ws = weights
        else:
            # 1-D weights apply to every output row (reference reshapes
            # weights alongside y, SymbolicRegression.jl/src/SymbolicRegression.jl:387-398).
            ws = np.broadcast_to(weights[None, :], (nout, weights.shape[-1]))
        if ws.shape != ys.shape:
            raise ValueError(
                f"weights shape {weights.shape} incompatible with y shape {y.shape}"
            )
    else:
        ws = [None] * nout

    verbosity = 1 if verbosity is None else verbosity
    rng = np.random.default_rng(options.seed)

    # preflight (reference: _validate_options, SymbolicRegression.jl/src/SymbolicRegression.jl:604-633)
    if options.runtests:
        from .configure import test_mini_pipeline, test_option_configuration

        test_option_configuration(options)
        if options.runtests == "full":
            test_mini_pipeline(options)

    saved = saved_state
    if saved is not None and not isinstance(saved, (list, tuple)):
        saved = [saved]

    if y_variable_names is None:
        y_names = [None] * nout
    elif isinstance(y_variable_names, str):
        y_names = [y_variable_names] * nout
    else:
        y_names = list(y_variable_names)
        if len(y_names) != nout:
            raise ValueError(
                f"y_variable_names has {len(y_names)} entries for {nout} outputs"
            )

    def _make_dataset(j):
        dataset = Dataset(
            X,
            ys[j],
            weights=ws[j] if weights is not None else None,
            variable_names=variable_names,
            y_variable_name=y_names[j],
            X_units=X_units,
            y_units=y_units,
        )
        if options.runtests:
            from .configure import test_dataset_configuration

            test_dataset_configuration(dataset, options, verbosity)
        return dataset

    # the timestamped default base is computed ONCE per search: per-output
    # (and, under parallel_outputs, per-thread) regeneration could scatter a
    # multi-output fit's .out{j} files across different base names when the
    # wall clock ticks across a second boundary between calls
    _default_base = f"hall_of_fame_{time.strftime('%Y-%m-%d_%H%M%S')}.csv"

    def _output_file(j):
        if not options.save_to_file:
            return None
        base = options.output_file or _default_base
        return base if nout == 1 else f"{base}.out{j + 1}"

    # per-output RNG streams: multi-output fits spawn one child stream per
    # output for EVERY scheduler, so serial and concurrent execution of the
    # same fit are seed-for-seed identical (the concurrent path below cannot
    # share one sequential stream across threads)
    child_rngs = list(rng.spawn(nout)) if nout > 1 else [rng]

    # ONE recorder for the whole fit, dumped once after every output returns:
    # per-output recorders would all write options.recorder_file, and the
    # concurrent path below would race them (the reference likewise keeps one
    # record for the run, SymbolicRegression.jl/src/SearchUtils.jl:377-393)
    from .utils.recorder import Recorder

    shared_recorder = Recorder(options)

    def _run_one(j, dataset, reader=None, quiet=False):
        saved_j = saved[j] if saved is not None else None
        if options.scheduler == "device":
            from .models.device_search import device_search_one_output

            return device_search_one_output(
                dataset, options, niterations, child_rngs[j],
                saved_state=saved_j,
                verbosity=0 if quiet else verbosity,
                output_file=_output_file(j),
                stdin_reader=reader,
            )
        return _search_one_output(
            dataset, options, niterations, child_rngs[j],
            saved_state=saved_j,
            verbosity=0 if quiet else verbosity,
            output_file=_output_file(j),
            stdin_reader=reader,
            recorder=shared_recorder,
            out_j=j + 1,
        )

    # --- concurrent multi-output: one search per host
    # thread; device programs / scorer dispatches and host-side work of
    # different outputs overlap. The reference interleaves (output,
    # population) work units in one scheduler for the same reason
    # (SymbolicRegression.jl/src/SymbolicRegression.jl:676-679,871-877).
    if nout > 1 and options.parallel_outputs is not False:
        from concurrent.futures import ThreadPoolExecutor

        from .utils.stdin_reader import StdinReader

        datasets = [_make_dataset(j) for j in range(nout)]
        reader = StdinReader()  # shared; its quit latch reaches all outputs

        try:
            with ThreadPoolExecutor(max_workers=min(nout, 8)) as pool:
                # only output 0 narrates — interleaved progress from N
                # threads is unreadable
                results = list(
                    pool.map(
                        lambda j: _run_one(
                            j, datasets[j], reader=reader, quiet=j > 0
                        ),
                        range(nout),
                    )
                )
        finally:
            reader.close()
        shared_recorder.dump()
        return results

    results = []
    for j in range(nout):
        results.append(_run_one(j, _make_dataset(j)))
        # 'q' quits the WHOLE search, not just the current output (reference:
        # one watch_stream for the run, SymbolicRegression.jl/src/SearchUtils.jl:140-188)
        if getattr(results[-1], "stop_reason", None) == "user_quit":
            break
    shared_recorder.dump()
    return results if multi_output else results[0]
