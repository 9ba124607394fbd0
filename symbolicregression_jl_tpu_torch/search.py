"""equation_search: the top-level search driver.

Counterpart of ``symbolicregression_jl_tpu/search.py`` for the lockstep
scheduler (below) and the device-resident engine (``scheduler="device"``,
models/device_search.py), with full-state checkpoints, ``resume_from`` and
fault injection (utils/checkpoint.py, utils/faults.py); the async scheduler
and the multi-host per-process snapshots are later slices of the port.

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


def _poison_populations(pops: list[Population], frac: float) -> None:
    """nan_flood fault: overwrite the leading ``frac`` of every population's
    losses/scores with NaN — the storm the quarantine must absorb."""
    for pop in pops:
        k = max(1, int(round(frac * pop.n)))
        for m in pop.members[:k]:
            m.loss = float("nan")
            m.score = float("nan")


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
    resume=None,
    checkpoint_base: str | None = None,
) -> SearchResult:
    from .models.pop_member import counter_state, restore_counter_state
    from .utils import faults
    from .utils.checkpoint import (
        SearchCheckpoint,
        SearchCheckpointer,
        options_fingerprint,
    )

    scorer = BatchScorer(dataset, options)
    nfeatures = dataset.n_features
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
    start_iter = 0
    if resume is not None:
        # bit-exact continuation (SearchCheckpoint, exact=True): populations,
        # hall of fame, RNG stream, and the member id counters are restored
        # VERBATIM — no rescoring, no refill — so iteration start_iter
        # proceeds exactly as the uninterrupted run's would have
        pops = list(resume.populations)
        hof = resume.hall_of_fame
        scorer.num_evals = float(resume.num_evals)
        if resume.rng_state is not None:
            rng.bit_generator.state = resume.rng_state
        if resume.counters is not None:
            restore_counter_state(resume.counters)
        start_iter = int(resume.iteration)
    elif saved_state is not None:
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
    if resume is not None and resume.stats_frequencies is not None:
        stats.frequencies[:] = np.asarray(resume.stats_frequencies)
        stats.normalize()
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

    for iteration in range(start_iter, niterations):
        # simulated preemption (peer_death fault): fires BEFORE the
        # iteration's work, so the last completed checkpoint is the resume
        # point — exactly the window a real kill would leave
        injector.maybe_die("peer_death")
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
        hit = injector.fire("nan_flood")
        if hit is not None:
            _poison_populations(pops, float(hit.get("frac", 0.75)))
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

        if ckptr is not None and ckptr.due(iteration + 1):
            # end-of-iteration boundary: everything iteration+1 will consume
            # (RNG stream, counters, stats, populations, hof) is captured, so
            # the resumed run replays the remaining iterations bit-exactly
            ckptr.save(SearchCheckpoint(
                iteration=iteration + 1,
                niterations=niterations,
                scheduler="lockstep",
                exact=True,
                populations=pops,
                hall_of_fame=hof,
                num_evals=float(scorer.num_evals),
                rng_state=rng.bit_generator.state,
                stats_frequencies=stats.frequencies.copy(),
                counters=counter_state(),
                options_fingerprint=options_fingerprint(options),
                wall_time=time.time() - start_time,
                out_j=out_j,
            ))

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

    ``resume_from`` restores a full-state checkpoint written by a prior run
    with ``Options.checkpoint_every`` (a snapshot path or the checkpoint
    base, newest snapshot wins; multi-output runs append ``.out{j}`` like
    ``output_file``). On the lockstep scheduler, resuming a matching-options
    run from the port's own snapshot continues BIT-EXACTLY — the final hall
    of fame is identical to the uninterrupted run's. The device engine, a
    snapshot the JAX package wrote, and any cross-scheduler resume
    warm-start instead: populations and hall of fame are rescored and the
    remaining ``niterations - iteration`` iterations run. Mutually exclusive
    with ``saved_state``.
    """
    options = options or Options()
    # peer-death state is PER SEARCH: a second equation_search in the same
    # process must not exclude peers that died in a previous search's
    # exchange
    from .parallel import distributed as _dist

    _dist.reset_peer_state()
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

    resumes = None
    if resume_from is not None:
        if saved is not None:
            raise ValueError(
                "resume_from and saved_state are mutually exclusive: a "
                "checkpoint already carries the populations and hall of fame"
            )
        import warnings

        from .utils.checkpoint import load_checkpoint
        from .utils.checkpoint import options_fingerprint as _ofp

        resumes = []
        for j in range(nout):
            base_j = resume_from if nout == 1 else f"{resume_from}.out{j + 1}"
            try:
                ck = load_checkpoint(base_j)
            except FileNotFoundError:
                # multi-process device runs snapshot per process (.p{id})
                world, pid = _dist.world_shape()
                if world <= 1:
                    raise
                ck = load_checkpoint(f"{base_j}.p{pid}")
            if ck.options_fingerprint and tuple(ck.options_fingerprint) != _ofp(options):
                warnings.warn(
                    "resume_from: checkpoint was written with different "
                    "search options (operators/sizes/seed); continuing as a "
                    "best-effort warm start — exact resume is not guaranteed",
                    stacklevel=2,
                )
                ck.exact = False  # demote: verbatim state may not even fit
            resumes.append(ck)

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
            y_units=y_units[j] if isinstance(y_units, (list, tuple)) else y_units,
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

    def _ckpt_base(j):
        # mirrors _output_file's .out{j} convention; the schedulers gate on
        # Options.checkpoint_every / checkpoint_every_seconds being set
        base = options.checkpoint_file or "sr_checkpoint.pkl"
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
        nit = niterations
        resume_kw = {}
        if resumes is not None:
            ck = resumes[j]
            if options.scheduler == "lockstep" and ck.exact and ck.scheduler == "lockstep":
                # bit-exact continuation: the lockstep scheduler restores the
                # snapshot verbatim and runs iterations [ck.iteration,
                # niterations) on the restored RNG stream
                resume_kw["resume"] = ck
            else:
                # cross-scheduler / non-exact snapshot: rescored warm start
                # over the REMAINING budget
                saved_j = ck
                nit = max(0, niterations - int(ck.iteration))
        kw = dict(
            saved_state=saved_j,
            verbosity=0 if quiet else verbosity,
            output_file=_output_file(j),
            stdin_reader=reader,
            out_j=j + 1,
            checkpoint_base=_ckpt_base(j),
        )
        if options.scheduler == "async":
            from .parallel.islands import async_search_one_output

            return async_search_one_output(dataset, options, nit, child_rngs[j],
                                           recorder=shared_recorder, **kw)
        if options.scheduler == "device":
            from .models.device_search import device_search_one_output

            return device_search_one_output(dataset, options, nit, child_rngs[j],
                                            recorder=shared_recorder, **kw)
        return _search_one_output(
            dataset, options, nit, child_rngs[j], recorder=shared_recorder, **kw, **resume_kw
        )

    # --- concurrent multi-output: one search per host
    # thread; device programs / scorer dispatches and host-side work of
    # different outputs overlap. The reference interleaves (output,
    # population) work units in one scheduler for the same reason
    # (SymbolicRegression.jl/src/SymbolicRegression.jl:676-679,871-877).
    serial = _dist.world_shape()[0] > 1
    if nout > 1 and options.parallel_outputs is True and serial:
        # multi-process exchanges are per output and lockstep across
        # processes: interleaving outputs would deadlock them
        import warnings

        warnings.warn(
            "parallel_outputs=True: multi-host searches run their outputs "
            "serially (the per-iteration cross-host exchange is per-output)",
            stacklevel=2,
        )
    if nout > 1 and options.parallel_outputs is not False and not serial:
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
