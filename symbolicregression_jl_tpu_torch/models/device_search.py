"""Driver for the device-resident evolution engine (scheduler="device").

Counterpart of ``symbolicregression_jl_tpu/models/device_search.py``,
single process and single card. The host builds the configuration, uploads
the dataset and the initial populations once, runs each iteration's legs on
the device, reads back ONE packed tensor per iteration for the hall of fame
and the stop conditions, and decodes the final populations at the end.
Everything else — tournament, mutation, crossover, accept, replacement,
frequencies, migration — runs on the device (ops/evolve.py).

An iteration is three legs, each counted by the dispatch hook: "evolve"
(``ncycles`` batched events, then migration), "const_opt" (a lockstep
batched BFGS over K members x S restarts), "finalize" (under batching only)
and "readback" (one packed tensor). Where the JAX package compiles the
chain into one program, the port runs it eagerly: the evolve leg makes no
host sync (no ``.item()``, no boolean-mask indexing, no Python branch on a
tensor), so the host only enqueues work. Constant optimization syncs at
most once per line-search step and once per BFGS iteration, to stop where
the JAX package's ``while_loop``s stop.

Kernels: on f32 with built-in operators and a built-in real loss
(``loss_kernel_eligible``), every scoring call goes through B1
(``fused_loss``) and every gradient of constant optimization through B2
(``fused_loss_grad``, via ``DiffLoss``); otherwise (f64, user callables)
both are their plain versions (``plain_losses``). Packing happens on the
device from the state tensors. The TPU's bucket ladders are gone: the
kernels loop to each tree's own length.

The evolve block (``SR_ENGINE_BLOCK``, the JAX package's gate at its
``device_search.py:2010-2046``): where ``block_eligible`` holds on at most
``BLOCK_MAX_ROWS`` rows, the evolve leg is one launch of B3 per iteration
(``evolve_block_cuda.evolve_block``) on a CUDA device with kernel-eligible
names; unset, the block runs exactly there; ``"1"`` forces it, taking B3's
plain version on the CPU or with names the kernels do not take; ``"0"``
keeps the event leg.

The pipelined readback (``Options.async_readback``, on by default here)
copies iteration i's packed tensor into pinned host memory without
blocking and consumes iteration i-1's while the card runs iteration i, so
the hall of fame, the simplify pool and the stop conditions lag one
iteration (the JAX package's documented staleness).

Checkpoints and faults (the JAX package's ``device_search.py:1851-1867,
2710-2725, 2841-2866``): ``peer_death`` fires at the top of each iteration
and ``nan_flood`` writes NaN into the losses of the leading islands on the
device; a due snapshot (``Options.checkpoint_every``) decodes the live
state after the iteration's legs — one full readback, never inside the
evolve leg — into an ``exact=False`` SearchCheckpoint. Resuming from it is
a rescored warm start through ``saved_state``; the engine's generator is
seeded anew from the search's numpy stream, so the resumed run keeps the
snapshot's frontier but not the uninterrupted run's trajectory.

Options of one card (the JAX package's ``device_search.py:2189-2215,
2463-2940``): ``profile=True`` opens a ``utils.profiling`` stage around
each leg where the leg timer sits ("evolve", "const_opt", "finalize") and
around the parts of the readback leg ("readback_pack", "readback_d2h",
"decode_hof", "simplify", "migrate") and the snapshot ("checkpoint"); each
stage ends with a fence, which the disabled profiler never makes, and the
summary is ``SearchResult.engine_profile``. ``use_recorder=True`` sets
``record_events``: the legs queue their event logs on the context, the
readback leg copies them to the host and replays them into the recorder
(models/device_recorder.py), then records the populations. Either one
forces the synchronous readback. A dataset with units sets ``units_check``:
every loss the engine compares carries the dimensional penalty, added after
the kernel's loss. ``optimizer_algorithm="NelderMead"`` runs the batched
simplex of ops/constant_opt.py over the engine scorer (B1 only).

The fleet (``fleet_search``, ``FleetLaneSpec``; the JAX package's
``device_search.py:3062-3878``) runs N compatible searches as one engine:
each lane keeps its solo state and generator, and every kernel launch is
shared across the lanes on the kernels' lane axis (one B3 launch per
iteration, one B1 or B2 launch per constant-optimization step), with one
stacked readback per iteration. A lane ends bit for bit where its solo
``device_search_one_output`` ends.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..analysis.ir_verify import debug_checks_enabled
from ..dataset import Dataset
from ..ops.evolve_block import (
    BLOCK_MAX_ROWS, block_eligible, make_plain_eval, run_block_iteration,
    run_block_iteration_fleet,
)
from ..ops.evolve_block_cuda import evolve_block, evolve_block_reference
from ..ops.constant_opt import _neldermead
from ..ops.evolve import (
    EvoConfig,
    EvoContext,
    EvoState,
    _complexity_members,
    _score_of,
    dim_penalty_batch,
    fleet_migrate_from_pool,
    init_state,
    merge_best_seen,
    migrate_from_pool,
    run_fleet_iteration_fused,
    run_iteration_fused,
)
from ..ops.flat import (
    KIND_BINARY, KIND_CONST, KIND_UNARY, KIND_VAR, FlatTrees, flatten_trees,
    unflatten_tree,
)
from ..ops.interp_cuda import (
    DiffLoss, build, fused_loss, loss_kernel_eligible, over_lanes, plain_losses,
    unpack_programs_fused,
)
from ..ops.treeops import Tree
from ..options import Options, _not_ported
from ..utils.profiling import NULL_PROFILER, StageProfiler
from .hall_of_fame import HallOfFame
from .pop_member import PopMember
from .population import Population

__all__ = [
    "device_search_one_output", "device_mode_supported", "build_evo_config",
    "ScoreData", "EngineScorer", "pack_batch", "fleet_search", "FleetLaneSpec",
    "fleet_eligibility",
]


def device_mode_supported(options: Options) -> str | None:
    """None if the device engine can honor this configuration; else a reason
    (the JAX package's ``device_mode_supported``; its graph-node case raises
    in Options here)."""
    if options.loss_function is not None:
        return (
            "custom full-objective loss_function (host-callable per-tree "
            "objectives cannot run inside the engine)"
        )
    if options.use_recorder and options.device_mutation_attempts > 1:
        # the event log records ONE (kind, candidate) per lane; multi-attempt
        # lanes would mis-attribute the surviving candidate's kind
        return "recorder with device_mutation_attempts > 1"
    if np.dtype(options.dtype) not in (np.dtype(np.float32), np.dtype(np.float64)):
        return f"unsupported engine dtype {np.dtype(options.dtype).name}"
    return None


def build_evo_config(
    options: Options,
    n_features: int,
    baseline_loss: float,
    use_baseline: bool,
    niterations: int,
    n_islands: int | None = None,
    n_rows: int | None = None,
    dataset: Dataset | None = None,
) -> EvoConfig:
    """Translate Options (and the dataset's units) into the engine's static
    EvoConfig, field for field as the JAX package does."""
    I = options.populations if n_islands is None else n_islands
    P = options.population_size
    mw = options.mutation_weights
    tn = min(options.tournament_selection_n, P)
    tw = np.asarray(options.tournament_weights)[:tn]
    return EvoConfig(
        n_islands=I,
        pop_size=P,
        n_slots=options.max_nodes,
        maxsize=options.maxsize,
        maxdepth=options.maxdepth,
        nfeatures=n_features,
        n_unary=options.operators.n_unary,
        n_binary=options.operators.n_binary,
        tournament_n=tn,
        tournament_weights=tuple(tw / tw.sum()),
        mutation_weights=(
            mw.mutate_constant, mw.mutate_operator, mw.swap_operands, mw.add_node,
            mw.insert_node, mw.delete_node, mw.randomize, mw.do_nothing,
        ),
        crossover_probability=options.crossover_probability,
        annealing=options.annealing,
        alpha=options.alpha,
        parsimony=options.parsimony,
        use_frequency=options.use_frequency,
        use_frequency_in_tournament=options.use_frequency_in_tournament,
        adaptive_parsimony_scaling=options.adaptive_parsimony_scaling,
        perturbation_factor=options.perturbation_factor,
        probability_negate_constant=options.probability_negate_constant,
        baseline_loss=baseline_loss,
        use_baseline=use_baseline,
        ncycles=options.ncycles_per_iteration,
        events_per_cycle=max(1, -(-P // tn)),
        fraction_replaced=options.fraction_replaced,
        fraction_replaced_hof=options.fraction_replaced_hof,
        migration=options.migration,
        hof_migration=options.hof_migration,
        topn=min(options.topn, P),
        niterations=niterations,
        warmup_maxsize_by=options.warmup_maxsize_by,
        mutation_attempts=int(options.device_mutation_attempts),
        bin_caps=tuple(tuple(c) for c in options.op_constraints[0]),
        una_caps=tuple(options.op_constraints[1]),
        nested_constraints=tuple(
            (od, oi, tuple(tuple(inner) for inner in inners))
            for od, oi, inners in (options.nested_constraints_resolved or ())
        ),
        batching=bool(options.batching),
        eval_fraction=(
            min(int(options.batch_size), n_rows) / n_rows
            if options.batching and n_rows
            else 1.0
        ),
        val_dtype=str(np.dtype(options.dtype)),
        complexity_table=_complexity_table(options, n_features),
        record_events=bool(options.use_recorder),
        **_units_config(options, dataset, n_features),
    )


_DIM_BASES = ("length", "mass", "time", "current", "temperature", "luminosity", "amount")
#: exponent multipliers of the power-like unary operators (None: generic)
_UNA_DIM_POWERS = {
    "sqrt": 0.5, "sqrt_abs": 0.5, "cbrt": 1.0 / 3.0, "abs": 1.0, "neg": 1.0,
    "square": 2.0, "cube": 3.0, "inv": -1.0,
}
#: binary dim-combination codes: 0 add/sub, 1 mult, 2 div, 3 generic/pow
_BIN_DIM_CODES = {"add": 0, "sub": 0, "mult": 1, "div": 2}


def _units_config(options: Options, dataset, n_features: int) -> dict:
    """EvoConfig units fields (static tables) from the dataset's parsed SI
    units and the operator names; empty when the dataset carries no units
    (the JAX package's ``_units_config``)."""
    if dataset is None or not dataset.has_units:
        return {}
    from ..units import DIMENSIONLESS, Quantity

    def dim_row(dims):
        return tuple(float(getattr(dims, b)) for b in _DIM_BASES)

    xq = dataset.X_units_parsed
    if xq is None:
        xq = [Quantity(1.0, DIMENSIONLESS)] * n_features
    yq = dataset.y_units_parsed
    return dict(
        units_check=True,
        x_dims=tuple(dim_row(q.dims) for q in xq),
        y_dims=dim_row(yq.dims) if yq is not None else None,
        una_dim_pow=tuple(_UNA_DIM_POWERS.get(op.name) for op in options.operators.unary),
        bin_dim_code=tuple(_BIN_DIM_CODES.get(op.name, 3) for op in options.operators.binary),
        dim_penalty=(
            1000.0 if options.dimensional_constraint_penalty is None
            else float(options.dimensional_constraint_penalty)
        ),
        allow_wildcards=not options.dimensionless_constants_only,
    )


def _complexity_table(options: Options, n_features: int):
    """Static per-node cost tables for the engine's mapped complexity
    (reference ComplexityMapping, SymbolicRegression.jl
    src/OptionsStruct.jl:21-113); None -> node count."""
    cm = options.complexity_mapping
    if cm is None:
        return None
    var = np.asarray(cm["variable"], dtype=np.float64)
    var_costs = (
        (float(var),) * max(n_features, 1)
        if var.ndim == 0
        else tuple(float(v) for v in var)
    )
    return (
        tuple(float(c) for c in cm["binop"]),
        tuple(float(c) for c in cm["unaop"]),
        float(cm["constant"]),
        var_costs,
    )


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------


class ScoreData(NamedTuple):
    """The dataset on the engine's device: X [F, R], y [R], w [R] or None in
    the engine dtype, and the score normalization max(baseline, 0.01) as a
    0-d tensor."""

    X: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor | None
    norm: torch.Tensor


def _make_score_data(dataset: Dataset, dtype, device, norm: float) -> ScoreData:
    X, y, w = dataset.device_arrays(dtype, device)
    return ScoreData(X, y, w, torch.tensor(norm, dtype=X.dtype, device=X.device))


def pack_batch(batch: Tree, opset) -> tuple[torch.Tensor, torch.Tensor]:
    """A tree batch -> the kernels' (prog int32 [B, 4N+1], vals [B, N]) on
    its own device (``pack_programs_fused`` without the host round trip)."""
    k = batch.kind
    code = torch.where(
        k == KIND_VAR, 1,
        torch.where(
            k == KIND_UNARY, 2 + batch.op,
            torch.where(k == KIND_BINARY, 2 + opset.n_unary + batch.op, 0),
        ),
    )
    prog = torch.cat(
        [code, batch.lhs, batch.rhs, batch.feat, batch.length[:, None]], 1
    ).to(torch.int32).contiguous()
    return prog, batch.val.contiguous()


class EngineScorer:
    """Every loss and gradient the engine asks for, with its counts.

    ``use_kernel`` (f32, built-in operators and loss): losses through B1,
    gradients through one B2 launch each (``DiffLoss``). Otherwise the plain
    versions (``plain_losses``), on the engine dtype. ``score_calls`` counts loss calls (one B1
    launch each on the card), ``grad_calls`` gradient calls (one B2 launch
    each on the card)."""

    def __init__(self, options: Options, use_kernel: bool):
        self.opset = options.operators
        self.loss_elem = options.loss
        self.use_kernel = use_kernel
        self.score_calls = 0
        self.grad_calls = 0

    def losses(self, batch: Tree, X, y, w) -> torch.Tensor:
        return self.packed_losses(*pack_batch(batch, self.opset), X, y, w)

    def packed_losses(self, prog, vals, X, y, w) -> torch.Tensor:
        """Losses of a packed batch with constants ``vals``; X may carry a
        lane axis (``fused_loss``'s)."""
        self.score_calls += 1
        if self.use_kernel:
            return fused_loss(prog, vals, X, y, w, self.opset, self.loss_elem)
        return over_lanes(
            lambda p, v, Xl, yl, wl: plain_losses(self._unpacked(p), v, Xl, yl, wl, self.opset,
                                                  self.loss_elem),
            prog, vals, X, y, w,
        )

    def packed_loss_grad(self, prog, vals, X, y, w):
        """(losses, d losses / d vals) of a packed batch; X may carry a lane
        axis."""
        self.grad_calls += 1
        if self.use_kernel:
            with torch.enable_grad():
                v = vals.detach().requires_grad_(True)
                f = DiffLoss.apply(v, prog, X, y, w, self.opset, self.loss_elem)
                (g,) = torch.autograd.grad(f.sum(), v)
            return f.detach(), g
        return over_lanes(
            lambda p, v, Xl, yl, wl: plain_losses(self._unpacked(p), v, Xl, yl, wl, self.opset,
                                                  self.loss_elem, with_grad=True),
            prog, vals, X, y, w,
        )

    def _unpacked(self, prog) -> FlatTrees:
        p = np.asarray(prog.cpu())
        return unpack_programs_fused(p, np.zeros((p.shape[0], (p.shape[1] - 1) // 4),
                                                 np.float32), self.opset)


# ---------------------------------------------------------------------------
# Constant optimization
# ---------------------------------------------------------------------------


def _select_and_jitter(state: EvoState, K: int, S: int, I: int, P: int, ctx: EvoContext):
    """Pick K distinct members, constant-bearing ones first (priority
    uniform(0,1) + has_const, top K), and build their restart starts
    [K, S, N]: the constants themselves, then x(1 + 0.5 randn) jitters
    (SymbolicRegression.jl src/ConstantOptimization.jl:53-68). Returns
    (ii, pp, val0, mask, starts)."""
    has_const = (state.kind == KIND_CONST).any(-1).reshape(-1)
    prio = ctx.rand(I * P) + has_const.to(torch.float32)
    flat_idx = torch.argsort(-prio, stable=True)[:K]
    ii, pp = flat_idx // P, flat_idx % P
    val0 = state.val[ii, pp]
    mask = state.kind[ii, pp] == KIND_CONST
    N = val0.shape[1]
    jitter = 1.0 + 0.5 * torch.randn((K, S - 1, N), generator=ctx.gen, device=ctx.device,
                                      dtype=val0.dtype)
    starts = torch.cat([val0[:, None, :], val0[:, None, :] * jitter], 1)
    return ii, pp, val0, mask, starts


def _accept_and_scatter(state: EvoState, cfg: EvoConfig, ii, pp, mask_k, val0, vals,
                        fbest, n_evals: float, norm=None, base_loss=None,
                        ctx: EvoContext | None = None) -> EvoState:
    """Accept only improvements, scatter the new constants, losses and scores
    back, reset the birth of improved members (SymbolicRegression.jl
    src/ConstantOptimization.jl:70-78); fold the tuned members into the
    best-seen frontier unless batching (there ``fbest`` and ``base_loss``
    are losses on one minibatch, and finalize rescores on full data). Under
    ``record_events`` the tuning log (the reference's "tuning" events,
    src/SingleIteration.jl:140-171) goes to ``ctx``."""
    old_loss = state.loss[ii, pp]
    base = old_loss if base_loss is None else base_loss
    improved = (fbest < base) & mask_k.any(1)
    new_val = torch.where(improved[:, None], vals, val0)
    new_loss = torch.where(improved, fbest, old_loss)
    comp_m = _complexity_members(state, cfg, ctx)[ii, pp]
    new_score = _score_of(new_loss, comp_m.to(new_loss.dtype), cfg, norm)
    if not cfg.batching:
        lengths = state.length[ii, pp]
        fields = [state.kind[ii, pp], state.op[ii, pp], state.lhs[ii, pp],
                  state.rhs[ii, pp], state.feat[ii, pp], new_val]
        state = merge_best_seen(
            state, cfg, new_loss, torch.isfinite(new_loss) & (lengths >= 1), fields,
            lengths, comps=comp_m,
        )
    if ctx is not None:
        ctx.log("tuning", {"ii": ii, "pp": pp, "improved": improved, "new_loss": new_loss,
                           "new_val": new_val})
    return state._replace(
        val=torch.index_put(state.val, (ii, pp), new_val),
        loss=torch.index_put(state.loss, (ii, pp), new_loss),
        score=torch.index_put(state.score, (ii, pp), new_score),
        birth=torch.index_put(
            state.birth, (ii, pp), torch.where(improved, state.step, state.birth[ii, pp])
        ),
        num_evals=state.num_evals + n_evals,
    )


class _PackedObjective:
    """``ops.constant_opt._neldermead``'s objective over the engine scorer:
    each value call is one ``packed_losses`` call (one B1 launch on the
    card) on the packed batch, each row repeated ``repeat`` times for the
    simplex's vertices."""

    def __init__(self, scorer: EngineScorer, prog, X, y, w):
        self.scorer = scorer
        self.X, self.y, self.w = X, y, w
        self._progs = {1: prog}

    def value(self, v, repeat: int = 1):
        prog = self._progs.get(repeat)
        if prog is None:
            prog = self._progs[repeat] = torch.repeat_interleave(self._progs[1], repeat, dim=0)
        return self.scorer.packed_losses(prog, v.contiguous(), self.X, self.y, self.w)


def make_const_opt_fn(options: Options, cfg: EvoConfig, scorer: EngineScorer,
                      ctx: EvoContext) -> Callable:
    """The engine's constant optimization (the JAX package's
    ``_make_const_opt_fn_pallas``): the whole (member, restart) batch runs
    one BFGS in lockstep with Armijo backtracking, every value+gradient
    evaluation one B2 launch and every line-search evaluation one B1 launch.
    Under ``optimizer_algorithm="NelderMead"`` (the JAX package's algorithm
    dispatch, its ``device_search.py:788-793``) the batch runs the masked
    simplex of ``ops.constant_opt._neldermead`` instead, every evaluation
    one B1 launch (S·(N+1) vertices per member at once), and no B2.

    Semantics as the JAX package's, including its documented deviation
    (BFGS for every tree, where the reference uses Newton for one-constant
    trees). The backtracking loop syncs once per step to stop when every
    instance satisfies Armijo (the JAX ``while_loop``'s condition); the
    convergence gate (``optimizer_g_tol``) syncs once per BFGS iteration, and
    not at all when the gate is 0. Under batching the whole BFGS runs on one
    fresh row draw, accepts batch against batch and counts evaluations
    fractionally. Returns ``(state, data) -> state``: the one-lane case of
    ``make_fleet_const_opt_fn``."""
    fleet = make_fleet_const_opt_fn(options, cfg, scorer, None)
    return lambda state, data: fleet([state], [data], [ctx], [0])[0]


def make_fleet_const_opt_fn(options: Options, cfg: EvoConfig, scorer: EngineScorer,
                            stacked: Callable | None) -> Callable:
    """Constant optimization for a fleet of searches: ``(states, datas,
    ctxs, lanes) -> states``. Each lane picks its members and draws its
    jitters on its own generator, as its solo run; the L·K·S instances of
    all lanes then run ONE lockstep BFGS (or simplex), each B1 or B2 launch
    on the lane axis (lane l's instances on lane l's data); each lane accepts
    and scatters its own results. ``stacked(lanes)`` gives those lanes'
    ScoreData stacked on a leading lane axis; one lane uses its own data
    unstacked, which is the solo's launch. Each lane's results are its solo
    run's bits: the kernels take their launch shape from one lane's
    instances, the convergence gate freezes lane by lane (``_bfgs_lockstep``)
    and every other operation is per instance."""
    I, P, N = cfg.n_islands, cfg.pop_size, cfg.n_slots
    K = max(1, int(round(options.optimizer_probability * I * P)))
    S = 1 + options.optimizer_nrestarts
    B = K * S
    iters = int(options.optimizer_iterations)
    g_tol = float(options.optimizer_g_tol)
    opset = options.operators
    neldermead = options.optimizer_algorithm == "NelderMead"

    def prepare(state: EvoState, data: ScoreData, ctx: EvoContext):
        """One lane's rows (a fresh draw under batching), members and
        restart starts, in its solo run's draw order."""
        X, y, w = data.X, data.y, data.w
        if cfg.batching:
            idx = torch.randint(0, X.shape[1], (ctx.batch_rows,), generator=ctx.gen,
                                device=ctx.device)
            X, y = X[:, idx].contiguous(), y[idx].contiguous()
            w = None if w is None else w[idx].contiguous()
        ii, pp, val0, mask_k, starts = _select_and_jitter(state, K, S, I, P, ctx)
        members = Tree(*(f[ii, pp] for f in (state.kind, state.op, state.lhs, state.rhs,
                                              state.feat, state.val, state.length)))
        prog_k, _ = pack_batch(members, opset)
        # instance b = tree b // S, restart b % S
        return dict(rows=(X, y, w), ii=ii, pp=pp, val0=val0, mask_k=mask_k, members=members,
                    prog_b=torch.repeat_interleave(prog_k, S, dim=0),
                    mask_b=torch.repeat_interleave(mask_k, S, dim=0),
                    x=starts.reshape(B, N).contiguous())

    def finish(state: EvoState, data: ScoreData, ctx: EvoContext, pre: dict, x, f, f0):
        """One lane's best restart per member, accepted and scattered."""
        val0, mask_k = pre["val0"], pre["mask_k"]
        fs = torch.where(torch.isfinite(f), f, torch.inf).reshape(K, S)
        best = torch.argmin(fs, 1)
        rows = torch.arange(K, device=x.device)
        vals = x.reshape(K, S, N)[rows, best].to(val0.dtype)
        fbest = fs[rows, best].to(val0.dtype)
        n_ev = float(K * S * 2 * iters)
        base = None
        if cfg.batching:
            base = f0.reshape(K, S)[:, 0].to(val0.dtype)
            n_ev *= cfg.eval_fraction
        if cfg.units_check:
            # const-opt never changes structure, so the dimensional penalty
            # is one constant per tree: add it to every loss the accept
            # rule compares (stored losses already carry it)
            pen_k = dim_penalty_batch(pre["members"], cfg, ctx)
            fbest = fbest + pen_k
            if base is not None:
                base = base + pen_k
        return _accept_and_scatter(
            state, cfg, pre["ii"], pre["pp"], mask_k, val0, vals, fbest,
            n_ev, norm=data.norm, base_loss=base, ctx=ctx,
        )

    def const_opt(states, datas, ctxs, lanes) -> list:
        L = len(states)
        pres = [prepare(st, d, ctx) for st, d, ctx in zip(states, datas, ctxs)]
        if L == 1:
            X, y, w = pres[0]["rows"]
        elif cfg.batching:
            X, y, w = (None if pres[0]["rows"][k] is None
                       else torch.stack([p["rows"][k] for p in pres]) for k in range(3))
        else:
            X, y, w = stacked(lanes)[:3]
        prog_b = torch.cat([p["prog_b"] for p in pres])
        mask_b = torch.cat([p["mask_b"] for p in pres])
        x = torch.cat([p["x"] for p in pres])

        def vloss(v):
            return scorer.packed_losses(prog_b, v.contiguous(), X, y, w)

        def vgrad(v):
            f, g = scorer.packed_loss_grad(prog_b, v.contiguous(), X, y, w)
            return f, torch.where(mask_b, g, 0.0)

        if neldermead:
            # restart 0 starts at val0: under batching its loss is the
            # member's loss on this batch
            f0 = vloss(x) if cfg.batching else None
            x, f = _neldermead(_PackedObjective(scorer, prog_b, X, y, w), x, mask_b, iters,
                               g_tol)
        else:
            x, f, f0 = _bfgs_lockstep(x, mask_b, vloss, vgrad, iters, g_tol, lanes=L)
        return [
            finish(st, d, ctx, pre, x[l * B:(l + 1) * B], f[l * B:(l + 1) * B],
                   None if f0 is None else f0[l * B:(l + 1) * B])
            for l, (st, d, ctx, pre) in enumerate(zip(states, datas, ctxs, pres))
        ]

    return const_opt


def _lane_bmm(a, b, lanes: int):
    """``torch.bmm`` on each lane's block of a lane-major batch: cuBLAS may
    choose another algorithm for another batch count, so each lane's
    products are taken at its solo run's batch count, and have its bits."""
    if lanes == 1:
        return torch.bmm(a, b)
    return torch.cat([torch.bmm(u, v) for u, v in zip(a.chunk(lanes), b.chunk(lanes))])


def _bfgs_lockstep(x, mask_b, vloss, vgrad, iters: int, g_tol: float, lanes: int = 1):
    """BFGS over every instance of the batch in lockstep (the JAX package's
    ``_make_const_opt_fn_pallas`` loop): Armijo backtracking (c1 = 1e-4,
    halving, at most 12 steps) that syncs once per step to stop when every
    instance is satisfied, and the g_tol gate, which syncs once per
    iteration and not at all when it is 0. Returns (x, f, f at the start).

    ``lanes``: the batch is that many searches' instances, lane-major (a
    fleet). The g_tol gate then holds lane by lane: a lane whose own max
    |g| is under ``g_tol`` freezes (its x, f and g stay as they are, which is
    what its solo run's ``break`` leaves) while the others go on, and the
    loop ends when every lane is frozen, still at one sync per iteration.
    The Armijo stop stays fleet-wide: an instance already satisfied keeps
    its ``alpha`` and ``f_new`` through ``torch.where``, so the halvings a
    fleetmate still needs change nothing for it, and a frozen lane counts as
    satisfied."""
    B, N = x.shape
    eye = torch.eye(N, dtype=x.dtype, device=x.device).expand(B, N, N)
    f, g = vgrad(x)
    f0 = f
    H = eye
    frozen = fz = None
    for _ in range(iters):
        if g_tol > 0:
            conv = g.abs().reshape(lanes, -1).amax(1) < g_tol
            frozen = conv if frozen is None else frozen | conv
            if bool(frozen.all()):
                break
            if lanes > 1:
                fz = torch.repeat_interleave(frozen, B // lanes)
        d = -_lane_bmm(H, g[:, :, None], lanes)[:, :, 0]
        d = torch.where(mask_b, d, 0.0)
        gtd = (g * d).sum(-1)
        bad = gtd >= 0
        d = torch.where(bad[:, None], -g, d)
        gtd = torch.where(bad, -(g * g).sum(-1), gtd)
        # Armijo backtracking (c1 = 1e-4, halving, <= 12 steps);
        # satisfied instances keep their step and value
        alpha = torch.ones((B,), dtype=x.dtype, device=x.device)
        f_new = vloss(x + d)
        for _ in range(12):
            armijo = f_new <= f + 1e-4 * alpha * gtd
            if fz is not None:
                armijo = armijo | fz
            if bool(armijo.all()):
                break
            alpha = torch.where(armijo, alpha, alpha * 0.5)
            f_new = torch.where(armijo, f_new, vloss(x + alpha[:, None] * d))
        ok = torch.isfinite(f_new) & (f_new < f)
        if fz is not None:
            # a frozen lane keeps x (so s = 0 and H stays), f and g
            ok = ok & ~fz
        x_new = torch.where(ok[:, None], x + alpha[:, None] * d, x)
        f = torch.where(ok, f_new, f)
        _, g_new = vgrad(x_new)
        if fz is not None:
            g_new = torch.where(fz[:, None], g, g_new)
        s = x_new - x
        yk = g_new - g
        sy = (s * yk).sum(-1)
        good = sy > 1e-10
        rho = torch.where(good, 1.0 / torch.where(good, sy, 1.0), 0.0)
        I_rsy = eye - rho[:, None, None] * (s[:, :, None] * yk[:, None, :])
        H_new = _lane_bmm(_lane_bmm(I_rsy, H, lanes), I_rsy.transpose(1, 2), lanes) + (
            rho[:, None, None] * (s[:, :, None] * s[:, None, :])
        )
        H = torch.where(good[:, None, None], H_new, H)
        x, g = x_new, g_new
    return x, f, f0


# ---------------------------------------------------------------------------
# Legs, readback, decode
# ---------------------------------------------------------------------------

# test seam: when set to a callable, the engine main loop reports each leg
# it runs by name ("evolve", "const_opt", "finalize", "readback")
_DISPATCH_HOOK = None
# test seam: when set, a callable (leg name) -> context manager entered
# around the leg (chip_smoke.py checks the evolve leg makes no host sync)
_LEG_WRAP = None


def _count_dispatch(name: str):
    hook = _DISPATCH_HOOK
    if hook is not None:
        hook(name)


class _LegTimer:
    """Host seconds per leg, and device milliseconds per leg from CUDA events
    recorded around it (summed once, at the end of the search); with a
    profiler, the leg is also its stage of the same name, fenced at its
    end (``stage=False`` for a leg whose parts are stages of their own)."""

    def __init__(self, device: torch.device, prof: StageProfiler = NULL_PROFILER):
        self.cuda = device.type == "cuda"
        self.prof = prof
        self.host: dict = {}
        self.events: dict = {}

    @contextlib.contextmanager
    def leg(self, name: str, stage: bool = True):
        _count_dispatch(name)
        wrap = _LEG_WRAP(name) if _LEG_WRAP is not None else contextlib.nullcontext()
        # timed inside the wrap: what the wrap itself does is not the leg's
        with wrap:
            start = end = None
            if self.cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True
                )
                start.record()
            t0 = time.perf_counter()
            with self.prof.stage(name) if stage else contextlib.nullcontext():
                yield
                if stage:
                    self.prof.fence()
            self.host[name] = self.host.get(name, 0.0) + time.perf_counter() - t0
            if self.cuda:
                end.record()
                self.events.setdefault(name, []).append((start, end))

    def device_seconds(self) -> dict:
        if not self.cuda:
            return {}
        torch.cuda.synchronize()
        return {
            name: sum(a.elapsed_time(b) for a, b in ev) * 1e-3
            for name, ev in self.events.items()
        }


def _readback_pack(state: EvoState) -> torch.Tensor:
    """The best-seen frontier and the counters as ONE tensor of the engine
    dtype (the JAX package's ``_make_readback_fn``)."""
    vdt = state.bs_loss.dtype
    parts = [state.bs_loss, state.bs_exists.to(vdt), state.bs_tree[6].to(vdt)]
    parts += [f.to(vdt).reshape(-1) for f in state.bs_tree[:6]]
    parts += [state.num_evals.reshape(1).to(vdt), state.step.reshape(1).to(vdt)]
    return torch.cat(parts)


def _decode_readback(buf: np.ndarray, cfg: EvoConfig):
    S1 = cfg.maxsize + 1
    N = cfg.n_slots
    off = 0

    def take(n):
        nonlocal off
        out = buf[off: off + n]
        off += n
        return out

    bs_loss = take(S1)
    bs_exists = take(S1) > 0.5
    bs_len = take(S1).astype(np.int32)
    fields = [take(S1 * N).reshape(S1, N) for _ in range(6)]
    num_evals = float(take(1)[0])
    return bs_loss, bs_exists, bs_len, fields, num_evals


class _Readback:
    """Start the copy of a packed tensor into pinned host memory without
    blocking (two buffers, used in turn) and hand out a materializer that
    waits for that copy's CUDA event."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.bufs: list = []
        self.turn = 0

    def start(self, rb: torch.Tensor) -> Callable[[], np.ndarray]:
        if not self.cuda:
            host = rb.numpy().copy()
            return lambda: host
        if len(self.bufs) < 2:
            self.bufs.append(torch.empty(rb.shape, dtype=rb.dtype, pin_memory=True))
        host = self.bufs[self.turn % len(self.bufs)]
        self.turn += 1
        host.copy_(rb, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

        def fetch() -> np.ndarray:
            done.synchronize()
            return host.numpy().copy()

        return fetch


def _bs_to_members(bs_loss, bs_exists, bs_len, fields, cfg: EvoConfig, options):
    """Decode best-seen rows into host PopMembers."""
    kind, op, lhs, rhs, feat, val = fields
    flat = FlatTrees(
        kind.astype(np.int32), op.astype(np.int32), lhs.astype(np.int32),
        rhs.astype(np.int32), feat.astype(np.int32), val, np.asarray(bs_len, np.int32),
    )
    if debug_checks_enabled(options):
        from ..analysis import ir_verify

        live = np.asarray(bs_exists) & (np.asarray(bs_len) >= 1)
        ir_verify.verify_flat_trees(
            FlatTrees(*(np.asarray(a)[live] for a in flat)), options.operators,
            allow_empty=False, where="device_search._bs_to_members: ",
        )
    members = []
    for s in range(len(bs_loss)):
        if not bs_exists[s] or bs_len[s] < 1:
            continue
        tree = unflatten_tree(flat, s)
        loss = float(bs_loss[s])
        if cfg.complexity_table is None:
            comp = int(bs_len[s])
        else:
            from ..complexity import compute_complexity

            comp = compute_complexity(tree, options)
        score = float(_score_of(loss, float(comp), cfg))
        members.append(PopMember(tree, score, loss, complexity=comp))
    return members


def _flat_to_tree(flat: FlatTrees, device, vdt) -> Tree:
    return Tree(
        *(torch.from_numpy(np.ascontiguousarray(np.asarray(getattr(flat, f), np.int32)))
          .to(device) for f in ("kind", "op", "lhs", "rhs", "feat")),
        torch.from_numpy(np.ascontiguousarray(flat.val)).to(device=device, dtype=vdt),
        torch.from_numpy(np.asarray(flat.length, np.int32)).to(device),
    )


def _simplified_frontier_pool(members, options, cfg: EvoConfig, score_call, hof, device):
    """Iteration-boundary simplify (the reference simplifies every member
    every iteration, SymbolicRegression.jl src/SingleIteration.jl:107-132;
    the engine has no tree rewriting on the device, so the decoded frontier
    is simplified on the host, rescored through B1 and re-injected).

    Returns (pool, n_scored): a fixed [maxsize+1]-row migration pool of the
    strictly simplified, rescored trees (None when nothing simplified), and
    the evaluations spent. Also folds the rescored members into ``hof``.
    ``score_call`` adds the dimensional penalty where units are on."""
    from ..complexity import compute_complexity
    from .simplify import combine_operators, simplify_tree

    cand = []
    for m in members:
        t = combine_operators(simplify_tree(m.tree.copy(), options), options)
        c = compute_complexity(t, options)
        if c < m.complexity:
            cand.append((t, c, m.loss))
    if not cand:
        return None, 0
    S1 = cfg.maxsize + 1
    cand = sorted(cand, key=lambda tc: tc[2])[:S1]
    trees = [t for t, _, _ in cand]
    vdt = np.dtype(cfg.val_dtype)
    flat = flatten_trees(trees + [trees[0]] * (S1 - len(trees)), cfg.n_slots, dtype=vdt)
    batch = _flat_to_tree(flat, device, getattr(torch, cfg.val_dtype))
    losses_dev = score_call(batch)
    losses = np.asarray(losses_dev.cpu()).astype(vdt).copy()
    losses[len(trees):] = np.inf  # pad rows are never drawn
    for (t, c, _), loss in zip(cand, losses):
        if np.isfinite(loss):
            hof.update(
                PopMember(t, float(_score_of(float(loss), float(c), cfg)), float(loss),
                          complexity=int(c)),
                options,
            )
    pool = (*batch, torch.from_numpy(losses).to(device))
    return pool, len(trees)


def _to_host(entry):
    """An event log (tensors in dicts and tuples) as numpy arrays."""
    if isinstance(entry, dict):
        return {k: _to_host(v) for k, v in entry.items()}
    if isinstance(entry, tuple):
        return tuple(_to_host(v) for v in entry)
    return entry.cpu().numpy()


def _replay_logs(replay, ctx: EvoContext) -> None:
    """Read the legs' queued event logs back and replay them, in the order
    the legs made them."""
    consume = {"iteration": replay.consume_iteration, "migration": replay.consume_migration,
               "tuning": replay.consume_tuning}
    for kind, entry in ctx.take_logs():
        consume[kind](_to_host(entry))


def _state_arrays(state: EvoState):
    """The population fields and losses as numpy: (kind, op, lhs, rhs, feat,
    val, length, loss, score)."""
    return tuple(t.cpu().numpy() for t in (state.kind, state.op, state.lhs, state.rhs,
                                           state.feat, state.val, state.length, state.loss,
                                           state.score))


def _decode_state_populations(state: EvoState, I: int, P: int, cfg: EvoConfig, options):
    """The live EvoState as host Populations — ONE full readback. Returns
    (pops, slots, arrays): ``slots`` is (island, member, complexity) per live
    member, ``arrays`` the decoded (kind, op, lhs, rhs, feat, val, length,
    loss, score)."""
    kind, opa, lhs, rhs, feat, val, length, loss, score = _state_arrays(state)
    loss, score = loss.astype(np.float64), score.astype(np.float64)
    if debug_checks_enabled(options):
        from ..analysis import ir_verify

        ir_verify.verify_flat_trees(
            FlatTrees(kind.reshape(I * P, -1), opa.reshape(I * P, -1),
                      lhs.reshape(I * P, -1), rhs.reshape(I * P, -1),
                      feat.reshape(I * P, -1), val.reshape(I * P, -1),
                      length.reshape(I * P)),
            options.operators, where="device_search._decode_state_populations: ",
        )
    pops, slots = [], []
    for i in range(I):
        flat_i = FlatTrees(kind[i], opa[i], lhs[i], rhs[i], feat[i], val[i], length[i])
        members = []
        for p in range(P):
            if length[i, p] < 1:
                continue
            m = PopMember(
                unflatten_tree(flat_i, p), float(score[i, p]), float(loss[i, p]),
                complexity=int(length[i, p]) if cfg.complexity_table is None else None,
            )
            members.append(m)
            slots.append((i, p, m.get_complexity(options)))
        pops.append(Population(members))
    return pops, slots, (kind, opa, lhs, rhs, feat, val, length, loss, score)


def _reject_out_of_slice(options: Options) -> None:
    reason = device_mode_supported(options)
    if reason is not None:
        raise ValueError(
            f"scheduler='device' cannot honor this configuration ({reason}); "
            "use scheduler='lockstep'"
        )


def _block_mode(ecfg: EvoConfig, device, use_kernel: bool, n_rows: int) -> str | None:
    """Which evolve leg an iteration runs: "kernel" (B3), "plain" (B3's plain
    version) or None (the event leg). The JAX package's gate
    (``device_search.py:2010-2046``): ``SR_ENGINE_BLOCK=0`` turns the block
    off; unset, it runs where the accelerator's kernel would (a CUDA device,
    kernel-eligible names); ``1`` forces it; either way only where
    ``block_eligible`` holds on at most BLOCK_MAX_ROWS rows. Decided from
    names and shapes, never by probing."""
    env = os.environ.get("SR_ENGINE_BLOCK", "")
    if env == "0" or n_rows > BLOCK_MAX_ROWS or not block_eligible(ecfg)[0]:
        return None
    on_card = torch.device(device).type == "cuda" and use_kernel
    if on_card:
        return "kernel"
    return "plain" if env == "1" else None


def _make_block_fn(mode: str | None, options: Options, ecfg: EvoConfig, data: ScoreData,
                   ctx: EvoContext):
    """The evolve leg's ``(state, data) -> state`` for ``mode``, or None. The
    kernel is built here, at set-up, not inside the first leg."""
    if mode is None:
        return None
    opset, loss_elem = options.operators, options.loss
    if mode == "kernel":
        build("evolve_block")

        def kernel_fn(*args):
            return evolve_block(*args, data.X, data.y, data.w, ecfg, opset, loss_elem)

        return lambda state, d: run_block_iteration(state, d, ctx, kernel_fn=kernel_fn)
    eval_fn = make_plain_eval(opset, loss_elem, data.X, data.y, data.w)
    return lambda state, d: run_block_iteration(state, d, ctx, eval_fn=eval_fn)


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------


class _EngineLane:
    """One search's engine set-up, the solo search's prelude, which each
    lane of a fleet runs too: the baseline loss, the configs, the dataset
    on the device, the scorer, the initial trees (drawn from ``rng`` unless
    given), the engine's generator seeded from ``rng`` after them (the JAX
    package's order: same seed, same initial trees), the context and the
    scored initial state.

    ``fleet``: the lane's ``cfg.niterations`` is 0 when there is no warmup
    schedule (the only thing it drives), so that lanes of other budgets
    share one engine config, as the JAX package's ``_FleetLane`` does."""

    def __init__(self, dataset: Dataset, options: Options, niterations: int,
                 rng: np.random.Generator, init_trees=None, fleet: bool = False):
        self.dataset, self.options = dataset, options
        device = self.device = torch.device(options.device)
        I, P = options.populations, options.population_size
        eng_dt = self.eng_dt = np.dtype(options.dtype)
        vdt = self.vdt = getattr(torch, eng_dt.name)

        # baseline loss of the constant mean predictor (reference
        # update_baseline_loss!, SymbolicRegression.jl
        # src/LossFunctions.jl:201-215), from numpy: it becomes a score constant
        y = dataset.y.astype(eng_dt)
        w = None if dataset.weights is None else dataset.weights.astype(eng_dt)
        elem = np.asarray(
            options.loss(torch.from_numpy(np.full_like(y, dataset.avg_y)), torch.from_numpy(y)),
            np.float64,
        )
        bl = float((elem * w).sum() / w.sum()) if w is not None else float(elem.mean())
        use_baseline = bool(np.isfinite(bl))
        dataset.baseline_loss = bl if use_baseline else 1.0
        dataset.use_baseline = use_baseline

        cfg = build_evo_config(
            options, n_features=dataset.n_features, baseline_loss=dataset.baseline_loss,
            use_baseline=use_baseline, niterations=niterations, n_islands=I, n_rows=dataset.n,
            dataset=dataset,
        )
        if fleet and cfg.warmup_maxsize_by == 0:
            cfg = dataclasses.replace(cfg, niterations=0)
        self.cfg = cfg
        # engine config: the score normalization travels as data.norm
        self.ecfg = ecfg = dataclasses.replace(cfg, baseline_loss=1.0, use_baseline=True)
        norm_val = (dataset.baseline_loss if (use_baseline and dataset.baseline_loss >= 0.01)
                    else 0.01)
        self.data = _make_score_data(dataset, eng_dt, device, norm_val)
        self.use_kernel = loss_kernel_eligible(options.operators, options.loss, eng_dt)
        self.scorer = EngineScorer(options, self.use_kernel)

        # --- initial populations (host trees -> device state) ---------------
        if init_trees is None:
            init_trees = Population.random_trees(I * P, options, dataset.n_features, rng)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(rng.integers(0, 2**31 - 1)))
        batch_rows = min(int(options.batch_size), dataset.n) if options.batching else 0
        self.ctx = EvoContext(ecfg, device, gen, self.scorer.losses, batch_rows=batch_rows)
        self.bflat = flatten_trees(init_trees, options.max_nodes, dtype=eng_dt)
        losses0 = self.score_call(_flat_to_tree(self.bflat, device, vdt))
        state = init_state(self.bflat, losses0, ecfg, device)
        comp = _complexity_members(state, ecfg, self.ctx).to(vdt)
        self.state = state._replace(score=_score_of(state.loss, comp, cfg))  # real baseline

    def score_call(self, batch: Tree) -> torch.Tensor:
        """Losses of a batch the host hands the engine (initial members, the
        warm start's hall of fame, the simplify pool), with the same
        structure-only dimensional penalty the legs add."""
        data = self.data
        losses = self.scorer.losses(batch, data.X, data.y, data.w)
        if self.ecfg.units_check:
            losses = losses.to(self.vdt) + dim_penalty_batch(batch, self.ecfg, self.ctx)
        return losses




def device_search_one_output(
    dataset: Dataset,
    options: Options,
    niterations: int,
    rng: np.random.Generator,
    saved_state=None,
    verbosity: int = 1,
    output_file: str | None = None,
    stdin_reader=None,
    out_j: int = 1,
    checkpoint_base: str | None = None,
    recorder=None,
):
    """Run one output's search on the device engine. Returns SearchResult
    (the contract of search._search_one_output), with ``engine_stats``:
    scoring and gradient calls, legs run, seconds per leg (host clock, and
    device time from CUDA events on the card), the host seconds of each
    snapshot written and the islands a ``nan_flood`` fault poisoned; and,
    under ``Options.profile``, ``engine_profile``: the stage profiler's
    summary. ``recorder``: a shared ``utils.recorder.Recorder`` (dumped by
    its owner), or None for one of this search's own."""
    from ..search import SearchResult  # late import (module cycle)
    from ..utils import faults
    from ..utils.checkpoint import SearchCheckpoint, SearchCheckpointer, options_fingerprint
    from ..utils.export_csv import save_hall_of_fame
    from ..utils.progress import ProgressReporter
    from ..utils.recorder import Recorder
    from ..utils.stdin_reader import StdinReader

    _reject_out_of_slice(options)
    own_recorder = recorder is None
    if own_recorder:
        recorder = Recorder(options)
    t_setup = time.perf_counter()
    I, P = options.populations, options.population_size
    injector = faults.install(options.fault_spec) if options.fault_spec else faults.active()
    ckptr = (SearchCheckpointer.from_options(options, checkpoint_base)
             if checkpoint_base else None)

    init_trees = None
    if saved_state is not None:
        init_trees = [m.tree for pop in saved_state.populations for m in pop.members][: I * P]
        if len(init_trees) < I * P:
            init_trees.extend(Population.random_trees(
                I * P - len(init_trees), options, dataset.n_features, rng))
    lane = _EngineLane(dataset, options, niterations, rng, init_trees)
    device, eng_dt, vdt = lane.device, lane.eng_dt, lane.vdt
    cfg, ecfg, data, ctx = lane.cfg, lane.ecfg, lane.data, lane.ctx
    use_kernel, scorer, score_call, bflat, state = (
        lane.use_kernel, lane.scorer, lane.score_call, lane.bflat, lane.state)
    N = options.max_nodes
    const_opt = (
        make_const_opt_fn(options, ecfg, scorer, ctx)
        if options.should_optimize_constants else None
    )
    block_mode = _block_mode(ecfg, device, use_kernel, dataset.n)
    block_fn = _make_block_fn(block_mode, options, ecfg, data, ctx)

    replay = None
    if options.use_recorder:
        from .device_recorder import EngineLineageReplay

        state0 = tuple(
            np.asarray(a).reshape((I, P) + np.shape(a)[1:])
            for a in (bflat.kind, bflat.op, bflat.lhs, bflat.rhs, bflat.feat,
                      np.asarray(bflat.val, eng_dt), bflat.length)
        )
        replay = EngineLineageReplay(state0, options, recorder, out_j=out_j, cfg=cfg,
                                     loss0=state.loss.cpu().numpy(),
                                     score0=state.score.cpu().numpy())

    hof = HallOfFame(options.maxsize)
    if saved_state is not None:
        # rescore the saved hall of fame on this dataset (the reference
        # rescores on warm start, SymbolicRegression.jl
        # src/SymbolicRegression.jl:727-744)
        saved_members = [m.copy() for m in saved_state.hall_of_fame.members if m is not None]
        if saved_members:
            sflat = flatten_trees([m.tree for m in saved_members], N, dtype=eng_dt)
            slosses = np.asarray(score_call(_flat_to_tree(sflat, device, vdt)).cpu())
            for m, loss in zip(saved_members, slosses):
                m.loss = float(loss)
                m.score = float(_score_of(m.loss, float(m.get_complexity(options)), cfg))
                hof.update(m, options)

    # the pipelined readback, unless lineage replay (which consumes each
    # iteration's logs in lockstep) or the profiler (whose fences serialize
    # the pipeline anyway) needs the synchronous one
    async_rb = options.async_readback is not False and replay is None and not options.profile
    prof = StageProfiler(device=device) if options.profile else NULL_PROFILER
    early_stop = options.early_stop_fn()
    own_stdin = stdin_reader is None
    if own_stdin:
        stdin_reader = StdinReader()
    reporter = ProgressReporter(niterations, options, use_bar=bool(options.progress),
                                verbosity=verbosity)
    timer = _LegTimer(device, prof)
    readback = _Readback(device)
    base_evals = float(getattr(saved_state, "num_evals", 0.0) or 0.0) if saved_state else 0.0
    num_evals = base_evals
    device_evals = 0.0
    host_evals = 0.0
    pending = None
    setup_seconds = time.perf_counter() - t_setup
    start_time = time.time()
    stop_reason = None
    iterations_run = 0
    checkpoint_seconds = []
    flooded_islands = 0

    def consume(buf: np.ndarray):
        """Fold one iteration's packed readback into the hall of fame, then
        inject the simplify pool into the CURRENT device state."""
        nonlocal state, device_evals, host_evals
        with prof.stage("decode_hof"):
            bs_loss, bs_exists, bs_len, fields, device_evals = _decode_readback(buf, cfg)
            members = _bs_to_members(bs_loss, bs_exists, bs_len, fields, cfg, options)
            for m in members:
                hof.update(m, options)
        if options.should_simplify:
            with prof.stage("simplify"):
                pool, n_scored = _simplified_frontier_pool(
                    members, options, cfg, score_call, hof, device
                )
            host_evals += n_scored
            if pool is not None:
                with prof.stage("migrate"):
                    state = migrate_from_pool(
                        state, ctx, pool, float(options.fraction_replaced_hof), data.norm
                    )
                    prof.fence()

    for it in range(niterations):
        # simulated preemption (fault-injection harness): one call per
        # iteration, before its legs
        injector.maybe_die("peer_death")
        if injector.armed("nan_flood"):
            hit = injector.fire("nan_flood")
            if hit is not None:
                # poison the leading islands' losses on the device: the NaN
                # storm selection and the pool injections must wash out
                flooded_islands = max(1, int(round(I * float(hit.get("frac", 0.75)))))
                bad = (torch.arange(I, device=device) < flooded_islands)[:, None]
                state = state._replace(loss=torch.where(bad, torch.nan, state.loss))
        state = run_iteration_fused(state, data, ctx, copt=const_opt, leg=timer.leg,
                                    block=block_fn)
        with timer.leg("readback", stage=False):
            with prof.stage("readback_pack"):
                rb = _readback_pack(state)
                prof.fence()
            fetch = readback.start(rb)
            if async_rb:
                prev, pending = pending, fetch
                if prev is not None:
                    consume(prev())
            else:
                with prof.stage("readback_d2h"):
                    buf = fetch()
                if replay is not None:
                    # the evolve, const-opt and finalize legs' logs
                    _replay_logs(replay, ctx)
                consume(buf)
                if replay is not None:
                    # the simplify pool's migration, then the authoritative
                    # populations (out{j}_pop{i} entries, as the host engines)
                    _replay_logs(replay, ctx)
                    replay.snapshot_populations(_state_arrays(state), it + 1)
        iterations_run += 1
        num_evals = base_evals + device_evals + host_evals
        if output_file and options.save_to_file:
            save_hall_of_fame(output_file, hof, options, dataset.variable_names,
                              num_evals=num_evals)
        if ckptr is not None and ckptr.due(it + 1):
            # best-effort snapshot (exact=False) of the live state; in the
            # pipelined loop the hall of fame and num_evals lag one iteration
            t_ck = time.perf_counter()
            with prof.stage("checkpoint"):
                ck_pops, _, _ = _decode_state_populations(state, I, P, cfg, options)
                ckptr.save(SearchCheckpoint(
                    iteration=it + 1, niterations=niterations, scheduler="device", exact=False,
                    populations=ck_pops, hall_of_fame=hof.copy(), num_evals=float(num_evals),
                    options_fingerprint=options_fingerprint(options),
                    wall_time=time.time() - start_time, out_j=out_j,
                ))
            checkpoint_seconds.append(time.perf_counter() - t_ck)
        reporter.update(hof, num_evals, dataset.variable_names,
                        force=it == niterations - 1, y_variable_name=dataset.y_variable_name)
        prof.next_iteration()

        # stop conditions (reference SymbolicRegression.jl
        # src/SearchUtils.jl:190-212); in the pipelined loop the hall of fame
        # and num_evals lag one iteration
        if options.iteration_callback is not None:
            from ..search import IterationReport

            if options.iteration_callback(IterationReport(
                iteration=it + 1, niterations=niterations, hall_of_fame=hof,
                num_evals=float(num_evals), elapsed=time.time() - start_time,
            )):
                stop_reason = "callback"
                break
        if early_stop is not None and any(
            early_stop(m.loss, m.get_complexity(options)) for m in hof.pareto_frontier()
        ):
            stop_reason = "early_stop"
            break
        if (options.timeout_in_seconds is not None
                and time.time() - start_time > options.timeout_in_seconds):
            stop_reason = "timeout"
            break
        if options.max_evals is not None and num_evals >= options.max_evals:
            stop_reason = "max_evals"
            break
        if stdin_reader.check_for_user_quit():
            stop_reason = "user_quit"
            break

    if pending is not None:
        # drain the pipeline: the last iteration's readback is in flight
        consume(pending())
        num_evals = base_evals + device_evals + host_evals
    iteration_seconds = time.time() - start_time
    if own_stdin:
        stdin_reader.close()

    # final population readback: folds the last constant optimization's
    # improvements (absent from the frontier readbacks) into the hall of fame
    pops, _, _ = _decode_state_populations(state, I, P, cfg, options)
    for pop in pops:
        hof.update_many(pop.members, options)
    if output_file and options.save_to_file:
        save_hall_of_fame(output_file, hof, options, dataset.variable_names,
                          num_evals=num_evals)
    result = SearchResult(hall_of_fame=hof, populations=pops, dataset=dataset,
                          options=options, num_evals=num_evals)
    result.stop_reason = stop_reason
    result.iteration_seconds = iteration_seconds
    result.setup_seconds = setup_seconds
    result.use_kernel = use_kernel
    result.engine_stats = {
        "iterations": iterations_run,
        "block": block_mode,
        "score_calls": scorer.score_calls,
        "grad_calls": scorer.grad_calls,
        "host_seconds": dict(timer.host),
        "device_seconds": timer.device_seconds(),
        "checkpoint_seconds": checkpoint_seconds,
        "nan_flooded_islands": flooded_islands,
    }
    if options.profile:
        result.engine_profile = prof.summary()
    if own_recorder:
        recorder.dump()
    return result


# ---------------------------------------------------------------------------
# The fleet: N concurrent searches as one batched engine
# ---------------------------------------------------------------------------
#
# The JAX package runs a fleet as jit(vmap(the fused iteration)) over a
# leading lane axis. The port keeps one state and one generator per lane and
# shares every kernel launch across the lanes instead: one B3 launch per
# iteration on the block (ops/evolve_block.run_block_iteration_fleet), one B1
# or B2 launch per constant-optimization step (make_fleet_const_opt_fn), each
# on the lane axis, and ONE stacked readback per iteration. Every other step
# is the lane's solo code on its own tensors, so each lane ends bit for bit
# where its solo device_search_one_output ends.


@dataclasses.dataclass
class FleetLaneSpec:
    """One lane of a fleet: a single-output dataset and its Options (the JAX
    package's ``FleetLaneSpec``).

    ``options.seed`` drives the lane's randomness exactly as a solo
    ``equation_search(X, y, options=...)`` would (one
    ``np.random.default_rng(seed)`` stream for the initial trees and the
    engine's generator), so a lane's final frontier and ``num_evals`` are
    bit-identical to the same search run solo on the same (padded) data.

    ``init_trees`` / ``init_hof`` warm-start the lane: exactly
    populations*population_size trees, and a live HallOfFame the lane adopts
    (not copied). A warm-started lane is a continuation, not a replay: the
    solo-bitwise guarantee holds for cold lanes."""

    X: object
    y: object
    options: Options
    weights: object = None
    niterations: int = 10
    label: str = ""
    init_trees: object = None
    init_hof: object = None


def fleet_eligibility(options: Options) -> str | None:
    """None when a search with these Options can run as a fleet lane, else
    the reason it must run solo (the JAX package's reasons that apply to one
    card)."""
    reason = device_mode_supported(options)
    if reason is not None:
        return reason
    if options.scheduler != "device":
        return f"scheduler={options.scheduler!r} (fleet lanes run the device engine)"
    if options.use_recorder:
        return "use_recorder (per-lane replay logs are not demuxed)"
    if options.fault_spec:
        return "fault_spec (fault injection is a solo debugging rig)"
    if options.save_to_file:
        return "save_to_file (fleet lanes have no per-lane output file)"
    if options.checkpoint_every is not None or options.checkpoint_every_seconds is not None:
        return "checkpointing (fleet lanes snapshot via the serve spool only)"
    return None


class _FleetLane(_EngineLane):
    """Per-lane host state: the solo prelude (``_EngineLane``) on the lane's
    dataset, padded to the fleet's row count where it is shorter, plus the
    loop's bookkeeping (hall of fame, evaluation counts, stop conditions)."""

    def __init__(self, idx: int, spec: FleetLaneSpec, n_bucket: int, force_weights: bool):
        from ..ops.scoring import pad_rows_np

        self.idx, self.spec = idx, spec
        options = spec.options
        self.nit = int(spec.niterations)
        X, y = np.asarray(spec.X), np.asarray(spec.y)
        w = None if spec.weights is None else np.asarray(spec.weights)
        if y.shape[0] < n_bucket or (force_weights and w is None):
            # mixed row counts: pad to the fleet's rows with row-0 replicas
            # at weight 0; the lane's bitwise reference is then the solo run
            # on this padded, weighted dataset
            X, y, w = pad_rows_np(X, y, w, n_bucket)
        # one fresh stream per search, seeded from Options.seed, as
        # equation_search's single-output entry
        rng = np.random.default_rng(options.seed)
        I, P = options.populations, options.population_size
        init_trees = None
        if spec.init_trees is not None:
            init_trees = list(spec.init_trees)
            if len(init_trees) != I * P:
                raise ValueError(
                    "init_trees must carry populations*population_size="
                    f"{I * P} trees (got {len(init_trees)})"
                )
        super().__init__(Dataset(X, y, weights=w), options, self.nit, rng, init_trees,
                         fleet=True)
        self.block_mode = _block_mode(self.ecfg, self.device, self.use_kernel, self.dataset.n)
        self.async_rb = options.async_readback is not False and not options.profile
        self.early_stop = options.early_stop_fn()
        self.hof = spec.init_hof if spec.init_hof is not None else HallOfFame(options.maxsize)
        self.device_evals = self.host_evals = self.num_evals = 0.0
        self.iterations = 0

    def agreement_key(self) -> tuple:
        """What every lane of a fleet must share beside the engine config:
        the device, the readback mode, the scoring path and evolve leg, and
        the constant optimization's settings."""
        o = self.options
        return (str(self.device), self.async_rb, self.use_kernel, self.block_mode,
                o.should_optimize_constants, o.optimizer_algorithm, o.optimizer_probability,
                o.optimizer_nrestarts, o.optimizer_iterations, o.optimizer_g_tol,
                o.operators, o.loss, self.data.w is not None)


class _FleetData:
    """The active lanes' datasets stacked on a leading lane axis (X [L, F, R],
    y and w [L, R], norm [L]) for the kernels' lane axis, rebuilt only when
    the set of active lanes changes."""

    def __init__(self, datas):
        self.datas = datas
        self.key = self.value = None

    def __call__(self, lanes) -> ScoreData:
        key = tuple(lanes)
        if key != self.key:
            ds = [self.datas[l] for l in lanes]
            self.key, self.value = key, ScoreData(
                torch.stack([d.X for d in ds]), torch.stack([d.y for d in ds]),
                None if ds[0].w is None else torch.stack([d.w for d in ds]),
                torch.stack([d.norm for d in ds]),
            )
        return self.value


def _make_fleet_block_fn(mode: str | None, options: Options, ecfg: EvoConfig,
                         stacked: _FleetData):
    """The fleet's evolve leg ``(states, datas, ctxs, lanes) -> states`` for
    ``mode``, or None (the event leg, lane after lane): one B3 launch over
    every active lane's islands ("kernel"), or B3's plain version on the
    same lane axis ("plain")."""
    if mode is None:
        return None
    opset, loss_elem = options.operators, options.loss
    block = evolve_block
    if mode == "kernel":
        build("evolve_block")
    else:
        block = evolve_block_reference

    def fleet_block(states, datas, ctxs, lanes):
        d = stacked(lanes)
        return run_block_iteration_fleet(
            states, datas, ctxs,
            lambda *a: block(*a, d.X, d.y, d.w, ecfg, opset, loss_elem),
        )

    return fleet_block


_STOP_REASONS = {0: None, 1: "early_stop", 2: "timeout", 3: "max_evals", 5: "callback"}


def fleet_search(
    specs,
    verbosity: int = 0,
    coalesce_wait_s: float = 0.0,
    on_lane_done=None,
    lane_bucket: int | None = None,
    data_update_hook=None,
    on_lanes_ready=None,
):
    """Run N compatible single-output searches as one batched engine (the
    JAX package's ``fleet_search``). Returns ``[SearchResult]`` in spec
    order.

    Every lane must be fleet-eligible (``fleet_eligibility``) and the lanes
    must share one engine configuration: equal engine EvoConfig (operators,
    sizes, cycles: everything but the per-lane baseline and seed), the same
    device, scoring path, evolve leg, readback mode and constant
    optimization. Lanes of different row counts are padded to the largest
    (``pad_rows_np``), and then every lane carries explicit weights. Each
    lane keeps its own niterations, timeout, max_evals, early stop and
    iteration_callback: a finished lane stops running while the rest go on.

    An iteration is one "evolve" leg (one B3 launch for every active lane on
    the block, else each lane's event leg in turn), one "const_opt" leg
    (one BFGS over all lanes' instances, each B1 / B2 launch on the lane
    axis), "finalize" under batching, and one "readback" leg: ONE stacked
    tensor copied to the host and demuxed into each lane's hall of fame,
    simplify pool and ``fleet_migrate_from_pool``.

    ``on_lane_done(idx, result)`` fires as each lane ends.
    ``coalesce_wait_s`` is bookkeeping only. ``lane_bucket`` is accepted
    and changes nothing: the JAX package pads the lane axis with inert lanes
    so that fleets of other sizes share one compiled program, and the port
    compiles nothing per fleet size, so it launches only the real lanes.
    ``data_update_hook`` and ``on_lanes_ready`` (the stream session's live
    row swaps) come with the stream slice."""
    from ..search import IterationReport, SearchResult  # late import (module cycle)

    if data_update_hook is not None:
        raise _not_ported("fleet_search(data_update_hook=...)", "A, slice 5: stream/")
    if on_lanes_ready is not None:
        raise _not_ported("fleet_search(on_lanes_ready=...)", "A, slice 5: stream/")
    specs = list(specs)
    L = len(specs)
    if L == 0:
        return []
    for spec in specs:
        reason = fleet_eligibility(spec.options)
        if reason is not None:
            raise ValueError(f"spec not fleet-eligible: {reason}")
    if lane_bucket is not None and int(lane_bucket) < 1:
        raise ValueError(f"lane_bucket must be >= 1 (got {lane_bucket})")
    t_setup = time.perf_counter()

    ns = [np.asarray(s.y).shape[0] for s in specs]
    n_bucket = max(ns)
    # mixed row counts (or mixed weight presence) force explicit weights on
    # EVERY lane, so that the lanes' data stack
    force_weights = any(s.weights is not None for s in specs) or any(n < n_bucket for n in ns)
    lanes = [_FleetLane(i, s, n_bucket, force_weights) for i, s in enumerate(specs)]
    lead = lanes[0]
    ecfg, options = lead.ecfg, lead.options
    for lane in lanes[1:]:
        if lane.ecfg != ecfg:
            raise ValueError(
                "fleet lanes must share one engine EvoConfig (operators, "
                "population geometry, cycles, maxsize, dtype, batching); "
                f"lane {lane.idx} ({lane.spec.label!r}) differs"
            )
        if lane.agreement_key() != lead.agreement_key():
            raise ValueError(
                "fleet lanes must agree on async_readback/profile, the "
                f"const-opt configuration and the device; lane {lane.idx} differs"
            )

    device = lead.device
    datas = [lane.data for lane in lanes]
    ctxs = [lane.ctx for lane in lanes]
    states = [lane.state for lane in lanes]
    for lane in lanes:
        lane.state = None  # the fleet's list is the state from here on
    stacked = _FleetData(datas)
    scorer = EngineScorer(options, lead.use_kernel)
    const_opt = (make_fleet_const_opt_fn(options, ecfg, scorer, stacked)
                 if options.should_optimize_constants else None)
    block_fn = _make_fleet_block_fn(lead.block_mode, options, ecfg, stacked)
    frac_hof = float(options.fraction_replaced_hof)
    async_rb = lead.async_rb
    prof = (StageProfiler(device=device) if any(ln.options.profile for ln in lanes)
            else NULL_PROFILER)
    timer = _LegTimer(device, prof)
    readback = _Readback(device)
    active = [lane.nit > 0 for lane in lanes]
    results: list = [None] * L
    pending = None  # (fetch, the lanes it holds): the pipelined carry
    setup_seconds = time.perf_counter() - t_setup
    start_time = time.time()

    def consume_rows(buf: np.ndarray, consumers) -> None:
        """Demux one stacked readback into the lanes' halls of fame and
        simplify pools, then inject the pools (``fleet_migrate_from_pool``;
        a lane without a pool is left alone)."""
        nonlocal states
        pools = [None] * L
        for l in sorted(consumers):
            lane = lanes[l]
            with prof.stage("decode_hof"):
                bs_loss, bs_exists, bs_len, fields, lane.device_evals = _decode_readback(
                    buf[l], lane.cfg)
                members = _bs_to_members(bs_loss, bs_exists, bs_len, fields, lane.cfg,
                                         lane.options)
                for m in members:
                    lane.hof.update(m, lane.options)
            if lane.options.should_simplify:
                with prof.stage("simplify"):
                    pools[l], n_scored = _simplified_frontier_pool(
                        members, lane.options, lane.cfg, lane.score_call, lane.hof, device)
                lane.host_evals += n_scored
            lane.num_evals = lane.device_evals + lane.host_evals
        if any(p is not None for p in pools):
            with prof.stage("migrate"):
                states = fleet_migrate_from_pool(
                    states, ctxs, pools, [p is not None for p in pools], frac_hof,
                    [d.norm for d in datas])
                prof.fence()

    def stop_lanes(stopping) -> None:
        """The solo's post-loop sequence for each (lane, stop code): drain
        its pending readback (simplify injection included); then, the main
        loop's seconds taken (before any final decode, as the solo's), decode
        its populations, fold them into its hall of fame, build its
        SearchResult. A lane's drain touches only its own state."""
        nonlocal pending
        for l, _ in stopping:
            active[l] = False
            if pending is not None and l in pending[1]:
                pending[1].discard(l)
                consume_rows(pending[0](), (l,))
        iteration_seconds = time.time() - start_time
        for l, stop_code in stopping:
            finish_lane(l, stop_code, iteration_seconds)

    def finish_lane(l: int, stop_code: int, iteration_seconds: float) -> None:
        lane = lanes[l]
        pops, _, _ = _decode_state_populations(states[l], lane.ctx.cfg.n_islands,
                                               lane.options.population_size, lane.cfg,
                                               lane.options)
        for pop in pops:
            lane.hof.update_many(pop.members, lane.options)
        result = SearchResult(hall_of_fame=lane.hof, populations=pops, dataset=lane.dataset,
                              options=lane.options, num_evals=lane.num_evals)
        result.stop_reason = _STOP_REASONS[stop_code]
        result.iteration_seconds = iteration_seconds
        result.setup_seconds = setup_seconds
        result.use_kernel = lane.use_kernel
        result.engine_stats = {
            "iterations": lane.iterations,
            "block": lane.block_mode,
            "score_calls": lane.scorer.score_calls,
            "grad_calls": lane.scorer.grad_calls,
            "fleet": {"lanes": L, "lane_bucket": lane_bucket,
                      "coalesce_wait_s": float(coalesce_wait_s)},
        }
        results[l] = result
        if on_lane_done is not None:
            on_lane_done(l, result)

    stop_lanes([(l, 0) for l, lane in enumerate(lanes) if lane.nit <= 0])

    for it in range(max(lane.nit for lane in lanes)):
        if not any(active):
            break
        on = {l for l in range(L) if active[l]}
        states = run_fleet_iteration_fused(states, datas, ctxs, active, copt=const_opt,
                                           leg=timer.leg, block=block_fn)
        for l in on:
            lanes[l].iterations += 1
        with timer.leg("readback", stage=False):
            with prof.stage("readback_pack"):
                rb = torch.stack([_readback_pack(st) for st in states])
                prof.fence()
            fetch = readback.start(rb)
            if async_rb:
                prev, pending = pending, (fetch, set(on))
                if prev is not None and prev[1]:
                    consume_rows(prev[0](), prev[1])
            else:
                with prof.stage("readback_d2h"):
                    buf = fetch()
                consume_rows(buf, on)
        prof.next_iteration()

        t_now = time.time()
        stopping = []
        for l in sorted(on):
            lane = lanes[l]
            o = lane.options
            stop_code = 0
            if o.iteration_callback is not None and o.iteration_callback(IterationReport(
                iteration=it + 1, niterations=lane.nit, hall_of_fame=lane.hof,
                num_evals=float(lane.num_evals), elapsed=t_now - start_time,
            )):
                stop_code = 5
            elif lane.early_stop is not None and any(
                lane.early_stop(m.loss, m.get_complexity(o)) for m in lane.hof.pareto_frontier()
            ):
                stop_code = 1
            elif o.timeout_in_seconds is not None and t_now - start_time > o.timeout_in_seconds:
                stop_code = 2
            elif o.max_evals is not None and lane.num_evals >= o.max_evals:
                stop_code = 3
            if stop_code or it + 1 >= lane.nit:
                stopping.append((l, stop_code))
        stop_lanes(stopping)
        if verbosity > 0:
            print(f"[fleet iter {it + 1}] lanes={L} live={sum(active)}")

    fleet_stats = {
        "score_calls": scorer.score_calls,
        "grad_calls": scorer.grad_calls,
        "host_seconds": dict(timer.host),
        "device_seconds": timer.device_seconds(),
    }
    summary = prof.summary() if prof.enabled else None
    for result in results:
        result.engine_stats["fleet"].update(fleet_stats)
        if summary is not None:
            result.engine_profile = summary
    return results
