"""Driver for the device-resident evolution engine (scheduler="device").

Counterpart of ``symbolicregression_jl_tpu/models/device_search.py``. The
host builds the configuration, uploads
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
tensor), so the host only enqueues work. Constant optimization makes no
host sync either: its line search scores all 13 trial steps at once and its
stop tests (the JAX package's ``while_loop`` conditions) are decided per
instance on the device (``_bfgs_lockstep``).

Kernels: on f32 with built-in operators and a built-in real loss
(``loss_kernel_eligible``), every scoring call goes through B1
(``fused_loss``) and every gradient of constant optimization through B2
(``fused_loss_grad``, via ``DiffLoss``); otherwise (f64, user callables)
both are their plain versions (``plain_losses``). Under a full objective
(``Options.loss_function_jit``, the JAX package's ``device_search.py:
684-741, 836-845``) every scoring call is B4 then the objective
(``objective_losses``) and every gradient B4, autograd of the objective and
one seeded B2 sweep (``DiffPreds``), on f32 with built-in operators
(``preds_kernel_eligible``); the block is off, as in the JAX package, so
the evolve leg is the event leg. Packing happens on the device from the
state tensors. The TPU's bucket ladders are gone: the kernels loop to each
tree's own length.

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
summary is ``SearchResult.engine_profile``.

Spans and host-sync counts (``utils.profiling.SpanRecord``, one per search,
carried by every shard's ``EvoContext``): under ``profile=True``, or when a
torch profiler records at the call's start, the search records spans, each
a host wall and a count in ``engine_stats["spans"]`` and, under a profiler,
a range ``leg:<name>`` on the device trace's clock. The spans are each leg
("evolve", "const_opt", "finalize", "readback", "exchange"); inside the
const-opt leg, gapless sub-spans "const_opt/prepare", then one
"const_opt/step" per BFGS iteration (the host's enqueue of it), then
"const_opt/finish"; the call's "prelude" (entry to the first iteration's
legs; sub-spans "prelude/lane" and "prelude/initial_scoring") and "tail"
(loop exit to the return; "tail/drain", "tail/decode_populations",
"tail/hof"). ``setup_seconds`` is the prelude's wall, read whether or not
the spans are on. A span never fences or syncs, so the frontier is the same
with spans on and off; off, each costs an attribute load and the shared
no-op context. ``engine_stats["host_syncs"]`` counts, always, the
deliberate host syncs by site: "readback" (a wait for the packed readback's
copy) is the only one; a fleet's are the fleet's, every lane waiting at the
same syncs. ``engine_stats["line_search"]`` counts the const-opt leg's line
searches and, read once at the call's tail, the step each instance accepted
(``LineSearchStats``).

``use_recorder=True`` sets ``record_events``: the legs queue their event
logs on the context, the readback leg copies them to the host and replays
them into the recorder (models/device_recorder.py), then records the
populations. It forces the synchronous readback, as ``profile`` does. A
dataset with units sets ``units_check``: every loss the engine compares
carries the dimensional penalty, added after the kernel's loss. ``optimizer_algorithm="NelderMead"`` runs the batched
simplex of ops/constant_opt.py over the engine scorer (B1 only).

The fleet (``fleet_search``, ``FleetLaneSpec``; the JAX package's
``device_search.py:3062-3878``) runs N compatible searches as one engine:
each lane keeps its solo state and generator, and every kernel launch is
shared across the lanes on the kernels' lane axis (one B3 launch per
iteration, one B1 or B2 launch per constant-optimization step), with one
stacked readback per iteration. A lane ends bit for bit where its solo
``device_search_one_output`` ends. The stream session (stream/session.py)
keeps one lane alive and swaps its rows between iterations through
``fleet_search``'s ``data_update_hook``: the swap writes the lane's resident
tensors in place (``LaneDataUpdate``), so every kernel reads the new rows
through the same pointers.

The in-process mesh (the JAX package's ``device_search.py:1912-1960``):
over the devices ``Options.mesh_devices`` names (the JAX engine takes every
local device; here the caller names them, because a mesh turns the block
off and one card on the block runs a search faster) and with no recorder,
the islands shard over 'pop' when they divide over the devices; under
``data_sharding="rows"`` the largest rows axis dividing both the row count
and the device count takes the rows, the pop axis what is left
(``_mesh_shape``). Each shard keeps its islands, its row block, its
generator and its scorer on its device (``_EngineLane``), and every leg
runs in all shards at once (``parallel.mesh.shard_map``): the frontier,
the frequency histogram and the counters stay equal on every shard by the
island axis's collectives (``ops/evolve.py``), and under a rows axis every
loss and gradient is combined over the row blocks (``EngineScorer``). The
block, the recorder and the fleet stay off under a mesh, as in the JAX
package. The host reads the frontier from shard 0 and decodes the global
islands in island order, so a snapshot does not depend on the mesh. In a
world of processes each one shards its own islands over its devices and
merges its shards' migration pools on the mesh before the exchange
(``parallel.mesh.intra_host_pool_merge``). The whole search runs with its
first device as the CUDA runtime's current one.

What outlives a search goes through the process's program cache
(``serve/program_cache.py``, ``PROGRAM_CACHE``): the dataset's ``ScoreData``
upload, keyed on its digest, norm, dtype and device (``_cached_score_data``;
never written in place: a fleet stacks copies of it), and the kernels'
operator table, which each scorer looks up once (``scorer.cached_optab``).
Searches of one process may run at once (serve workers,
``parallel_outputs``): each has its own state, generator and tensors, but
the kernels' launch counters, the test seams ``_DISPATCH_HOOK``,
``_LEG_WRAP`` and ``_STATE_HOOK`` and the synchronizations of the leg timer
and profiler are process-wide, so under concurrent searches the counters
and the hooks' calls sum over all of them and a leg's times include the
other searches' queued work. The spans and host-sync counts are per search
and never mix; a torch profiler's ranges are process-wide, and under a
profiler that records from a call's start the call's legs are ranges
whether or not ``_LEG_WRAP`` opens its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
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
    extract_topn_pool,
    fleet_migrate_from_pool,
    init_state,
    make_sharded_finalize,
    make_sharded_iteration,
    merge_best_seen,
    migrate_from_pool,
    run_fleet_iteration_fused,
    run_iteration_fused,
    shard_evo_state,
    unshard_evo_state,
)
from ..ops.flat import (
    KIND_BINARY, KIND_CONST, KIND_UNARY, KIND_VAR, FlatTrees, flatten_trees,
    unflatten_tree,
)
from ..ops.interp import eval_plan, make_plan
from ..ops.interp_cuda import (
    DiffLoss, DiffPreds, build, fused_loss, loss_kernel_eligible, objective_losses,
    over_lanes, plain_losses, preds_kernel_eligible, unpack_programs_fused,
)
from ..ops.scoring import objective_loss, objective_loss_plain
from ..ops.treeops import Tree
from ..options import Options
from ..serve.program_cache import global_program_cache, oom_site
from ..utils.profiling import NULL_PROFILER, SpanRecord, StageProfiler
from .hall_of_fame import HallOfFame
from .pop_member import PopMember
from .population import Population
from ..parallel import mesh as mesh_mod
from ..parallel.mesh import indexed_device, shard_map
from .scorer import cached_optab

__all__ = [
    "device_search_one_output", "device_mode_supported", "build_evo_config",
    "ScoreData", "EngineScorer", "pack_batch", "fleet_search", "FleetLaneSpec",
    "fleet_eligibility", "LaneDataUpdate",
]


def device_mode_supported(options: Options) -> str | None:
    """None if the device engine can honor this configuration; else a reason
    (the JAX package's ``device_mode_supported``, reason for reason).
    Complex dtypes and graph-node DAGs run on the lockstep scheduler, on the
    card."""
    if options.loss_function is not None:
        return (
            "custom full-objective loss_function (host-callable per-tree "
            "objectives cannot run inside the engine; batched objectives over "
            "the prediction matrix run in-engine via Options.loss_function_jit)"
        )
    if options.loss_function_jit is not None and options.data_sharding == "rows":
        return (
            "loss_function_jit with data_sharding='rows' (cross-shard "
            "combination of an arbitrary objective is undefined; the "
            "engine's combine is specific to weighted-mean losses)"
        )
    if options.use_recorder and options.device_mutation_attempts > 1:
        # the event log records ONE (kind, candidate) per lane; multi-attempt
        # lanes would mis-attribute the surviving candidate's kind
        return "recorder with device_mutation_attempts > 1"
    if options.graph_nodes:
        return "GraphNode shared-subtree DAGs"
    if np.dtype(options.dtype) not in (np.dtype(np.float32), np.dtype(np.float64)):
        return f"unsupported engine dtype {np.dtype(options.dtype).name}"
    return None


def engine_kernel_eligible(options: Options, eng_dt) -> bool:
    """Whether the engine's losses and gradients run on the kernels: B1 and
    B2 (``loss_kernel_eligible``), or under a full objective B4 and the
    seeded sweep (``preds_kernel_eligible``: the elementwise loss plays no
    part). Decided from names only."""
    if options.loss_function_jit is not None:
        return preds_kernel_eligible(options.operators, eng_dt)
    return loss_kernel_eligible(options.operators, options.loss, eng_dt)


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


# the process's cache of what outlives a search (serve/program_cache.py)
PROGRAM_CACHE = global_program_cache()


def _dataset_key(dataset: Dataset) -> tuple:
    """Content key of a dataset's rows (the JAX package's ``_dataset_key``:
    digest, shape and dtype of X, y and the weights)."""
    def part(a):
        if a is None:
            return None
        a = np.ascontiguousarray(a)
        return hashlib.blake2b(a.tobytes(), digest_size=16).hexdigest(), a.shape, str(a.dtype)

    return part(dataset.X), part(dataset.y), part(dataset.weights)


def _cached_score_data(dataset: Dataset, dtype, device, norm: float) -> ScoreData:
    """The dataset's ScoreData from ``PROGRAM_CACHE`` (kind "score_data",
    charged by its bytes), uploaded on a miss. Keyed as the JAX package keys
    it (``models/device_search.py:389-415``): the rows' digest, the norm (it
    depends on the loss, not only on the rows), the engine dtype and the
    indexed card ("cuda" and "cuda:0" share an entry). The tensors are
    shared by every search of the dataset: nothing
    writes them in place (``_FleetData`` stacks copies; a stream swap's data
    is built by ``_FleetLane.rebuild_score_data``, outside the cache)."""
    key = (_dataset_key(dataset), float(norm), np.dtype(dtype).name, str(indexed_device(device)))
    data = PROGRAM_CACHE.get("score_data", key)
    if data is None:
        # uploaded outside the cache's lock; a racing upload of the same key
        # loses to the first put
        data = _make_score_data(dataset, dtype, device, norm)
        data = PROGRAM_CACHE.put("score_data", key, data, nbytes=sum(
            t.numel() * t.element_size() for t in data if t is not None))
    return data


def _make_score_data_rows(dataset: Dataset, dtype, mesh, norm: float) -> list:
    """Rows-sharded ScoreData over ``mesh``'s 'rows' axis (the JAX
    package's ``_make_score_data_rows``): one per shard in flat order, shard
    (i, j) holding row block j of X, y and w on its device (shards on one
    device share the block's tensors), ``norm`` replicated. The row count
    must divide over the axis (the mesh decision chooses the axis so)."""
    n_rows = mesh.devices.shape[1]
    X, y, w = (None if a is None else np.ascontiguousarray(np.asarray(a, dtype))
               for a in (dataset.X, dataset.y, dataset.weights))
    R = X.shape[1]
    if R % n_rows:
        raise ValueError(f"{R} rows do not divide over a rows axis of {n_rows}")
    k = R // n_rows
    placed, out = {}, []
    for s_ in range(mesh.size):
        i, j = mesh.coords(s_)
        dev = mesh.devices[i, j]
        key = (str(dev), j)
        if key not in placed:
            sl = slice(j * k, (j + 1) * k)
            Xd = torch.from_numpy(np.ascontiguousarray(X[:, sl])).to(dev)
            placed[key] = ScoreData(
                Xd, torch.from_numpy(np.ascontiguousarray(y[sl])).to(dev),
                None if w is None else torch.from_numpy(np.ascontiguousarray(w[sl])).to(dev),
                torch.tensor(norm, dtype=Xd.dtype, device=dev),
            )
        out.append(placed[key])
    return out


def score_data_specs(data: ScoreData | None = None) -> ScoreData:
    """Which axis of each ScoreData leaf splits over the mesh (the JAX
    package's ``score_data_specs``, as tuples): X's rows, y's and w's over
    'rows', ``norm`` replicated (``()``); a ScoreData without weights has
    None for w."""
    has_w = data is None or data.w is not None
    return ScoreData((None, "rows"), ("rows",), ("rows",) if has_w else None, ())


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
    gradients through one B2 launch each (``DiffLoss``), each handed the
    operator table the scorer looked up once on ``device`` (default
    ``options.device``; ``cached_optab``). Otherwise the plain versions
    (``plain_losses``), on the engine dtype. ``score_calls`` counts loss
    calls (one B1 launch each on the card), ``grad_calls`` gradient calls
    (one B2 launch each on the card); ``line_search`` the constant
    optimization's line searches (``LineSearchStats``).

    Under a full objective (``options.loss_function_jit``; ``use_kernel``
    then means ``preds_kernel_eligible``) a loss call is B4 and the
    objective (``objective_losses``) and a gradient call is ``DiffPreds``
    (B4, autograd of the objective, one seeded sweep), once per lane of a
    lane axis (``over_lanes``: B4 and the seeded sweep take no lane axis);
    otherwise their plain versions, the interpreter and its autograd. A
    tree whose predictions are not all finite scores inf with zero
    gradients on both.

    ``rows_axis``: the rows axis of a mesh (``parallel.mesh.Axis``), whose
    shard holds one row block. Every loss and gradient is then its block's,
    combined over the axis in one gather (the JAX package's
    ``psum(local * wsum) / psum(wsum)``), in f64 and in shard order, with
    ``parallel/sharding.make_sharded_loss``'s rule: a tree not finite on a
    block with weight scores inf (zero gradients), a block whose weights
    sum to 0 adds nothing. Every shard of the axis gets the same bits."""

    def __init__(self, options: Options, use_kernel: bool, device=None, rows_axis=None):
        self.opset = options.operators
        self.loss_elem = options.loss
        self.objective = options.loss_function_jit
        self.use_kernel = use_kernel
        device = options.device if device is None else device
        self.table = cached_optab(self.opset, device) if use_kernel else None
        self.rows_axis = rows_axis
        self.score_calls = 0
        self.grad_calls = 0
        self.line_search = LineSearchStats()

    def losses(self, batch: Tree, X, y, w) -> torch.Tensor:
        return self.packed_losses(*pack_batch(batch, self.opset), X, y, w)

    def packed_losses(self, prog, vals, X, y, w) -> torch.Tensor:
        """Losses of a packed batch with constants ``vals``; X may carry a
        lane axis (``fused_loss``'s)."""
        self.score_calls += 1
        if self.objective is not None:
            return over_lanes(self._objective_losses, prog, vals, X, y, w)
        if self.use_kernel:
            f = fused_loss(prog, vals, X, y, w, self.opset, self.loss_elem, self.table)
        else:
            f = over_lanes(
                lambda p, v, Xl, yl, wl: plain_losses(self._unpacked(p), v, Xl, yl, wl,
                                                      self.opset, self.loss_elem),
                prog, vals, X, y, w,
            )
        return f if self.rows_axis is None else self._combine_rows(f, y, w)

    def packed_loss_grad(self, prog, vals, X, y, w):
        """(losses, d losses / d vals) of a packed batch; X may carry a lane
        axis."""
        self.grad_calls += 1
        if self.objective is not None:
            return over_lanes(self._objective_loss_grad, prog, vals, X, y, w)
        if self.use_kernel:
            with torch.enable_grad():
                v = vals.detach().requires_grad_(True)
                f = DiffLoss.apply(v, prog, X, y, w, self.opset, self.loss_elem, self.table)
                (g,) = torch.autograd.grad(f.sum(), v)
            f = f.detach()
        else:
            f, g = over_lanes(
                lambda p, v, Xl, yl, wl: plain_losses(self._unpacked(p), v, Xl, yl, wl,
                                                      self.opset, self.loss_elem,
                                                      with_grad=True),
                prog, vals, X, y, w,
            )
        return (f, g) if self.rows_axis is None else self._combine_rows(f, y, w, g)

    def _combine_rows(self, f, y, w, g=None):
        """The global losses (and gradients) from this row block's: one
        gather of [losses, weight sum (, gradients)] over the rows axis."""
        ax = self.rows_axis
        B = f.shape[0]
        den = (w.double().sum().reshape(1) if w is not None
               else torch.full((1,), float(y.shape[-1]), dtype=torch.float64, device=f.device))
        parts = [f.double(), den]
        if g is not None:
            parts.append(g.double().reshape(-1))
        G = ax.all_gather(torch.cat(parts))
        num = gsum = tot = ok = None
        for j in range(ax.size):
            lj, dj = G[j, :B], G[j, B]
            fine = torch.isfinite(lj) | (dj == 0)
            part = torch.where(dj == 0, 0.0, lj * dj)
            num = part if num is None else num + part
            tot = dj if tot is None else tot + dj
            ok = fine if ok is None else ok & fine
            if g is not None:
                gj = torch.where(dj == 0, 0.0, G[j, B + 1:].reshape(B, -1) * dj)
                gsum = gj if gsum is None else gsum + gj
        ok = ok & (tot > 0)
        loss = torch.where(ok, (num / tot).to(f.dtype), torch.inf)
        if g is None:
            return loss
        fin = torch.isfinite(loss)[:, None]
        return loss, torch.where(fin, (gsum / tot).to(g.dtype), 0.0)

    def _objective_losses(self, prog, vals, X, y, w) -> torch.Tensor:
        if self.use_kernel:
            return objective_losses(prog, vals, X, y, w, self.opset, self.objective, self.table)
        flat = self._unpacked(prog)._replace(val=vals)
        return objective_loss_plain(flat, X, y, w, self.opset, self.objective)

    def _objective_loss_grad(self, prog, vals, X, y, w):
        with torch.enable_grad():
            v = vals.detach().requires_grad_(True)
            if self.use_kernel:
                preds = DiffPreds.apply(v, prog, X, self.opset, self.table)
            else:
                preds = eval_plan(make_plan(self._unpacked(prog), self.opset, X.device), v, X)
            f = objective_loss(preds, y, w, self.objective)
            (g,) = torch.autograd.grad(f.sum(), v)
        # DiffPreds already zeroes these; the plain sweep would carry the
        # objective's NaN adjoints of a non-finite prediction
        ok = torch.isfinite(preds.detach()).all(dim=-1, keepdim=True)
        return f.detach(), torch.where(ok, g, 0.0)

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
                        ctx: EvoContext | None = None, axis=None) -> EvoState:
    """Accept only improvements, scatter the new constants, losses and scores
    back, reset the birth of improved members (SymbolicRegression.jl
    src/ConstantOptimization.jl:70-78); fold the tuned members into the
    best-seen frontier unless batching (there ``fbest`` and ``base_loss``
    are losses on one minibatch, and finalize rescores on full data). Under
    ``record_events`` the tuning log (the reference's "tuning" events,
    src/SingleIteration.jl:140-171) goes to ``ctx``. ``axis``: the island
    axis of a mesh: every shard tuned as many members, so the evaluations
    count ``axis.size`` times, and the frontier merge is global."""
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
            lengths, comps=comp_m, axis=axis,
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
        num_evals=state.num_evals + n_evals * (1 if axis is None else axis.size),
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
    trees). The line search scores its 13 trial steps in one B1 launch and
    picks each instance's step on the device, and the convergence gate
    (``optimizer_g_tol``) freezes on the device: no host sync
    (``_bfgs_lockstep``). Under batching the whole BFGS runs on one
    fresh row draw, accepts batch against batch and counts evaluations
    fractionally. Returns ``(state, data, axis=None) -> state``: the
    one-lane case of ``make_fleet_const_opt_fn``. ``axis``: the island axis
    of a mesh (the JAX package's ``_shard_const_opt``): ``cfg`` is then the
    shard's, each shard tunes its own K members, and a rows axis combines
    every loss and gradient in ``scorer``."""
    fleet = make_fleet_const_opt_fn(options, cfg, scorer, None)
    return lambda state, data, axis=None: fleet([state], [data], [ctx], [0], axis=axis)[0]


def make_fleet_const_opt_fn(options: Options, cfg: EvoConfig, scorer: EngineScorer,
                            stacked: Callable | None) -> Callable:
    """Constant optimization for a fleet of searches: ``(states, datas,
    ctxs, lanes) -> states``. Each lane picks its members and draws its
    jitters on its own generator, as its solo run; the L·K·S instances of
    all lanes then run ONE lockstep BFGS (or simplex), each B1 or B2 launch
    on the lane axis (lane l's instances on lane l's data; a line search's
    one B1 launch on 13 x L lanes, a trial step and a lane each); each lane accepts
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
            idx = torch.randint(0, X.shape[1], (ctx.batch_rows,), generator=ctx.batch_gen,
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

    def finish(state: EvoState, data: ScoreData, ctx: EvoContext, pre: dict, x, f, f0,
               axis=None):
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
            n_ev, norm=data.norm, base_loss=base, ctx=ctx, axis=axis,
        )

    # the line search's 13 trial steps as one B1 launch on a lane axis of
    # 13 x L (step-major, then lane): each lane's instances keep their solo
    # launch shape (P / lanes = B), so their bits. A rows axis (its combine
    # would sum 13 copies' weights) and a full objective (B4 takes no lane
    # axis) score the trials in 13 calls instead.
    wide = scorer.rows_axis is None and scorer.objective is None

    def wide_trials(prog_b, X, y, w):
        """``vtrials`` of ``_bfgs_lockstep`` over the lanes' rows: their
        programs and rows repeated once per step, built once a leg."""
        if X.dim() == 2:  # one lane, unstacked
            X, y, w = X[None], y[None], None if w is None else w[None]
        Xw, yw = X.repeat(LINE_STEPS, 1, 1), y.repeat(LINE_STEPS, 1)
        ww = None if w is None else w.repeat(LINE_STEPS, 1)
        prog_w = prog_b.repeat(LINE_STEPS, 1)

        def vtrials(V):
            return scorer.packed_losses(prog_w, V.reshape(-1, V.shape[-1]), Xw, yw, ww).reshape(
                LINE_STEPS, -1)

        return vtrials

    def const_opt(states, datas, ctxs, lanes, axis=None) -> list:
        # the leg's spans tile it: prepare, then one step per BFGS
        # iteration, then finish
        tiles = ctxs[0].record.tiles()
        tiles.to("const_opt/prepare")
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

        tiles.to("const_opt/step")
        if neldermead:
            # restart 0 starts at val0: under batching its loss is the
            # member's loss on this batch
            f0 = vloss(x) if cfg.batching else None
            x, f = _neldermead(_PackedObjective(scorer, prog_b, X, y, w), x, mask_b, iters,
                               g_tol)
        else:
            x, f, f0 = _bfgs_lockstep(
                x, mask_b, vloss, vgrad, iters, g_tol, lanes=L, tiles=tiles,
                vtrials=wide_trials(prog_b, X, y, w) if wide else None,
                stats=scorer.line_search)
        tiles.to("const_opt/finish")
        out = [
            finish(st, d, ctx, pre, x[l * B:(l + 1) * B], f[l * B:(l + 1) * B],
                   None if f0 is None else f0[l * B:(l + 1) * B], axis=axis)
            for l, (st, d, ctx, pre) in enumerate(zip(states, datas, ctxs, pres))
        ]
        tiles.close()
        return out

    return const_opt


def _lane_bmm(a, b, lanes: int):
    """``torch.bmm`` on each lane's block of a lane-major batch: cuBLAS may
    choose another algorithm for another batch count, so each lane's
    products are taken at its solo run's batch count, and have its bits."""
    if lanes == 1:
        return torch.bmm(a, b)
    return torch.cat([torch.bmm(u, v) for u, v in zip(a.chunk(lanes), b.chunk(lanes))])


#: the line search's trial steps: alpha = 0.5**k for k = 0..12 (Armijo
#: backtracking with c1 = 1e-4, at most 12 halvings)
LINE_STEPS = 13


class LineSearchStats:
    """How a search's line searches went (``engine_stats["line_search"]``):
    ``searches`` run, how many scored their 13 trial steps in one loss call
    (``wide``) or in 13 calls in a row (``fallback``: a rows axis or a full
    objective), and ``hist``, on the device, the count of instances by the
    step each accepted: bins ``k* = 0..12``, then one for instances a
    frozen lane held (the g_tol gate). Nothing is read back until
    ``summary``, at the call's tail."""

    def __init__(self):
        self.searches = self.wide = 0
        self.hist = None

    def add(self, k, wide: bool) -> None:
        """One line search's accepted steps ``k`` [B] (int64, frozen = 13)."""
        if self.hist is None:
            self.hist = torch.zeros((LINE_STEPS + 1,), dtype=torch.int64, device=k.device)
        self.hist.index_add_(0, k, torch.ones_like(k))
        self.searches += 1
        self.wide += int(wide)

    @staticmethod
    def summary(stats: list) -> dict:
        """The counts of ``stats`` (one per shard) summed: one host read."""
        hist = np.zeros(LINE_STEPS + 1, np.int64)
        for st in stats:
            if st.hist is not None:
                hist += st.hist.cpu().numpy()
        searches = sum(st.searches for st in stats)
        wide = sum(st.wide for st in stats)
        return {"searches": searches, "wide": wide, "fallback": searches - wide,
                "accepted_at": hist.tolist()}


def _bfgs_lockstep(x, mask_b, vloss, vgrad, iters: int, g_tol: float, lanes: int = 1,
                   tiles=None, vtrials=None, stats: LineSearchStats | None = None):
    """BFGS over every instance of the batch in lockstep (the JAX package's
    ``_make_const_opt_fn_pallas`` loop), with no host sync: Armijo
    backtracking (c1 = 1e-4, halving, at most 12 steps) and the g_tol gate
    both decided on the device. Returns (x, f, f at the start).

    The line search scores all 13 trial points ``x + 0.5**k d`` (k = 0..12)
    at once and takes, per instance, the first k in 0..11 whose Armijo test
    holds, else 12: what halving until every instance is satisfied leaves,
    bit for bit (a halving is exact, and ``1.0 * d == d``). ``vtrials(V
    [13, B, N]) -> [13, B]`` scores them (one wide loss call); without it,
    13 calls of ``vloss`` in a row. ``stats`` (``LineSearchStats``) counts
    each search and its accepted steps, on the device.

    ``tiles``: the leg's gapless spans (``SpanRecord.tiles``; default a
    record of its own), at ``const_opt/step`` on entry: each BFGS
    iteration's enqueue is one ``const_opt/step`` (the first also holds the
    starting gradient).

    ``lanes``: the batch is that many searches' instances, lane-major (a
    fleet; one for a solo run). The g_tol gate holds lane by lane: a lane
    whose own max |g| is under ``g_tol`` freezes (its x, f, g and H stay as
    they are, which is what a ``break`` there would leave, and its line
    search counts as satisfied at once) while the others go on; every
    iteration is enqueued."""
    if tiles is None:
        tiles = SpanRecord().tiles()
    B, N = x.shape
    eye = torch.eye(N, dtype=x.dtype, device=x.device).expand(B, N, N)
    # 0.5**k, k = 0..12, exact, made on the device (an upload of a host
    # list would wait for the stream)
    steps = torch.full((LINE_STEPS,), 0.5, dtype=x.dtype, device=x.device).cumprod(0) * 2
    f, g = vgrad(x)
    f0 = f
    H = eye
    frozen = fz = None
    for it in range(iters):
        if it:
            tiles.to("const_opt/step")
        if g_tol > 0:
            conv = g.abs().reshape(lanes, -1).amax(1) < g_tol
            frozen = conv if frozen is None else frozen | conv
            fz = torch.repeat_interleave(frozen, B // lanes)
        d = -_lane_bmm(H, g[:, :, None], lanes)[:, :, 0]
        d = torch.where(mask_b, d, 0.0)
        gtd = (g * d).sum(-1)
        bad = gtd >= 0
        d = torch.where(bad[:, None], -g, d)
        gtd = torch.where(bad, -(g * g).sum(-1), gtd)
        # every trial step at once: [13, B, N] points, [13, B] losses
        trial = x + steps[:, None, None] * d
        F = torch.stack([vloss(v) for v in trial]) if vtrials is None else vtrials(trial)
        armijo = F[:-1] <= f + 1e-4 * steps[:-1, None] * gtd
        if fz is not None:
            armijo = armijo | fz
        # the first step that holds (the count of leading misses), else 12
        k = (~armijo).to(torch.int64).cumprod(0).sum(0)
        alpha = steps.gather(0, k)
        f_new = F.gather(0, k[None])[0]
        if stats is not None:
            stats.add(k if fz is None else torch.where(fz, LINE_STEPS, k), vtrials is not None)
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
# it runs by name ("evolve", "const_opt", "finalize", "readback"); it is
# process-wide, so under concurrent searches (serve workers) it sees the
# legs of all of them
_DISPATCH_HOOK = None
# test seam: when set, a callable (leg name) -> context manager entered
# around the leg (chip_smoke.py checks the evolve leg makes no host sync);
# process-wide like _DISPATCH_HOOK
_LEG_WRAP = None
# test seam: when set, a callable handed each iteration's state just after
# its legs (one EvoState per shard under a mesh); process-wide like the two
# above
_STATE_HOOK = None


def _count_dispatch(name: str):
    hook = _DISPATCH_HOOK
    if hook is not None:
        hook(name)


class _LegTimer:
    """Host seconds per leg, and device milliseconds per leg from CUDA events
    recorded around it on each of ``devices``' current streams (the longest
    card counts; summed once, at the end of the search); with a profiler,
    the leg is also its stage of the same name, fenced at its end
    (``stage=False`` for a leg whose parts are stages of their own); with
    the search's spans on (``record``), the leg is its span ``<name>``."""

    def __init__(self, devices, record: SpanRecord, prof: StageProfiler = NULL_PROFILER):
        devices = [torch.device(d) for d in (devices if isinstance(devices, (list, tuple))
                                              else [devices])]
        self.devices = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
        self.prof = prof
        self.record = record
        self.host: dict = {}
        self.events: dict = {}

    @contextlib.contextmanager
    def leg(self, name: str, stage: bool = True):
        _count_dispatch(name)
        wrap = _LEG_WRAP(name) if _LEG_WRAP is not None else contextlib.nullcontext()
        # timed inside the wrap: what the wrap itself does is not the leg's
        with wrap:
            marks = []
            for d in self.devices:
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record(torch.cuda.current_stream(d))
                marks.append((d, start, end))
            t0 = time.perf_counter()
            with self.record.span(name), (
                    self.prof.stage(name) if stage else contextlib.nullcontext()):
                yield
                if stage:
                    self.prof.fence()
            self.host[name] = self.host.get(name, 0.0) + time.perf_counter() - t0
            for d, start, end in marks:
                end.record(torch.cuda.current_stream(d))
            if marks:
                self.events.setdefault(name, []).append([(s_, e) for _, s_, e in marks])

    def device_seconds(self) -> dict:
        if not self.devices:
            return {}
        for d in self.devices:
            torch.cuda.synchronize(d)
        return {
            name: sum(max(a.elapsed_time(b) for a, b in marks) for marks in ev) * 1e-3
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
    waits for that copy's CUDA event; each materializer's call is a host
    sync, counted in ``record`` at the site "readback"."""

    def __init__(self, device: torch.device, record: SpanRecord):
        self.cuda = device.type == "cuda"
        self.record = record
        self.bufs: list = []
        self.turn = 0

    def start(self, rb: torch.Tensor) -> Callable[[], np.ndarray]:
        count = self.record.count_sync
        if not self.cuda:
            host = rb.numpy().copy()

            def fetch_host() -> np.ndarray:
                count("readback")
                return host

            return fetch_host
        if len(self.bufs) < 2:
            self.bufs.append(torch.empty(rb.shape, dtype=rb.dtype, pin_memory=True))
        host = self.bufs[self.turn % len(self.bufs)]
        self.turn += 1
        host.copy_(rb, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(rb.device))

        def fetch() -> np.ndarray:
            count("readback")
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


def _block_mode(ecfg: EvoConfig, device, use_kernel: bool, n_rows: int,
                objective: bool = False) -> str | None:
    """Which evolve leg an iteration runs: "kernel" (B3), "plain" (B3's plain
    version) or None (the event leg). The JAX package's gate
    (``device_search.py:2010-2046``): ``SR_ENGINE_BLOCK=0`` turns the block
    off; unset, it runs where the accelerator's kernel would (a CUDA device,
    kernel-eligible names); ``1`` forces it; either way only where
    ``block_eligible`` holds on at most BLOCK_MAX_ROWS rows, and never under
    a full objective (``objective``: the block reduces an elementwise loss
    in its pass). Decided from names and shapes, never by probing."""
    env = os.environ.get("SR_ENGINE_BLOCK", "")
    if (env == "0" or objective or n_rows > BLOCK_MAX_ROWS
            or not block_eligible(ecfg)[0]):
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


def _baseline_norm(dataset: Dataset, options: Options, eng_dt) -> float:
    """Set ``dataset.baseline_loss`` and ``use_baseline`` from the loss of
    the constant mean predictor (reference update_baseline_loss!,
    SymbolicRegression.jl src/LossFunctions.jl:201-215), computed from numpy
    in the engine dtype, and return the score normalization max(baseline,
    0.01) (0.01 when the baseline is not finite). The lane prelude and a live
    row swap both use it, so the same rows give the same bits."""
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
    return bl if (use_baseline and bl >= 0.01) else 0.01


def _mesh_shape(options: Options, n_rows: int, n_islands: int, n_dev: int) -> tuple:
    """(pop shards, rows shards) of the engine's mesh over ``n_dev`` local
    devices (the JAX package's decision, its ``device_search.py:1912-1960``):
    islands over 'pop' when they divide over every device; under
    ``data_sharding="rows"`` the largest rows axis dividing both the row
    count and the device count whose leftover pop axis divides the islands.
    (1, 1): no mesh. A recorder session stays on one device."""
    if n_dev <= 1 or options.use_recorder:
        return 1, 1
    if options.data_sharding == "rows":
        for r in sorted((d for d in range(1, n_dev + 1) if n_dev % d == 0), reverse=True):
            if n_rows % r == 0 and n_islands % (n_dev // r) == 0:
                return n_dev // r, r
        return 1, 1
    return (n_dev, 1) if n_islands % n_dev == 0 else (1, 1)


def engine_devices(options: Options) -> list:
    """The devices the device engine may shard one search over:
    ``Options.mesh_devices``, else ``Options.device`` alone."""
    return [torch.device(d) for d in (options.mesh_devices or (options.device,))]


def _engine_mesh(options: Options, n_rows: int, n_islands: int):
    """The engine's mesh over ``engine_devices(options)``: one shard on the
    first device where the rule gives no mesh."""
    devices = engine_devices(options)
    n_pop, n_rows_sh = _mesh_shape(options, n_rows, n_islands, len(devices))
    return mesh_mod.make_mesh(n_pop, n_rows_sh, devices=devices[:n_pop * n_rows_sh])


def _shard_seed(seed: int, *where) -> int:
    """A shard's generator seed from the engine's seed and the shard's
    coordinates (the counterpart of ``fold_in(key, axis_index)``)."""
    return int(np.random.SeedSequence([seed, *where]).generate_state(1, np.uint32)[0])


class _EngineLane:
    """One search's engine set-up, the solo search's prelude, which each
    lane of a fleet runs too: the baseline loss, the configs, the dataset
    on the device, the scorer, the initial trees (drawn from ``rng`` unless
    given), the engine's generator seeded from ``rng`` after them (the JAX
    package's order: same seed, same initial trees), the context and the
    scored initial state.

    ``fleet``: the lane's ``cfg.niterations`` is 0 when there is no warmup
    schedule (the only thing it drives), so that lanes of other budgets
    share one engine config, as the JAX package's ``_FleetLane`` does.
    ``islands``: this process's share of the islands in a multi-process
    world (default ``options.populations``); ``local_migration=False`` turns
    the in-program migration off, where the cross-process pools take its
    place.

    ``mesh``: the in-process mesh (``_engine_mesh``; default one shard on
    the first of ``engine_devices``). Each shard has its own ScoreData (the
    dataset, or its row block under a rows axis), its scorer (combining over
    the rows axis), its generator (on a pop axis seeded from the engine's
    seed and the shard's pop index; a rows axis's minibatch draws from one
    seeded with the rows index too) and its context over ``ecfg_local`` (the
    shard's islands); ``states`` is one EvoState per shard
    (``ops.evolve.shard_evo_state``). ``cfg`` and ``ecfg`` stay global: the
    host decodes the global arrays in island order. ``data``, ``scorer``
    and ``ctx`` are shard 0's.

    ``record``: the search's spans and host-sync counts (``SpanRecord``),
    which every shard's context carries; the initial scoring is its span
    ``prelude/initial_scoring``."""

    def __init__(self, dataset: Dataset, options: Options, niterations: int,
                 rng: np.random.Generator, init_trees=None, fleet: bool = False,
                 islands: int | None = None, local_migration: bool = True, mesh=None,
                 record: SpanRecord | None = None):
        if mesh is None:
            mesh = mesh_mod.make_mesh(1, 1, devices=engine_devices(options)[:1])
        self.dataset, self.options, self.mesh = dataset, options, mesh
        self.record = SpanRecord() if record is None else record
        device = self.device = mesh.devices[0, 0]
        I = options.populations if islands is None else islands
        P = options.population_size
        eng_dt = self.eng_dt = np.dtype(options.dtype)
        vdt = self.vdt = getattr(torch, eng_dt.name)

        norm_val = _baseline_norm(dataset, options, eng_dt)
        cfg = build_evo_config(
            options, n_features=dataset.n_features, baseline_loss=dataset.baseline_loss,
            use_baseline=dataset.use_baseline, niterations=niterations, n_islands=I,
            n_rows=dataset.n, dataset=dataset,
        )
        if fleet and cfg.warmup_maxsize_by == 0:
            cfg = dataclasses.replace(cfg, niterations=0)
        if not local_migration:
            cfg = dataclasses.replace(cfg, migration=False, hof_migration=False)
        n_pop, n_rows = mesh.devices.shape
        batch_rows = min(int(options.batch_size), dataset.n) if options.batching else 0
        if n_rows > 1 and options.batching:
            # each rows shard draws batch_size / rows_shards of its rows:
            # count the effective global draw exactly (the JAX package's
            # eval_fraction under a rows axis)
            batch_rows = max(1, batch_rows // n_rows)
            cfg = dataclasses.replace(
                cfg, eval_fraction=min(batch_rows * n_rows, dataset.n) / dataset.n)
        self.cfg = cfg
        # engine config: the score normalization travels as data.norm
        self.ecfg = ecfg = dataclasses.replace(cfg, baseline_loss=1.0, use_baseline=True)
        self.ecfg_local = ecfg if n_pop == 1 else dataclasses.replace(ecfg, n_islands=I // n_pop)
        self.use_kernel = engine_kernel_eligible(options, eng_dt)
        self.datas = (
            _make_score_data_rows(dataset, eng_dt, mesh, norm_val) if n_rows > 1
            else [_cached_score_data(dataset, eng_dt, d, norm_val) for d in mesh.device_list()])
        self.scorers = [
            EngineScorer(options, self.use_kernel, d,
                         rows_axis=mesh_mod.mesh_axis(mesh, "rows", k) if n_rows > 1 else None)
            for k, d in enumerate(mesh.device_list())]
        self.data, self.scorer = self.datas[0], self.scorers[0]

        # --- initial populations (host trees -> device state) ---------------
        if init_trees is None:
            init_trees = Population.random_trees(I * P, options, dataset.n_features, rng)
        seed = int(rng.integers(0, 2**31 - 1))
        self.ctxs = []
        for k, d in enumerate(mesh.device_list()):
            i, j = mesh.coords(k)
            gen = torch.Generator(device=d)
            gen.manual_seed(seed if n_pop == 1 else _shard_seed(seed, i))
            bgen = None
            if n_rows > 1:
                bgen = torch.Generator(device=d)
                bgen.manual_seed(_shard_seed(seed, i, 1 + j))
            self.ctxs.append(EvoContext(self.ecfg_local, d, gen, self.scorers[k].losses,
                                        batch_rows=batch_rows, batch_gen=bgen,
                                        record=self.record))
        self.ctx = self.ctxs[0]
        # the collectives of each leg ({leg: {axis: counts}})
        self.collectives: dict = {}
        mesh_mod.warm_up(mesh)
        self.build_state(init_trees)

    def build_state(self, trees) -> list:
        """Host trees -> the scored states on the devices (``self.states``,
        one per shard). Runs at set-up and again when an elastic joiner
        adopts a checkpoint shard (the shard's trees replace the random
        ones)."""
        ecfg, vdt = self.ecfg, self.vdt
        self.bflat = flatten_trees(trees, self.options.max_nodes, dtype=self.eng_dt)
        with self.record.span("prelude/initial_scoring"):
            losses0 = self.score_call(_flat_to_tree(self.bflat, self.device, vdt))
        state = init_state(self.bflat, losses0, ecfg, self.device)
        comp = _complexity_members(state, ecfg, self.ctx).to(vdt)
        state = state._replace(score=_score_of(state.loss, comp, self.cfg))  # real baseline
        self.states = shard_evo_state(state, self.mesh)
        return self.states

    @property
    def state(self) -> EvoState:
        """Shard 0's state: a one-shard lane's whole state."""
        return self.states[0]

    def score_call(self, batch: Tree) -> torch.Tensor:
        """Losses of a batch the host hands the engine (initial members, the
        warm start's hall of fame, the simplify pool), with the same
        structure-only dimensional penalty the legs add, on the lane's first
        device. Under a rows axis the batch is scored on every row block of
        pop shard 0 and combined (the JAX package's replicated-batch
        shard_map)."""
        if self.mesh.devices.shape[1] > 1:
            n_rows = self.mesh.devices.shape[1]

            def one(sh, scorer, data):
                b = Tree(*(t.to(sh.device) for t in batch))
                return scorer.losses(b, data.X, data.y, data.w)

            losses = shard_map(one, self.mesh, zip(self.scorers[:n_rows], self.datas[:n_rows]),
                               shards=range(n_rows))[0]
        else:
            data = self.data
            losses = self.scorer.losses(batch, data.X, data.y, data.w)
        if self.ecfg.units_check:
            losses = losses.to(self.vdt) + dim_penalty_batch(batch, self.ecfg, self.ctx)
        return losses

    # -- the legs and host steps over the shards -----------------------------

    def iterate(self, states, leg, copts, block=None) -> list:
        """One iteration, ``leg(name)`` entered around each leg on the
        calling thread. One shard runs ``run_iteration_fused`` (the block
        where ``block`` is given); a mesh runs leg by leg, every shard at
        once (the block and the fused iteration are off under a mesh, as in
        the JAX package)."""
        mesh = self.mesh
        if mesh.size == 1:
            return [run_iteration_fused(states[0], self.data, self.ctx,
                                        copt=None if copts is None else copts[0],
                                        leg=leg, block=block)]
        with self._leg(leg, "evolve"):
            states = make_sharded_iteration(mesh, self.ctxs)(states, self.datas)
        if copts is not None:
            with self._leg(leg, "const_opt"):
                states = shard_map(lambda sh, st, d, fn: fn(st, d, axis=sh.axis("pop")),
                                   mesh, zip(states, self.datas, copts))
        if self.ecfg.batching:
            with self._leg(leg, "finalize"):
                states = make_sharded_finalize(mesh, self.ctxs)(states, self.datas)
        return states

    @contextlib.contextmanager
    def _leg(self, leg, name: str):
        """``leg(name)``, and the collectives the leg made added to
        ``collectives[name]`` ({axis: counts}, ``mesh.collective_stats``)."""
        before = mesh_mod.collective_stats(self.mesh)
        with leg(name):
            yield
        after = mesh_mod.collective_stats(self.mesh)
        acc = self.collectives.setdefault(name, {})
        for ax, c in after.items():
            tot = acc.setdefault(ax, {"gathers": 0, "bytes": 0, "gather_seconds": 0.0,
                                      "wait_seconds": 0.0, "groups": c["groups"],
                                      "transport": c["transport"]})
            for k in ("gathers", "bytes", "gather_seconds", "wait_seconds"):
                tot[k] += c[k] - before.get(ax, {}).get(k, 0)

    def migrate(self, states, pool, frac: float) -> list:
        """``migrate_from_pool`` of one pool (on any device) in every shard,
        each on its islands with its generator (one shard: on the calling
        thread)."""
        return shard_map(
            lambda sh, st, ctx, d: migrate_from_pool(
                st, ctx, tuple(t.to(sh.device) for t in pool), frac, d.norm),
            self.mesh, zip(states, self.ctxs, self.datas))

    def flood(self, states, n_bad: int) -> list:
        """``nan_flood``: NaN into the losses of the leading ``n_bad``
        islands (global island order)."""
        out = []
        for k, st in enumerate(states):
            i, _ = self.mesh.coords(k)
            I_l = st.loss.shape[0]
            bad = ((torch.arange(I_l, device=st.loss.device) + i * I_l) < n_bad)[:, None]
            out.append(st._replace(loss=torch.where(bad, torch.nan, st.loss)))
        return out

    def topn_pool(self, states):
        """This process's topn migration pool, every shard's islands merged
        in island order on the first device (``intra_host_pool_merge``; one
        shard's pool as it is)."""
        merge = mesh_mod.intra_host_pool_merge(self.mesh)
        return merge([extract_topn_pool(st, self.ecfg_local) for st in states])[0]


def _hof_pool_np(decoded_rows, cfg: EvoConfig):
    """Concatenate every process's decoded best-seen frontier into one
    migration pool (the 8-tuple of ``_topn_pool``) as host numpy arrays."""
    vdt = np.dtype(cfg.val_dtype)
    kinds, ops, lhss, rhss, feats, vals, lens, losses = ([] for _ in range(8))
    for bs_loss, bs_exists, bs_len, fields, _ in decoded_rows:
        kind, op, lhs, rhs, feat, val = fields
        kinds.append(kind.astype(np.int32))
        ops.append(op.astype(np.int32))
        lhss.append(lhs.astype(np.int32))
        rhss.append(rhs.astype(np.int32))
        feats.append(feat.astype(np.int32))
        vals.append(val.astype(vdt))
        lens.append(np.where(bs_exists, bs_len, 0).astype(np.int32))
        losses.append(np.where(bs_exists, bs_loss, np.inf).astype(vdt))
    return tuple(np.concatenate(a) for a in (kinds, ops, lhss, rhss, feats, vals, lens, losses))


_STOP_CODES = {1: "early_stop", 2: "timeout", 3: "max_evals", 4: "user_quit", 5: "callback"}


def _on_first_device(fn):
    """Run ``fn(dataset, options, ...)`` with the first of the search's
    devices (``engine_devices``) as the CUDA runtime's current one: the leg
    timer's events, the pipelined readback's event and every implicit
    stream are then that card's, whichever card it is."""
    @functools.wraps(fn)
    def run(dataset, options, *args, **kwargs):
        with mesh_mod.device_scope(engine_devices(options)[0]):
            return fn(dataset, options, *args, **kwargs)

    return run


@_on_first_device
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
    its owner), or None for one of this search's own.

    In a world of more than one process (``parallel/distributed.py``) every
    process runs this function on its own slice of the islands, on
    ``Options.device`` (processes may share one card; each shards its
    slice over its own devices where the mesh decision says so). The
    in-program
    migration is off; instead, once per iteration, each process's packed
    readback and topn migration pool are exchanged through an
    ``ExchangeGroup`` (``parallel/membership.py``, the one host step of the
    iteration, its own leg "exchange") and every process injects the
    global pools. ``stop_sync`` makes the stop decision lockstep and is the
    admission point of elastic membership; a final flat gather of each
    process's best members per complexity gives every process the same hall
    of fame. Snapshots go to ``{checkpoint_base}.p{rank}``.
    ``engine_stats["exchange_bytes"]`` is the payload this process posted
    per iteration.

    On a mesh (``_engine_mesh``) ``engine_stats["mesh"]`` holds its shape,
    its devices and the collectives it made, in all and per leg."""
    from ..parallel import distributed as dist
    from ..parallel import membership
    from ..search import SearchResult  # late import (module cycle)
    from ..utils import faults
    from ..utils.checkpoint import SearchCheckpoint, SearchCheckpointer, options_fingerprint
    from ..utils.export_csv import save_hall_of_fame
    from ..utils.progress import ProgressReporter
    from ..utils.recorder import Recorder
    from ..utils.stdin_reader import StdinReader

    # the call's prelude, from here to the first iteration's legs: its wall
    # is ``setup_seconds`` whether or not the spans are on
    record = SpanRecord.for_search(options.profile)
    prelude = record.span("prelude", timed=True).begin()
    _reject_out_of_slice(options)
    cache_stats0 = PROGRAM_CACHE.stats() if options.profile else None
    # world identity: the process group's size and rank, or the elastic
    # rig's SR_ELASTIC_WORLD / SR_ELASTIC_ID (a logical world over a shared
    # coordination directory, with no process group: the only way a
    # RESTARTED process can come back)
    n_proc, proc_id = dist.world_shape()
    multi_host = n_proc > 1
    head = proc_id == 0
    if options.use_recorder and multi_host:
        raise ValueError(
            "use_recorder is single-process: lineage replay cannot see other "
            "processes' events (run the recorder session un-distributed)"
        )
    own_recorder = recorder is None
    if own_recorder:
        recorder = Recorder(options)
    I, P = options.populations, options.population_size
    if multi_host:
        # even split required: the per-iteration allgather needs identical
        # pool shapes on every process, and this check must raise on ALL
        # processes (an uneven raise would leave the others deadlocked in
        # their first collective)
        if I % n_proc != 0:
            raise ValueError(
                f"multi-host search needs populations divisible by the "
                f"process count (populations={I}, processes={n_proc})"
            )
        isl_start, isl_stop = dist.process_island_slice(I)
        I = isl_stop - isl_start
        # decorrelate this process's initial populations and engine generator
        rng = np.random.default_rng([int(rng.integers(0, 2**31 - 1)), proc_id])
    injector = faults.install(options.fault_spec) if options.fault_spec else faults.active()
    ckptr = None
    if checkpoint_base:
        # per-process snapshot files: each process owns only its island
        # slice; equation_search(resume_from=...) falls back to .p{rank}
        ckptr = SearchCheckpointer.from_options(
            options, f"{checkpoint_base}.p{proc_id}" if multi_host else checkpoint_base)

    init_trees = None
    if saved_state is not None:
        init_trees = [m.tree for pop in saved_state.populations for m in pop.members][: I * P]
        if len(init_trees) < I * P:
            init_trees.extend(Population.random_trees(
                I * P - len(init_trees), options, dataset.n_features, rng))
    # the in-process mesh over the named devices (islands over 'pop', rows
    # over 'rows'); one shard on one device where there is none
    mesh = _engine_mesh(options, dataset.n, I)
    # cross-process pools (injected once per iteration below) subsume the
    # in-program migration: the pool is then GLOBAL across all processes'
    # islands, as the reference's head-mediated migration
    with record.span("prelude/lane"):
        lane = _EngineLane(dataset, options, niterations, rng, init_trees, islands=I,
                           local_migration=not multi_host, mesh=mesh, record=record)
    device, eng_dt, vdt = lane.device, lane.eng_dt, lane.vdt
    cfg, ecfg, data, ctx = lane.cfg, lane.ecfg, lane.data, lane.ctx
    use_kernel, score_call, bflat, states = (
        lane.use_kernel, lane.score_call, lane.bflat, lane.states)
    N = options.max_nodes
    copts = None
    if options.should_optimize_constants:
        copts = [make_const_opt_fn(options, lane.ecfg_local, sc, c)
                 for sc, c in zip(lane.scorers, lane.ctxs)]
    # the evolve block stays off under a mesh, as in the JAX package
    block_mode = None if mesh.size > 1 else _block_mode(
        ecfg, device, use_kernel, dataset.n, objective=options.loss_function_jit is not None)
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
                                     loss0=states[0].loss.cpu().numpy(),
                                     score0=states[0].score.cpu().numpy())

    hof = HallOfFame(options.maxsize)
    if saved_state is not None:
        # rescore the saved hall of fame on this dataset (the reference
        # rescores on warm start, SymbolicRegression.jl
        # src/SymbolicRegression.jl:727-744)
        saved_members = [m.copy() for m in saved_state.hall_of_fame.members if m is not None]
        if saved_members:
            with record.span("prelude/initial_scoring"):
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
    if multi_host and membership.elastic_enabled(options):
        # elastic membership admits joiners at iteration boundaries; the
        # one-slot pipelined exchange would straddle an epoch bump (the
        # stashed payload was posted under the pre-join epoch's keys)
        async_rb = False
    prof = StageProfiler(device=mesh.device_list()) if options.profile else NULL_PROFILER
    early_stop = options.early_stop_fn()
    own_stdin = stdin_reader is None
    if own_stdin:
        stdin_reader = StdinReader()
    reporter = ProgressReporter(niterations, options, use_bar=bool(options.progress),
                                verbosity=verbosity)
    timer = _LegTimer(mesh.device_list(), record, prof)
    readback = _Readback(device, record)
    base_evals = float(getattr(saved_state, "num_evals", 0.0) or 0.0) if saved_state else 0.0
    num_evals = base_evals
    device_evals = 0.0
    own_dev_evals = 0.0  # this process's cumulative device evals (multi-process)
    host_evals = 0.0
    pending = None
    stop_reason = None
    iterations_run = 0
    checkpoint_seconds = []
    exchange_bytes = []
    flooded_islands = 0
    it_start = 0
    start_time = time.time()

    # --- the exchange group: every multi-process search routes its
    # exchange through one (the KV store carries it on every backend, so
    # membership.should_use_group holds in every such world); created after
    # the set-up so that a joiner never holds up the others while it builds
    grp = None
    cur_it = [0]  # the shard provider's view of the loop counter
    if multi_host:

        def shard_provider() -> bytes:
            # the leader publishes this process's state as a format-2
            # checkpoint shard when a joiner is admitted: the encoding the
            # on-disk snapshots use, verified on load
            from ..utils.checkpoint import dump_checkpoint_bytes

            ck_pops, _, _ = _decode_state_populations(unshard_evo_state(states, mesh), I, P,
                                                      cfg, options)
            return dump_checkpoint_bytes(SearchCheckpoint(
                iteration=int(cur_it[0]), niterations=niterations, scheduler="device",
                exact=False, populations=ck_pops, hall_of_fame=hof.copy(),
                num_evals=float(num_evals), options_fingerprint=options_fingerprint(options),
                wall_time=time.time() - start_time, out_j=out_j,
            ))

        grp = membership.ExchangeGroup(
            membership.coord_store(), membership.next_group_id(out_j), proc_id, n_proc,
            on_peer_loss=options.on_peer_loss, topology=options.exchange_topology,
            heartbeat_every=options.heartbeat_every_seconds, shard_provider=shard_provider,
        )
        if membership.join_pending():
            # JOINER: announce only now (the kernels are built), adopt the
            # leader's shard and re-enter at the recorded iteration boundary
            import warnings

            from ..utils.checkpoint import CheckpointError, load_checkpoint_bytes

            joined, shard = grp.join()
            it_start = int(joined.get("iteration", 0))
            cur_it[0] = it_start
            if shard is not None:
                try:
                    ck = load_checkpoint_bytes(shard)
                    strees = [m.tree for pop in ck.populations for m in pop.members][: I * P]
                    if len(strees) < I * P:
                        strees.extend(Population.random_trees(
                            I * P - len(strees), options, dataset.n_features, rng))
                    states = lane.build_state(strees)
                    for m in ck.hall_of_fame.members:
                        if m is not None:
                            hof.update(m.copy(), options)
                except CheckpointError as e:
                    warnings.warn(f"rejoin shard rejected ({e}); warm-starting from "
                                  "random populations instead")
            if verbosity > 0:
                print(f"[device] rank {proc_id} rejoined at epoch {grp.epoch} "
                      f"(iteration {it_start}/{niterations}, live={grp.live})")
    known_dead = set(dist.dead_peers())

    def note_lost_peers():
        """Degraded-mode bookkeeping (on_peer_loss="continue"): name newly
        lost processes and re-derive this process's share of the global
        island space so logs agree on the shrunken world. The islands on
        the device are untouched: survivors keep searching their slice."""
        import warnings

        lost = set(dist.dead_peers()) - known_dead
        if not lost:
            return
        known_dead.update(lost)
        live = dist.live_process_ids()
        try:
            s0, s1 = dist.process_island_slice(options.populations, live=live)
            span = f"; this process now covers island slice [{s0}, {s1})"
        except ValueError:
            span = ""
        warnings.warn(
            f"peer process(es) {sorted(lost)} lost mid-search; continuing "
            f"on {len(live)} survivor(s) with a one-iteration-stale "
            f"migration pool{span}"
        )

    def simplify_inject(members):
        nonlocal states, host_evals
        if options.should_simplify:
            with prof.stage("simplify"):
                pool, n_scored = _simplified_frontier_pool(
                    members, options, cfg, score_call, hof, device
                )
            host_evals += n_scored
            if pool is not None:
                with prof.stage("migrate"):
                    states = lane.migrate(states, pool, float(options.fraction_replaced_hof))
                    prof.fence()

    def consume(buf: np.ndarray):
        """Fold one iteration's packed readback into the hall of fame, then
        inject the simplify pool into the CURRENT device state."""
        nonlocal device_evals
        with prof.stage("decode_hof"):
            bs_loss, bs_exists, bs_len, fields, device_evals = _decode_readback(buf, cfg)
            members = _bs_to_members(bs_loss, bs_exists, bs_len, fields, cfg, options)
            for m in members:
                hof.update(m, options)
        simplify_inject(members)

    def consume_gathered(gathered):
        """Multi-process: fold every process's readback (one row per live
        process) into the hall of fame, inject the global topn pool with
        fraction_replaced and every process's best-seen frontier with
        fraction_replaced_hof (reference migrate! semantics), then the
        simplify pool. Every process does the same deterministic host work
        on the same rows."""
        nonlocal states, device_evals
        with prof.stage("decode_hof"):
            g0 = np.asarray(gathered[0])
            decoded = [_decode_readback(np.asarray(g0[pi]), cfg) for pi in range(g0.shape[0])]
            device_evals = sum(d[4] for d in decoded)
            members = []
            for d in decoded:
                members.extend(_bs_to_members(d[0], d[1], d[2], d[3], cfg, options))
            for m in members:
                hof.update(m, options)
        with prof.stage("migrate"):
            pools = []
            if options.migration:
                pools.append((tuple(torch.from_numpy(np.ascontiguousarray(
                    g.reshape((-1,) + g.shape[2:]))).to(device) for g in gathered[1:]),
                    float(options.fraction_replaced)))
            if options.hof_migration:
                pools.append((tuple(torch.from_numpy(a).to(device)
                                    for a in _hof_pool_np(decoded, cfg)),
                               float(options.fraction_replaced_hof)))
            for pool, frac in pools:
                states = lane.migrate(states, pool, frac)
            prof.fence()
        simplify_inject(members)

    setup_seconds = prelude.end()
    for it in range(it_start, niterations):
        # simulated preemption (fault-injection harness): one call per
        # iteration, before its legs
        injector.maybe_die("peer_death")
        if injector.armed("nan_flood"):
            hit = injector.fire("nan_flood")
            if hit is not None:
                # poison the leading islands' losses on the device: the NaN
                # storm selection and the pool injections must wash out
                flooded_islands = max(1, int(round(I * float(hit.get("frac", 0.75)))))
                states = lane.flood(states, flooded_islands)
        states = lane.iterate(states, timer.leg, copts, block=block_fn)
        if _STATE_HOOK is not None:
            _STATE_HOOK(states)
        with timer.leg("readback", stage=False):
            with prof.stage("readback_pack"):
                # the frontier and the counters are replicated: shard 0's
                rb = _readback_pack(states[0])
                pool_dev = ()
                if multi_host and options.migration:
                    # this process's topn pool rides the same exchange as
                    # the readback (options are equal on every process, so
                    # the exchange stays uniform); a mesh merges its shards'
                    # pools on the device first (the exchange's local stage)
                    pool_dev = lane.topn_pool(states)
                prof.fence()
            fetch = readback.start(rb)
            if multi_host:
                with prof.stage("readback_d2h"):
                    # srl: disable=SRL003 -- leg boundary readback: the exchange payload
                    payload = (fetch(), *(a.cpu().numpy() for a in pool_dev))
            elif async_rb:
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
                    replay.snapshot_populations(_state_arrays(states[0]), it + 1)
        if multi_host:
            # the iteration's one cross-process step: flat (every live row)
            # or ring ([self, pred] rows); pipelined, the previous
            # iteration's payload (one-iteration-stale pools)
            with timer.leg("exchange", stage=False), prof.stage("exchange"):
                exchange_bytes.append(sum(a.nbytes for a in payload))
                own_dev_evals = float(_decode_readback(payload[0], cfg)[4])
                gathered = grp.roll(payload) if async_rb else grp.exchange(payload)
                note_lost_peers()
                if gathered is not None:
                    consume_gathered(gathered)
        iterations_run += 1
        num_evals = base_evals + device_evals + host_evals
        if output_file and options.save_to_file and head:
            save_hall_of_fame(output_file, hof, options, dataset.variable_names,
                              num_evals=num_evals)
        if ckptr is not None and ckptr.due(it + 1):
            # best-effort snapshot (exact=False) of the live state; in the
            # pipelined loop the hall of fame and num_evals lag one iteration
            t_ck = time.perf_counter()
            with prof.stage("checkpoint"):
                ck_pops, _, _ = _decode_state_populations(unshard_evo_state(states, mesh),
                                                          I, P, cfg, options)
                ckptr.save(SearchCheckpoint(
                    iteration=it + 1, niterations=niterations, scheduler="device", exact=False,
                    populations=ck_pops, hall_of_fame=hof.copy(), num_evals=float(num_evals),
                    options_fingerprint=options_fingerprint(options),
                    wall_time=time.time() - start_time, out_j=out_j,
                ))
            checkpoint_seconds.append(time.perf_counter() - t_ck)
        if head:
            reporter.update(hof, num_evals, dataset.variable_names,
                            force=it == niterations - 1, y_variable_name=dataset.y_variable_name)

        # stop conditions (reference SymbolicRegression.jl
        # src/SearchUtils.jl:190-212); in the pipelined loop the hall of fame
        # and num_evals lag one iteration. In a world of processes the
        # decision is LOCKSTEP: any process's local trigger is gathered so
        # every process breaks on the same iteration
        stop_code = 0
        if options.iteration_callback is not None:
            from ..search import IterationReport

            if options.iteration_callback(IterationReport(
                iteration=it + 1, niterations=niterations, hall_of_fame=hof,
                num_evals=float(num_evals), elapsed=time.time() - start_time,
            )):
                stop_code = 5
        if stop_code == 0:
            if early_stop is not None and any(
                early_stop(m.loss, m.get_complexity(options)) for m in hof.pareto_frontier()
            ):
                stop_code = 1
            elif (options.timeout_in_seconds is not None
                    and time.time() - start_time > options.timeout_in_seconds):
                stop_code = 2
            elif options.max_evals is not None and num_evals >= options.max_evals:
                stop_code = 3
            elif head and stdin_reader.check_for_user_quit():
                stop_code = 4
        if multi_host:
            with timer.leg("exchange", stage=False), prof.stage("stop_sync"):
                # the iteration's ADMISSION POINT: stop codes max-reduce,
                # per-process cumulative evals sum-reduce (exact under the
                # ring, whose payload exchange sees [self, pred] rows only),
                # and any membership change lands here, in lockstep, with an
                # epoch bump
                cur_it[0] = it + 1
                stop_code, evals_sum, _ = grp.stop_sync(stop_code, own_dev_evals, it + 1)
                device_evals = evals_sum
                num_evals = base_evals + device_evals + host_evals
                note_lost_peers()
        prof.next_iteration()
        if stop_code:
            stop_reason = _STOP_CODES[int(stop_code)]
            break

    # the call's tail, from the loop's exit to the return
    tail = record.span("tail").begin()
    with record.span("tail/drain"):
        if multi_host:
            if async_rb:
                # drain the pipeline: every process reaches here on the same
                # iteration (lockstep stop), so the last gather stays uniform
                with timer.leg("exchange", stage=False):
                    gathered = grp.flush()
                    note_lost_peers()
                    if gathered is not None:
                        consume_gathered(gathered)
        elif pending is not None:
            # drain the pipeline: the last iteration's readback is in flight
            consume(pending())
    num_evals = base_evals + device_evals + host_evals
    iteration_seconds = time.time() - start_time
    if own_stdin:
        stdin_reader.close()

    # final population readback: folds the last constant optimization's
    # improvements (absent from the frontier readbacks) into the hall of fame
    with record.span("tail/decode_populations"):
        pops, final_slots, (kind, opa, lhs, rhs, feat, val, length, loss, _) = (
            _decode_state_populations(unshard_evo_state(states, mesh), I, P, cfg, options))
    fold = record.span("tail/hof").begin()
    if not multi_host:
        for pop in pops:
            hof.update_many(pop.members, options)
    else:
        # final lockstep hall-of-fame sync: the last const-opt's improvements
        # live only in the state, so folding LOCAL members in here would make
        # the processes' halls of fame diverge. Exchange a best-per-complexity
        # snapshot of the final populations (always FLAT, even under the
        # ring) and let every process merge the same global set.
        S1 = cfg.maxsize + 1
        vdt_np = np.dtype(cfg.val_dtype)
        fl = np.full((S1,), np.inf, vdt_np)
        fn_ = np.zeros((S1,), vdt_np)
        ffields = [np.zeros((S1, N), vdt_np) for _ in range(6)]
        for i, p, comp_ip in final_slots:
            s_ = min(int(comp_ip), cfg.maxsize)
            if np.isfinite(loss[i, p]) and loss[i, p] < fl[s_]:
                fl[s_] = loss[i, p]
                fn_[s_] = length[i, p]
                for arr, src in zip(ffields, (kind, opa, lhs, rhs, feat, val)):
                    arr[s_] = src[i, p]
        with timer.leg("exchange", stage=False):
            g, _, _ = grp.allgather((fl, fn_, *ffields))
            note_lost_peers()
        for pi in range(np.asarray(g[0]).shape[0]):
            bl = np.asarray(g[0][pi])
            bn = np.asarray(g[1][pi]).astype(np.int32)
            flds = [np.asarray(g[2 + j][pi]) for j in range(6)]
            for m in _bs_to_members(bl, np.isfinite(bl), bn, flds, cfg, options):
                hof.update(m, options)
    fold.end()
    if grp is not None:
        # stop the heartbeat thread and drop this rank's beat: the group is
        # per-search state, nothing survives into the next equation_search
        grp.close()
    if output_file and options.save_to_file and head:
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
        "score_calls": sum(sc.score_calls for sc in lane.scorers),
        "grad_calls": sum(sc.grad_calls for sc in lane.scorers),
        "host_seconds": dict(timer.host),
        "device_seconds": timer.device_seconds(),
        "checkpoint_seconds": checkpoint_seconds,
        "nan_flooded_islands": flooded_islands,
        "host_syncs": dict(record.syncs),
        "line_search": LineSearchStats.summary([sc.line_search for sc in lane.scorers]),
    }
    if mesh.size > 1:
        result.engine_stats["mesh"] = {
            "shape": tuple(int(v) for v in mesh.devices.shape),
            "devices": [str(d) for d in mesh.device_list()],
            "collectives": mesh_mod.collective_stats(mesh),
            "collectives_by_leg": lane.collectives,
        }
    if multi_host:
        result.engine_stats.update(
            world=n_proc, rank=proc_id, islands=(isl_start, isl_stop),
            exchange_bytes=exchange_bytes,
            epoch=grp.epoch, live=list(grp.live),
        )
    if options.profile:
        prof.set_counters("program_cache", _cache_counters(cache_stats0))
        result.engine_profile = prof.summary()
    if own_recorder:
        recorder.dump()
    tail.end()
    if record.enabled:
        result.engine_stats["spans"] = record.summary()
    return result


def _cache_counters(stats0: dict, fleet: bool = False) -> dict:
    """The engine profile's ``program_cache`` counter block (the JAX
    package's keys): this search's hits, misses and evictions since
    ``stats0``, the live entries and data bytes; a fleet's also its
    ``fleet``-kind hits and misses (the JAX package's compiled fleet
    programs: the port caches no such kind, so they stay 0). Under
    concurrent searches the deltas include the others' traffic (the cache
    is process-wide)."""
    cs = PROGRAM_CACHE.stats()
    out = {k: cs[k] - stats0[k] for k in ("hits", "misses", "evictions")}
    if fleet:
        out["fleet_hits"] = cs["fleet"]["hits"] - stats0["fleet"]["hits"]
        out["fleet_misses"] = cs["fleet"]["misses"] - stats0["fleet"]["misses"]
    out["entries"] = cs["entries"]
    out["data_bytes"] = cs["data_bytes"]
    return out


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
    the reason it must run solo (the JAX package's reasons, the two mesh
    reasons judged over ``engine_devices(options)``)."""
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
    from ..parallel.distributed import world_shape

    if world_shape()[0] > 1:
        return "multi-host (the per-iteration cross-host exchange is per-search)"
    n_dev = len(engine_devices(options))
    if n_dev > 1:
        # the solo run's mesh decision: a lane is ineligible only where the
        # solo run of these options would shard (the lane axis is one
        # device's)
        if options.data_sharding == "rows":
            return (
                "data_sharding='rows' on a multi-device host (a solo search "
                "would shard rows over the mesh; the fleet axis is "
                "single-device)"
            )
        if int(options.populations) % n_dev == 0:
            return (
                "multi-device host with populations divisible by the device "
                "count (a solo search would shard islands over the mesh; "
                "the fleet axis is single-device)"
            )
    return None


class _FleetLane(_EngineLane):
    """Per-lane host state: the solo prelude (``_EngineLane``) on the lane's
    dataset, padded to the fleet's row count where it is shorter, plus the
    loop's bookkeeping (hall of fame, evaluation counts, stop conditions)."""

    def __init__(self, idx: int, spec: FleetLaneSpec, n_bucket: int, force_weights: bool,
                 record: SpanRecord | None = None):
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
                         fleet=True, record=record)
        self.block_mode = _block_mode(self.ecfg, self.device, self.use_kernel, self.dataset.n,
                                      objective=options.loss_function_jit is not None)
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
                o.operators, o.loss, o.loss_function_jit, self.data.w is not None)

    def rebuild_score_data(self, X, y, weights) -> tuple[ScoreData, Dataset]:
        """A ScoreData for a live row swap (the stream session's update
        between iterations), on the lane's device, and the Dataset the lane's
        SearchResult then reports (the JAX package's
        ``_FleetLane.rebuild_score_data``).

        The lane prelude's host arithmetic runs exactly (the engine-dtype
        cast, the weighted baseline loss, the norm clamp: ``_baseline_norm``),
        so the lane's own rows give bit-identical tensors. The shapes and the
        presence of weights must be the lane's: the swap writes the lane's
        resident tensors in place (``LaneDataUpdate``)."""
        X, y = np.asarray(X), np.asarray(y)
        w = None if weights is None else np.asarray(weights)
        old = self.dataset
        if X.shape != old.X.shape or y.shape != old.y.shape or (w is None) != (
                old.weights is None):
            raise ValueError(
                f"row swap must keep the lane's shapes: X {old.X.shape}/y {old.y.shape}/"
                f"weights {old.weights is not None} vs swapped X {X.shape}/y {y.shape}/"
                f"weights {w is not None}"
            )
        ds = Dataset(X, y, weights=w)
        norm = _baseline_norm(ds, self.options, self.eng_dt)
        return _make_score_data(ds, self.eng_dt, self.device, norm), ds


@dataclasses.dataclass
class LaneDataUpdate:
    """One lane's data swap between iterations, returned by a
    ``fleet_search`` ``data_update_hook`` (the JAX package's
    ``LaneDataUpdate``): a ScoreData of the lane's shapes (from
    ``_FleetLane.rebuild_score_data``), the Dataset the lane's SearchResult
    reports, and whether to reset the lane's parsimony-frequency histogram to
    the ``init_state`` uniform (the drift response that forgets the sizes
    learned on the old rows)."""

    score_data: ScoreData | None = None
    dataset: Dataset | None = None
    reset_freq: bool = False


def _write_score_data(dst: ScoreData, src: ScoreData, what: str) -> None:
    """Copy ``src`` into ``dst``'s tensors in place: every holder of ``dst``
    (the legs, the scorer, the BFGS, the lane-axis stack whose views they
    are) reads the new values through the same pointers. The copy is ordered on the stream
    after the work already queued on the old values. Raises ValueError when
    the shapes, dtypes or weight presence differ."""
    if (src.w is None) != (dst.w is None) or any(
            a is not None and (a.shape != b.shape or a.dtype != b.dtype)
            for a, b in zip(dst, src)):
        raise ValueError(
            f"{what} changes the ScoreData structure; rebuild it with "
            "_FleetLane.rebuild_score_data"
        )
    for a, b in zip(dst, src):
        if a is not None:
            a.copy_(b)


class _FleetData:
    """The lanes' datasets on a leading lane axis (X [L, F, R], y and w
    [L, R], norm [L]) for the kernels' lane axis, allocated once. Each
    lane's ``data`` is rebound to views of its slice, so a lane's in-place
    swap reaches every holder, the lane-axis launches included. ``(lanes)``
    gives the active lanes' stack: a view where they are consecutive, else a
    gather."""

    def __init__(self, lanes):
        # the fleet's largest allocation: the ``oom_compile`` fault site
        # (the stack itself is never cached, since stream swaps write into it)
        oom_site("fleet_aot", (len(lanes), tuple(lanes[0].data.X.shape)))
        self.full = ScoreData(*(
            None if ts[0] is None else torch.stack(ts) for ts in zip(*(ln.data for ln in lanes))
        ))
        for l, lane in enumerate(lanes):
            lane.data = ScoreData(*(None if t is None else t[l] for t in self.full))

    def __call__(self, lanes) -> ScoreData:
        lanes = list(lanes)
        a, n = lanes[0], len(lanes)
        if lanes == list(range(a, a + n)):
            return ScoreData(*(None if t is None else t[a:a + n] for t in self.full))
        idx = torch.tensor(lanes, device=self.full.X.device)
        return ScoreData(*(None if t is None else t.index_select(0, idx) for t in self.full))


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

    The stream session's hooks (``stream/session.py``):
    ``on_lanes_ready(lanes)`` fires once, after the lanes are built, with the
    live ``_FleetLane`` objects. ``data_update_hook(it)`` runs at the top of
    each iteration, before the evolve leg, with the 0-based iteration index,
    and may return ``{lane index: LaneDataUpdate}``. A lane's update is
    written in place into its resident X, y, w and norm, which are views of
    its slice of the lane-axis stack, so every kernel reads the new rows
    through the same pointers and nothing is rebuilt; an update of other
    shapes raises ValueError."""
    from ..search import IterationReport, SearchResult  # late import (module cycle)

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
    profile = any(s.options.profile for s in specs)
    cache_stats0 = PROGRAM_CACHE.stats() if profile else None
    # the fleet's spans and host syncs: every lane waits at the same syncs
    record = SpanRecord.for_search(profile)

    ns = [np.asarray(s.y).shape[0] for s in specs]
    n_bucket = max(ns)
    # mixed row counts (or mixed weight presence) force explicit weights on
    # EVERY lane, so that the lanes' data stack
    force_weights = any(s.weights is not None for s in specs) or any(n < n_bucket for n in ns)
    lanes = [_FleetLane(i, s, n_bucket, force_weights, record) for i, s in enumerate(specs)]
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
    stacked = _FleetData(lanes)
    datas = [lane.data for lane in lanes]
    ctxs = [lane.ctx for lane in lanes]
    states = [lane.states[0] for lane in lanes]
    for lane in lanes:
        lane.states = None  # the fleet's list is the state from here on
    if on_lanes_ready is not None:
        on_lanes_ready(lanes)
    scorer = EngineScorer(options, lead.use_kernel, device)
    const_opt = (make_fleet_const_opt_fn(options, ecfg, scorer, stacked)
                 if options.should_optimize_constants else None)
    block_fn = _make_fleet_block_fn(lead.block_mode, options, ecfg, stacked)
    frac_hof = float(options.fraction_replaced_hof)
    async_rb = lead.async_rb
    prof = StageProfiler(device=device) if profile else NULL_PROFILER
    timer = _LegTimer(device, record, prof)
    readback = _Readback(device, record)
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
        if data_update_hook is not None:
            for l, upd in (data_update_hook(it) or {}).items():
                lane = lanes[l]
                if upd.score_data is not None:
                    _write_score_data(lane.data, upd.score_data, f"lane {l} data update")
                if upd.dataset is not None:
                    lane.dataset = upd.dataset
                if upd.reset_freq:
                    states[l] = states[l]._replace(freq=torch.ones_like(states[l].freq))
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

    line_search = LineSearchStats.summary([scorer.line_search])
    fleet_stats = {
        "score_calls": scorer.score_calls,
        "grad_calls": scorer.grad_calls,
        "host_seconds": dict(timer.host),
        "device_seconds": timer.device_seconds(),
    }
    summary = None
    if prof.enabled:
        prof.set_counters("program_cache", _cache_counters(cache_stats0, fleet=True))
        summary = prof.summary()
    for result in results:
        result.engine_stats["fleet"].update(fleet_stats)
        result.engine_stats["host_syncs"] = dict(record.syncs)
        result.engine_stats["line_search"] = dict(line_search)
        if record.enabled:
            result.engine_stats["spans"] = record.summary()
        if summary is not None:
            result.engine_profile = summary
    return results
