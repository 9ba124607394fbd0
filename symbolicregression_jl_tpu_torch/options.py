"""Search configuration.

Counterpart of ``symbolicregression_jl_tpu/options.py`` — same fields, same
defaults — and of the reference's Options layer
(SymbolicRegression.jl/src/Options.jl:379-453 for default values,
SymbolicRegression.jl/src/OptionsStruct.jl:123-195 for the struct,
SymbolicRegression.jl/src/MutationWeights.jl:30-43 for mutation weights). Defaults
mirror the reference so search dynamics are comparable out of the box.

``Options`` resolves operators and losses to torch callables. One field is
the port's own: ``device`` ("cuda" by default; tests pass "cpu"). Options
that select a feature outside the port's first slice raise
``NotImplementedError`` naming the ROADMAP.md item that will bring it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np

from .ops.losses import resolve_loss
from .ops.operators import OperatorSet, resolve_operators
from .ops.flat import pad_bucket

__all__ = ["MutationWeights", "Options"]


@dataclasses.dataclass
class MutationWeights:
    """Relative frequencies of the mutation kinds
    (reference defaults: SymbolicRegression.jl/src/MutationWeights.jl:30-43)."""

    mutate_constant: float = 0.048
    mutate_operator: float = 0.47
    swap_operands: float = 0.1
    add_node: float = 0.79
    insert_node: float = 5.1
    delete_node: float = 1.7
    simplify: float = 0.0020
    randomize: float = 0.00023
    do_nothing: float = 0.21
    optimize: float = 0.0
    form_connection: float = 0.5
    break_connection: float = 0.1

    NAMES = (
        "mutate_constant",
        "mutate_operator",
        "swap_operands",
        "add_node",
        "insert_node",
        "delete_node",
        "simplify",
        "randomize",
        "do_nothing",
        "optimize",
        "form_connection",
        "break_connection",
    )

    def as_vector(self) -> np.ndarray:
        return np.array([getattr(self, n) for n in self.NAMES], dtype=np.float64)

    def copy(self) -> "MutationWeights":
        return dataclasses.replace(self)

    def sample(self, rng: np.random.Generator, weights: np.ndarray | None = None) -> str:
        """Weighted draw of a mutation kind
        (reference: sample_mutation, SymbolicRegression.jl/src/MutationWeights.jl:61-64)."""
        w = self.as_vector() if weights is None else weights
        total = w.sum()
        if total <= 0:
            return "do_nothing"
        return self.NAMES[rng.choice(len(w), p=w / total)]


@dataclasses.dataclass
class Options:
    """All search hyperparameters. Field names and defaults track the
    reference's Options constructor (SymbolicRegression.jl/src/Options.jl:379-453);
    the JAX package's own knobs are grouped at the bottom, with the port's
    ``device``. Fields of features outside the port's first slice keep
    their defaults and raise when set (``_reject_out_of_slice``)."""

    # -- operators & losses --------------------------------------------------
    binary_operators: Sequence[Any] = ("+", "-", "/", "*")
    unary_operators: Sequence[Any] = ()
    elementwise_loss: Any = None  # name | callable(pred, target [,weight]); default L2
    loss_function: Callable | None = None  # full-objective override (host-side)
    # batched full objective over the prediction matrix (preds [B, R], y,
    # weights) -> losses [B]; not ported yet (raises)
    loss_function_jit: Callable | None = None

    # -- complexity / constraints -------------------------------------------
    maxsize: int = 20
    maxdepth: int | None = None
    constraints: dict | None = None  # op-name -> int | (int,int) subtree-size caps
    nested_constraints: dict | None = None  # op -> {op -> max nesting}
    complexity_of_operators: dict | None = None  # op-name -> complexity
    complexity_of_constants: float | None = None
    complexity_of_variables: float | Sequence[float] | None = None
    parsimony: float = 0.0032
    # loss penalty for dimensionally-inconsistent trees when the dataset has
    # units; None -> 1000, the reference default
    # (SymbolicRegression.jl/src/LossFunctions.jl:217-227)
    dimensional_constraint_penalty: float | None = None
    # forbid free constants from absorbing units (reference
    # options.dimensionless_constants_only,
    # SymbolicRegression.jl/src/DimensionalAnalysis.jl:204)
    dimensionless_constants_only: bool = False
    use_frequency: bool = True
    use_frequency_in_tournament: bool = True
    adaptive_parsimony_scaling: float = 20.0
    warmup_maxsize_by: float = 0.0

    # -- evolution -----------------------------------------------------------
    populations: int = 15
    population_size: int = 33
    ncycles_per_iteration: int = 550
    tournament_selection_n: int = 12
    tournament_selection_p: float = 0.86
    topn: int = 12
    crossover_probability: float = 0.066
    annealing: bool = False
    alpha: float = 0.1
    perturbation_factor: float = 0.076
    probability_negate_constant: float = 0.01
    mutation_weights: MutationWeights = dataclasses.field(default_factory=MutationWeights)
    skip_mutation_failures: bool = True
    migration: bool = True
    hof_migration: bool = True
    fraction_replaced: float = 0.00036
    fraction_replaced_hof: float = 0.035
    should_simplify: bool | None = None
    should_optimize_constants: bool = True
    # GraphNode mode: expressions may share subtrees (DAGs); enables the
    # form_connection / break_connection mutations and switches complexity to
    # unique-node counting (reference: node_type=GraphNode, experimental,
    # SymbolicRegression.jl/src/SymbolicRegression.jl:616-618)
    graph_nodes: bool = False

    # -- constant optimizer --------------------------------------------------
    optimizer_algorithm: str = "BFGS"
    optimizer_probability: float = 0.14
    optimizer_nrestarts: int = 2
    optimizer_iterations: int = 8
    optimizer_f_calls_limit: int | None = None
    # convergence gate for the batched BFGS/Newton inner loops: stop a tree's
    # optimization as soon as the masked gradient's inf-norm drops below this
    # (Optim.jl g_tol semantics, default 1e-8 like Optim's); 0 disables the
    # gate and restores the fixed-iteration scan exactly
    optimizer_g_tol: float = 1e-8

    # -- batching ------------------------------------------------------------
    batching: bool = False
    batch_size: int = 50

    # -- run control ---------------------------------------------------------
    # preflight checks before searching (reference runs them by default,
    # SymbolicRegression.jl/src/Configure.jl): True = operator totality + dataset
    # validation; "full" additionally runs a miniature end-to-end pipeline
    runtests: Any = True
    early_stop_condition: float | Callable | None = None
    timeout_in_seconds: float | None = None
    max_evals: int | None = None
    # end-of-iteration hook: called after every completed iteration with an
    # IterationReport (iteration, niterations, hall_of_fame, num_evals,
    # elapsed). A truthy return stops the search with stop_reason="callback"
    # — the serving layer (serve/) drives streaming frontier updates and
    # cooperative preemption through this. On the pipelined device loop the
    # report's hof/num_evals lag one iteration, the documented staleness of
    # every consumer there; exceptions propagate and abort the search.
    iteration_callback: Callable | None = None
    seed: int | None = None
    deterministic: bool = False
    verbosity: int | None = None
    progress: bool | None = None
    print_precision: int = 5
    save_to_file: bool = True
    output_file: str | None = None
    use_recorder: bool = False
    recorder_file: str = "sr_recorder.json"

    # -- the JAX package's own knobs ------------------------------------------
    dtype: Any = np.float32  # compute dtype; f32 scores through the kernel
    pad_multiple: int = 8  # node-slot padding bucket
    # "lockstep": host-driven islands, one scoring dispatch per cycle;
    # "device": the device-resident engine (models/device_search.py);
    # "async" is a later slice (raises)
    scheduler: str = "lockstep"
    async_workers: int | None = None  # async scheduler only
    device_mutation_attempts: int = 1  # device engine only
    # one scoring call before the timed loop builds the kernel and starts
    # the CUDA context (models/warmup.py; the reference precompiles its
    # workload, SymbolicRegression.jl/src/precompile.jl:36-93)
    jit_warmup: bool = True
    data_sharding: str | None = None  # "rows": later slice (raises)
    # multi-output fits: run the per-output searches on a host thread pool
    # (None = auto: concurrent; False = serial). Concurrent and serial runs
    # are seed-for-seed identical (per-output RNG streams either way).
    parallel_outputs: bool | None = None
    profile: bool = False  # device-engine stage profiling: later slice (raises)
    # device engine: pipelined readback (None = auto: on; False: the
    # iteration's readback is consumed before the next iteration starts)
    async_readback: bool | None = None

    # -- fault tolerance -------------------------------------------------------
    # full-state checkpoint cadence: every N iterations and/or every S
    # wall-clock seconds (either alone enables checkpointing). Snapshots are
    # written atomically as {checkpoint_file}.{seq:06d} with a rolling window
    # of checkpoint_keep files (utils/checkpoint.py). equation_search(
    # resume_from=...) restores the newest: bit-exact continuation on the
    # lockstep scheduler, rescored warm start on the device engine.
    checkpoint_every: int | None = None
    checkpoint_every_seconds: float | None = None
    checkpoint_file: str | None = None  # base path; default "sr_checkpoint.pkl"
    checkpoint_keep: int = 3
    # multi-host exchange policies: a later slice (setting on_peer_loss or
    # exchange_topology raises); heartbeat_every_seconds only serves them
    on_peer_loss: str = "raise"
    heartbeat_every_seconds: float = 5.0
    exchange_topology: str = "flat"
    # deterministic fault injection (utils/faults.py) — same grammar as the
    # SR_FAULT_SPEC env var, e.g. "nan_flood@2:frac=0.9;ckpt_crash@1"
    fault_spec: str | None = None
    # flat-IR invariant verification (analysis/ir_verify.py) of every scoring
    # batch: True/False overrides, None defers to the SR_DEBUG_CHECKS env
    # var. Off by default — resolved ONCE per search so the hot path carries
    # zero verifier calls when disabled.
    debug_checks: bool | None = None

    # -- port ------------------------------------------------------------------
    # torch device every tensor of the search lives on; the CPU only when the
    # caller asks for it
    device: str = "cuda"

    # -- derived (filled in __post_init__) -----------------------------------
    operators: OperatorSet = dataclasses.field(init=False)
    loss: Callable = dataclasses.field(init=False)
    max_nodes: int = dataclasses.field(init=False)

    def __post_init__(self):
        _reject_out_of_slice(self)
        self.operators = resolve_operators(self.binary_operators, self.unary_operators)
        self.loss = resolve_loss(self.elementwise_loss)
        if self.maxdepth is None:
            self.maxdepth = self.maxsize
        if self.loss_function is not None and self.loss_function_jit is not None:
            raise ValueError(
                "loss_function and loss_function_jit are mutually exclusive: "
                "the first is a host-side per-tree objective, the second a "
                "batched-predictions objective"
            )
        if self.should_simplify is None:
            # Reference disables auto-simplify when a full custom objective is
            # used (the objective may depend on exact tree shape); algebraic
            # rewriting would also silently break GraphNode sharing.
            # loss_function_jit sees only PREDICTIONS, which simplify
            # preserves, so it keeps auto-simplify on.
            self.should_simplify = self.loss_function is None and not self.graph_nodes
        if self.deterministic and self.seed is None:
            self.seed = 0
        if self.scheduler not in ("lockstep", "device", "async"):
            raise ValueError(
                f"unknown scheduler {self.scheduler!r}; "
                "expected 'lockstep', 'device', or 'async'"
            )
        if self.async_workers is not None and self.async_workers < 1:
            raise ValueError("async_workers must be >= 1 (or None for auto)")
        if self.iteration_callback is not None and not callable(
            self.iteration_callback
        ):
            raise ValueError("iteration_callback must be callable (or None)")
        if self.device_mutation_attempts < 1:
            raise ValueError("device_mutation_attempts must be >= 1")
        if not (self.optimizer_g_tol >= 0.0):
            raise ValueError("optimizer_g_tol must be >= 0 (0 disables the gate)")
        if self.optimizer_algorithm not in ("BFGS", "NelderMead"):
            raise ValueError(
                f"unsupported optimizer_algorithm {self.optimizer_algorithm!r}; "
                "expected 'BFGS' or 'NelderMead' (1-constant trees always use "
                "Newton, like the reference)"
            )
        if self.async_readback is True and self.use_recorder:
            raise ValueError(
                "async_readback=True is incompatible with use_recorder "
                "(lineage replay consumes per-iteration logs in lockstep); "
                "leave async_readback=None for auto"
            )
        if self.async_readback is True and self.profile:
            raise ValueError(
                "async_readback=True is incompatible with profile=True "
                "(stage fencing serializes the pipeline the async path "
                "exists to overlap); leave async_readback=None for auto"
            )
        if self.on_peer_loss not in ("raise", "continue", "rejoin"):
            raise ValueError(
                f"on_peer_loss must be 'raise', 'continue', or 'rejoin', got "
                f"{self.on_peer_loss!r}"
            )
        if not self.heartbeat_every_seconds > 0:
            raise ValueError("heartbeat_every_seconds must be > 0")
        if self.exchange_topology not in ("flat", "ring"):
            raise ValueError(
                f"exchange_topology must be 'flat' or 'ring', got "
                f"{self.exchange_topology!r}"
            )
        if self.checkpoint_every is not None and self.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1 (or None to disable)")
        if (
            self.checkpoint_every_seconds is not None
            and not self.checkpoint_every_seconds > 0
        ):
            raise ValueError(
                "checkpoint_every_seconds must be > 0 (or None to disable)"
            )
        if self.checkpoint_keep < 1:
            raise ValueError("checkpoint_keep must be >= 1")
        if self.fault_spec:
            # validate the grammar eagerly — a typo'd spec that never fires
            # would silently test nothing
            from .utils.faults import parse_fault_spec

            parse_fault_spec(self.fault_spec)
        if self.use_recorder and self.crossover_probability > 0:
            # recorder lineage is single-parent; same constraint as the
            # reference (SymbolicRegression.jl/src/RegularizedEvolution.jl:26-28)
            raise ValueError(
                "use_recorder requires crossover_probability=0 "
                "(mutation lineage recording does not track two-parent events)"
            )

        self._op_constraints = _normalize_constraints(self.constraints, self.operators)
        self._nested_constraints = _normalize_nested(
            self.nested_constraints, self.operators
        )
        self._complexity_mapping = _complexity_mapping(self)
        # +2 head-room matches the reference's hall-of-fame sizing
        # (members[1:maxsize+MAX_DEGREE], SymbolicRegression.jl/src/HallOfFame.jl:45-63).
        # Complexity != node count when custom per-node complexities < 1 exist:
        # a constraint-passing tree may then hold up to maxsize/min_complexity
        # nodes, so the device node budget is sized from that bound.
        # check_constraints additionally enforces count_nodes() <= max_nodes as
        # a hard cap (load-bearing when some complexity is <= 0, where the
        # complexity metric cannot bound node count at all).
        node_budget = self.maxsize + 2
        cm = self._complexity_mapping
        min_c = 1.0
        if cm is not None:
            min_c = min(
                float(np.min(cm["binop"])) if cm["binop"].size else np.inf,
                float(np.min(cm["unaop"])) if cm["unaop"].size else np.inf,
                float(cm["constant"]),
                float(np.min(cm["variable"])),
            )
            if 0 < min_c < 1:
                node_budget = int(np.ceil(self.maxsize / min_c)) + 2
        self.max_nodes = pad_bucket(node_budget, self.pad_multiple)
        # Node-cap traversal in check_constraints is only needed when the
        # complexity metric cannot bound node count (some complexity < 1).
        self._needs_node_cap = min_c < 1
        # Geometric tournament weights p*(1-p)^k, precomputed like the
        # reference (SymbolicRegression.jl/src/Options.jl:713-720).
        p = self.tournament_selection_p
        n = self.tournament_selection_n
        w = p * (1 - p) ** np.arange(n)
        self._tournament_weights = w / w.sum()

    # pickling --------------------------------------------------------------
    # The derived OperatorSet wraps torch callables that pickle may refuse
    # to resolve by name, so Options is only picklable if the derived state
    # is dropped and rebuilt on load.
    # This is what lets the serve-layer job journal persist a JobSpec: only
    # the declared hyperparameters travel, and __post_init__ re-derives the
    # rest on the recovering process. Custom operator/loss CALLABLES still
    # pickle by reference like any function — specs built from lambdas
    # remain undurable, which the journal degrades to gracefully.

    _DERIVED = (
        "operators",
        "loss",
        "max_nodes",
        "_op_constraints",
        "_nested_constraints",
        "_complexity_mapping",
        "_needs_node_cap",
        "_tournament_weights",
    )

    def __getstate__(self):
        state = dict(self.__dict__)
        for name in self._DERIVED:
            state.pop(name, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.__post_init__()

    # hooks used across the stack ------------------------------------------

    @property
    def op_constraints(self):
        return self._op_constraints

    @property
    def nested_constraints_resolved(self):
        return self._nested_constraints

    @property
    def complexity_mapping(self):
        return self._complexity_mapping

    @property
    def tournament_weights(self) -> np.ndarray:
        return self._tournament_weights

    def early_stop_fn(self) -> Callable | None:
        """Scalar threshold -> closure, as in the reference
        (SymbolicRegression.jl/src/Options.jl:683-689)."""
        cond = self.early_stop_condition
        if cond is None:
            return None
        if callable(cond):
            return cond
        thresh = float(cond)
        return lambda loss, complexity: loss < thresh


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md, {item})"
    )


def _reject_out_of_slice(o: Options) -> None:
    """Features outside the port's first slice raise instead of falling
    back silently."""
    if o.scheduler == "async":
        raise _not_ported("scheduler='async'", "A, slice 4: parallel/islands.py")
    if o.data_sharding is not None:
        raise _not_ported(f"data_sharding={o.data_sharding!r}", "A, slice 4: parallel/sharding.py")
    if o.on_peer_loss != "raise" or o.exchange_topology != "flat":
        raise _not_ported("multi-host exchange policies", "A, slice 4: parallel/")
    if np.dtype(o.dtype).kind == "c":
        raise _not_ported("complex dtypes", "A, slice 2: complex dtypes")
    if o.loss_function_jit is not None:
        raise _not_ported("loss_function_jit", "A, slice 2: loss_function_jit")
    if o.graph_nodes:
        raise _not_ported("graph_nodes", "A, slice 2: graph nodes")


def _normalize_constraints(constraints, opset: OperatorSet):
    """Per-operator subtree-size caps -> (bin_caps, una_caps) index arrays.
    -1 = unconstrained. Reference: build_constraints
    (SymbolicRegression.jl/src/Options.jl:39-90)."""
    bin_caps = [(-1, -1)] * opset.n_binary
    una_caps = [-1] * opset.n_unary
    if constraints:
        for name, cap in constraints.items():
            try:
                i = opset.binary_index(name)
                if isinstance(cap, int):
                    cap = (cap, cap)
                bin_caps[i] = (int(cap[0]), int(cap[1]))
                continue
            except KeyError:
                pass
            i = opset.unary_index(name)
            una_caps[i] = int(cap) if not isinstance(cap, (tuple, list)) else int(cap[0])
    return tuple(bin_caps), tuple(una_caps)


def _normalize_nested(nested, opset: OperatorSet):
    """{outer op: {inner op: max times inner may appear under outer}} ->
    [(outer_deg, outer_idx, [(inner_deg, inner_idx, max), ...])]. Matches the
    reference's compiled-tuple form (SymbolicRegression.jl/src/Options.jl:571-626)."""
    if not nested:
        return ()

    def locate(name):
        try:
            return 2, opset.binary_index(name)
        except KeyError:
            return 1, opset.unary_index(name)

    out = []
    for outer, inners in nested.items():
        odeg, oidx = locate(outer)
        compiled = tuple(
            (*locate(inner), int(maxn)) for inner, maxn in inners.items()
        )
        out.append((odeg, oidx, compiled))
    return tuple(out)


def _complexity_mapping(o: Options):
    """Per-op/variable/constant complexities (reference: ComplexityMapping,
    SymbolicRegression.jl/src/OptionsStruct.jl:21-113). None -> plain node count.

    Costs are quantized to the 2^-16 grid: every grid value is exactly
    representable in float32, so the device engine's f32 per-node cost sums
    (ops/evolve._complexity_of) and the host's f64 sums are bit-identical
    for any tree whose total cost stays under 2^8 — host and engine then
    round the SAME number, never disagreeing by the half-ulp that a raw
    fractional cost (e.g. 0.1) would leave between the two accumulators.
    Integer costs (the common case) are unchanged by the quantization."""

    def q(a):
        return np.round(np.asarray(a, np.float64) * 65536.0) / 65536.0

    custom = (
        o.complexity_of_operators is not None
        or o.complexity_of_constants is not None
        or o.complexity_of_variables is not None
    )
    if not custom:
        return None
    binop = np.ones(o.operators.n_binary)
    unaop = np.ones(o.operators.n_unary)
    if o.complexity_of_operators:
        for name, c in o.complexity_of_operators.items():
            try:
                binop[o.operators.binary_index(name)] = c
            except KeyError:
                unaop[o.operators.unary_index(name)] = c
    const_c = 1.0 if o.complexity_of_constants is None else float(o.complexity_of_constants)
    var_c = o.complexity_of_variables
    if var_c is None:
        var_c = 1.0
    return {
        "binop": q(binop),
        "unaop": q(unaop),
        "constant": float(q(const_c)),
        "variable": q(var_c),
    }
