"""Device-resident regularized evolution, in PyTorch.

Counterpart of ``symbolicregression_jl_tpu/ops/evolve.py``: populations,
tournament selection, mutation, crossover, the Metropolis accept rule,
replacement, frequency statistics, the best-seen frontier and migration
all live on the device as tensors, and the host reads back one packed
tensor per iteration (models/device_search.py). Reference semantics and
the documented deviations are the JAX package's (its module docstring);
this module changes only how they are expressed:

- the JAX package writes each step for one tree or island and ``vmap``s
  it; here every step takes the lane axis explicitly, and tree surgery is
  batched (ops/treeops.py). Where JAX's ``lax.switch`` under ``vmap``
  evaluates every mutation kind and selects, the port computes every kind
  for every lane and selects by kind in the same way;
- the PRNG key of ``EvoState`` becomes a ``torch.Generator`` on the
  engine's device, held in the ``EvoContext`` beside the state. Threefry
  cannot be reproduced in torch, so parity with the JAX package is by
  per-seed quality bands, never by trajectory; categorical draws are
  inverse-CDF lookups of one uniform draw;
- an iteration is a Python loop over cycles. Nothing in the evolve leg
  (``run_iteration``, migration included) reads a tensor back to the
  host: every draw, index and count stays on the device, so the host only
  enqueues work. Constant tables are uploaded once, when the context is
  built;
- the recorder's event log (``cfg.record_events``), which the JAX package
  returns from its compiled programs, is written into tensors preallocated
  on the device once per iteration (one row per cycle) and queued on the
  context (``EvoContext.logs``) in the order the legs make them; the
  engine loop (models/device_search.py) reads them back once per
  iteration, in its readback leg;
- the dimensional check (``cfg.units_check``) is one batched pass over the
  postorder slots of every tree of a batch (``dim_violates_batch``), where
  the JAX package ``vmap``s a per-tree ``fori_loop``;
- a fleet of searches (``run_fleet_iteration_fused``, the JAX package's
  ``vmap`` of the fused iteration over a lane axis) keeps one state and one
  generator per lane. The kernels' launches are shared across lanes (the
  block, the constant optimization); every other step is the lane's solo
  code on its own tensors. Which lanes run is host bookkeeping (a lane
  stops on the host's stop conditions), so a stopped lane is not run at
  all, where JAX computes it and selects the old state: its state and its
  generator stay as they were, and no step reads a mask back.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from .flat import KIND_BINARY, KIND_CONST, KIND_UNARY, KIND_VAR
from .treeops import (
    Tree,
    cat_trees,
    extract_block,
    random_tree,
    replace_range,
    select_tree,
    subtree_sizes,
    tree_depth,
    _randint,
)
from ..utils.profiling import SpanRecord

__all__ = [
    "EvoConfig",
    "EvoState",
    "EvoContext",
    "init_state",
    "run_iteration",
    "run_finalize",
    "run_iteration_fused",
    "run_fleet_iteration_fused",
    "extract_topn_pool",
    "migrate_from_pool",
    "fleet_migrate_from_pool",
    "merge_best_seen",
    "complexity_batch",
    "state_tree",
    "dim_violates_batch",
    "dim_penalty_batch",
    "evo_state_specs",
    "shard_evo_state",
    "unshard_evo_state",
    "make_sharded_iteration",
    "make_sharded_finalize",
]

# Mutation kind indices (subset of the reference's 12; see the JAX module).
M_CONST, M_OPERATOR, M_SWAP, M_ADD, M_INSERT, M_DELETE, M_RANDOMIZE, M_NOTHING = range(8)


@dataclasses.dataclass(frozen=True)
class EvoConfig:
    """Static engine configuration: the JAX package's ``EvoConfig`` fields,
    with the same meaning, less its ablation switches ``poisson_migration``
    and ``copt_updates_bs`` (fixed on here, as they are by default there).

    Units (reference WildcardQuantity abstract evaluation,
    SymbolicRegression.jl src/DimensionalAnalysis.jl:45-226): with
    ``units_check`` one postorder pass propagates (SI-exponent vector [7],
    wildcard, violation) per slot, and violating trees take the additive
    loss penalty ``dim_penalty`` (src/LossFunctions.jl:217-227). As in the
    JAX package the check is structure-only: the host oracle
    (dimensional_analysis.py) also latches violations on non-finite sample
    values, which the engine leaves to ordinary inf-loss scoring. Tables
    from operator names (models/device_search._units_config):
    ``una_dim_pow[i]`` is the exponent multiplier of a power-like unary op
    (sqrt 0.5, square 2, inv -1, abs/neg 1, ...) or None (input must be
    dimensionless or a wildcard); ``bin_dim_code[i]`` is 0 add/sub, 1 mult,
    2 div, 3 generic/pow.

    ``record_events`` (the recorder, SymbolicRegression.jl
    src/Mutate.jl:126-341, src/SearchUtils.jl:377-393): every leg also logs
    its events for the host replay (models/device_recorder.py). Requires
    ``crossover_probability=0`` and ``mutation_attempts=1``."""

    n_islands: int
    pop_size: int
    n_slots: int
    maxsize: int
    maxdepth: int
    nfeatures: int
    n_unary: int
    n_binary: int
    tournament_n: int
    tournament_weights: tuple
    mutation_weights: tuple  # 8 floats, M_* order
    crossover_probability: float
    annealing: bool
    alpha: float
    parsimony: float
    use_frequency: bool
    use_frequency_in_tournament: bool
    adaptive_parsimony_scaling: float
    perturbation_factor: float
    probability_negate_constant: float
    baseline_loss: float
    use_baseline: bool
    ncycles: int
    events_per_cycle: int
    fraction_replaced: float
    fraction_replaced_hof: float
    migration: bool
    hof_migration: bool
    topn: int
    niterations: int
    warmup_maxsize_by: float
    mutation_attempts: int = 1
    bin_caps: tuple = ()
    una_caps: tuple = ()
    nested_constraints: tuple = ()
    batching: bool = False
    eval_fraction: float = 1.0
    val_dtype: str = "float32"
    complexity_table: tuple | None = None
    units_check: bool = False
    x_dims: tuple = ()  # F rows of 7 SI exponents (floats)
    y_dims: tuple | None = None
    una_dim_pow: tuple = ()
    bin_dim_code: tuple = ()
    dim_penalty: float = 1000.0
    allow_wildcards: bool = True
    record_events: bool = False


class EvoState(NamedTuple):
    """All mutable search state on the device. Tree fields are [I, P, N]
    (islands x members x slots); per-member scalars are [I, P]. The JAX
    state's PRNG key is the context's generator."""

    kind: torch.Tensor
    op: torch.Tensor
    lhs: torch.Tensor
    rhs: torch.Tensor
    feat: torch.Tensor
    val: torch.Tensor
    length: torch.Tensor  # int32 [I, P]
    loss: torch.Tensor  # engine dtype [I, P]
    score: torch.Tensor  # engine dtype [I, P]
    birth: torch.Tensor  # int32 [I, P]
    freq: torch.Tensor  # float32 [S+1] complexity histogram
    bs_loss: torch.Tensor  # engine dtype [S+1] best-seen loss per complexity
    bs_tree: tuple  # Tree-field tensors [S+1, N] (+ length [S+1]) of best-seen
    bs_exists: torch.Tensor  # bool [S+1]
    step: torch.Tensor  # int32 0-d event counter (birth clock)
    num_evals: torch.Tensor  # float64 0-d
    iteration: torch.Tensor  # int32 0-d; drives the warmup-maxsize schedule


class EvoContext:
    """What every engine step needs beside the state: the static config,
    the device, the random generator, the scoring function
    ``score_rows(batch: Tree, X, y, w) -> losses [B]`` and the minibatch
    size, and the config's constant tables, uploaded once here (so the
    evolve leg makes no host-to-device copy). On a mesh each shard has its
    own context: its device, its generator, its scorer. Under
    ``cfg.record_events``,
    ``logs`` collects the legs' event logs as ``(kind, tensors)`` entries,
    kind one of "iteration", "migration" and "tuning", in the order the
    legs make them, until the engine loop takes them (``take_logs``).
    ``record``: the search's spans and host-sync counts
    (``utils.profiling.SpanRecord``; every shard of a search, and every lane
    of a fleet, shares its search's)."""

    def __init__(self, cfg: EvoConfig, device, gen: torch.Generator, score_rows: Callable,
                 batch_rows: int = 0, batch_gen: torch.Generator | None = None,
                 record: SpanRecord | None = None):
        self.cfg = cfg
        self.record = SpanRecord() if record is None else record
        self.device = torch.device(device)
        self.gen = gen
        # the minibatch row draws' generator: ``gen`` itself, except on a
        # rows axis, where each row shard draws its own local rows (the JAX
        # package folds the rows index into the draw's key)
        self.batch_gen = gen if batch_gen is None else batch_gen
        self.score_rows = score_rows
        self.batch_rows = batch_rows
        self.vdt = getattr(torch, cfg.val_dtype)
        dev = self.device
        tw = torch.tensor(cfg.tournament_weights, dtype=torch.float64)
        self.tour_cdf = torch.cumsum(tw, 0).to(torch.float32).to(dev)
        self.mut_w = torch.tensor(cfg.mutation_weights, dtype=torch.float32, device=dev)
        self.table = None
        if cfg.complexity_table is not None:
            bin_c, una_c, const_c, var_c = cfg.complexity_table
            self.table = (
                torch.tensor(bin_c or (1.0,), dtype=torch.float32, device=dev),
                torch.tensor(una_c or (1.0,), dtype=torch.float32, device=dev),
                float(const_c),
                torch.tensor(var_c or (1.0,), dtype=torch.float32, device=dev),
            )
        self.una_caps = (
            torch.tensor(cfg.una_caps, dtype=torch.int32, device=dev) if cfg.una_caps else None
        )
        self.bin_caps = (
            torch.tensor(np.asarray(cfg.bin_caps, np.int32).reshape(-1, 2), device=dev)
            if cfg.bin_caps else None
        )
        self.dim_tables = _dim_tables(cfg, dev) if cfg.units_check else None
        self.logs: list = []

    def log(self, kind: str, entry) -> None:
        """Queue one leg's event log (tensors on the device); a no-op unless
        the config records events."""
        if self.cfg.record_events:
            self.logs.append((kind, entry))

    def take_logs(self) -> list:
        logs, self.logs = self.logs, []
        return logs

    def rand(self, *shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)

    def score(self, batch: Tree, data, minibatch: bool = False) -> torch.Tensor:
        """Losses [B] of a tree batch on all rows of ``data`` (X, y, w, norm),
        or on a fresh with-replacement draw of ``batch_rows`` rows
        (SymbolicRegression.jl src/LossFunctions.jl:114-127)."""
        X, y, w = data.X, data.y, data.w
        if minibatch:
            idx = torch.randint(0, X.shape[1], (self.batch_rows,), generator=self.batch_gen,
                                device=self.device)
            X, y = X[:, idx].contiguous(), y[idx].contiguous()
            w = None if w is None else w[idx].contiguous()
        return self.score_rows(batch, X, y, w)


def _score_of(loss, complexity, cfg: EvoConfig, norm=None):
    """loss_to_score (SymbolicRegression.jl src/LossFunctions.jl:138-158).
    ``norm``: the dataset's normalization tensor inside engine steps; host
    decode callers omit it and use the cfg constants."""
    if norm is None:
        norm = (
            cfg.baseline_loss
            if (cfg.use_baseline and cfg.baseline_loss >= 0.01)
            else 0.01
        )
    return loss / norm + complexity * cfg.parsimony


def state_tree(state: EvoState) -> Tree:
    """The whole population as one [I*P, N] tree batch."""
    I, P, N = state.kind.shape
    return Tree(
        state.kind.reshape(I * P, N), state.op.reshape(I * P, N),
        state.lhs.reshape(I * P, N), state.rhs.reshape(I * P, N),
        state.feat.reshape(I * P, N), state.val.reshape(I * P, N),
        state.length.reshape(I * P),
    )


def init_state(flat_arrays, losses, cfg: EvoConfig, device, freq_init=None) -> EvoState:
    """Device state from host-flattened populations ([I*P, N] fields) and
    their losses ([I*P], already scored)."""
    I, P, N, S = cfg.n_islands, cfg.pop_size, cfg.n_slots, cfg.maxsize
    vdt = getattr(torch, cfg.val_dtype)
    device = torch.device(device)

    def r(a, dtype):
        t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
        t = t.to(device=device, dtype=dtype)
        return t.reshape((I, P) + tuple(t.shape[1:]))

    kind, op, lhs, rhs, feat = (
        r(getattr(flat_arrays, f), torch.int32) for f in ("kind", "op", "lhs", "rhs", "feat")
    )
    val = r(flat_arrays.val, vdt)
    length = r(flat_arrays.length, torch.int32)
    loss = r(losses, vdt)
    comp = complexity_batch(
        Tree(kind.reshape(I * P, N), op.reshape(I * P, N), lhs.reshape(I * P, N),
             rhs.reshape(I * P, N), feat.reshape(I * P, N), val.reshape(I * P, N),
             length.reshape(I * P)),
        cfg,
    ).reshape(I, P).to(vdt)
    freq = (
        torch.as_tensor(np.asarray(freq_init), dtype=torch.float32).to(device)
        if freq_init is not None
        else torch.ones((S + 1,), dtype=torch.float32, device=device)
    )
    zi = lambda: torch.zeros((S + 1, N), dtype=torch.int32, device=device)  # noqa: E731
    return EvoState(
        kind, op, lhs, rhs, feat, val, length, loss,
        _score_of(loss, comp, cfg),
        birth=torch.arange(P, dtype=torch.int32, device=device)[None].repeat(I, 1),
        freq=freq,
        bs_loss=torch.full((S + 1,), torch.inf, dtype=vdt, device=device),
        bs_tree=(zi(), zi(), zi(), zi(), zi(),
                 torch.zeros((S + 1, N), dtype=vdt, device=device),
                 torch.zeros((S + 1,), dtype=torch.int32, device=device)),
        bs_exists=torch.zeros((S + 1,), dtype=torch.bool, device=device),
        step=torch.tensor(P, dtype=torch.int32, device=device),
        num_evals=torch.zeros((), dtype=torch.float64, device=device),
        iteration=torch.zeros((), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Complexity and constraints
# ---------------------------------------------------------------------------


def complexity_batch(batch: Tree, cfg: EvoConfig, ctx: EvoContext | None = None) -> torch.Tensor:
    """[B] mapped complexities (reference compute_complexity,
    SymbolicRegression.jl src/Complexity.jl:17-50: the rounded sum of
    per-node costs); the node count when no mapping is configured. Costs
    sit on the 2^-16 grid (options._complexity_mapping), so the f32 sum is
    exact in any order."""
    if cfg.complexity_table is None:
        return batch.length
    if ctx is not None and ctx.table is not None:
        bc, uc, const_c, vc = ctx.table
    else:
        dev = batch.kind.device
        bin_c, una_c, const_c, var_c = cfg.complexity_table
        bc = torch.tensor(bin_c or (1.0,), dtype=torch.float32, device=dev)
        uc = torch.tensor(una_c or (1.0,), dtype=torch.float32, device=dev)
        vc = torch.tensor(var_c or (1.0,), dtype=torch.float32, device=dev)
    N = batch.kind.shape[1]
    live = torch.arange(N, device=batch.kind.device)[None, :] < batch.length[:, None]

    def at(tab, idx):
        return tab[torch.clamp(idx, 0, tab.shape[0] - 1).long()]

    cost = torch.where(
        batch.kind == KIND_CONST, float(const_c),
        torch.where(
            batch.kind == KIND_VAR, at(vc, batch.feat),
            torch.where(batch.kind == KIND_UNARY, at(uc, batch.op), at(bc, batch.op)),
        ),
    )
    total = torch.where(live, cost, 0.0).sum(1, dtype=torch.float32)
    return torch.round(total).to(torch.int32)


def _complexity_members(state: EvoState, cfg: EvoConfig, ctx=None) -> torch.Tensor:
    """[I, P] mapped complexities of the population."""
    if cfg.complexity_table is None:
        return state.length
    I, P = state.length.shape
    return complexity_batch(state_tree(state), cfg, ctx).reshape(I, P)


def _has_op_constraints(cfg: EvoConfig) -> bool:
    return any(c != (-1, -1) for c in cfg.bin_caps) or any(c != -1 for c in cfg.una_caps)


def _nest_depth(t: Tree, deg: int, op_idx: int) -> torch.Tensor:
    """nd[l, i] = max count of (deg, op_idx) nodes along any root-to-leaf
    path of the subtree at slot i (count_max_nestedness,
    SymbolicRegression.jl src/CheckConstraints.jl:40-52). A slot loop: used
    only when nested constraints are configured."""
    L, N = t.kind.shape
    want = KIND_UNARY if deg == 1 else KIND_BINARY
    is_target = ((t.kind == want) & (t.op == op_idx)).to(torch.int32)
    is_op = t.kind >= KIND_UNARY
    is_bin = t.kind == KIND_BINARY
    nd = torch.zeros((L, N), dtype=torch.int32, device=t.kind.device)
    for i in range(N):
        left = torch.gather(nd, 1, t.lhs[:, i:i + 1].long())[:, 0]
        right = torch.gather(nd, 1, t.rhs[:, i:i + 1].long())[:, 0]
        child = torch.maximum(
            torch.where(is_op[:, i], left, 0), torch.where(is_bin[:, i], right, 0)
        )
        nd[:, i] = child + is_target[:, i]
    return nd


def _constraints_ok(t: Tree, cfg: EvoConfig, ctx: EvoContext | None = None) -> torch.Tensor:
    """Per-operator subtree-size caps and illegal nesting, per lane [L]
    (constraints.check_constraints; SymbolicRegression.jl
    src/CheckConstraints.jl:9-70). All True when none are configured."""
    L, N = t.kind.shape
    dev = t.kind.device
    ok = torch.ones((L,), dtype=torch.bool, device=dev)
    live = torch.arange(N, device=dev)[None, :] < t.length[:, None]
    if _has_op_constraints(cfg):
        sizes = subtree_sizes(t)
        l_size = torch.gather(sizes, 1, t.lhs.long())
        r_size = torch.gather(sizes, 1, t.rhs.long())
        if cfg.una_caps:
            cap_u = (ctx.una_caps if ctx is not None else
                     torch.tensor(cfg.una_caps, dtype=torch.int32, device=dev))
            c = cap_u[torch.clamp(t.op, 0, len(cfg.una_caps) - 1).long()]
            viol = live & (t.kind == KIND_UNARY) & (c >= 0) & (l_size > c)
            ok &= ~viol.any(1)
        if cfg.bin_caps:
            caps = (ctx.bin_caps if ctx is not None else torch.tensor(
                np.asarray(cfg.bin_caps, np.int32).reshape(-1, 2), device=dev))
            opc = torch.clamp(t.op, 0, len(cfg.bin_caps) - 1).long()
            cl, cr = caps[:, 0][opc], caps[:, 1][opc]
            viol = (live & (t.kind == KIND_BINARY)) & (
                ((cl >= 0) & (l_size > cl)) | ((cr >= 0) & (r_size > cr))
            )
            ok &= ~viol.any(1)
    if cfg.nested_constraints:
        cache: dict = {}
        for odeg, oidx, inners in cfg.nested_constraints:
            o_kind = KIND_UNARY if odeg == 1 else KIND_BINARY
            is_outer = live & (t.kind == o_kind) & (t.op == oidx)
            for ideg, iidx, maxn in inners:
                nd = cache.get((ideg, iidx))
                if nd is None:
                    nd = cache[(ideg, iidx)] = _nest_depth(t, ideg, iidx)
                child_nest = torch.maximum(
                    torch.gather(nd, 1, t.lhs.long()),
                    torch.where(t.kind == KIND_BINARY, torch.gather(nd, 1, t.rhs.long()), 0),
                )
                ok &= ~(is_outer & (child_nest > maxn)).any(1)
    return ok


# ---------------------------------------------------------------------------
# Dimensional analysis (units)
# ---------------------------------------------------------------------------

_DIM_TOL = 1e-4  # SI-exponent equality tolerance (1/3 etc. live in f32)


def _dim_tables(cfg: EvoConfig, device):
    """(x_dims [F, 7], unary power [nu], unary is-power [nu], binary code
    [nb], y_dims [7] or None) on ``device``."""
    f32 = torch.float32
    xd = torch.tensor(cfg.x_dims if cfg.x_dims else ((0.0,) * 7,), dtype=f32, device=device)
    u_pow = torch.tensor([p if p is not None else 0.0 for p in cfg.una_dim_pow] or [0.0],
                         dtype=f32, device=device)
    u_is_pow = torch.tensor([p is not None for p in cfg.una_dim_pow] or [False],
                            dtype=torch.bool, device=device)
    b_code = torch.tensor(list(cfg.bin_dim_code) or [3], dtype=torch.int32, device=device)
    yd = None if cfg.y_dims is None else torch.tensor(cfg.y_dims, dtype=f32, device=device)
    return xd, u_pow, u_is_pow, b_code, yd


def dim_violates_batch(t: Tree, cfg: EvoConfig, ctx: EvoContext | None = None) -> torch.Tensor:
    """[B] True where a tree is dimensionally inconsistent with
    ``cfg.x_dims`` / ``cfg.y_dims`` (the JAX package's ``_dim_violates``,
    one tree per lane of its ``vmap``; reference
    violates_dimensional_constraints, SymbolicRegression.jl
    src/DimensionalAnalysis.jl:45-226). One pass over the N slots in
    postorder carries every tree's (dims [B, N, 7], wildcard, violation);
    all False when units are not configured."""
    B, N = t.kind.shape
    dev = t.kind.device
    if not cfg.units_check:
        return torch.zeros((B,), dtype=torch.bool, device=dev)
    xd, u_pow, u_is_pow, b_code, yd = (
        (ctx.dim_tables if ctx is not None else None) or _dim_tables(cfg, dev))
    F, nu, nb = xd.shape[0], u_pow.shape[0], b_code.shape[0]
    rows = torch.arange(B, device=dev)

    def dimless(d):  # [B, 7] -> [B]
        return (torch.abs(d) < _DIM_TOL).all(-1)

    # what does not depend on the children, for every slot at once
    is_un, is_bin = t.kind == KIND_UNARY, t.kind == KIND_BINARY
    li, ri = t.lhs.long(), t.rhs.long()
    # leaves: constants are wildcards (unless forbidden), variables carry
    # their feature's dims and are never wildcards
    leaf_dims = torch.where((t.kind == KIND_VAR)[..., None],
                            xd[torch.clamp(t.feat, 0, F - 1).long()], 0.0)
    leaf_wc = (t.kind == KIND_CONST) if cfg.allow_wildcards else torch.zeros_like(is_un)
    ou = torch.clamp(t.op, 0, nu - 1).long()
    up, u_ispow = u_pow[ou], u_is_pow[ou]
    code = b_code[torch.clamp(t.op, 0, nb - 1).long()]
    c_as, c_mul, c_arith, c_gen = code == 0, code == 1, code <= 2, code > 2  # add/sub, mult, + - * /, other

    dims = torch.zeros((B, N, 7), dtype=torch.float32, device=dev)
    wc = torch.zeros((B, N), dtype=torch.bool, device=dev)
    vio = torch.zeros((B, N), dtype=torch.bool, device=dev)
    for i in range(N):
        ld, lw, lv = dims[rows, li[:, i]], wc[rows, li[:, i]], vio[rows, li[:, i]]
        rd, rw, rv = dims[rows, ri[:, i]], wc[rows, ri[:, i]], vio[rows, ri[:, i]]
        ld_free, rd_free = dimless(ld) | lw, dimless(rd) | rw

        ispow = u_ispow[:, i]
        u_dims = torch.where(ispow[:, None], ld * up[:, i, None], 0.0)
        u_wc = ispow & lw
        u_vio = lv | (~ispow & ~ld_free)

        same = (torch.abs(ld - rd) < _DIM_TOL).all(-1)
        both_wc = lw & rw
        as_dims = torch.where(
            same[:, None], ld,
            torch.where(both_wc[:, None], 0.0, torch.where(lw[:, None], rd, ld)),
        )
        as_vio = ~same & ~lw & ~rw
        mul_dims = torch.where(c_mul[:, i, None], ld + rd, ld - rd)
        b_dims = torch.where(c_as[:, i, None], as_dims,
                             torch.where(c_arith[:, i, None], mul_dims, 0.0))
        b_wc = torch.where(c_as[:, i], both_wc, c_arith[:, i] & (lw | rw))
        b_vio = lv | rv | torch.where(c_as[:, i], as_vio, c_gen[:, i] & ~(ld_free & rd_free))

        un, bn = is_un[:, i], is_bin[:, i]
        dims[:, i] = torch.where(un[:, None], u_dims,
                                 torch.where(bn[:, None], b_dims, leaf_dims[:, i]))
        wc[:, i] = torch.where(un, u_wc, torch.where(bn, b_wc, leaf_wc[:, i]))
        vio[:, i] = (un & u_vio) | (bn & b_vio)
    root = torch.clamp(t.length - 1, 0, N - 1).long()
    out = vio[rows, root]
    if yd is not None:
        out = out | (~wc[rows, root] & ~(torch.abs(dims[rows, root] - yd) < _DIM_TOL).all(-1))
    return out


def dim_penalty_batch(t: Tree, cfg: EvoConfig, ctx: EvoContext | None = None) -> torch.Tensor:
    """Additive dimensional-regularization penalties [B] in the engine's
    value dtype, added after the loss (never inside a kernel): ``dim_penalty``
    where ``dim_violates_batch`` holds, else 0."""
    return dim_violates_batch(t, cfg, ctx).to(getattr(torch, cfg.val_dtype)) * cfg.dim_penalty


# ---------------------------------------------------------------------------
# Tournament selection and mutations (lane axis first)
# ---------------------------------------------------------------------------


def _choice(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF categorical draw from a cumulative weight table: cdf [K]
    (shared) or [L, K] (per lane), unnormalized; u uniform [L] -> index
    [L]. An entry of zero weight is never drawn."""
    if cdf.dim() == 1:
        idx = torch.searchsorted(cdf, u * cdf[-1], right=True)
    else:
        idx = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)[:, 0]
    return torch.clamp(idx, max=cdf.shape[-1] - 1)


def _tournament(ctx: EvoContext, score, comp, freq) -> torch.Tensor:
    """Winner index in [0, P) per lane; score/comp are [L, P].
    Reference best_of_sample, SymbolicRegression.jl src/Population.jl:110-160."""
    cfg = ctx.cfg
    L, P = score.shape
    n = cfg.tournament_n
    order = torch.argsort(ctx.rand(L, P), dim=1, stable=True)
    cand = order[:, :n]
    s = torch.gather(score, 1, cand)
    if cfg.use_frequency_in_tournament:
        fnorm = freq / torch.clamp_min(freq.sum(), 1e-30)
        sizes = torch.clamp(torch.gather(comp, 1, cand), 0, cfg.maxsize).long()
        s = s * torch.exp(cfg.adaptive_parsimony_scaling * fnorm[sizes]).to(s.dtype)
    rank = _choice(ctx.tour_cdf, ctx.rand(L))
    by_score = torch.argsort(s, dim=1, stable=True)
    return torch.gather(cand, 1, torch.gather(by_score, 1, rank[:, None]))[:, 0]


def _pick_slot(ctx: EvoContext, mask: torch.Tensor):
    """(slot, count): a uniformly drawn slot where ``mask`` [L, N] holds,
    per lane (slot 0 when none does)."""
    n = mask.sum(1, dtype=torch.int32)
    ranks = torch.cumsum(mask.to(torch.int32), 1) - 1
    pick = _randint(ctx.gen, n, (mask.shape[0],), ctx.device)
    hits = mask & (ranks == pick[:, None])
    return torch.argmax(hits.to(torch.int32), dim=1).to(torch.int32), n


def _at(arr: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.gather(arr, 1, p.long()[:, None])[:, 0]


def _set_at(arr: torch.Tensor, p: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    j = torch.arange(arr.shape[1], device=arr.device)[None, :]
    return torch.where(j == p[:, None], value[:, None], arr)


def _mutate_constant(ctx: EvoContext, t: Tree, temperature: float) -> Tree:
    """Multiply or divide one random constant by maxChange^U(0,1), maybe
    negate (SymbolicRegression.jl src/MutationFunctions.jl:60-89)."""
    cfg = ctx.cfg
    L = t.kind.shape[0]
    is_c = t.kind == KIND_CONST
    slot, n_c = _pick_slot(ctx, is_c)
    max_change = cfg.perturbation_factor * temperature + 1.0 + 0.1
    factor = max_change ** ctx.rand(L)
    factor = torch.where(ctx.rand(L) < 0.5, factor, 1.0 / factor)
    neg = ctx.rand(L) < cfg.probability_negate_constant
    j = torch.arange(t.n_slots, device=ctx.device)[None, :]
    hits = is_c & (j == slot[:, None])
    mult = torch.where(hits, (factor * torch.where(neg, -1.0, 1.0))[:, None], 1.0)
    newval = t.val * mult.to(t.val.dtype)
    return t._replace(val=torch.where((n_c > 0)[:, None], newval, t.val))


def _mutate_operator(ctx: EvoContext, t: Tree) -> Tree:
    """Swap one operator for a random same-arity operator
    (SymbolicRegression.jl src/MutationFunctions.jl:44-57)."""
    cfg = ctx.cfg
    L = t.kind.shape[0]
    slot, n_op = _pick_slot(ctx, t.kind >= KIND_UNARY)
    new_un = _randint(ctx.gen, cfg.n_unary, (L,), ctx.device)
    new_bin = _randint(ctx.gen, cfg.n_binary, (L,), ctx.device)
    j = torch.arange(t.n_slots, device=ctx.device)[None, :]
    hits = (j == slot[:, None]) & (n_op > 0)[:, None]
    new_op = torch.where(t.kind == KIND_UNARY, new_un[:, None], new_bin[:, None])
    return t._replace(op=torch.where(hits, new_op, t.op))


def _swap_operands(ctx: EvoContext, t: Tree, sizes) -> Tree:
    """Swap the child subtrees of one random binary node
    (SymbolicRegression.jl src/MutationFunctions.jl:34-41)."""
    N = t.n_slots
    p, n_b = _pick_slot(ctx, t.kind == KIND_BINARY)
    r_root, l_root = _at(t.rhs, p), _at(t.lhs, p)
    lenB, lenA = _at(sizes, r_root), _at(sizes, l_root)
    al = l_root - lenA + 1  # A = [al, al+lenA), B = [al+lenA, p)
    j = torch.arange(N, device=ctx.device, dtype=torch.int32)[None, :]
    al2, lenA2, lenB2, p2 = al[:, None], lenA[:, None], lenB[:, None], p[:, None]
    src = torch.clamp(torch.where(j < al2 + lenB2, j + lenA2, j - lenB2), 0, N - 1)
    use_move = (j >= al2) & (j < p2)
    g = [torch.gather(f, 1, src.long()) for f in (t.kind, t.op, t.lhs, t.rhs, t.feat, t.val)]

    def mv(gf, orig):
        return torch.where(use_move, gf, orig)

    def mv_ptr(c, orig):
        cin_a = (c >= al2) & (c < al2 + lenA2)
        c2 = torch.where(cin_a, c + lenB2,
                         torch.where((c >= al2 + lenA2) & (c < p2), c - lenA2, c))
        return torch.where(use_move, c2, orig)

    kind = mv(g[0], t.kind)
    lhs = torch.where(kind >= KIND_UNARY, mv_ptr(g[2], t.lhs), 0)
    rhs = torch.where(kind == KIND_BINARY, mv_ptr(g[3], t.rhs), 0)
    new = Tree(
        kind, mv(g[1], t.op),
        _set_at(lhs, p, al + lenB - 1).to(torch.int32),
        _set_at(rhs, p, p - 1).to(torch.int32),
        mv(g[4], t.feat), mv(g[5], t.val), t.length,
    )
    return select_tree(n_b > 0, new, t)


def _leaf_material(ctx: EvoContext, L: int):
    """One random leaf per lane (50/50 constant/feature): (kind, feat, val)
    [L]. Canonical: a constant carries feat 0, a feature val 0."""
    cfg = ctx.cfg
    is_const = ctx.rand(L) < 0.5
    if cfg.nfeatures <= 0:
        is_const = torch.ones_like(is_const)
    feat = _randint(ctx.gen, cfg.nfeatures, (L,), ctx.device)
    val = torch.randn((L,), generator=ctx.gen, device=ctx.device, dtype=ctx.vdt)
    kind = torch.where(is_const, KIND_CONST, KIND_VAR).to(torch.int32)
    return kind, torch.where(is_const, 0, feat), torch.where(is_const, val, torch.zeros_like(val))


def _use_binary(ctx: EvoContext, L: int) -> torch.Tensor:
    cfg = ctx.cfg
    use_bin = ctx.rand(L) < (cfg.n_binary / max(cfg.n_binary + cfg.n_unary, 1))
    if cfg.n_unary == 0:
        use_bin = torch.ones_like(use_bin)
    if cfg.n_binary == 0:
        use_bin = torch.zeros_like(use_bin)
    return use_bin


def _add_node(ctx: EvoContext, t: Tree) -> Tree:
    """append_random_op: replace a random leaf with a random depth-1
    operator subtree (SymbolicRegression.jl src/MutationFunctions.jl:92-121)."""
    cfg = ctx.cfg
    L, N = t.kind.shape
    p, n_l = _pick_slot(ctx, (t.kind == KIND_CONST) | (t.kind == KIND_VAR))
    use_bin = _use_binary(ctx, L)
    k1, f1, v1 = _leaf_material(ctx, L)
    k2, f2, v2 = _leaf_material(ctx, L)
    opb = _randint(ctx.gen, cfg.n_binary, (L,), ctx.device)
    opu = _randint(ctx.gen, cfg.n_unary, (L,), ctx.device)
    j = torch.arange(N, device=ctx.device)[None, :]
    ub = use_bin[:, None]
    z = torch.zeros((L, N), dtype=torch.int32, device=ctx.device)
    kind = torch.where(j == 0, k1[:, None], z)
    kind = torch.where(j == 1, torch.where(ub, k2[:, None], KIND_UNARY), kind)
    kind = torch.where((j == 2) & ub, KIND_BINARY, kind)
    op = torch.where((j == 1) & ~ub, opu[:, None], z)
    op = torch.where((j == 2) & ub, opb[:, None], op)
    rhs = torch.where((j == 2) & ub, 1, z)
    feat = torch.where(j == 0, f1[:, None], z)
    feat = torch.where((j == 1) & ub, f2[:, None], feat)
    val = torch.zeros((L, N), dtype=t.val.dtype, device=ctx.device)
    val = torch.where(j == 0, v1[:, None], val)
    val = torch.where((j == 1) & ub, v2[:, None], val)
    mat = Tree(kind.to(torch.int32), op.to(torch.int32), z, rhs.to(torch.int32),
               feat.to(torch.int32), val, torch.where(use_bin, 3, 2).to(torch.int32))
    out = replace_range(t, p, p + 1, mat)
    return select_tree(n_l > 0, out, t)


def _insert_node(ctx: EvoContext, t: Tree, sizes) -> Tree:
    """insert_random_op: wrap a random subtree in a new operator node
    (SymbolicRegression.jl src/MutationFunctions.jl:124-143)."""
    cfg = ctx.cfg
    L, N = t.kind.shape
    p = _randint(ctx.gen, t.length, (L,), ctx.device)
    a = p - _at(sizes, p) + 1
    blk = extract_block(t, a, p + 1)
    blen = blk.length[:, None]
    use_bin = _use_binary(ctx, L)
    lk, lf, lv = _leaf_material(ctx, L)
    opb = _randint(ctx.gen, cfg.n_binary, (L,), ctx.device)
    opu = _randint(ctx.gen, cfg.n_unary, (L,), ctx.device)
    j = torch.arange(N, device=ctx.device)[None, :]
    ub = use_bin[:, None]
    leaf_pos = blen
    op_pos = torch.where(ub, blen + 1, blen)
    at_leaf = (j == leaf_pos) & ub
    at_op = j == op_pos
    kind = torch.where(at_leaf, lk[:, None], blk.kind)
    kind = torch.where(at_op, torch.where(ub, KIND_BINARY, KIND_UNARY), kind)
    op = torch.where(at_op, torch.where(ub, opb[:, None], opu[:, None]), blk.op)
    lhs = torch.where(at_op, blen - 1, blk.lhs)
    rhs = torch.where(at_op, torch.where(ub, leaf_pos, 0), blk.rhs)
    feat = torch.where(at_leaf, lf[:, None], blk.feat)
    val = torch.where(at_leaf, lv[:, None], blk.val)
    mat = Tree(kind.to(torch.int32), op.to(torch.int32), lhs.to(torch.int32),
               rhs.to(torch.int32), feat.to(torch.int32), val,
               (op_pos[:, 0] + 1).to(torch.int32))
    return replace_range(t, a, p + 1, mat)


def _delete_node(ctx: EvoContext, t: Tree, sizes) -> Tree:
    """delete_random_op: splice a random operator node out, promoting one
    of its children (SymbolicRegression.jl src/MutationFunctions.jl:191-234)."""
    L = t.kind.shape[0]
    p, n_op = _pick_slot(ctx, t.kind >= KIND_UNARY)
    keep_right = (_at(t.kind, p) == KIND_BINARY) & (ctx.rand(L) < 0.5)
    child = torch.where(keep_right, _at(t.rhs, p), _at(t.lhs, p))
    ca = child - _at(sizes, child) + 1
    blk = extract_block(t, ca, child + 1)
    out = replace_range(t, p - _at(sizes, p) + 1, p + 1, blk)
    return select_tree(n_op > 0, out, t)


def _randomize(ctx: EvoContext, t: Tree, curmaxsize) -> Tree:
    """A fresh random tree of size ~ U[1, curmaxsize] (the reference's
    randomize branch, SymbolicRegression.jl src/Mutate.jl)."""
    cfg = ctx.cfg
    L = t.kind.shape[0]
    m = 1 + _randint(ctx.gen, curmaxsize.expand(L) if torch.is_tensor(curmaxsize)
                     else int(curmaxsize), (L,), ctx.device)
    return random_tree(ctx.gen, m, t.n_slots, cfg.nfeatures, cfg.n_unary,
                       cfg.n_binary, dtype=t.val.dtype)


def _crossover(ctx: EvoContext, t1: Tree, t2: Tree, s1, s2):
    """Swap random subtrees between two trees per lane
    (SymbolicRegression.jl src/MutationFunctions.jl:271-303)."""
    L = t1.kind.shape[0]
    p1 = _randint(ctx.gen, t1.length, (L,), ctx.device)
    p2 = _randint(ctx.gen, t2.length, (L,), ctx.device)
    a1 = p1 - _at(s1, p1) + 1
    a2 = p2 - _at(s2, p2) + 1
    b1 = extract_block(t1, a1, p1 + 1)
    b2 = extract_block(t2, a2, p2 + 1)
    return replace_range(t1, a1, p1 + 1, b2), replace_range(t2, a2, p2 + 1, b1)


def _condition_weights(ctx: EvoContext, t: Tree, curmaxsize) -> torch.Tensor:
    """Zero out illegal mutations per lane (SymbolicRegression.jl
    src/Mutate.jl:34-76). Returns [L, 8] f32."""
    cfg = ctx.cfg
    L = t.kind.shape[0]
    w = ctx.mut_w.expand(L, 8)
    n_const = (t.kind == KIND_CONST).sum(1)
    n_ops = (t.kind >= KIND_UNARY).sum(1)
    n_bin = (t.kind == KIND_BINARY).sum(1)
    at_max = complexity_batch(t, cfg, ctx) >= curmaxsize
    no_ops = n_ops == 0
    zero = torch.zeros((), dtype=torch.float32, device=ctx.device)
    col = [w[:, k] for k in range(8)]
    col[M_OPERATOR] = torch.where(no_ops, zero, col[M_OPERATOR])
    col[M_SWAP] = torch.where(n_bin == 0, zero, col[M_SWAP])
    col[M_DELETE] = torch.where(no_ops, zero, col[M_DELETE])
    col[M_CONST] = torch.where(
        n_const == 0, zero,
        col[M_CONST] * torch.clamp_max(n_const.to(torch.float32), 8.0) / 8.0,
    )
    col[M_ADD] = torch.where(at_max, zero, col[M_ADD])
    col[M_INSERT] = torch.where(at_max, zero, col[M_INSERT])
    return torch.stack(col, 1)


def _apply_mutation(ctx: EvoContext, t: Tree, kinds, curmaxsize, temperature, sizes) -> Tree:
    """Every mutation kind for every lane, then a per-lane select by
    ``kinds`` [L] (the batched form of the JAX package's lax.switch)."""
    branches = [
        _mutate_constant(ctx, t, temperature),
        _mutate_operator(ctx, t),
        _swap_operands(ctx, t, sizes),
        _add_node(ctx, t),
        _insert_node(ctx, t, sizes),
        _delete_node(ctx, t, sizes),
        _randomize(ctx, t, curmaxsize),
        t,
    ]
    out = t
    for k, br in enumerate(branches):
        out = select_tree(kinds == k, br, out)
    return out


def _choose_kinds(ctx: EvoContext, t: Tree, curmaxsize) -> torch.Tensor:
    w = _condition_weights(ctx, t, curmaxsize)
    # all-zero guard: degenerate contexts fall back to do_nothing
    w = w + torch.where(
        (w.sum(1) <= 0)[:, None] & (torch.arange(8, device=ctx.device) == M_NOTHING)[None, :],
        1.0, 0.0,
    )
    return _choice(torch.cumsum(w, 1), ctx.rand(t.kind.shape[0]))


def merge_best_seen(state: EvoState, cfg: EvoConfig, losses, valid, fields, lengths,
                    comps=None, axis=None) -> EvoState:
    """Fold a batch of scored trees into the best-seen frontier (the per-size
    mini hall of fame, SymbolicRegression.jl src/SingleIteration.jl:64-100):
    per size the first lowest valid loss, taken where it beats the stored
    one. ``fields``: 6 tensors [B, N].

    ``axis``: the island axis of a mesh (``parallel.mesh.Axis``): the
    shards' candidates merge to the global lowest loss per size, the lowest
    shard index winning ties (the JAX package's ``pmin`` of the loss and of
    the owner shard, then the owner's tree broadcast by a masked ``psum``),
    in one gather of the losses, lengths and six fields, so the frontier
    stays equal on every shard."""
    return _merge_best_seen(state, cfg, losses, valid, fields, lengths, comps, axis)[0]


def _merge_best_seen(state: EvoState, cfg: EvoConfig, losses, valid, fields, lengths,
                     comps=None, axis=None, extra=None):
    """``merge_best_seen``; under ``axis`` the f64 columns ``extra`` [S+1, k]
    ride the same gather and come back summed over the shards in shard
    order (the event's frequency delta and scored count). Returns (state,
    summed extra or None)."""
    S1 = cfg.maxsize + 1
    sizes = torch.clamp(lengths if comps is None else comps, 0, cfg.maxsize)
    size_mask = sizes[None, :] == torch.arange(S1, device=sizes.device, dtype=sizes.dtype)[:, None]
    cand_loss = torch.where(size_mask & valid[None, :], losses[None, :], torch.inf)
    best_loss_s = torch.amin(cand_loss, dim=1)
    best_idx = torch.argmin(cand_loss, dim=1)  # the first minimum, as jnp.argmin
    cand_fields = [f[best_idx] for f in fields]
    cand_len = lengths[best_idx]
    summed = None
    if axis is not None:
        # every column is exact in f64 (int32 fields, f32 or f64 values)
        cols = [best_loss_s.double()[:, None], cand_len.double()[:, None]]
        cols += [f.double() for f in cand_fields]
        if extra is not None:
            cols.append(extra.double())
        g = axis.all_gather(torch.cat(cols, 1))  # [shards, S1, 2 + 6N (+k)]
        N = cand_fields[0].shape[1]
        g_loss = torch.amin(g[:, :, 0], dim=0)
        win = (g[:, :, 0] <= g_loss[None, :]) & torch.isfinite(g_loss)[None, :]
        owner = torch.argmax(win.to(torch.int8), dim=0)  # the first winning shard
        row = g[owner, torch.arange(S1, device=g.device)]  # [S1, cols]
        best_loss_s = g_loss.to(losses.dtype)
        cand_len = row[:, 1].to(lengths.dtype)
        cand_fields = [row[:, 2 + q * N: 2 + (q + 1) * N].to(f.dtype)
                       for q, f in enumerate(cand_fields)]
        if extra is not None:
            summed = g[0, :, 2 + 6 * N:]
            for k in range(1, g.shape[0]):
                summed = summed + g[k, :, 2 + 6 * N:]
    better = best_loss_s < state.bs_loss
    bs_loss = torch.where(better, best_loss_s.to(state.bs_loss.dtype), state.bs_loss)
    bt_new = [torch.where(better[:, None], f.to(cur.dtype), cur)
              for cur, f in zip(state.bs_tree[:6], cand_fields)]
    bs_len = torch.where(better, cand_len.to(torch.int32), state.bs_tree[6])
    return state._replace(
        bs_loss=bs_loss, bs_tree=(*bt_new, bs_len), bs_exists=state.bs_exists | better
    ), summed


def _put(cur: torch.Tensor, isl, idx, new, mask):
    """cur[isl, idx] = new where mask (lanes [L]), out of place."""
    m = mask.view((-1,) + (1,) * (new.dim() - 1))
    return torch.index_put(cur, (isl, idx), torch.where(m, new, cur[isl, idx]))


# ---------------------------------------------------------------------------
# One evolve pass for every island; iteration, finalize, migration
# ---------------------------------------------------------------------------


def _event(state: EvoState, data, ctx: EvoContext, temperature: float, curmaxsize,
           log: dict | None = None, cycle: int = 0, axis=None) -> EvoState:
    """One evolve pass: all of a cycle's events for all islands in one
    batched step (the JAX package's ``_event``): tournament -> mutate or
    crossover -> score -> Metropolis accept -> replace. Lane e of island i
    replaces the (2e)-th oldest member and its crossover child the
    (2e+1)-th, so the scatter never collides. ``log``: the iteration's
    event-log buffers (``_event_log``), whose row ``cycle`` this pass
    fills. ``axis``: the island axis of a mesh; the frequency delta and the
    scored count are summed over the shards and the frontier merged, in the
    one gather of the merge (the JAX package's ``psum``s and merge)."""
    cfg = ctx.cfg
    I, P, N = state.kind.shape
    E = min(cfg.events_per_cycle, P)
    L = I * E
    can_pair = 2 * E <= P
    dev = ctx.device

    comp_members = _complexity_members(state, cfg, ctx)
    score_r = state.score.unsqueeze(1).expand(I, E, P).reshape(L, P)
    comp_r = comp_members.unsqueeze(1).expand(I, E, P).reshape(L, P)
    win1 = _tournament(ctx, score_r, comp_r, state.freq)
    win2 = _tournament(ctx, score_r, comp_r, state.freq)
    isl = torch.arange(L, device=dev) // E  # island of each lane
    w1, w2 = win1.long(), win2.long()

    def member(idx):
        return Tree(*(f[isl, idx] for f in (state.kind, state.op, state.lhs, state.rhs,
                                             state.feat, state.val)), state.length[isl, idx])

    parent1, parent2 = member(w1), member(w2)
    pscore1, ploss1 = state.score[isl, w1], state.loss[isl, w1]
    pscore2, ploss2 = state.score[isl, w2], state.loss[isl, w2]

    if cfg.crossover_probability > 0 and can_pair:
        do_xover = ctx.rand(L) < cfg.crossover_probability
    else:
        do_xover = torch.zeros((L,), dtype=torch.bool, device=dev)

    sizes1 = subtree_sizes(parent1)
    sizes2 = subtree_sizes(parent2)

    def valid(c: Tree) -> torch.Tensor:
        ok = ((complexity_batch(c, cfg, ctx) <= curmaxsize) & (c.length <= N)
              & (tree_depth(c) <= cfg.maxdepth))
        if _has_op_constraints(cfg) or cfg.nested_constraints:
            ok &= _constraints_ok(c, cfg, ctx)
        return ok

    if cfg.mutation_attempts <= 1:
        kinds = _choose_kinds(ctx, parent1, curmaxsize)
        mutated = _apply_mutation(ctx, parent1, kinds, curmaxsize, temperature, sizes1)
    else:
        # bounded retries: re-draw kind + mutation for lanes whose earlier
        # attempts produced an invalid candidate (SymbolicRegression.jl
        # src/Mutate.jl:247-266)
        mutated = parent1
        mut_ok = torch.zeros((L,), dtype=torch.bool, device=dev)
        for _ in range(cfg.mutation_attempts):
            kinds = _choose_kinds(ctx, parent1, curmaxsize)
            cand = _apply_mutation(ctx, parent1, kinds, curmaxsize, temperature, sizes1)
            take = valid(cand) & ~mut_ok
            mutated = select_tree(take, cand, mutated)
            mut_ok = mut_ok | take

    xo1, xo2 = _crossover(ctx, parent1, parent2, sizes1, sizes2)
    cand1 = select_tree(do_xover, xo1, mutated)
    # cand2 matters only where do_xover; elsewhere a 1-node leaf keeps the
    # kernel's length-bounded slot loop at leaf cost
    zi = torch.zeros((L, N), dtype=torch.int32, device=dev)
    leaf_stub = Tree(torch.where(torch.arange(N, device=dev)[None, :] == 0, KIND_CONST, zi)
                     .to(torch.int32), zi, zi, zi, zi,
                     torch.zeros((L, N), dtype=state.val.dtype, device=dev),
                     torch.ones((L,), dtype=torch.int32, device=dev))
    cand2 = select_tree(do_xover, xo2, leaf_stub)

    ok1 = valid(cand1)
    ok2 = valid(cand2)
    cand1 = select_tree(ok1, cand1, parent1)
    cand2 = select_tree(ok2, cand2, parent2)

    batch = cat_trees(cand1, cand2)
    losses = ctx.score(batch, data, minibatch=cfg.batching).to(state.loss.dtype)
    if cfg.units_check:
        # violating candidates carry the additive penalty into accept,
        # replacement and the frontier merge, like the reference's eval_loss
        losses = losses + dim_penalty_batch(batch, cfg, ctx)
    loss1, loss2 = losses[:L], losses[L:]
    comp1 = complexity_batch(cand1, cfg, ctx)
    comp2 = complexity_batch(cand2, cfg, ctx)
    score1 = _score_of(loss1, comp1.to(loss1.dtype), cfg, data.norm)
    score2 = _score_of(loss2, comp2.to(loss2.dtype), cfg, data.norm)

    # Metropolis accept (mutation path only; crossover children are accepted
    # whenever valid and finite, SymbolicRegression.jl src/Mutate.jl:361-429)
    fnorm = state.freq / torch.clamp_min(state.freq.sum(), 1e-30)
    sz_old = torch.clamp(comp_members[isl, w1], 0, cfg.maxsize).long()
    sz_new = torch.clamp(comp1, 0, cfg.maxsize).long()
    prob = torch.ones((L,), dtype=torch.float32, device=dev)
    if cfg.annealing:
        delta = (score1 - pscore1).to(torch.float32)
        # temperature is exactly 0 on the final cycle: IEEE inf/0 semantics
        # match the reference (NaN/0-division -> accept)
        prob = prob * torch.exp(-delta / (cfg.alpha * temperature))
    if cfg.use_frequency:
        old_f = torch.clamp_min(fnorm[sz_old], 1e-6)
        new_f = torch.clamp_min(fnorm[sz_new], 1e-6)
        prob = prob * (old_f / new_f)
    u = ctx.rand(L)
    accept1 = ~(prob < u) & torch.isfinite(loss1) & ok1
    accept1 = torch.where(do_xover, torch.isfinite(loss1) & ok1, accept1)
    accept2 = do_xover & torch.isfinite(loss2) & ok2

    baby1 = select_tree(accept1, cand1, parent1)
    baby2 = select_tree(accept2, cand2, parent2)
    bloss1 = torch.where(accept1, loss1, ploss1)
    bscore1 = torch.where(accept1, score1, pscore1)
    bloss2 = torch.where(accept2, loss2, ploss2)
    bscore2 = torch.where(accept2, score2, pscore2)

    # replacement: oldest first; argsort must be stable (JAX's sort is)
    order = torch.argsort(state.birth, dim=1, stable=True)
    stride = 2 if can_pair else 1
    lane_e = torch.arange(L, device=dev) % E
    slot1 = order[isl, torch.clamp(stride * lane_e, 0, P - 1)]
    slot2 = order[isl, torch.clamp(stride * lane_e + 1, 0, P - 1)]

    def insert(st: EvoState, idx, tb: Tree, loss_b, score_b, mask) -> EvoState:
        return st._replace(
            kind=_put(st.kind, isl, idx, tb.kind, mask),
            op=_put(st.op, isl, idx, tb.op, mask),
            lhs=_put(st.lhs, isl, idx, tb.lhs, mask),
            rhs=_put(st.rhs, isl, idx, tb.rhs, mask),
            feat=_put(st.feat, isl, idx, tb.feat, mask),
            val=_put(st.val, isl, idx, tb.val, mask),
            length=_put(st.length, isl, idx, tb.length, mask),
            loss=_put(st.loss, isl, idx, loss_b, mask),
            score=_put(st.score, isl, idx, score_b, mask),
            birth=_put(st.birth, isl, idx, st.step.expand(L), mask),
        )

    st = insert(state, slot1, baby1, bloss1, bscore1, torch.ones((L,), dtype=torch.bool,
                                                                  device=dev))
    st = insert(st, slot2, baby2, bloss2, bscore2, do_xover)

    # frequency histogram of accepted inserts (whole numbers: exact in any
    # order)
    comp_b1 = torch.where(accept1, comp1, comp_members[isl, w1])
    comp_b2 = torch.where(accept2, comp2, comp_members[isl, w2])
    fd = torch.zeros_like(st.freq)
    fd.index_add_(0, torch.clamp(comp_b1, 0, cfg.maxsize).long(), accept1.to(fd.dtype))
    fd.index_add_(0, torch.clamp(comp_b2, 0, cfg.maxsize).long(), accept2.to(fd.dtype))

    all_valid = torch.cat([torch.isfinite(loss1) & ok1, torch.isfinite(loss2) & ok2 & do_xover])
    n_scored = (L + do_xover.sum()).to(torch.float64) * cfg.eval_fraction
    extra = None
    if axis is not None:
        # column 0 the frequency delta, column 1 the scored count (row 0)
        extra = torch.zeros((cfg.maxsize + 1, 2), dtype=torch.float64, device=dev)
        extra[:, 0] = fd
        extra[0, 1] = n_scored
    st, summed = _merge_best_seen(
        st, cfg, losses.to(st.bs_loss.dtype), all_valid,
        [batch.kind, batch.op, batch.lhs, batch.rhs, batch.feat, batch.val],
        batch.length, comps=torch.cat([comp1, comp2]), axis=axis, extra=extra,
    )
    if summed is not None:
        fd = summed[:, 0].to(fd.dtype)
        n_scored = summed[0, 1]
    if log is not None:
        # index writes into the preallocated row: no host sync. Recorder
        # runs are mutation-only and single-attempt, so ``kinds`` is the
        # kind of the candidate scored.
        for key, v in (("kind", kinds), ("win1", win1), ("slot1", slot1), ("accept", accept1),
                       ("loss", loss1), ("score", score1), ("ploss", ploss1),
                       ("pscore", pscore1)):
            log[key][cycle] = v
        for buf, f in zip(log["cand"], cand1):
            buf[cycle] = f
    return st._replace(freq=st.freq + fd, step=st.step + 1, num_evals=st.num_evals + n_scored)


def _event_log(cfg: EvoConfig, device) -> dict:
    """The iteration's event-log buffers on the device, [C, L, ...] (the
    JAX package's per-cycle log of ``_run_iteration_impl``)."""
    vdt = getattr(torch, cfg.val_dtype)
    C, N = cfg.ncycles, cfg.n_slots
    L = cfg.n_islands * min(cfg.events_per_cycle, cfg.pop_size)

    def z(shape, dt):
        return torch.zeros((C,) + shape, dtype=dt, device=device)

    i32 = torch.int32
    return {
        "kind": z((L,), i32), "win1": z((L,), i32), "slot1": z((L,), i32),
        "accept": z((L,), torch.bool), "loss": z((L,), vdt), "score": z((L,), vdt),
        "ploss": z((L,), vdt), "pscore": z((L,), vdt),
        "cand": (z((L, N), i32), z((L, N), i32), z((L, N), i32), z((L, N), i32),
                 z((L, N), i32), z((L, N), vdt), z((L,), i32)),
    }


def _curmaxsize(state: EvoState, cfg: EvoConfig):
    """The warmup-maxsize schedule (get_cur_maxsize, SymbolicRegression.jl
    src/SearchUtils.jl:458-470), from the device-held iteration counter."""
    if cfg.warmup_maxsize_by > 0:
        frac_done = state.iteration.to(torch.float32) / max(cfg.niterations, 1)
        in_warmup = frac_done / cfg.warmup_maxsize_by
        return torch.clamp_max(3 + (in_warmup * (cfg.maxsize - 3)).to(torch.int32), cfg.maxsize)
    return cfg.maxsize


def run_iteration(state: EvoState, data, ctx: EvoContext, axis=None) -> EvoState:
    """Advance every island through one iteration (the reference's
    _dispatch_s_r_cycle, SymbolicRegression.jl src/SymbolicRegression.jl:1088-1129):
    ncycles evolve passes at annealed temperature, the frequency-window
    decay, then migration (moved to finalize under batching). ``axis``: the
    island axis of a mesh (``_event``); migration stays within the shard's
    islands, as in the JAX package's sharded iteration."""
    cfg = ctx.cfg
    curmaxsize = _curmaxsize(state, cfg)
    log = _event_log(cfg, ctx.device) if cfg.record_events else None
    for cycle in range(cfg.ncycles):
        # linspace(1, 0, ncycles): the final cycle runs at exactly T=0
        temp = 1.0 - cycle / max(cfg.ncycles - 1, 1) if cfg.annealing else 1.0
        state = _event(state, data, ctx, temp, curmaxsize, log=log, cycle=cycle, axis=axis)
    ctx.log("iteration", {"events": log})
    state = state._replace(iteration=state.iteration + 1)
    # frequency-window decay (proportional variant of move_window!,
    # SymbolicRegression.jl src/AdaptiveParsimony.jl:57-89; window 100k)
    total_f = state.freq.sum()
    window = 100_000.0
    state = state._replace(
        freq=torch.where(total_f > window, state.freq * (window / total_f), state.freq)
    )
    if not cfg.batching:
        if cfg.migration:
            state = _migrate(state, ctx, use_hof=False, norm=data.norm)
        if cfg.hof_migration:
            state = _migrate(state, ctx, use_hof=True, norm=data.norm)
    return state


def run_finalize(state: EvoState, data, ctx: EvoContext, axis=None) -> EvoState:
    """Full-data finalize under cfg.batching, after the batch constant
    optimization (SymbolicRegression.jl src/SingleIteration.jl:107-132):
    exact member losses, the best-seen frontier rescored and re-merged,
    then migration on the exact scores. ``axis``: the island axis of a
    mesh: the members' evaluations count on every shard (each shard holds
    the same number of islands), the replicated frontier is rescored on
    every shard and counted once, and the merge is global."""
    cfg = ctx.cfg
    I, P, N = state.kind.shape
    members = state_tree(state)
    full_loss = ctx.score(members, data).to(state.loss.dtype)
    if cfg.units_check:
        full_loss = full_loss + dim_penalty_batch(members, cfg, ctx)
    full_loss = full_loss.reshape(I, P)
    comp_m = _complexity_members(state, cfg, ctx)
    state = state._replace(
        loss=full_loss,
        score=_score_of(full_loss, comp_m.to(full_loss.dtype), cfg, data.norm),
        num_evals=state.num_evals + float(I * P * (1 if axis is None else axis.size)),
    )
    bs_len = state.bs_tree[6]
    bs_batch = Tree(*state.bs_tree[:6], bs_len)
    bs_full = ctx.score(bs_batch, data).to(state.bs_loss.dtype)
    if cfg.units_check:
        bs_full = bs_full + dim_penalty_batch(bs_batch, cfg, ctx)
    bs_valid = state.bs_exists & torch.isfinite(bs_full) & (bs_len >= 1)
    state = state._replace(
        bs_loss=torch.where(bs_valid, bs_full, torch.inf),
        bs_exists=bs_valid,
        num_evals=state.num_evals + float(bs_len.shape[0]),
    )
    flat_loss = full_loss.reshape(I * P)
    state = merge_best_seen(
        state, cfg, flat_loss, torch.isfinite(flat_loss) & (members.length >= 1),
        [members.kind, members.op, members.lhs, members.rhs, members.feat, members.val],
        members.length, comps=comp_m.reshape(I * P), axis=axis,
    )
    if cfg.migration:
        state = _migrate(state, ctx, use_hof=False, norm=data.norm)
    if cfg.hof_migration:
        state = _migrate(state, ctx, use_hof=True, norm=data.norm)
    return state


def run_iteration_fused(state: EvoState, data, ctx: EvoContext, copt=None,
                        leg=None, block=None) -> EvoState:
    """One engine iteration: evolve -> constant optimization -> (batching)
    full-data finalize, chained as one Python function (the JAX package
    compiles the same chain into one program). ``copt``: ``(state, data)
    -> state`` or None. ``leg(name)``: a context manager entered around
    each leg (the engine's dispatch count and timers). ``block``: the evolve
    block's ``(state, data) -> state`` (ops/evolve_block.py), which replaces
    the event leg inside the "evolve" leg, or None."""
    leg = leg or (lambda name: contextlib.nullcontext())
    with leg("evolve"):
        state = run_iteration(state, data, ctx) if block is None else block(state, data)
    if copt is not None:
        with leg("const_opt"):
            state = copt(state, data)
    if ctx.cfg.batching:
        with leg("finalize"):
            state = run_finalize(state, data, ctx)
    return state


def run_fleet_iteration_fused(states, datas, ctxs, active, copt=None, leg=None,
                              block=None) -> list:
    """One iteration of a fleet of searches (the JAX package's
    ``_run_fleet_iteration_fused_impl``): every active lane advances as its
    solo ``run_iteration_fused`` would, and an inactive lane keeps its state
    and its generator untouched. ``states``, ``datas``, ``ctxs``: one per
    lane; ``active``: host bools. ``copt`` and ``block``, when given, take
    the active lanes' (states, datas, ctxs, lane indices) and return their
    new states, sharing each kernel launch across the lanes; without
    ``block`` the event leg runs lane after lane. ``leg``: as in
    ``run_iteration_fused``, entered once per leg for the whole fleet."""
    leg = leg or (lambda name: contextlib.nullcontext())
    states = list(states)
    on = [l for l, a in enumerate(active) if a]
    if not on:
        return states

    def run(fn):
        new = fn([states[l] for l in on], [datas[l] for l in on], [ctxs[l] for l in on], on)
        for l, st in zip(on, new):
            states[l] = st

    with leg("evolve"):
        if block is None:
            for l in on:
                states[l] = run_iteration(states[l], datas[l], ctxs[l])
        else:
            run(block)
    if copt is not None:
        with leg("const_opt"):
            run(copt)
    if ctxs[on[0]].cfg.batching:
        with leg("finalize"):
            for l in on:
                states[l] = run_finalize(states[l], datas[l], ctxs[l])
    return states


def _topn_pool(state: EvoState, cfg: EvoConfig):
    """Migration pool from each island's best ``topn`` members (best_sub_pop,
    SymbolicRegression.jl src/Migration.jl:25-31): the 8-tuple (kind, op,
    lhs, rhs, feat, val, length, loss), rows [I*topn]."""
    I, P, N = state.kind.shape
    k = cfg.topn
    top = torch.argsort(state.score, dim=1, stable=True)[:, :k]
    isl = torch.arange(I, device=top.device)[:, None]
    return tuple(
        f[isl, top].reshape((I * k,) + tuple(f.shape[2:]))
        for f in (state.kind, state.op, state.lhs, state.rhs, state.feat, state.val,
                  state.length, state.loss)
    )


def _inject_pool(state: EvoState, ctx: EvoContext, pool, pool_valid, frac: float,
                 norm=None) -> EvoState:
    """Replace a Poisson(frac*P)-count of members per island (at most the
    number of valid pool rows) with uniform draws from the valid pool rows
    (reference migrate!, SymbolicRegression.jl src/Migration.jl:16-38): the
    members of the lowest ranks of one uniform draw."""
    cfg = ctx.cfg
    I, P, N = state.kind.shape
    p_kind, p_op, p_lhs, p_rhs, p_feat, p_val, p_len, p_loss = pool
    n_valid = pool_valid.sum(dtype=torch.int32)
    u = ctx.rand(I, P)
    rank = torch.argsort(torch.argsort(u, dim=1, stable=True), dim=1, stable=True)
    rate = torch.full((I, 1), frac * P, dtype=torch.float32, device=ctx.device)
    n_rep = torch.poisson(rate, generator=ctx.gen).to(torch.int32)
    replace = (rank < torch.minimum(n_rep, n_valid)) & pool_valid.any()
    cdf = torch.cumsum(pool_valid.to(torch.float32), 0)
    src = _choice(cdf, ctx.rand(I * P)).reshape(I, P)

    def mix(cur, pool_f):
        take = pool_f[src]
        m = replace.view((I, P) + (1,) * (cur.dim() - 2))
        return torch.where(m, take.to(cur.dtype), cur)

    if cfg.complexity_table is None:
        pool_comp, member_comp = p_len, state.length
    else:
        pool_comp = complexity_batch(Tree(p_kind, p_op, p_lhs, p_rhs, p_feat, p_val, p_len),
                                     cfg, ctx)
        member_comp = _complexity_members(state, cfg, ctx)
    comp = torch.where(replace, pool_comp[src], member_comp).to(state.score.dtype)
    src_loss = p_loss[src].to(state.loss.dtype)
    ctx.log("migration", {"replace": replace, "src": src, "pool": pool})
    return state._replace(
        kind=mix(state.kind, p_kind), op=mix(state.op, p_op), lhs=mix(state.lhs, p_lhs),
        rhs=mix(state.rhs, p_rhs), feat=mix(state.feat, p_feat), val=mix(state.val, p_val),
        length=torch.where(replace, p_len[src].to(torch.int32), state.length),
        loss=torch.where(replace, src_loss, state.loss),
        score=torch.where(replace, _score_of(src_loss, comp, cfg, norm), state.score),
        birth=torch.where(replace, state.step, state.birth),
    )


def _migrate(state: EvoState, ctx: EvoContext, use_hof: bool, norm=None) -> EvoState:
    """Migration from the islands' topn pool, or from the best-seen
    frontier (hof)."""
    cfg = ctx.cfg
    if use_hof:
        pool = (*state.bs_tree, torch.where(state.bs_exists, state.bs_loss, torch.inf))
        return _inject_pool(state, ctx, pool, state.bs_exists, cfg.fraction_replaced_hof, norm)
    pool = _topn_pool(state, cfg)
    return _inject_pool(state, ctx, pool, torch.isfinite(pool[7]), cfg.fraction_replaced, norm)


def extract_topn_pool(state: EvoState, cfg: EvoConfig):
    return _topn_pool(state, cfg)


def migrate_from_pool(state: EvoState, ctx: EvoContext, pool, frac: float, norm=None):
    """Inject an external pool (the simplified frontier) with Poisson-count
    replacement; rows with non-finite loss or length < 1 are never drawn."""
    pool_valid = torch.isfinite(pool[7]) & (pool[6] >= 1)
    return _inject_pool(state, ctx, pool, pool_valid, frac, norm)


def fleet_migrate_from_pool(states, ctxs, pools, apply, frac: float, norms) -> list:
    """Fleet twin of ``migrate_from_pool`` (the JAX package's
    ``fleet_migrate_from_pool``): one lane per entry of ``states``,
    ``ctxs``, ``pools`` and ``norms``. A lane whose ``apply`` is False keeps
    its state verbatim and does not touch its generator, exactly as a solo
    run that skipped the call (a lane whose simplify pass produced nothing
    must not diverge from its solo run because a fleetmate's did); its pool
    may be None. ``apply`` is host bookkeeping, so choosing costs no
    sync."""
    return [
        migrate_from_pool(st, ctx, pool, frac, nm) if ap else st
        for st, ctx, pool, ap, nm in zip(states, ctxs, pools, apply, norms)
    ]


# ---------------------------------------------------------------------------
# Multi-device: islands shard across the 'pop' mesh axis (the JAX package's
# evo_state_specs, shard_evo_state, make_sharded_iteration and
# make_sharded_finalize). A sharded state is one EvoState per shard of the
# mesh, in flat (pop, rows) order, on that shard's device: the per-member
# leaves hold the shard's islands, in island order; the frequency
# histogram, the best-seen frontier and the counters are replicated, and
# the collectives of _event, run_finalize and the constant optimization
# keep them equal on every shard. Shards of one pop index hold the same
# islands (the rows axis replicates the state).
# ---------------------------------------------------------------------------

def evo_state_specs() -> EvoState:
    """Which leaves split over 'pop' (the JAX package's PartitionSpecs, as
    tuples): per-member leaves on their leading island axis, everything else
    replicated (``()``)."""
    isl3, isl2, rep = ("pop", None, None), ("pop", None), ()
    return EvoState(
        kind=isl3, op=isl3, lhs=isl3, rhs=isl3, feat=isl3, val=isl3,
        length=isl2, loss=isl2, score=isl2, birth=isl2,
        freq=rep, bs_loss=rep, bs_tree=(rep,) * 7, bs_exists=rep,
        step=rep, num_evals=rep, iteration=rep,
    )


def _leaves(state: EvoState) -> list:
    """(spec, tensor) per leaf of ``state``, ``bs_tree``'s seven included."""
    out = []
    for spec, v in zip(evo_state_specs(), state):
        out.extend(zip(spec, v) if isinstance(v, tuple) else [(spec, v)])
    return out


def _rebuild(leaves: list) -> EvoState:
    """An EvoState from its leaves in ``_leaves``' order."""
    head, tail = leaves[:12], leaves[12:]
    return EvoState(*head, tuple(tail[:7]), *tail[7:])


def shard_evo_state(state: EvoState, mesh) -> list:
    """One EvoState per shard of ``mesh`` (flat order) on its device: pop
    shard i takes islands [i*I/n_pop, (i+1)*I/n_pop); replicated leaves are
    copied. The island count must divide over the 'pop' axis. One shard
    takes ``state`` as it is."""
    if mesh.size == 1:
        return [state]
    n_pop = mesh.devices.shape[0]
    I = state.kind.shape[0]
    if I % n_pop:
        raise ValueError(f"{I} islands do not divide over a pop axis of {n_pop}")
    k = I // n_pop
    out = []
    for s in range(mesh.size):
        i, j = mesh.coords(s)
        dev = mesh.devices[i, j]
        out.append(_rebuild([(v[i * k:(i + 1) * k] if spec else v).to(dev, copy=True)
                             for spec, v in _leaves(state)]))
    return out


def unshard_evo_state(states: list, mesh, device=None) -> EvoState:
    """The global EvoState of a sharded one on ``device`` (default: shard
    0's): the islands of the pop shards (rows index 0) concatenated in
    island order, the replicated leaves from shard 0. One shard's state as
    it is."""
    if mesh.size == 1 and device is None:
        return states[0]
    device = states[0].loss.device if device is None else device
    heads = [_leaves(st) for st in states[::mesh.devices.shape[1]]]
    return _rebuild([torch.cat([h[q][1].to(device) for h in heads]) if spec else v.to(device)
                     for q, (spec, v) in enumerate(heads[0])])


def make_sharded_iteration(mesh, ctxs) -> Callable:
    """``step(states, datas) -> states``: ``run_iteration`` in every shard of
    ``mesh`` at once (``parallel.mesh.shard_map``), each shard on its own
    islands with its own context (``ctxs``: one per shard; each context's
    ``cfg.n_islands`` is the shard's island count), the frontier, the
    frequency histogram and the counters kept equal by the island axis's
    collectives. ``datas``: one ScoreData per shard (a rows axis gives each
    shard its row block, and its scorer combines the losses over the
    axis)."""
    from ..parallel.mesh import shard_map

    def step(states, datas):
        return shard_map(lambda sh, st, d, c: run_iteration(st, d, c, axis=sh.axis("pop")),
                         mesh, zip(states, datas, ctxs))

    return step


def make_sharded_finalize(mesh, ctxs) -> Callable:
    """``make_sharded_iteration``'s twin for ``run_finalize``."""
    from ..parallel.mesh import shard_map

    def step(states, datas):
        return shard_map(lambda sh, st, d, c: run_finalize(st, d, c, axis=sh.axis("pop")),
                         mesh, zip(states, datas, ctxs))

    return step
