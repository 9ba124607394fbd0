"""The kernel-resident evolution block, in plain PyTorch (B3's plain version).

Counterpart of ``symbolicregression_jl_tpu/ops/evolve_block.py``: one
iteration of regularized evolution, ``ncycles`` of tournament -> mutate ->
check -> score -> accept, over the population packed into words (kind in the
low ``PACK_KIND_BITS`` bits, payload above) plus a constants lane. Every draw
is a counter hash of (seed, cycle, lane, draw id), so the block is
reproducible and order-independent, and bit-exact with the JAX package for
one seed: the uint32 bits and the u01 values are equal for every (seed,
cycle, lane, draw), and so is every integer decision made from them.

The semantics are the JAX block's, including its documented differences
from the event leg (``ops/evolve.py``): tournament candidates are drawn WITH
replacement and the rank by inverse CDF; crossover and randomize fold into
do-nothing; the size-frequency histogram is a snapshot taken at block entry,
with per-island deltas merged at exit; the best-seen frontier is a
per-island carry merged at exit.

What changes is the expression:

- ``vmap`` over islands becomes a leading island axis; the lanes of all
  islands (lane ``isl * E + e``) run as one batch;
- the Mosaic one-hot reads (``_take``, ``_gather_rows``, ``_permute_cols``)
  become indexed reads with the same out-of-range rule: an index outside
  the row reads 0;
- the uint32 hash runs in int64 masked to 32 bits (``_mul32`` keeps every
  product below 2^49, so nothing overflows);
- scalars that JAX computes as f32 from Python floats (thresholds, the
  temperature, the perturbation scale) are rounded to f32 the same way.

``run_block`` with the plain evaluator (``make_plain_eval``: the port's
interpreter with B1's loss rule, sums in f64) is B3's plain version; the
kernel is ``ops/evolve_block_cuda.evolve_block``. ``run_block_iteration``
wraps either into one engine iteration (unpack, best-seen merge, frequency
decay, migration), the block counterpart of ``evolve.run_iteration``;
``run_block_iteration_fleet`` does the same for a fleet of searches with one
block over all their lanes (the JAX package's ``vmap`` of the iteration).
"""

from __future__ import annotations

import numpy as np
import torch

from .evolve import (
    EvoConfig,
    EvoContext,
    EvoState,
    M_ADD,
    M_CONST,
    M_DELETE,
    M_INSERT,
    M_NOTHING,
    M_OPERATOR,
    M_RANDOMIZE,
    M_SWAP,
    _curmaxsize,
    _has_op_constraints,
    _migrate,
    _score_of,
    merge_best_seen,
)
from .flat import (
    KIND_BINARY,
    KIND_CONST,
    KIND_PAD,
    KIND_UNARY,
    KIND_VAR,
    PACK_KIND_BITS,
    PACK_KIND_MASK,
    FlatTrees,
)

__all__ = [
    "block_eligible",
    "run_block",
    "run_block_iteration",
    "run_block_iteration_fleet",
    "make_plain_eval",
    "pack_state_words",
    "unpack_pointers",
    "BLOCK_MAX_ROWS",
]

#: the JAX engine runs the block only on data of at most 8 * C_TILE rows
#: (``symbolicregression_jl_tpu/models/device_search.py:2029``); the port
#: keeps the same limit for choosing the algorithm (its kernel takes any R)
BLOCK_MAX_ROWS = 10_240

# Draw-id table: one id per independent decision a lane makes in a cycle.
# Tournament draws occupy ids [0, tournament_n).
D_RANK = 32
D_KIND = 33
D_SITE = 34
D_CHILD = 35
D_ACCEPT = 36
D_C_FACTOR = 37
D_C_INV = 38
D_C_NEG = 39
D_OP_UN = 40
D_OP_BIN = 41
D_L1_CONST = 42
D_L1_FEAT = 43
D_L1_N1 = 44
D_L1_N2 = 45
D_L2_CONST = 46
D_L2_FEAT = 47
D_L2_N1 = 48
D_L2_N2 = 49
D_M_OPB = 50
D_M_OPU = 51

_M32 = 0xFFFFFFFF
_TWO_PI_F32 = float(np.float32(2.0 * np.pi))


def f32(x: float) -> float:
    """``x`` rounded to f32, as JAX rounds a Python float it meets in f32
    arithmetic (a weakly typed scalar)."""
    return float(np.float32(x))


# --------------------------------------------------------------------------
# Counter-derived RNG
# --------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """The low 32 bits of ``x * c`` for int64 ``x`` in [0, 2^32) and a
    constant ``c`` in [0, 2^32), without overflowing int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _u32(v):
    """A uint32 value held in int64 (a Python int stays a Python int)."""
    if not torch.is_tensor(v):
        return int(v) & _M32
    return v.to(torch.int64) & _M32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _blk_bits(seed, cycle, lane, draw: int) -> torch.Tensor:
    """uint32 hash (in int64) of (seed, cycle, lane, draw). ``lane`` may be a
    tensor of any shape; ``draw`` is a Python int from the D_* table."""
    x = _u32(seed) ^ _mul32((_u32(cycle) + 1) & _M32, 0x9E3779B9)
    x = _fmix(x)
    x = x ^ _mul32((_u32(lane) + 1) & _M32, 0x85EBCA6B)
    x = _fmix(x)
    x = x ^ ((0xC2B2AE35 * (draw + 1)) & _M32)
    return _fmix(x)


def _blk_u01(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) f32 from the top 24 bits (exactly representable)."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _blk_normal(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Box-Muller standard normal from two uniforms."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u1, f32(1e-12))))
    return r * torch.cos(_TWO_PI_F32 * u2)


def _randint(u: torch.Tensor, n) -> torch.Tensor:
    """Integer in [0, n) from u in [0, 1); ``n`` an int or int tensor >= 1."""
    if torch.is_tensor(n):
        n = n.to(torch.int32)
        return torch.minimum((u * n.to(torch.float32)).to(torch.int32), n - 1)
    return torch.clamp_max((u * f32(n)).to(torch.int32), int(n) - 1)


def _u(seed, cycle, lane, draw: int) -> torch.Tensor:
    return _blk_u01(_blk_bits(seed, cycle, lane, draw))


# --------------------------------------------------------------------------
# Indexed reads with the one-hot reads' out-of-range rule
# --------------------------------------------------------------------------


def _take(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """mat [B, V], idx [B] -> mat[b, idx[b]], or 0 where idx is outside
    [0, V) (the JAX one-hot read matches no slot there)."""
    V = mat.shape[-1]
    g = torch.gather(mat, -1, idx.clamp(0, V - 1).long()[..., None])[..., 0]
    return torch.where((idx >= 0) & (idx < V), g, torch.zeros_like(g))


def _permute_cols(mat, src, use_move):
    """out[e, j] = mat[e, src[e, j]] where use_move[e, j] else mat[e, j]
    (``src`` is already clipped into [0, N))."""
    return torch.where(use_move, torch.gather(mat, -1, src.long()), mat)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (its size if none)."""
    N = mask.shape[-1]
    iota = torch.arange(N, device=mask.device, dtype=torch.int32)
    return torch.where(mask, iota, N).amin(-1).to(torch.int32)


def _cumsum_i32(mask: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(mask.to(torch.int32), -1, dtype=torch.int32)


def _pick_ranked(mask, u, count):
    """Slot of the pick-th True of ``mask`` [E, N], pick uniform in
    [0, max(count, 1)); N when there is none."""
    ranks = _cumsum_i32(mask) - 1
    pick = _randint(u, torch.clamp_min(count, 1))
    return _first_true(mask & (ranks == pick[:, None]))


def _iota(n, device):
    return torch.arange(n, device=device, dtype=torch.int32)


# --------------------------------------------------------------------------
# Pointers and packing
# --------------------------------------------------------------------------


def _block_pointers(words: torch.Tensor, length: torch.Tensor):
    """words [B, N] int32 packed, length [B] -> (lhs, rhs, start, depth),
    each [B, N] int32 (0 at dead slots): child slots, the first slot of the
    subtree rooted at each slot, and that subtree's depth (a leaf is 1).

    The JAX package computes these with a postfix stack pass, one slot at a
    time; here they come from batched ops over [B, N, N], exact on
    stack-sound rows, which are the only rows the block makes (parents are
    sound and every mutation keeps soundness; the kernel keeps the stack
    pass). With d = +1 per leaf, -1 per binary node and S its running sum,
    the subtree rooted at i starts at the last slot j <= i whose prefix
    before it is S[i] - 1; a unary node's child is i - 1; a binary node's
    right child is i - 1 and its left child ends where the right subtree
    starts; a is an ancestor of j when start[a] <= j < a, so the depth of i
    is one more than the most ancestors any slot of its subtree has up to
    i."""
    B, N = words.shape
    dev = words.device
    kind = words & PACK_KIND_MASK
    iota = _iota(N, dev)
    live = iota[None, :] < length[:, None]
    leaf = (kind == KIND_CONST) | (kind == KIND_VAR)
    is_un = live & (kind == KIND_UNARY)
    is_bin = live & (kind == KIND_BINARY)
    d = torch.where(live & leaf, 1, torch.where(is_bin, -1, 0))
    S = torch.cumsum(d, 1, dtype=torch.int32)
    upto = (iota[None, :] <= iota[:, None])[None]  # [1, i, j]: j <= i
    hit = ((S - d)[:, None, :] == (S - 1)[:, :, None]) & upto
    start = torch.where(live, torch.where(hit, iota, -1).amax(-1), 0)
    prev = torch.clamp_min(iota - 1, 0)
    l_bin = torch.gather(start, 1, prev.long().expand(B, N)) - 1
    lhs = torch.where(is_un, prev, torch.where(is_bin, l_bin, 0)).to(torch.int32)
    rhs = torch.where(is_bin, prev, 0).to(torch.int32)
    anc = (start[:, :, None] <= iota) & (iota < iota[:, None]) & live[:, :, None]  # [a, j]
    n_anc = torch.cumsum(anc.to(torch.int32), 1)  # [i, j]: ancestors a <= i of j
    in_sub = (start[:, :, None] <= iota) & upto
    depth = torch.where(live, 1 + torch.where(in_sub, n_anc, 0).amax(-1), 0)
    return lhs, rhs, start.to(torch.int32), depth.to(torch.int32)


def unpack_pointers(words: torch.Tensor, length: torch.Tensor):
    """(kind, op, lhs, rhs, feat) int32 [B, N] from stack-sound packed words
    (the in-engine half of the pack-out; constants pass through)."""
    w32 = words.to(torch.int32)
    kind = w32 & PACK_KIND_MASK
    payload = w32 >> PACK_KIND_BITS
    op = torch.where((kind == KIND_UNARY) | (kind == KIND_BINARY), payload, 0)
    feat = torch.where(kind == KIND_VAR, payload, 0)
    lhs, rhs, _, _ = _block_pointers(w32, length)
    return kind, op.to(torch.int32), lhs, rhs, feat.to(torch.int32)


def pack_state_words(kind, op, feat, val):
    """The torch form of ``flat.pack_words``: (words int32, consts f32) on
    the tensors' device. Payloads fit 12 bits, so the JAX package's int16
    round trip changes nothing."""
    payload = torch.where(
        (kind == KIND_UNARY) | (kind == KIND_BINARY), op, torch.where(kind == KIND_VAR, feat, 0)
    )
    words = (kind | (payload << PACK_KIND_BITS)).to(torch.int32)
    consts = torch.where(kind == KIND_CONST, val, torch.zeros_like(val)).to(torch.float32)
    return words, consts


def _word(kind, payload):
    return (kind | (payload << PACK_KIND_BITS)).to(torch.int32)


# --------------------------------------------------------------------------
# The mutation set on packed words (lanes first). Each returns
# (words', consts', length').
# --------------------------------------------------------------------------


def _mut_constant(words, consts, length, kind, live, u_site, u_fac, u_inv, u_neg, cfg,
                  max_change: float):
    """Mirror of evolve._mutate_constant on the constants lane.
    ``max_change``: perturbation_factor * temperature + 1.1, in f32."""
    N = words.shape[-1]
    is_c = live & (kind == KIND_CONST)
    n_c = is_c.sum(-1, dtype=torch.int32)
    p = _pick_ranked(is_c, u_site, n_c)
    hits = is_c & (_iota(N, words.device)[None, :] == p[:, None])
    factor = torch.pow(torch.full_like(u_fac, max_change), u_fac)
    factor = torch.where(u_inv < 0.5, factor, 1.0 / factor)
    neg = u_neg < f32(cfg.probability_negate_constant)
    scale = torch.where(hits, (factor * torch.where(neg, -1.0, 1.0))[:, None],
                        torch.ones((), dtype=consts.dtype, device=consts.device))
    newc = torch.where(n_c[:, None] > 0, consts * scale, consts)
    return words, newc, length


def _mut_operator(words, consts, length, kind, live, u_site, u_un, u_bin, cfg):
    """Mirror of evolve._mutate_operator: same-arity operator swap."""
    N = words.shape[-1]
    is_op = live & (kind >= KIND_UNARY)
    n_op = is_op.sum(-1, dtype=torch.int32)
    p = _pick_ranked(is_op, u_site, n_op)
    hits = is_op & (_iota(N, words.device)[None, :] == p[:, None])
    new_un = _randint(u_un, max(cfg.n_unary, 1))
    new_bin = _randint(u_bin, max(cfg.n_binary, 1))
    payload = torch.where(kind == KIND_UNARY, new_un[:, None], new_bin[:, None])
    new_words = torch.where(hits & (n_op[:, None] > 0), _word(kind, payload), words)
    return new_words, consts, length


def _mut_rotate(words, consts, length, kind, live, lhs, rhs, start, u_site, cfg):
    """Mirror of evolve._swap_operands: swap the child blocks of one random
    binary node (a pure block move; pointers are recomputed)."""
    N = words.shape[-1]
    iota = _iota(N, words.device)[None, :]
    is_bin = live & (kind == KIND_BINARY)
    n_b = is_bin.sum(-1, dtype=torch.int32)
    p = _pick_ranked(is_bin, u_site, n_b)
    l_root = _take(lhs, p)
    r_root = _take(rhs, p)
    sizes_l = l_root - _take(start, l_root) + 1
    sizes_r = r_root - _take(start, r_root) + 1
    al = l_root - sizes_l + 1
    src = torch.clamp(
        torch.where(iota < (al + sizes_r)[:, None], iota + sizes_l[:, None],
                    iota - sizes_r[:, None]),
        0, N - 1,
    )
    use_move = (iota >= al[:, None]) & (iota < p[:, None])
    ok = n_b[:, None] > 0
    return (
        torch.where(ok, _permute_cols(words, src, use_move), words),
        torch.where(ok, _permute_cols(consts, src, use_move), consts),
        length,
    )


def _leaf_draws(seed, cycle, lane, cfg, d_const, d_feat, d_n1, d_n2):
    """One random leaf as (word, const): 50/50 const/feature, val ~ N(0,1)."""
    u_c = _u(seed, cycle, lane, d_const)
    u_f = _u(seed, cycle, lane, d_feat)
    u_n1 = _u(seed, cycle, lane, d_n1)
    u_n2 = _u(seed, cycle, lane, d_n2)
    is_const = u_c < 0.5
    if cfg.nfeatures <= 0:
        is_const = torch.ones_like(is_const)
    feat = _randint(u_f, max(cfg.nfeatures, 1))
    word = torch.where(is_const, KIND_CONST, _word(KIND_VAR, feat)).to(torch.int32)
    cval = torch.where(is_const, _blk_normal(u_n1, u_n2), 0.0)
    return word, cval


def _use_bin_draw(u, cfg):
    """Binary-vs-unary material choice with the degenerate-table overrides."""
    use_bin = u < f32(cfg.n_binary / max(cfg.n_binary + cfg.n_unary, 1))
    if cfg.n_unary == 0:
        use_bin = torch.ones_like(use_bin)
    if cfg.n_binary == 0:
        use_bin = torch.zeros_like(use_bin)
    return use_bin


def _mut_add(words, consts, length, kind, live, seed, cycle, lane, u_site, u_child, cfg):
    """Mirror of evolve._add_node: replace a random leaf with
    binary(leaf, leaf) or unary(leaf) material."""
    N = words.shape[-1]
    iota = _iota(N, words.device)[None, :]
    is_leaf = live & ((kind == KIND_CONST) | (kind == KIND_VAR))
    n_l = is_leaf.sum(-1, dtype=torch.int32)
    p = _pick_ranked(is_leaf, u_site, n_l)
    use_bin = _use_bin_draw(u_child, cfg)
    w1, c1 = _leaf_draws(seed, cycle, lane, cfg, D_L1_CONST, D_L1_FEAT, D_L1_N1, D_L1_N2)
    w2, c2 = _leaf_draws(seed, cycle, lane, cfg, D_L2_CONST, D_L2_FEAT, D_L2_N1, D_L2_N2)
    opb = _randint(_u(seed, cycle, lane, D_M_OPB), max(cfg.n_binary, 1))
    opu = _randint(_u(seed, cycle, lane, D_M_OPU), max(cfg.n_unary, 1))
    m_len = torch.where(use_bin, 3, 2).to(torch.int32)
    mat1 = torch.where(use_bin, w2, _word(KIND_UNARY, opu))
    mat2 = _word(KIND_BINARY, opb)
    matc1 = torch.where(use_bin, c2, 0.0)
    src = torch.clamp(iota - (m_len - 1)[:, None], 0, N - 1)
    tail = iota >= (p + m_len)[:, None]
    new_words = _permute_cols(words, src, tail)
    new_consts = _permute_cols(consts, src, tail)
    at0 = iota == p[:, None]
    at1 = iota == (p + 1)[:, None]
    at2 = (iota == (p + 2)[:, None]) & use_bin[:, None]
    new_words = torch.where(at0, w1[:, None], new_words)
    new_words = torch.where(at1, mat1[:, None], new_words)
    new_words = torch.where(at2, mat2[:, None], new_words)
    new_consts = torch.where(at0, c1[:, None], new_consts)
    new_consts = torch.where(at1, matc1[:, None], new_consts)
    new_consts = torch.where(at2, 0.0, new_consts)
    new_len = length + m_len - 1
    ok = (n_l > 0) & (new_len <= N)
    return (
        torch.where(ok[:, None], new_words, words),
        torch.where(ok[:, None], new_consts, consts),
        torch.where(ok, new_len, length),
    )


def _mut_insert(words, consts, length, seed, cycle, lane, u_site, u_child, cfg):
    """Mirror of evolve._insert_node: wrap the subtree rooted at a random
    slot in a fresh operator (unary, or binary with a new leaf second)."""
    N = words.shape[-1]
    iota = _iota(N, words.device)[None, :]
    p = _randint(u_site, torch.clamp_min(length, 1))
    use_bin = _use_bin_draw(u_child, cfg)
    wl, cl = _leaf_draws(seed, cycle, lane, cfg, D_L1_CONST, D_L1_FEAT, D_L1_N1, D_L1_N2)
    opb = _randint(_u(seed, cycle, lane, D_M_OPB), max(cfg.n_binary, 1))
    opu = _randint(_u(seed, cycle, lane, D_M_OPU), max(cfg.n_unary, 1))
    shift = torch.where(use_bin, 2, 1).to(torch.int32)
    op_word = torch.where(use_bin, _word(KIND_BINARY, opb), _word(KIND_UNARY, opu))
    src = torch.clamp(iota - shift[:, None], 0, N - 1)
    tail = iota > (p + shift)[:, None]
    new_words = _permute_cols(words, src, tail)
    new_consts = _permute_cols(consts, src, tail)
    at_leaf = (iota == (p + 1)[:, None]) & use_bin[:, None]
    at_op = iota == (p + shift)[:, None]
    new_words = torch.where(at_leaf, wl[:, None], new_words)
    new_consts = torch.where(at_leaf, cl[:, None], new_consts)
    new_words = torch.where(at_op, op_word[:, None], new_words)
    new_consts = torch.where(at_op, 0.0, new_consts)
    new_len = length + shift
    ok = new_len <= N
    return (
        torch.where(ok[:, None], new_words, words),
        torch.where(ok[:, None], new_consts, consts),
        torch.where(ok, new_len, length),
    )


def _mut_delete(words, consts, length, kind, live, lhs, rhs, start, u_site, u_child, cfg):
    """Mirror of evolve._delete_node: splice a random operator out,
    promoting one of its children (the right one w.p. 0.5 for binary)."""
    N = words.shape[-1]
    iota = _iota(N, words.device)[None, :]
    is_op = live & (kind >= KIND_UNARY)
    n_op = is_op.sum(-1, dtype=torch.int32)
    p = _pick_ranked(is_op, u_site, n_op)
    keep_right = (_take(kind, p) == KIND_BINARY) & (u_child < 0.5)
    child = torch.where(keep_right, _take(rhs, p), _take(lhs, p))
    ca = _take(start, child)
    clen = child - ca + 1
    sub_a = _take(start, p)
    removed = (p - sub_a + 1) - clen
    in_child = (iota >= sub_a[:, None]) & (iota < (sub_a + clen)[:, None])
    src = torch.where(in_child, iota - sub_a[:, None] + ca[:, None], iota + removed[:, None])
    src = torch.clamp(src, 0, N - 1)
    use_move = iota >= sub_a[:, None]
    ok = n_op > 0
    return (
        torch.where(ok[:, None], _permute_cols(words, src, use_move), words),
        torch.where(ok[:, None], _permute_cols(consts, src, use_move), consts),
        torch.where(ok, length - removed, length),
    )


# --------------------------------------------------------------------------
# Tournament and replacement
# --------------------------------------------------------------------------


def tournament_thresholds(cfg: EvoConfig) -> list[float]:
    """The inverse-CDF thresholds of the static rank weights: cumulated in
    f64, compared in f32."""
    w = np.asarray(cfg.tournament_weights, np.float64)
    return [f32(c) for c in np.cumsum(w / np.sum(w))]


def _blk_tournament(score, length, fnorm, seed, cycle, lane, isl, cfg):
    """Winner member index in [0, P) per lane. score/length are the [I, P]
    population columns, lane the [L] lane ids and isl their islands."""
    n = cfg.tournament_n
    P = score.shape[1]
    cand = torch.stack([_randint(_u(seed, cycle, lane, d), P) for d in range(n)], -1)  # [L, n]
    flat = isl[:, None] * P + cand.long()
    s = score.reshape(-1)[flat]
    if cfg.use_frequency_in_tournament:
        sizes = torch.clamp(length.reshape(-1)[flat], 0, cfg.maxsize).long()
        s = s * torch.exp(f32(cfg.adaptive_parsimony_scaling) * fnorm[sizes])
    u = _u(seed, cycle, lane, D_RANK)
    rank = torch.zeros_like(u, dtype=torch.int32)
    for thr in tournament_thresholds(cfg):
        rank = rank + (u >= thr).to(torch.int32)
    rank = torch.clamp(rank, 0, n - 1)
    # stable rank of each candidate's adjusted score (pairwise count)
    io = _iota(n, score.device)
    less = (s[:, :, None] > s[:, None, :]).to(torch.int32)
    eq_before = ((s[:, :, None] == s[:, None, :]) & (io[None, None, :] < io[None, :, None]))
    crank = (less + eq_before.to(torch.int32)).sum(-1, dtype=torch.int32)
    pos = torch.clamp(_first_true(crank == rank[:, None]), 0, n - 1)
    return torch.gather(cand, 1, pos.long()[:, None])[:, 0]


def _oldest_slots(birth: torch.Tensor, E: int) -> torch.Tensor:
    """Stable ranks of ``birth`` [I, P]; member p hosts event e iff its rank
    is e. Returns [I, P] int32 (event index, or E where the member stays)."""
    P = birth.shape[-1]
    io = _iota(P, birth.device)
    less = birth[:, None, :] < birth[:, :, None]
    eq_before = (birth[:, None, :] == birth[:, :, None]) & (io[None, None, :] < io[None, :, None])
    rank = (less.to(torch.int32) + eq_before.to(torch.int32)).sum(-1, dtype=torch.int32)
    return torch.where(rank < E, rank, E).to(torch.int32)


def mutation_weights_f32(cfg: EvoConfig) -> np.ndarray:
    """The 8 kind weights in f32, randomize folded into do-nothing."""
    base = np.asarray(cfg.mutation_weights, np.float32).copy()
    base[M_NOTHING] += base[M_RANDOMIZE]
    base[M_RANDOMIZE] = 0.0
    return base


def temperature_f32(cycle: int, cfg: EvoConfig) -> float:
    """The annealing temperature of a cycle, in f32 (exactly 0 on the last)."""
    if not cfg.annealing:
        return 1.0
    return float(np.float32(1.0) - np.float32(cycle) / np.float32(max(cfg.ncycles - 1, 1)))


# --------------------------------------------------------------------------
# One cycle over every island
# --------------------------------------------------------------------------


def block_cycle(carry, cycle: int, seed, step0, curmaxsize, fnorm, norm, cfg: EvoConfig,
                eval_fn, stages: int = 4):
    """One evolution cycle of every island (the JAX package's ``_block_cycle``
    with a leading island axis). ``carry`` is the 11-tuple (words, consts,
    length, loss, score, birth [I, P(, N)], freq delta, best-seen loss,
    words, consts, length [I, S+1(, N)]); ``eval_fn(words, consts, length)``
    scores a batch of packed programs [L, N] -> [L] f32. ``stages`` < 4 stops
    after tournament+mutation (1), the check (2) or scoring (3), folding a
    checksum into ``loss`` as the JAX package's profile does."""
    (words, consts, length, loss, score, birth, fd, bs_loss, bs_w, bs_c, bs_len) = carry
    I, P, N = words.shape
    E = cfg.events_per_cycle
    L = I * E
    dev = words.device
    lane = _iota(L, dev)
    isl = (lane // E).long()
    iota_n = _iota(N, dev)[None, :]
    temperature = temperature_f32(cycle, cfg)

    # ---- stage 1: tournament + mutation draws + mutate + canonicalize ----
    parent = _blk_tournament(score, length, fnorm, seed, cycle, lane, isl, cfg).long()
    pw = words[isl, parent]
    pc = consts[isl, parent]
    plen = length[isl, parent]
    ploss = loss[isl, parent]
    pscore = score[isl, parent]
    live = iota_n < plen[:, None]
    kind = torch.where(live, pw & PACK_KIND_MASK, KIND_PAD)

    lhs, rhs, start, _ = _block_pointers(pw, plen)

    base = mutation_weights_f32(cfg)
    n_const = (live & (kind == KIND_CONST)).sum(-1, dtype=torch.int32)
    n_ops = (kind >= KIND_UNARY).sum(-1, dtype=torch.int32)
    n_bin = (kind == KIND_BINARY).sum(-1, dtype=torch.int32)
    at_max = plen >= curmaxsize
    zero = torch.zeros((L,), dtype=torch.float32, device=dev)
    cols = [torch.full((L,), float(base[m]), dtype=torch.float32, device=dev) for m in range(8)]
    cols[M_OPERATOR] = torch.where(n_ops == 0, zero, cols[M_OPERATOR])
    cols[M_SWAP] = torch.where(n_bin == 0, zero, cols[M_SWAP])
    cols[M_DELETE] = torch.where(n_ops == 0, zero, cols[M_DELETE])
    cols[M_CONST] = torch.where(
        n_const == 0, zero,
        cols[M_CONST] * torch.clamp_max(n_const.to(torch.float32), 8.0) / 8.0,
    )
    cols[M_ADD] = torch.where(at_max, zero, cols[M_ADD])
    cols[M_INSERT] = torch.where(at_max, zero, cols[M_INSERT])
    w = torch.stack(cols, -1)  # [L, 8]
    nothing = (torch.arange(8, device=dev) == M_NOTHING)[None, :]
    w = w + torch.where(nothing & (w.sum(-1) <= 0)[:, None], 1.0, 0.0)
    cum_w = torch.cumsum(w, -1)  # left to right in f32
    u_kind = _u(seed, cycle, lane, D_KIND)
    kidx = torch.clamp(
        ((u_kind * cum_w[:, -1])[:, None] >= cum_w).sum(-1, dtype=torch.int32), 0, 7
    )

    u_site = _u(seed, cycle, lane, D_SITE)
    u_child = _u(seed, cycle, lane, D_CHILD)
    max_change = f32(np.float32(cfg.perturbation_factor) * np.float32(temperature)
                     + np.float32(1.0) + np.float32(0.1))
    muts = {
        M_CONST: _mut_constant(
            pw, pc, plen, kind, live, u_site, _u(seed, cycle, lane, D_C_FACTOR),
            _u(seed, cycle, lane, D_C_INV), _u(seed, cycle, lane, D_C_NEG), cfg, max_change,
        ),
        M_OPERATOR: _mut_operator(
            pw, pc, plen, kind, live, u_site, _u(seed, cycle, lane, D_OP_UN),
            _u(seed, cycle, lane, D_OP_BIN), cfg,
        ),
        M_SWAP: _mut_rotate(pw, pc, plen, kind, live, lhs, rhs, start, u_site, cfg),
        M_ADD: _mut_add(pw, pc, plen, kind, live, seed, cycle, lane, u_site, u_child, cfg),
        M_INSERT: _mut_insert(pw, pc, plen, seed, cycle, lane, u_site, u_child, cfg),
        M_DELETE: _mut_delete(pw, pc, plen, kind, live, lhs, rhs, start, u_site, u_child, cfg),
    }
    cw, cc, clen = pw, pc, plen  # do-nothing / randomize
    for m, (mw, mc, ml) in muts.items():
        sel = kidx == m
        cw = torch.where(sel[:, None], mw, cw)
        cc = torch.where(sel[:, None], mc, cc)
        clen = torch.where(sel, ml, clen)
    tail = iota_n >= clen[:, None]
    cw = torch.where(tail, 0, cw).to(torch.int32)
    cc = torch.where(tail, 0.0, cc)

    def checked(chk):
        chk = chk.reshape(I, -1).sum(-1)
        return (words, consts, length, torch.where(torch.isnan(chk)[:, None], chk[:, None], loss),
                score, birth, fd, bs_loss, bs_w, bs_c, bs_len)

    if stages < 2:
        return checked(cw.to(torch.float32).sum(-1) + cc.sum(-1) + clen.to(torch.float32))

    # ---- stage 2: candidate pointer pass + size/depth check ----
    _, _, _, cdepth = _block_pointers(cw, clen)
    root_depth = _take(cdepth, torch.clamp_min(clen - 1, 0))
    ok = (clen <= curmaxsize) & (clen <= N) & (root_depth <= cfg.maxdepth)
    vw = torch.where(ok[:, None], cw, pw)
    vc = torch.where(ok[:, None], cc, pc)
    vlen = torch.where(ok, clen, plen)

    if stages < 3:
        return checked(ok.to(torch.float32) + vw.to(torch.float32).sum(-1))

    # ---- stage 3: loss scoring ----
    loss1 = eval_fn(vw, vc, vlen).to(torch.float32)
    score1 = _score_of(loss1, vlen.to(torch.float32), cfg, norm)

    if stages < 4:
        return checked(loss1)

    # ---- stage 4: annealing-gated accept + oldest-first replacement ----
    sz_old = torch.clamp(plen, 0, cfg.maxsize).long()
    sz_new = torch.clamp(vlen, 0, cfg.maxsize).long()
    prob = torch.ones((L,), dtype=torch.float32, device=dev)
    if cfg.annealing:
        # temperature is exactly 0 on the final cycle: IEEE inf/0 semantics
        den = torch.full_like(prob, f32(f32(cfg.alpha) * temperature))
        prob = prob * torch.exp(-(score1 - pscore) / den)
    if cfg.use_frequency:
        old_f = torch.clamp_min(fnorm[sz_old], f32(1e-6))
        new_f = torch.clamp_min(fnorm[sz_new], f32(1e-6))
        prob = prob * (old_f / new_f)
    u_acc = _u(seed, cycle, lane, D_ACCEPT)
    finite = torch.isfinite(loss1)
    accept = ~(prob < u_acc) & finite & ok

    bw = torch.where(accept[:, None], vw, pw)
    bc = torch.where(accept[:, None], vc, pc)
    blen = torch.where(accept, vlen, plen)
    bloss = torch.where(accept, loss1, ploss)
    bscore = torch.where(accept, score1, pscore)

    # insert ALWAYS (parent copy on reject) over the E oldest members
    ev = _oldest_slots(birth, E)
    hit = ev < E
    src = (_iota(I, dev)[:, None] * E + torch.clamp(ev, 0, E - 1)).long()  # [I, P]
    words = torch.where(hit[..., None], bw[src], words)
    consts = torch.where(hit[..., None], bc[src], consts)
    length = torch.where(hit, blen[src], length)
    loss = torch.where(hit, bloss[src], loss)
    score = torch.where(hit, bscore[src], score)
    birth = torch.where(hit, torch.as_tensor(step0 + cycle, device=dev).to(torch.int32), birth)

    # frequency delta of accepted inserts, merged across islands at exit
    S1 = fd.shape[1]
    iota_s = _iota(S1, dev)
    oh = (sz_new[:, None] == iota_s[None, :]) & accept[:, None]
    fd = fd + oh.reshape(I, E, S1).to(torch.float32).sum(1)

    # best-seen per size over every finite valid candidate (rejected ones
    # too), the first of equal minima
    valid = (finite & ok).reshape(I, 1, E)
    m_se = valid & (sz_new.reshape(I, 1, E) == iota_s[None, :, None])
    loss_se = torch.where(m_se, loss1.reshape(I, 1, E), torch.inf)
    min_s = loss_se.amin(-1)
    e_star = torch.clamp(_first_true(loss_se == min_s[..., None]), 0, E - 1)
    better = min_s < bs_loss
    src_s = (_iota(I, dev)[:, None] * E + e_star).long()  # [I, S1]
    bs_loss = torch.where(better, min_s, bs_loss)
    bs_w = torch.where(better[..., None], vw[src_s], bs_w)
    bs_c = torch.where(better[..., None], vc[src_s], bs_c)
    bs_len = torch.where(better, vlen[src_s], bs_len)
    return (words, consts, length, loss, score, birth, fd, bs_loss, bs_w, bs_c, bs_len)


def block_carry0(pop, cfg: EvoConfig):
    """The block's initial 11-tuple carry from the packed population."""
    words, consts, length, loss, score, birth = pop
    I, P, N = words.shape
    S1 = cfg.maxsize + 1
    dev = words.device
    return (
        words, consts, length, loss, score, birth,
        torch.zeros((I, S1), dtype=torch.float32, device=dev),
        torch.full((I, S1), torch.inf, dtype=torch.float32, device=dev),
        torch.zeros((I, S1, N), dtype=torch.int32, device=dev),
        torch.zeros((I, S1, N), dtype=torch.float32, device=dev),
        torch.zeros((I, S1), dtype=torch.int32, device=dev),
    )


def run_block(pop, seed, step0, curmaxsize, fnorm, norm, cfg: EvoConfig, eval_fn,
              stages: int = 4):
    """``cfg.ncycles`` cycles over every island (the JAX package's
    ``_island_block`` under ``vmap``). ``pop`` = (words int32 [I, P, N],
    consts f32 [I, P, N], length, loss, score, birth [I, P]). Returns the
    11-tuple block carry."""
    carry = block_carry0(pop, cfg)
    for cycle in range(cfg.ncycles):
        carry = block_cycle(carry, cycle, seed, step0, curmaxsize, fnorm, norm, cfg, eval_fn,
                            stages)
    return carry


def make_plain_eval(opset, loss_elem, X, y, w):
    """eval_fn(words, consts, length) -> losses [L] f32 through the port's
    plain interpreter over the unpacked programs, with B1's loss rule (a
    weighted mean summed in f64; inf when a prediction is non-finite or
    w_sum <= 0). The counterpart of the JAX package's
    ``make_reference_eval``; reads the programs back to the host."""
    from .interp_cuda import plain_losses

    def eval_fn(vw, vc, vlen):
        kind, op, lhs, rhs, feat = unpack_pointers(vw, vlen)
        flat = FlatTrees(*(np.asarray(a.cpu()) for a in (kind, op, lhs, rhs, feat, vc, vlen)))
        return plain_losses(flat, vc.to(X.dtype).contiguous(), X, y, w, opset, loss_elem)

    return eval_fn


# --------------------------------------------------------------------------
# Eligibility and the iteration
# --------------------------------------------------------------------------


def block_eligible(cfg: EvoConfig):
    """(ok, reason): can the block replace the event leg for this engine
    config? The JAX package's gates, with its reasons; the row-count gate
    lives in models/device_search."""
    if cfg.record_events:
        return False, "recorder mode needs the per-event XLA log"
    if cfg.batching:
        return False, "minibatch scoring draws per-cycle row subsets"
    if cfg.eval_fraction < 1.0:
        return False, "fractional eval accounting"
    if cfg.complexity_table is not None:
        return False, "custom complexity mapping"
    if _has_op_constraints(cfg) or cfg.nested_constraints:
        return False, "operator argument/nesting constraints"
    if cfg.units_check:
        return False, "dimensional analysis"
    if cfg.mutation_attempts > 1:
        return False, "multi-attempt mutation retries"
    if cfg.val_dtype != "float32":
        return False, "f64 engine (kernels are f32-only)"
    if cfg.events_per_cycle > cfg.pop_size:
        return False, "events_per_cycle exceeds pop_size"
    return True, ""


def draw_seed(ctx: EvoContext) -> torch.Tensor:
    """One uint32 block seed (int64 0-d tensor) from the engine's generator,
    drawn on the engine's device (no host sync)."""
    return torch.randint(0, 1 << 32, (), generator=ctx.gen, device=ctx.device,
                         dtype=torch.int64)


def run_block_iteration(state: EvoState, data, ctx: EvoContext, *, eval_fn=None,
                        kernel_fn=None, seed=None, stages: int = 4) -> EvoState:
    """One engine iteration through the block: the evolve leg's counterpart
    of ``evolve.run_iteration`` where ``block_eligible`` holds.

    Exactly one of ``kernel_fn`` (``evolve_block_cuda.evolve_block`` bound to
    the data) or ``eval_fn`` (for ``run_block``) is given. ``seed``: the
    block's uint32 seed; by default one draw from the engine's generator.
    No step reads a tensor back to the host on the kernel path."""
    pop, seed, curmaxsize, fnorm = _block_prologue(state, ctx, seed)
    if kernel_fn is not None:
        dev = state.kind.device
        if not torch.is_tensor(curmaxsize):
            curmaxsize = torch.full((), curmaxsize, dtype=torch.int32, device=dev)
        if not torch.is_tensor(seed):
            seed = torch.full((), seed, dtype=torch.int64, device=dev)
        out = kernel_fn(*pop, fnorm, seed, state.step, curmaxsize, data.norm)
    else:
        if eval_fn is None:
            raise ValueError("run_block_iteration needs eval_fn or kernel_fn")
        out = run_block(pop, seed, state.step, curmaxsize, fnorm, data.norm, ctx.cfg, eval_fn,
                        stages)
    return _block_epilogue(state, out, data, ctx)


def run_block_iteration_fleet(states, datas, ctxs, kernel_fn, seeds=None) -> list:
    """``run_block_iteration`` for a fleet of searches in ONE block launch:
    each lane draws its seed from its own generator and packs its own
    population, ``kernel_fn`` runs every lane's islands at once on the lane
    axis (``evolve_block_cuda.evolve_block`` bound to the lane-stacked data
    on the card, ``evolve_block_reference`` elsewhere), and each lane
    unpacks, merges and migrates on its own generator. Every step but the
    block is the solo's code on the lane's own tensors, and the block gives
    each lane its solo launch's outputs, so each lane ends where its solo
    iteration ends. ``seeds``: the lanes' block seeds; by default each one
    draw from its lane's generator. Returns the lanes' new states."""
    seeds = [None] * len(states) if seeds is None else seeds
    pro = [_block_prologue(st, ctx, sd) for st, ctx, sd in zip(states, ctxs, seeds)]
    dev = states[0].kind.device

    def scalar(v, dtype):
        return v.to(dtype) if torch.is_tensor(v) else torch.full((), v, dtype=dtype, device=dev)

    pop = tuple(torch.cat([p[0][k] for p in pro]) for k in range(6))
    out = kernel_fn(
        *pop, torch.stack([p[3] for p in pro]),
        torch.stack([scalar(p[1], torch.int64) for p in pro]),
        torch.stack([st.step for st in states]),
        torch.stack([scalar(p[2], torch.int32) for p in pro]),
        torch.stack([d.norm for d in datas]),
    )
    I = ctxs[0].cfg.n_islands
    return [
        _block_epilogue(st, tuple(o[l * I:(l + 1) * I] for o in out), d, ctx)
        for l, (st, d, ctx) in enumerate(zip(states, datas, ctxs))
    ]


def _block_prologue(state: EvoState, ctx: EvoContext, seed):
    """What the block takes from one search's state: (the packed population
    6-tuple, the uint32 seed, the current maxsize, the normalized size
    histogram). ``seed`` None draws it from the search's generator."""
    cfg = ctx.cfg
    if seed is None:
        seed = draw_seed(ctx)
    seed = _u32(seed)
    curmaxsize = _curmaxsize(state, cfg)
    fnorm = state.freq / torch.clamp_min(state.freq.sum(), 1e-30)
    words, consts = pack_state_words(state.kind, state.op, state.feat, state.val)
    pop = tuple(a.contiguous() for a in (words, consts, state.length,
                                         state.loss.to(torch.float32),
                                         state.score.to(torch.float32), state.birth))
    return pop, seed, curmaxsize, fnorm


def _block_epilogue(state: EvoState, out, data, ctx: EvoContext) -> EvoState:
    """One search's state after its block ``out`` (the 11-tuple carry):
    unpack, fold the best-seen carries into the frontier, decay the size
    histogram, migrate."""
    cfg = ctx.cfg
    I, P, N = state.kind.shape
    S1 = cfg.maxsize + 1
    (n_words, n_consts, n_len, n_loss, n_score, n_birth, fd, b_loss, b_w, b_c, b_len) = out

    vdt = state.val.dtype
    kind, op, lhs, rhs, feat = (
        a.reshape(I, P, N) for a in unpack_pointers(n_words.reshape(I * P, N),
                                                     n_len.reshape(I * P))
    )
    state = state._replace(
        kind=kind, op=op, lhs=lhs, rhs=rhs, feat=feat, val=n_consts.to(vdt),
        length=n_len, loss=n_loss.to(state.loss.dtype), score=n_score.to(state.score.dtype),
        birth=n_birth, freq=state.freq + fd.sum(0), step=state.step + cfg.ncycles,
        num_evals=state.num_evals + float(cfg.ncycles * I * cfg.events_per_cycle),
        iteration=state.iteration + 1,
    )
    # the per-island best-seen carries into the global frontier (per-size
    # min is associative: the same frontier as merging every cycle)
    b_len = b_len.reshape(I * S1)
    fields = [*unpack_pointers(b_w.reshape(I * S1, N), b_len),
              b_c.reshape(I * S1, N).to(vdt)]
    losses = b_loss.reshape(I * S1).to(state.bs_loss.dtype)
    state = merge_best_seen(state, cfg, losses, torch.isfinite(losses), fields, b_len)
    # frequency-window decay (window 100k), as the event leg's tail
    total_f = state.freq.sum()
    state = state._replace(
        freq=torch.where(total_f > 100_000.0, state.freq * (100_000.0 / total_f), state.freq)
    )
    if cfg.migration:
        state = _migrate(state, ctx, use_hof=False, norm=data.norm)
    if cfg.hof_migration:
        state = _migrate(state, ctx, use_hof=True, norm=data.norm)
    return state
