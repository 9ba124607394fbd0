"""Flat (device) representation of expression-tree populations.

Copy of ``symbolicregression_jl_tpu/ops/flat.py`` (numpy only). The device
never sees pointer trees. A batch of trees is a struct-of-arrays of
padded postorder tensors — the design called for by SURVEY.md §7.1 and the
driver north star: host<->device traffic is only these tensors plus loss
vectors. Replaces the role of DynamicExpressions.jl's recursive ``Node``
storage for everything math-related.

Postorder invariant: children of slot ``i`` are at slots ``< i``; the root of
tree ``p`` is at slot ``length[p] - 1``. Padding slots have kind=PAD and write
zeros during evaluation; they are never read by live slots.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..tree import Node

__all__ = [
    "KIND_PAD",
    "KIND_CONST",
    "KIND_VAR",
    "KIND_UNARY",
    "KIND_BINARY",
    "PACK_KIND_BITS",
    "PACK_KIND_MASK",
    "PACK_PAYLOAD_MAX",
    "FlatTrees",
    "PackedPrograms",
    "flatten_trees",
    "unflatten_tree",
    "pack_programs",
    "unpack_programs",
    "pack_words",
    "pad_bucket",
    "bucket_min",
    "bucket_sizes",
    "length_buckets",
    "slice_nodes",
]

KIND_PAD = 0
KIND_CONST = 1
KIND_VAR = 2
KIND_UNARY = 3
KIND_BINARY = 4

# Packed device-IR word layout (PackedPrograms): bits 0..2 carry the KIND_*
# code, bits 3..14 carry the payload — the operator index for UNARY/BINARY
# slots, the feature index for VAR slots, 0 for CONST/PAD. An int16 word
# therefore admits payloads up to 4095, far above any realistic operator
# table or feature count; verify_packed_programs enforces the real bounds.
PACK_KIND_BITS = 3
PACK_KIND_MASK = (1 << PACK_KIND_BITS) - 1
PACK_PAYLOAD_MAX = (1 << (15 - PACK_KIND_BITS)) - 1


class FlatTrees(NamedTuple):
    """A padded batch of postorder trees. All arrays share leading dim P.

    kind:   int32[P, N]  node kind (see KIND_*)
    op:     int32[P, N]  operator index within its arity table
    lhs:    int32[P, N]  left-child slot (< slot index); 0 for leaves
    rhs:    int32[P, N]  right-child slot; 0 for non-binary
    feat:   int32[P, N]  feature index for KIND_VAR slots
    val:    float[P, N]  constant value for KIND_CONST slots (the only
                         differentiable leaf array — autograd targets this)
    length: int32[P]     number of live slots; root at length-1
    """

    kind: np.ndarray
    op: np.ndarray
    lhs: np.ndarray
    rhs: np.ndarray
    feat: np.ndarray
    val: np.ndarray
    length: np.ndarray

    @property
    def n_trees(self) -> int:
        return self.kind.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.kind.shape[1]


def pad_bucket(n: int, multiple: int = 8) -> int:
    """Round a node budget up to a padding bucket so batch shapes stay
    few across the whole search."""
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def batch_bucket(n: int, minimum: int = 16) -> int:
    """Round a candidate-batch size up to a power-of-two bucket — the shared
    policy for every batched device program (scoring, constant optimization),
    bounding the compile-cache population to O(log P)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def length_buckets_enabled() -> bool:
    """Env kill-switch for the length-bucketed interpreter dispatch
    (``SR_LENGTH_BUCKETS=0`` restores single full-width programs — used by
    the bit-identity tests and the bench A/B)."""
    import os

    return os.environ.get("SR_LENGTH_BUCKETS", "1") != "0"


def bucket_min() -> int:
    """Smallest node bucket (``SR_BUCKET_MIN``, default 16). The bucket
    ladder trades compile count for scan length: every extra bucket is one
    more compiled program per hot path (scoring, BFGS, engine switch
    branches). The default keeps small-``max_nodes`` configs (<= 16 — the
    common test/tuning sizes) on a SINGLE full-width program — identical to
    the unbucketed seed — while big-maxsize searches still split; set
    ``SR_BUCKET_MIN=8`` for the full ladder when the per-iteration runtime
    dwarfs compiles (the committed engine-profile A/B does)."""
    import os

    return int(os.environ.get("SR_BUCKET_MIN", 16))


def bucket_sizes(max_nodes: int, minimum: int | None = None) -> tuple[int, ...]:
    """Node-count dispatch buckets for the interpreter hot paths: powers of
    two from ``minimum`` (default ``bucket_min()``) up, capped by (and
    always ending at) ``max_nodes`` — the node-axis analogue of
    ``batch_bucket``'s policy, so a search compiles O(log N) scan lengths
    instead of one per tree length."""
    if minimum is None:
        minimum = bucket_min()
    sizes: list[int] = []
    b = minimum
    while b < max_nodes:
        sizes.append(b)
        b *= 2
    sizes.append(max_nodes)
    return tuple(sizes)


def length_buckets(
    lengths, max_nodes: int, minimum: int | None = None
) -> list[tuple[int, np.ndarray]]:
    """Partition a batch by tree length into the ``bucket_sizes`` families.

    Returns ``[(n_b, row_indices)]`` with every row assigned to the smallest
    bucket that holds it; empty buckets are dropped. Host-side numpy — the
    caller slices the flat batch per bucket (``slice_nodes``) and dispatches
    each group to the bucket-sized compiled program.
    """
    lengths = np.asarray(lengths)
    out: list[tuple[int, np.ndarray]] = []
    prev = 0
    for n_b in bucket_sizes(max_nodes, minimum):
        if prev == 0:
            sel = np.nonzero(lengths <= n_b)[0]
        else:
            sel = np.nonzero((lengths > prev) & (lengths <= n_b))[0]
        if sel.size:
            out.append((n_b, sel))
        prev = n_b
    return out


def slice_nodes(flat: FlatTrees, n: int) -> FlatTrees:
    """Truncate the node axis to ``n`` slots. Valid whenever every row's
    length is <= n: postorder children live at strictly smaller slots and
    pad slots are never read, so evaluation (and its VJP) over the truncated
    batch is bit-identical to the full-width program. Works on numpy and
    traced arrays alike."""
    return FlatTrees(
        flat.kind[:, :n], flat.op[:, :n], flat.lhs[:, :n], flat.rhs[:, :n],
        flat.feat[:, :n], flat.val[:, :n], flat.length,
    )


def flatten_trees(
    trees: list[Node], max_nodes: int, dtype=np.float32
) -> FlatTrees:
    """Flatten host trees into one padded postorder batch (numpy; the caller
    device_puts / donates). Trees longer than max_nodes are a bug upstream —
    constraint checking caps sizes before anything is flattened.

    Pure-Python flatten path (the JAX package's optional native srcore
    speed-up is not ported)."""
    P = len(trees)
    kind = np.zeros((P, max_nodes), dtype=np.int32)
    op = np.zeros((P, max_nodes), dtype=np.int32)
    lhs = np.zeros((P, max_nodes), dtype=np.int32)
    rhs = np.zeros((P, max_nodes), dtype=np.int32)
    feat = np.zeros((P, max_nodes), dtype=np.int32)
    val = np.zeros((P, max_nodes), dtype=dtype)
    length = np.zeros((P,), dtype=np.int32)

    for p, tree in enumerate(trees):
        post = tree.postorder()
        if len(post) > max_nodes:
            raise ValueError(
                f"tree {p} has {len(post)} nodes > max_nodes={max_nodes}"
            )
        slot_of = {}
        for i, n in enumerate(post):
            slot_of[id(n)] = i
            if n.degree == 0:
                if n.is_const:
                    kind[p, i] = KIND_CONST
                    val[p, i] = n.val
                else:
                    kind[p, i] = KIND_VAR
                    feat[p, i] = n.feat
            elif n.degree == 1:
                kind[p, i] = KIND_UNARY
                op[p, i] = n.op
                lhs[p, i] = slot_of[id(n.l)]
            else:
                kind[p, i] = KIND_BINARY
                op[p, i] = n.op
                lhs[p, i] = slot_of[id(n.l)]
                rhs[p, i] = slot_of[id(n.r)]
        length[p] = len(post)

    return FlatTrees(kind, op, lhs, rhs, feat, val, length)


class PackedPrograms(NamedTuple):
    """Pointerless packed device-IR for a batch of postorder programs.

    This is the kernel-resident form the evolve-block engine mutates in
    place: one int16 word per slot (kind in the low ``PACK_KIND_BITS`` bits,
    payload above — see PACK_* constants) plus a separate f32 constants lane.
    Child pointers are NOT stored: postorder contiguity makes them fully
    recomputable by a single stack pass (``unpack_programs`` /
    ``evolve_block._block_pointers``), which is what lets whole subtrees
    move as contiguous word ranges during mutation with no pointer fixups.

    words:  int16[P, N]  kind | payload << PACK_KIND_BITS
    consts: float[P, N]  constant value at KIND_CONST slots, exactly 0 elsewhere
    length: int32[P]     number of live slots; root at length-1
    """

    words: np.ndarray
    consts: np.ndarray
    length: np.ndarray

    @property
    def n_trees(self) -> int:
        return self.words.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.words.shape[1]


def pack_words(kind, op, feat, val, length=None, xp=np):
    """Elementwise packing shared by the numpy and traced paths: returns
    ``(words, consts)`` from FlatTrees-style field arrays (lhs/rhs are
    dropped — they are recomputable). ``xp`` is an array namespace
    (numpy here).

    Payload slots outside the live range are forced to zero through the
    kind masks (pad kind is 0 everywhere the state is canonical), so packing
    a canonical population yields canonical packed programs with zeroed
    pad words/consts — the invariants verify_packed_programs pins.
    """
    kind = xp.asarray(kind)
    payload = xp.where(
        (kind == KIND_UNARY) | (kind == KIND_BINARY),
        xp.asarray(op),
        xp.where(kind == KIND_VAR, xp.asarray(feat), 0),
    )
    words = (kind | (payload << PACK_KIND_BITS)).astype(xp.int16)
    consts = xp.where(kind == KIND_CONST, xp.asarray(val), 0).astype(
        xp.asarray(val).dtype
    )
    return words, consts


def pack_programs(flat: FlatTrees) -> PackedPrograms:
    """Pack a FlatTrees batch into the pointerless device IR (numpy)."""
    words, consts = pack_words(
        np.asarray(flat.kind), np.asarray(flat.op), np.asarray(flat.feat),
        np.asarray(flat.val), xp=np,
    )
    return PackedPrograms(words, consts, np.asarray(flat.length, np.int32))


def unpack_programs(packed: PackedPrograms, dtype=None) -> FlatTrees:
    """Exact round-trip of ``pack_programs``: rebuild the FlatTrees batch,
    reconstructing lhs/rhs child pointers with a postfix stack pass (numpy).

    Raises ValueError on stack-discipline violations (a malformed packed
    row cannot silently produce a plausible tree)."""
    words = np.asarray(packed.words)
    consts = np.asarray(packed.consts)
    length = np.asarray(packed.length, np.int32)
    P, N = words.shape
    w32 = words.astype(np.int32)
    kind = (w32 & PACK_KIND_MASK).astype(np.int32)
    payload = (w32 >> PACK_KIND_BITS).astype(np.int32)

    op = np.where(
        (kind == KIND_UNARY) | (kind == KIND_BINARY), payload, 0
    ).astype(np.int32)
    feat = np.where(kind == KIND_VAR, payload, 0).astype(np.int32)
    val = np.where(kind == KIND_CONST, consts, 0).astype(
        consts.dtype if dtype is None else dtype
    )
    lhs = np.zeros((P, N), np.int32)
    rhs = np.zeros((P, N), np.int32)

    for p in range(P):
        stack: list[int] = []
        for i in range(int(length[p])):
            k = kind[p, i]
            if k == KIND_UNARY:
                if len(stack) < 1:
                    raise ValueError(f"row {p}: unary at slot {i} underflows")
                lhs[p, i] = stack.pop()
            elif k == KIND_BINARY:
                if len(stack) < 2:
                    raise ValueError(f"row {p}: binary at slot {i} underflows")
                rhs[p, i] = stack.pop()
                lhs[p, i] = stack.pop()
            elif k == KIND_PAD:
                raise ValueError(f"row {p}: pad slot {i} inside live range")
            stack.append(i)
        if int(length[p]) and len(stack) != 1:
            raise ValueError(
                f"row {p}: {len(stack)} roots after postfix pass (want 1)"
            )
    return FlatTrees(kind, op, lhs, rhs, feat, val, length)


def unflatten_tree(flat: FlatTrees, p: int) -> Node:
    """Rebuild a host tree from batch row p (round-trip of flatten_trees)."""
    kind = np.asarray(flat.kind[p])
    op_arr = np.asarray(flat.op[p])
    lhs = np.asarray(flat.lhs[p])
    rhs = np.asarray(flat.rhs[p])
    feat = np.asarray(flat.feat[p])
    val = np.asarray(flat.val[p])
    n = int(np.asarray(flat.length[p]))

    nodes: list[Node] = []
    for i in range(n):
        k = int(kind[i])
        if k == KIND_CONST:
            # .item() keeps complex constants complex (float() would raise)
            nodes.append(Node(0, is_const=True, val=val[i].item()))
        elif k == KIND_VAR:
            nodes.append(Node(0, is_const=False, feat=int(feat[i])))
        elif k == KIND_UNARY:
            nodes.append(Node(1, op=int(op_arr[i]), l=nodes[int(lhs[i])]))
        elif k == KIND_BINARY:
            nodes.append(
                Node(2, op=int(op_arr[i]), l=nodes[int(lhs[i])], r=nodes[int(rhs[i])])
            )
        else:
            raise ValueError(f"pad slot {i} inside live range of tree {p}")
    return nodes[-1]
