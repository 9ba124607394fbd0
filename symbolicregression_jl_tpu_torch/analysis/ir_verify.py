"""Flat-IR invariant verifier.

``verify_flat_trees`` enforces the documented :class:`~..ops.flat.FlatTrees`
invariants (ops/flat.py module docstring) as *named* checks, so a corrupted
snapshot or a bad host<->device decode fails with ``[postorder] tree 3 slot
5: ...`` instead of NaNs ten iterations later:

- **postorder**: children of slot ``i`` live at slots ``< i`` (and ``>= 0``);
- **root**: the root of tree ``p`` is at slot ``length[p] - 1`` (a live,
  non-PAD slot — implied by ``pad_kind``);
- **kind_range** / **op_range** / **feat_range**: kinds, operator indices,
  and feature indices are in range for the opset/dataset;
- **pad_kind** / **pad_zero**: slots ``>= length`` are ``KIND_PAD`` and
  exactly zero in every array (live slots are never PAD);
- **length_range**: ``0 <= length <= max_nodes`` (``1 <=`` with
  ``allow_empty=False``);
- **bucket**: the node-axis width is a member of the ``bucket_sizes()``
  ladder when the caller states the full width (length-bucketed dispatch).

Everything is vectorized numpy; a full population batch verifies in
microseconds. The verifier is **callable standalone** and wired — behind the
``Options.debug_checks`` / ``SR_DEBUG_CHECKS=1`` gate — into the host->device
flatten (models/scorer.py). The gate is resolved ONCE per search into a
plain bool; with it off the hot path makes zero verifier calls.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.flat import (
    KIND_BINARY,
    KIND_CONST,
    KIND_PAD,
    KIND_UNARY,
    KIND_VAR,
    PACK_KIND_BITS,
    PACK_KIND_MASK,
    bucket_sizes,
)

__all__ = [
    "FlatIRError",
    "verify_flat_trees",
    "verify_packed_programs",
    "debug_checks_enabled",
]


class FlatIRError(ValueError):
    """A violated FlatTrees invariant. ``invariant`` names the check
    (``postorder``, ``pad_zero``, ...) and always leads the message as
    ``[invariant]`` so wrapping errors keep the name visible."""

    def __init__(self, invariant: str, message: str):
        self.invariant = invariant
        super().__init__(f"[{invariant}] {message}")


def debug_checks_enabled(options=None) -> bool:
    """Resolve the debug-checks gate: ``Options.debug_checks`` when set
    (True/False), else the ``SR_DEBUG_CHECKS`` env var. Callers resolve this
    ONCE per search into a local bool — never per hot-path call."""
    if options is not None:
        explicit = getattr(options, "debug_checks", None)
        if explicit is not None:
            return bool(explicit)
    return os.environ.get("SR_DEBUG_CHECKS", "0") == "1"


def _first_bad(mask_2d: np.ndarray) -> tuple[int, int]:
    """(tree, slot) of the first True entry of a [P, N] violation mask."""
    p, s = np.unravel_index(int(np.argmax(mask_2d)), mask_2d.shape)
    return int(p), int(s)


def verify_flat_trees(
    flat,
    opset=None,
    *,
    n_features: int | None = None,
    max_nodes: int | None = None,
    full_width: int | None = None,
    allow_empty: bool = True,
    where: str = "",
) -> None:
    """Validate a FlatTrees batch against every documented invariant.

    Parameters: ``opset`` enables the op-index range checks; ``n_features``
    the feature-index upper bound; ``max_nodes`` asserts ``length <=
    max_nodes`` beyond the array width; ``full_width`` asserts the node-axis
    width sits on the ``bucket_sizes(full_width)`` ladder (length-bucketed
    dispatch); ``allow_empty`` accepts length-0 rows (dead engine slots);
    ``where`` prefixes messages with the call site. Raises
    :class:`FlatIRError` on the first violated invariant; returns None when
    the batch is sound.
    """
    kind = np.asarray(flat.kind)
    op = np.asarray(flat.op)
    lhs = np.asarray(flat.lhs)
    rhs = np.asarray(flat.rhs)
    feat = np.asarray(flat.feat)
    val = np.asarray(flat.val)
    length = np.asarray(flat.length)

    if kind.ndim != 2:
        raise FlatIRError("shape", f"{where}kind must be [P, N], got {kind.shape}")
    P, N = kind.shape
    for name, arr in (("op", op), ("lhs", lhs), ("rhs", rhs), ("feat", feat), ("val", val)):
        if arr.shape != (P, N):
            raise FlatIRError(
                "shape", f"{where}{name} shape {arr.shape} != kind shape {(P, N)}"
            )
    if length.shape != (P,):
        raise FlatIRError(
            "shape", f"{where}length shape {length.shape} != ({P},)"
        )

    lo = 0 if allow_empty else 1
    if P and (length.min() < lo or length.max() > N):
        p = int(np.argmax((length < lo) | (length > N)))
        raise FlatIRError(
            "length_range",
            f"{where}tree {p}: length={int(length[p])} outside [{lo}, {N}]",
        )
    if max_nodes is not None and P and length.max() > max_nodes:
        p = int(np.argmax(length > max_nodes))
        raise FlatIRError(
            "length_range",
            f"{where}tree {p}: length={int(length[p])} > max_nodes={max_nodes}",
        )
    if full_width is not None:
        ladder = bucket_sizes(full_width)
        if N not in ladder and N != full_width:
            raise FlatIRError(
                "bucket",
                f"{where}node-axis width {N} is not on the bucket_sizes"
                f"({full_width}) ladder {ladder}",
            )

    if (kind < KIND_PAD).any() or (kind > KIND_BINARY).any():
        p, s = _first_bad((kind < KIND_PAD) | (kind > KIND_BINARY))
        raise FlatIRError(
            "kind_range",
            f"{where}tree {p} slot {s}: kind={int(kind[p, s])} outside "
            f"[{KIND_PAD}, {KIND_BINARY}]",
        )

    cols = np.arange(N, dtype=length.dtype)[None, :]
    live = cols < length[:, None]

    # live slots are never PAD; pad slots are exactly PAD (root at length-1
    # being a real node is a corollary)
    mism = (kind != KIND_PAD) != live
    if mism.any():
        p, s = _first_bad(mism)
        what = "PAD kind in live range" if live[p, s] else "non-PAD kind in padding"
        raise FlatIRError(
            "pad_kind", f"{where}tree {p} slot {s}: {what} (kind={int(kind[p, s])})"
        )

    # pad slots write zeros and are never read — every array must be exactly
    # zero there (the length-bucketed truncation and the bit-identity A/Bs
    # rely on this; see ops/flat.slice_nodes)
    dead = ~live
    for name, arr in (("op", op), ("lhs", lhs), ("rhs", rhs), ("feat", feat), ("val", val)):
        bad = dead & (arr != 0)
        if bad.any():
            p, s = _first_bad(bad)
            raise FlatIRError(
                "pad_zero",
                f"{where}tree {p} slot {s}: {name}={arr[p, s]} nonzero in padding",
            )

    # postorder: children strictly below their parent slot
    parent = live & (kind >= KIND_UNARY)
    bad = parent & ((lhs >= cols) | (lhs < 0))
    if bad.any():
        p, s = _first_bad(bad)
        raise FlatIRError(
            "postorder",
            f"{where}tree {p} slot {s}: lhs={int(lhs[p, s])} not in [0, {s})",
        )
    isbin = live & (kind == KIND_BINARY)
    bad = isbin & ((rhs >= cols) | (rhs < 0))
    if bad.any():
        p, s = _first_bad(bad)
        raise FlatIRError(
            "postorder",
            f"{where}tree {p} slot {s}: rhs={int(rhs[p, s])} not in [0, {s})",
        )

    if opset is not None:
        bad = isbin & ((op < 0) | (op >= opset.n_binary))
        if bad.any():
            p, s = _first_bad(bad)
            raise FlatIRError(
                "op_range",
                f"{where}tree {p} slot {s}: binary op={int(op[p, s])} outside "
                f"[0, {opset.n_binary})",
            )
        isuna = live & (kind == KIND_UNARY)
        bad = isuna & ((op < 0) | (op >= opset.n_unary))
        if bad.any():
            p, s = _first_bad(bad)
            raise FlatIRError(
                "op_range",
                f"{where}tree {p} slot {s}: unary op={int(op[p, s])} outside "
                f"[0, {opset.n_unary})",
            )

    isvar = live & (kind == KIND_VAR)
    hi = n_features if n_features is not None else None
    bad = isvar & ((feat < 0) | ((feat >= hi) if hi is not None else False))
    if bad.any():
        p, s = _first_bad(bad)
        bound = f"[0, {hi})" if hi is not None else ">= 0"
        raise FlatIRError(
            "feat_range",
            f"{where}tree {p} slot {s}: feat={int(feat[p, s])} not {bound}",
        )


def verify_packed_programs(
    packed,
    opset=None,
    *,
    n_features: int | None = None,
    allow_empty: bool = True,
    where: str = "",
) -> None:
    """Validate a :class:`~..ops.flat.PackedPrograms` batch.

    The packed IR has no stored child pointers, so postorder soundness is a
    *stack discipline* over the word stream: walking slots ``0..length-1``,
    leaves push one operand, unary ops are depth-neutral, binary ops pop one
    — the running depth must stay ``>= 1`` after every live slot and end at
    exactly 1 (named **stack**). The remaining checks mirror
    ``verify_flat_trees``: **dtype** (words are int16), **kind_range**,
    **op_range** / **feat_range** on the payload bits, **pad_kind** /
    **pad_zero** (pad words AND consts are exactly zero, consts are zero on
    every non-CONST slot), and **length_range**. Vectorized numpy throughout
    (the stack pass is a cumulative sum, not a loop). Raises
    :class:`FlatIRError` on the first violation.
    """
    words = np.asarray(packed.words)
    consts = np.asarray(packed.consts)
    length = np.asarray(packed.length)

    if words.dtype != np.int16:
        raise FlatIRError(
            "dtype", f"{where}words dtype {words.dtype} != int16"
        )
    if words.ndim != 2:
        raise FlatIRError(
            "shape", f"{where}words must be [P, N], got {words.shape}"
        )
    P, N = words.shape
    if consts.shape != (P, N):
        raise FlatIRError(
            "shape", f"{where}consts shape {consts.shape} != {(P, N)}"
        )
    if length.shape != (P,):
        raise FlatIRError(
            "shape", f"{where}length shape {length.shape} != ({P},)"
        )

    lo = 0 if allow_empty else 1
    if P and (length.min() < lo or length.max() > N):
        p = int(np.argmax((length < lo) | (length > N)))
        raise FlatIRError(
            "length_range",
            f"{where}row {p}: length={int(length[p])} outside [{lo}, {N}]",
        )

    w32 = words.astype(np.int32)
    kind = w32 & PACK_KIND_MASK
    payload = w32 >> PACK_KIND_BITS

    if (kind > KIND_BINARY).any() or (w32 < 0).any():
        p, s = _first_bad((kind > KIND_BINARY) | (w32 < 0))
        raise FlatIRError(
            "kind_range",
            f"{where}row {p} slot {s}: word={int(w32[p, s])} has kind "
            f"{int(kind[p, s])} outside [{KIND_PAD}, {KIND_BINARY}]",
        )

    cols = np.arange(N, dtype=length.dtype)[None, :]
    live = cols < length[:, None]

    mism = (kind != KIND_PAD) != live
    if mism.any():
        p, s = _first_bad(mism)
        what = "PAD kind in live range" if live[p, s] else "non-PAD word in padding"
        raise FlatIRError(
            "pad_kind",
            f"{where}row {p} slot {s}: {what} (word={int(w32[p, s])})",
        )

    # payload must be zero wherever it has no meaning (CONST slots and
    # padding carry no payload), and consts exactly zero off CONST slots —
    # canonical zeros are what make packed A/B comparisons bitwise.
    bad = (kind <= KIND_CONST) & (payload != 0)
    if bad.any():
        p, s = _first_bad(bad)
        raise FlatIRError(
            "pad_zero",
            f"{where}row {p} slot {s}: payload={int(payload[p, s])} nonzero "
            f"on kind={int(kind[p, s])}",
        )
    bad = (kind != KIND_CONST) & (consts != 0)
    if bad.any():
        p, s = _first_bad(bad)
        raise FlatIRError(
            "pad_zero",
            f"{where}row {p} slot {s}: consts={consts[p, s]} nonzero on "
            f"non-CONST slot",
        )

    # stack discipline: +1 leaf, 0 unary, -1 binary; running depth >= 1 at
    # every live slot, == 1 at the root. This is the pointerless postorder
    # invariant — a cumsum over the delta stream checks every row at once.
    delta = np.where(
        live & (kind <= KIND_VAR) & (kind >= KIND_CONST),
        1,
        np.where(live & (kind == KIND_BINARY), -1, 0),
    )
    depth = np.cumsum(delta, axis=1)
    bad = live & (depth < 1)
    if bad.any():
        p, s = _first_bad(bad)
        raise FlatIRError(
            "stack",
            f"{where}row {p} slot {s}: operand stack underflows "
            f"(depth={int(depth[p, s])})",
        )
    if P:
        final = np.where(
            length > 0, depth[np.arange(P), np.maximum(length - 1, 0)], 1
        )
        if (final != 1).any():
            p = int(np.argmax(final != 1))
            raise FlatIRError(
                "stack",
                f"{where}row {p}: {int(final[p])} operands left after the "
                f"postfix pass (want 1)",
            )

    if opset is not None:
        bad = live & (kind == KIND_BINARY) & (payload >= opset.n_binary)
        if bad.any():
            p, s = _first_bad(bad)
            raise FlatIRError(
                "op_range",
                f"{where}row {p} slot {s}: binary op={int(payload[p, s])} "
                f"outside [0, {opset.n_binary})",
            )
        bad = live & (kind == KIND_UNARY) & (payload >= opset.n_unary)
        if bad.any():
            p, s = _first_bad(bad)
            raise FlatIRError(
                "op_range",
                f"{where}row {p} slot {s}: unary op={int(payload[p, s])} "
                f"outside [0, {opset.n_unary})",
            )

    if n_features is not None:
        bad = live & (kind == KIND_VAR) & (payload >= n_features)
        if bad.any():
            p, s = _first_bad(bad)
            raise FlatIRError(
                "feat_range",
                f"{where}row {p} slot {s}: feat={int(payload[p, s])} outside "
                f"[0, {n_features})",
            )
