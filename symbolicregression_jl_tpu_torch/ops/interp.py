"""Plain batched interpreter for flat expression trees, in PyTorch.

Counterpart of ``symbolicregression_jl_tpu/ops/interp.py``. Same structure:
a postorder sweep over slots that writes an SSA value buffer ``[P, N, R]``
(trees x slots x rows), vectorized over the population and the rows.

Where the JAX scan evaluates every operator branch for every tree and
selects, this sweep groups the trees of each slot by (kind, operator) on the
host once per batch (``Plan``) and runs each operator only on its own trees:
one gather, one operator call and one scatter per group.

Differentiation: the JAX package's custom VJP becomes ``_EvalTrees``, a
``torch.autograd.Function``. Every slot is written exactly once, so the
forward buffer IS the complete tape, and the backward pass is one reverse
sweep propagating adjoints to children: O(N·R) memory per tree. Operator
pullbacks come from autograd on the operator's own torch fn.

``eval_plan_autograd`` is the same forward with autograd recording every
step; it supports higher derivatives (the Newton curvature of constant
optimization) at the cost of keeping every intermediate.

NaN semantics: invalid math yields NaN/Inf at the root (safe operators,
ops/operators.py); ``ok = isfinite(pred).all(rows)`` reproduces the
reference's ``completed`` flag (SymbolicRegression.jl
src/LossFunctions.jl:55-57).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .flat import KIND_BINARY, KIND_CONST, KIND_UNARY, KIND_VAR, FlatTrees
from .operators import OperatorSet

__all__ = [
    "Plan",
    "make_plan",
    "eval_plan",
    "eval_plan_autograd",
    "eval_trees",
    "eval_trees_with_ok",
    "eval_grad_trees",
    "eval_diff_trees",
]


class Plan:
    """Host-built schedule of one flat batch on one device.

    ``slots[i]`` lists the groups live at slot ``i`` as
    ``(kind, op, rows, a, b)``: the tree rows of the group, and per row the
    left-child slot (unary/binary) or feature index (var) in ``a`` and the
    right-child slot in ``b``. All index tensors are views of one upload."""

    def __init__(self, flat: FlatTrees, opset: OperatorSet, device):
        kind = np.asarray(flat.kind)
        op = np.asarray(flat.op)
        lhs = np.asarray(flat.lhs)
        rhs = np.asarray(flat.rhs)
        feat = np.asarray(flat.feat)
        length = np.asarray(flat.length)
        self.opset = opset
        self.P, self.N = kind.shape
        spans = []  # (slot, kind, op, start, stop)
        rows_l, a_l, b_l = [], [], []
        n = 0
        for i in range(self.N):
            k_i, o_i = kind[:, i], op[:, i]
            live = np.nonzero(k_i != 0)[0]
            if live.size == 0:
                continue
            # one group per (kind, op) present at this slot
            key = k_i[live].astype(np.int64) * 4096 + np.where(
                (k_i[live] == KIND_UNARY) | (k_i[live] == KIND_BINARY), o_i[live], 0
            )
            order = np.argsort(key, kind="stable")
            live, key = live[order], key[order]
            cuts = np.nonzero(np.diff(key))[0] + 1
            for rows in np.split(live, cuts):
                kk = int(k_i[rows[0]])
                if kk == KIND_VAR:
                    a = feat[rows, i]
                else:
                    a = lhs[rows, i]
                spans.append((i, kk, int(o_i[rows[0]]), n, n + rows.size))
                rows_l.append(rows)
                a_l.append(a)
                b_l.append(rhs[rows, i])
                n += rows.size
        cat = (
            np.stack([np.concatenate(rows_l), np.concatenate(a_l), np.concatenate(b_l)])
            if rows_l
            else np.zeros((3, 0), np.int64)
        )
        idx = torch.from_numpy(cat.astype(np.int64)).to(device)
        self.slots: list[list[tuple]] = [[] for _ in range(self.N)]
        for i, kk, o, s, e in spans:
            self.slots[i].append((kk, o, idx[0, s:e], idx[1, s:e], idx[2, s:e]))
        self.root = torch.from_numpy(
            np.maximum(length.astype(np.int64) - 1, 0)
        ).to(device)
        self.rows = torch.arange(self.P, device=device)


def make_plan(flat: FlatTrees, opset: OperatorSet, device) -> Plan:
    return Plan(flat, opset, device)


def _forward(plan: Plan, val: torch.Tensor, X: torch.Tensor):
    """Fill the value buffer slot by slot. Returns (pred [P, R], buf)."""
    opset = plan.opset
    R = X.shape[1]
    buf = X.new_zeros((plan.P, plan.N, R))
    for i, groups in enumerate(plan.slots):
        for kk, o, rows, a, b in groups:
            if kk == KIND_CONST:
                res = val[rows, i].to(X.dtype)[:, None].expand(-1, R)
            elif kk == KIND_VAR:
                res = X[a]
            elif kk == KIND_UNARY:
                res = opset.unary[o].fn(buf[rows, a])
            else:
                res = opset.binary[o].fn(buf[rows, a], buf[rows, b])
            buf[rows, i] = res.to(X.dtype)
    pred = buf[plan.rows, plan.root]
    return pred, buf


def _vjp(fn, xs, ct):
    """Pullback of ``fn`` at ``xs`` contracted with ``ct``."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True) for x in xs]
        out = fn(*xs)
        if not out.requires_grad:
            return [torch.zeros_like(x) for x in xs]
        grads = torch.autograd.grad(out, xs, ct, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads)]


def _reverse_sweep(plan: Plan, buf, g_pred, F: int, per_row: bool, need_x: bool):
    """Reverse-postorder adjoint sweep over the forward buffer.

    Returns (g_val, g_X): g_val is [P, N] (row-summed) or [P, N, R]
    (per_row); g_X is the per-tree [P, F, R] feature adjoint, or None."""
    opset = plan.opset
    P, N, R = buf.shape
    gbuf = torch.zeros_like(buf)
    gbuf[plan.rows, plan.root] = g_pred.to(buf.dtype)
    gval = buf.new_zeros((P, N, R) if per_row else (P, N))
    gX = buf.new_zeros((P, F, R)) if need_x else None
    for i in range(N - 1, -1, -1):
        for kk, o, rows, a, b in plan.slots[i]:
            adj = gbuf[rows, i]
            if kk == KIND_CONST:
                gval[rows, i] = adj if per_row else adj.sum(-1)
            elif kk == KIND_VAR:
                if gX is not None:
                    gX.index_put_((rows, a), adj, accumulate=True)
            elif kk == KIND_UNARY:
                (dl,) = _vjp(opset.unary[o].fn, [buf[rows, a]], adj)
                gbuf.index_put_((rows, a), dl, accumulate=True)
            else:
                dl, dr = _vjp(opset.binary[o].fn, [buf[rows, a], buf[rows, b]], adj)
                gbuf.index_put_((rows, a), dl, accumulate=True)
                gbuf.index_put_((rows, b), dr, accumulate=True)
    return gval, gX


class _EvalTrees(torch.autograd.Function):
    """pred = eval(val, X) with the reverse-sweep VJP."""

    @staticmethod
    def forward(ctx, val, X, plan):
        pred, buf = _forward(plan, val, X)
        ctx.plan = plan
        ctx.buf = buf
        ctx.F = X.shape[0]
        return pred

    @staticmethod
    @once_differentiable
    def backward(ctx, g_pred):
        need_x = ctx.needs_input_grad[1]
        gval, gX = _reverse_sweep(ctx.plan, ctx.buf, g_pred, ctx.F, False, need_x)
        ctx.buf = None
        return gval, (gX.sum(0) if need_x else None), None


def eval_plan(plan: Plan, val: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """preds [P, R] of the planned batch with constants ``val`` [P, N];
    differentiable in ``val`` (and X) through the reverse sweep."""
    return _EvalTrees.apply(val, X, plan)


def eval_plan_autograd(plan: Plan, val: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """The same forward recorded step by step by autograd (higher-order
    derivatives; keeps every intermediate)."""
    return _forward(plan, val, X)[0]


def _as_tensor(X, device=None):
    if isinstance(X, torch.Tensor):
        return X if device is None else X.to(device)
    return torch.from_numpy(np.ascontiguousarray(X)).to(device or "cpu")


def _val_tensor(flat: FlatTrees, X: torch.Tensor) -> torch.Tensor:
    if isinstance(flat.val, torch.Tensor):
        return flat.val.to(X.device)
    return torch.from_numpy(np.ascontiguousarray(flat.val)).to(X.device)


def eval_trees(flat: FlatTrees, X, opset: OperatorSet) -> torch.Tensor:
    """Evaluate a batch of trees: FlatTrees[P,N] x X[F,R] -> preds[P,R],
    on X's device."""
    X = _as_tensor(X)
    plan = make_plan(flat, opset, X.device)
    with torch.no_grad():
        return _forward(plan, _val_tensor(flat, X), X)[0]


def eval_trees_with_ok(flat: FlatTrees, X, opset: OperatorSet):
    """As eval_trees, plus the per-tree ``completed`` flag: all rows finite."""
    preds = eval_trees(flat, X, opset)
    return preds, torch.isfinite(preds).all(dim=-1)


def eval_grad_trees(
    flat: FlatTrees, X, opset: OperatorSet, wrt: str = "constants"
) -> torch.Tensor:
    """Per-row gradients of each tree's prediction — the counterpart of the
    reference's ``eval_grad_tree_array`` (SymbolicRegression.jl
    src/InterfaceDynamicExpressions.jl:118-124), from one reverse sweep with
    a unit cotangent (rows are independent, so per-row adjoints are the
    per-row derivatives).

    wrt="features": d(pred)/d(X) of shape [P, F, R].
    wrt="constants": d(pred)/d(val) of shape [P, N, R]; non-constant slots
    are zero."""
    if wrt not in ("features", "constants"):
        raise ValueError(f"wrt must be 'features' or 'constants', got {wrt!r}")
    X = _as_tensor(X)
    plan = make_plan(flat, opset, X.device)
    with torch.no_grad():
        pred, buf = _forward(plan, _val_tensor(flat, X), X)
        gval, gX = _reverse_sweep(
            plan, buf, torch.ones_like(pred), X.shape[0], True, wrt == "features"
        )
    return gX if wrt == "features" else gval


def eval_diff_trees(flat: FlatTrees, X, opset: OperatorSet, direction: int) -> torch.Tensor:
    """Directional derivative d(pred)/d(x_direction) per row: [P, R]
    (reference ``eval_diff_tree_array``)."""
    return eval_grad_trees(flat, X, opset, wrt="features")[:, direction, :]
