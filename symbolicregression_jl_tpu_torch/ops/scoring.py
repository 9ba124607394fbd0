"""Batched scoring on the plain interpreter.

Counterpart of ``symbolicregression_jl_tpu/ops/scoring.py`` (the reference's
score_func / eval_loss path, SymbolicRegression.jl
src/LossFunctions.jl:97-194): every call evaluates a whole batch of candidate
trees against the dataset at once. Incomplete evaluations (NaN/Inf at the
root) get ``inf`` loss (src/LossFunctions.jl:55-57).

This is the path for what the fused CUDA loss kernel does not take (user
operators or losses, f64); ``ops/interp_cuda.py`` holds the kernel path.

``loss_to_score`` is host-side numpy:
score = loss / max(baseline, 0.01) + complexity * parsimony
(src/LossFunctions.jl:138-158).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .flat import FlatTrees, length_buckets, length_buckets_enabled, slice_nodes
from .interp import eval_trees
from .losses import weighted_mean_loss
from .operators import OperatorSet

__all__ = [
    "batched_loss",
    "batched_loss_bucketed",
    "loss_to_score",
    "baseline_loss",
]


def batched_loss(
    flat: FlatTrees,
    X: torch.Tensor,
    y: torch.Tensor,
    weights: torch.Tensor | None,
    opset: OperatorSet,
    loss_elem: Callable,
) -> torch.Tensor:
    """Losses for a batch of trees: [P] on X's device; inf where evaluation
    is invalid."""
    preds = eval_trees(flat, X, opset)
    elem = loss_elem(preds, y[None, :])
    losses = weighted_mean_loss(elem, None if weights is None else weights[None, :])
    ok = torch.isfinite(preds).all(dim=-1)
    return torch.where(ok, losses, torch.inf)


def batched_loss_bucketed(
    flat: FlatTrees,
    X: torch.Tensor,
    y: torch.Tensor,
    weights: torch.Tensor | None,
    opset: OperatorSet,
    loss_elem: Callable,
) -> Callable[[], np.ndarray]:
    """Length-bucketed scoring over a host (numpy) flat batch.

    Partitions the batch by tree length (``length_buckets``) and evaluates
    each bucket at its own node count instead of the global max_nodes, which
    bounds the value buffer by the bucket's width. Losses equal the
    full-width evaluation: pad slots are never read.

    Returns a zero-arg materializer yielding float64 [P] losses in input
    order."""
    lengths = np.asarray(flat.length)
    P, N = flat.kind.shape
    parts = length_buckets(lengths, N)
    if not length_buckets_enabled() or len(parts) == 1:
        dev = batched_loss(flat, X, y, weights, opset, loss_elem)
        return lambda: dev.detach().cpu().numpy().astype(np.float64)
    pending = []
    for n_b, sel in parts:
        sub = FlatTrees(*(np.asarray(a)[sel] for a in flat))
        pending.append(
            (sel, batched_loss(slice_nodes(sub, n_b), X, y, weights, opset, loss_elem))
        )

    def materialize() -> np.ndarray:
        out = np.empty((P,), dtype=np.float64)
        for sel, dev in pending:
            out[sel] = dev.detach().cpu().numpy()
        return out

    return materialize


def loss_to_score(
    loss,
    complexity,
    *,
    use_baseline: bool,
    baseline: float,
    parsimony: float,
):
    """Normalized loss + parsimony penalty (host-side numpy; see module doc)."""
    normalization = baseline if (use_baseline and baseline >= 0.01) else 0.01
    return np.asarray(loss) / normalization + np.asarray(complexity) * parsimony


def baseline_loss(dataset, opset: OperatorSet, loss_elem, dtype=np.float32, device="cpu"):
    """Loss of the constant avg_y predictor (reference: update_baseline_loss!,
    SymbolicRegression.jl src/LossFunctions.jl:201-215). Returns
    (baseline, use)."""
    X, y, w = dataset.device_arrays(dtype, device)
    pred = torch.full((dataset.n,), dataset.avg_y, dtype=y.dtype, device=y.device)
    elem = loss_elem(pred[None, :], y[None, :])
    val = float(weighted_mean_loss(elem, None if w is None else w[None, :])[0])
    if np.isfinite(val):
        return val, True
    return 1.0, False
