"""Sharded scoring: population-parallel x row-parallel loss over a mesh.

Counterpart of ``symbolicregression_jl_tpu/parallel/sharding.py``: trees
shard across the mesh's 'pop' axis and dataset rows across its 'rows' axis;
each (pop shard x rows shard) block is scored on its device, and only the
per-tree partials are combined, as the JAX package's ``psum`` combines
them: the weighted numerator and the denominator, each summed in f64
across the row shards. A tree whose predictions are not all finite on any
shard scores inf (the JAX package's ``pmin`` of ``ok``).

A block is B1 (``ops/interp_cuda.fused_loss``) over the shard's rows: the
kernel on a CUDA device, its plain version on the CPU; a configuration B1
does not take (user operators or losses, f64) runs the same plain function
(``plain_losses``). B1 returns a per-tree mean, so each block's partial
numerator is its mean times its denominator (the shard's row count, or the
sum of its weights). The combined loss therefore rounds each block's mean
to f32 before the combination: it agrees with one B1 call over all rows to
f32 tolerance, not bit for bit. A row shard whose weights sum to 0 adds
nothing, and its predictions do not enter the ``ok`` rule (B1 reports such
a block as not ok whatever its predictions).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..ops.flat import FlatTrees
from ..ops.operators import OperatorSet
from .mesh import Mesh, Sharding, data_sharding, population_sharding

__all__ = ["make_sharded_loss", "shard_dataset", "shard_population"]


@dataclasses.dataclass
class Sharded:
    """An array placed on a mesh: ``blocks[(i, j)]`` is the block that mesh
    entry (i, j) holds (entries that name one device for one block share
    its tensor). ``shape`` is the global shape. ``packed`` holds a
    population's programs as the loss packed them for each device."""

    sharding: Sharding
    blocks: dict
    shape: tuple
    packed: dict = dataclasses.field(default_factory=dict)


def _split(n: int, parts: int, what: str) -> list[slice]:
    if n % parts:
        raise ValueError(f"{what} ({n}) is not divisible by the mesh axis ({parts}); "
                         "pad it to the mesh divisor first")
    k = n // parts
    return [slice(j * k, (j + 1) * k) for j in range(parts)]


def _place_rows(mesh: Mesh, a, row_axis: int) -> Sharded:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    n_pop, n_rows = mesh.devices.shape
    spans = _split(t.shape[row_axis], n_rows, "rows")
    placed, blocks = {}, {}
    for i in range(n_pop):
        for j in range(n_rows):
            dev = mesh.devices[i, j]
            key = (str(dev), j)
            if key not in placed:
                idx = [slice(None)] * t.dim()
                idx[row_axis] = spans[j]
                placed[key] = t[tuple(idx)].contiguous().to(dev)
            blocks[(i, j)] = placed[key]
    spec = data_sharding(mesh) if t.dim() == 2 else Sharding(mesh, ("rows",))
    return Sharded(spec, blocks, tuple(t.shape))


def shard_dataset(mesh: Mesh, X, y, weights=None):
    """Place dataset arrays row-sharded on the mesh: X [F, R], y and
    weights [R]. The rows must divide over the 'rows' axis."""
    Xs = _place_rows(mesh, X, 1)
    ys = _place_rows(mesh, y, 0)
    ws = None if weights is None else _place_rows(mesh, weights, 0)
    return Xs, ys, ws


def shard_population(mesh: Mesh, flat: FlatTrees) -> Sharded:
    """A FlatTrees batch tree-sharded across the 'pop' axis: block (i, j)
    is pop shard i (host arrays; the loss packs and uploads each to its
    device). The trees must divide over the 'pop' axis."""
    n_pop, n_rows = mesh.devices.shape
    P = int(np.asarray(flat.length).shape[0])
    spans = _split(P, n_pop, "trees")
    blocks = {}
    for i in range(n_pop):
        part = FlatTrees(*(np.asarray(a)[spans[i]] for a in flat))
        for j in range(n_rows):
            blocks[(i, j)] = part
    return Sharded(population_sharding(mesh), blocks, (P,) + tuple(np.shape(flat.kind)[1:]))


def make_sharded_loss(
    mesh: Mesh, opset: OperatorSet, loss_elem: Callable, has_weights: bool = False
) -> Callable:
    """Build the loss over the mesh: (flat[P,N], X[F,R], y[R], w[R]?) ->
    losses [P] f32 on the mesh's first device, with P sharded over 'pop'
    and R over 'rows'. Unsharded arguments are sharded on the way in;
    ``w`` is ignored unless ``has_weights``."""
    from ..ops.interp_cuda import fused_loss, loss_kernel_eligible, pack_programs_fused, plain_losses

    n_pop, n_rows = mesh.devices.shape
    out_dev = mesh.devices[0, 0]

    def block_losses(i, j, fs, X, y, w):
        dev = mesh.devices[i, j]
        part = fs.blocks[(i, j)]
        Xb, yb = X.blocks[(i, j)], y.blocks[(i, j)]
        wb = w.blocks[(i, j)] if has_weights else None
        if loss_kernel_eligible(opset, loss_elem, str(Xb.dtype).removeprefix("torch.")):
            key = (i, str(dev))
            if key not in fs.packed:
                prog, vals = pack_programs_fused(part, opset)
                fs.packed[key] = (torch.from_numpy(prog).to(dev), torch.from_numpy(vals).to(dev))
            prog, vals = fs.packed[key]
            from ..models.scorer import cached_optab

            return fused_loss(prog, vals, Xb, yb, wb, opset, loss_elem,
                              cached_optab(opset, dev))
        vals = torch.as_tensor(np.asarray(part.val)).to(device=dev, dtype=Xb.dtype)
        return plain_losses(part, vals, Xb, yb, wb, opset, loss_elem)

    def loss(flat, X, y, w=None):
        fs = flat if isinstance(flat, Sharded) else shard_population(mesh, flat)
        if not isinstance(X, Sharded):
            X, y, w = shard_dataset(mesh, X, y, w if has_weights else None)
        outs = []
        for i in range(n_pop):
            num = den = None
            ok = None
            for j in range(n_rows):
                lj = block_losses(i, j, fs, X, y, w).to(out_dev)
                if has_weights:
                    dj = w.blocks[(i, j)].double().sum().to(out_dev)
                else:
                    dj = torch.tensor(float(y.blocks[(i, j)].shape[0]), dtype=torch.float64,
                                      device=out_dev)
                fine = torch.isfinite(lj) | (dj == 0)
                part = torch.where(dj == 0, 0.0, lj.double() * dj)
                num = part if num is None else num + part
                den = dj if den is None else den + dj
                ok = fine if ok is None else ok & fine
            outs.append(torch.where(ok, (num / den).float(), torch.inf))
        return torch.cat(outs)

    return loss
