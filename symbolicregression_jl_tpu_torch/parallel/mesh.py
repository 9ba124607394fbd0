"""Device meshes over explicit torch devices.

Counterpart of ``symbolicregression_jl_tpu/parallel/mesh.py``. The
framework's two parallel axes:
  - ``pop``:  island/population axis — embarrassingly parallel tree batches,
  - ``rows``: dataset-row axis — data-parallel loss reduction (the weighted
              numerator and the denominator are summed across row shards).

A :class:`Mesh` is a [n_pop, n_rows] grid of torch devices; the shardings
are plain descriptors of which array axis splits over which mesh axis
(``parallel/sharding.py`` places and scores the blocks). A mesh may name one
device more than once: ``make_mesh(1, 2, devices=[cuda:0, cuda:0])`` splits
the rows in two on a machine with one card, and the CPU tests split them
over ``cpu`` the same way.

The JAX package's ``shard_map_compat`` and ``intra_host_pool_merge`` serve
its engine's in-process mesh (islands sharded over local devices), which is
not part of this package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Mesh", "Sharding", "make_mesh", "population_sharding", "data_sharding"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array [n_pop, n_rows] of ``torch.device``."""

    devices: np.ndarray
    axis_names: tuple = ("pop", "rows")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which mesh axis splits each array axis (None: replicated), the
    counterpart of a ``NamedSharding(mesh, PartitionSpec(...))``."""

    mesh: Mesh
    spec: tuple


def _default_devices() -> list:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_pop: int | None = None, n_rows: int = 1, devices: list | None = None) -> Mesh:
    """Create a ('pop', 'rows') mesh over ``devices`` (default: every CUDA
    device, else the CPU). Default: all devices on the pop axis."""
    devices = [torch.device(d) for d in (devices if devices is not None else _default_devices())]
    n = len(devices)
    if n_pop is None:
        n_pop = n // n_rows
    if n_pop * n_rows != n:
        raise ValueError(f"mesh {n_pop}x{n_rows} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n_pop, n_rows))


def population_sharding(mesh: Mesh) -> Sharding:
    """FlatTrees arrays [P, N]: shard trees across 'pop', replicate slots."""
    return Sharding(mesh, ("pop", None))


def data_sharding(mesh: Mesh) -> Sharding:
    """X [F, R]: shard the row axis across 'rows' (y and w [R] likewise)."""
    return Sharding(mesh, (None, "rows"))
