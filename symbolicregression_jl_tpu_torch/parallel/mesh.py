"""Device meshes over explicit torch devices, and the in-process shard_map.

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

``shard_map(f, mesh, per_shard_args)`` is the counterpart of the JAX
package's ``shard_map_compat``: it runs ``f`` once per shard, each shard in
a thread of its own under ``torch.cuda.device(shard's device)``, and hands
it a :class:`Shard` whose :class:`Axis` handles (``shard.axis("pop")``,
``shard.axis("rows")``) give the shard's ``index`` and the axis ``size`` and
the collectives ``all_gather``, ``psum`` and ``pmin``. The shards of one
axis group (the shards that share the other axis's index) meet at a
``threading.Barrier`` with a timeout (``BARRIER_TIMEOUT_S``, 600 s): a
shard that raises aborts every barrier of the mesh, so each shard raises
and none hangs, and ``shard_map`` re-raises the first error. The shards'
host work is Python and torch dispatch under one GIL, so one shard thread
runs at a time, from one collective to the next, handing over at the
barrier or while it waits for its device (``host_wait``); the cards run
every shard's queued work at once.

The transport of a group is chosen from its device names, never by
probing: distinct CUDA cards gather with ``torch.cuda.nccl.all_gather`` (one
process; torch makes one NCCL communicator per device set, once), each
shard's part on that shard's current stream; a group that names one device
twice, or the CPU, gathers with copies onto each shard's device. Every
reduction is an
all-gather followed by a sum (or a min) in shard order, so its bits do not
depend on how the shards are laid out: four shards over ``cuda:0..3`` and
four shards on ``cuda:0`` reduce alike. No collective synchronizes the host
with a device: the barrier is host-side, and the gather is enqueued on the
shards' streams.

``local_devices(device)`` is where the engine and the row-sharded scorer
take their device lists from: ``"cuda"`` (no index) means every visible
card, as the JAX package means ``jax.local_devices()``; ``"cuda:N"`` that
card alone; ``"cpu"`` one CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

__all__ = [
    "Mesh", "Sharding", "make_mesh", "population_sharding", "data_sharding", "local_devices",
    "indexed_device", "shard_map", "Shard", "Axis", "MeshAborted", "intra_host_pool_merge",
    "collective_stats", "reset_collective_stats", "mesh_axis", "device_scope", "host_wait",
    "warm_up",
]

AXES = ("pop", "rows")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array [n_pop, n_rows] of ``torch.device``. The
    mesh's collective groups (``shard_map``) are made at first use and kept
    with it."""

    devices: np.ndarray
    axis_names: tuple = AXES
    _groups: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, k: int) -> tuple:
        """The (pop, rows) position of flat shard ``k`` (row-major)."""
        return divmod(k, self.devices.shape[1])

    def device_list(self) -> list:
        """Every shard's device, in flat shard order."""
        return list(self.devices.reshape(-1))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which mesh axis splits each array axis (None: replicated), the
    counterpart of a ``NamedSharding(mesh, PartitionSpec(...))``."""

    mesh: Mesh
    spec: tuple


def local_devices(device) -> list:
    """The devices a search on ``device`` may shard over: every visible card
    for ``"cuda"`` (no index), the one card for ``"cuda:N"``, one CPU for
    ``"cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return [torch.device("cuda", i) for i in range(max(n, 1))]
    return [device]


def indexed_device(device) -> torch.device:
    """``device`` with its card's index (``"cuda"`` names the current card):
    the key of every per-device cache, so ``"cuda"`` and ``"cuda:0"`` share
    one entry and ``"cuda:1"`` has its own."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_pop: int | None = None, n_rows: int = 1, devices: list | None = None) -> Mesh:
    """Create a ('pop', 'rows') mesh over ``devices`` (default: every CUDA
    device, else the CPU). Default: all devices on the pop axis."""
    if devices is None:
        devices = local_devices("cuda") if torch.cuda.is_available() else ["cpu"]
    devices = [torch.device(d) for d in devices]
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


# ---------------------------------------------------------------------------
# shard_map and the collectives
# ---------------------------------------------------------------------------


class MeshAborted(RuntimeError):
    """A collective could not complete: another shard raised, or the group's
    barrier timed out."""


# how long a shard waits at a collective for the rest of its group
BARRIER_TIMEOUT_S = 600.0


class _Turns:
    """Which shard thread may run: one at a time, from one collective to the
    next, handing over at the barrier. The shards' host work is Python and
    torch dispatch under one GIL, and threads that all want the GIL at
    every torch call slow each other down more than taking turns does (the
    devices still run every shard's queued work at once)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()

    def enter(self) -> None:
        self.lock.acquire()
        self.local.held = True

    def leave(self) -> None:
        if getattr(self.local, "held", False):
            self.local.held = False
            self.lock.release()

    @contextlib.contextmanager
    def paused(self):
        """Let the other shards run while this one waits at a barrier."""
        held = getattr(self.local, "held", False)
        if held:
            self.leave()
        try:
            yield
        finally:
            if held:
                self.enter()


_CURRENT = threading.local()


@contextlib.contextmanager
def host_wait():
    """Around a host synchronization in a shard (the constant
    optimization's stop tests): the other shards run while this one waits
    for its device. Nothing outside ``shard_map``."""
    turns = getattr(_CURRENT, "turns", None)
    if turns is None:
        yield
        return
    with turns.paused():
        yield


class _Group:
    """The shards of one axis group: their devices (in axis order), the
    barrier they meet at, the transport, and the counts of what crossed."""

    def __init__(self, devices: list, turns: "_Turns"):
        self.devices = devices
        self.turns = turns
        self.size = len(devices)
        cuda = all(d.type == "cuda" for d in devices)
        distinct = len({str(d) for d in devices}) == len(devices)
        self.transport = "nccl" if cuda and distinct and self.size > 1 else "copy"
        self.inputs: list = [None] * self.size
        self.streams: list = [None] * self.size
        self.outputs: list = [None] * self.size
        self.timeout = BARRIER_TIMEOUT_S
        self.barrier = threading.Barrier(self.size, action=self._gather, timeout=self.timeout)
        self.gathers = 0
        self.bytes = 0
        self.gather_seconds = 0.0
        self.wait_seconds = 0.0
        self._lock = threading.Lock()

    def _gather(self) -> None:
        """The barrier's action, run by the last shard to arrive: every
        shard's part, stacked in axis order, onto every shard's device."""
        t0 = time.perf_counter()
        ins = self.inputs
        shape, dtype = ins[0].shape, ins[0].dtype
        for t in ins:
            if t.shape != shape or t.dtype != dtype:
                raise MeshAborted(f"all_gather: parts differ ({[tuple(x.shape) for x in ins]}, "
                                  f"{[x.dtype for x in ins]})")
        if self.transport == "nccl":
            import torch.cuda.nccl as nccl

            outs = [torch.empty((self.size, *shape), dtype=dtype, device=d)
                    for d in self.devices]
            nccl.all_gather(ins, outs, streams=self.streams)
        else:
            stacked, outs = {}, []
            for d in self.devices:
                key = str(d)
                if key not in stacked:
                    stacked[key] = torch.stack([t.to(d) for t in ins])
                outs.append(stacked[key])
        self.outputs = outs
        self.inputs = [None] * self.size
        self.gathers += 1
        self.bytes += ins[0].numel() * ins[0].element_size() * self.size
        self.gather_seconds += time.perf_counter() - t0

    def all_gather(self, index: int, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        self.inputs[index] = t
        self.streams[index] = torch.cuda.current_stream(t.device) if t.is_cuda else None
        t0 = time.perf_counter()
        try:
            with self.turns.paused():
                self.barrier.wait()
        except threading.BrokenBarrierError:
            raise MeshAborted("a collective was aborted (another shard raised, or the "
                              f"barrier's {self.timeout} s timeout passed)") from None
        with self._lock:
            self.wait_seconds += time.perf_counter() - t0
        return self.outputs[index]


class Axis:
    """One shard's handle on one mesh axis: ``index`` (the shard's position
    on the axis) and ``size``, and the collectives over the shards of its
    group. Valid while the shards run in ``shard_map``."""

    def __init__(self, name: str, group: _Group, index: int):
        self.name, self._group, self.index = name, group, index
        self.size = group.size

    @property
    def device(self) -> torch.device:
        return self._group.devices[self.index]

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every shard's ``t`` in axis order, on this
        shard's device (an axis of one shard gathers nothing)."""
        if self.size == 1:
            return t.unsqueeze(0)
        return self._group.all_gather(self.index, t)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every shard's ``t``, added in axis order."""
        g = self.all_gather(t)
        out = g[0]
        for k in range(1, self.size):
            out = out + g[k]
        return out

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        return torch.amin(self.all_gather(t), dim=0)


class Shard:
    """What ``f`` sees in ``shard_map``: the flat index ``k``, the (pop,
    rows) coordinates, the device, and the axis handles."""

    def __init__(self, mesh: Mesh, k: int, running: set):
        self.mesh, self.k = mesh, k
        self.coords = mesh.coords(k)
        self.device = mesh.devices[self.coords]
        self._running = running

    def axis(self, name: str) -> Axis:
        i, j = self.coords
        n_pop, n_rows = self.mesh.devices.shape
        members = ([q * n_rows + j for q in range(n_pop)] if name == "pop"
                   else [i * n_rows + q for q in range(n_rows)])
        if not set(members) <= self._running:
            raise ValueError(f"axis {name!r}: shard_map runs only part of shard {self.k}'s group")
        return mesh_axis(self.mesh, name, self.k)


def mesh_axis(mesh: Mesh, name: str, k: int) -> Axis:
    """The persistent handle of shard ``k`` on axis ``name`` (what
    ``Shard.axis`` gives that shard), for objects made before the shards run
    and used inside them (the engine's row-combining scorers)."""
    ax = mesh._groups.get(("axis", name, k))
    if ax is None:
        _ensure_groups(mesh)
        ax = mesh._groups[("axis", name, k)]
    return ax


def _ensure_groups(mesh: Mesh) -> None:
    """Make the mesh's groups and axis handles (once, on the calling
    thread, before any shard runs)."""
    if mesh._groups:
        return
    n_pop, n_rows = mesh.devices.shape
    turns = _Turns()
    made = {("turns",): turns}
    for j in range(n_rows):
        made[("group", "pop", j)] = _Group(list(mesh.devices[:, j]), turns)
    for i in range(n_pop):
        made[("group", "rows", i)] = _Group(list(mesh.devices[i, :]), turns)
    for k in range(mesh.size):
        i, j = mesh.coords(k)
        made[("axis", "pop", k)] = Axis("pop", made[("group", "pop", j)], i)
        made[("axis", "rows", k)] = Axis("rows", made[("group", "rows", i)], j)
    mesh._groups.update(made)


def _groups_of(mesh: Mesh) -> list:
    return [(key, g) for key, g in mesh._groups.items() if key[0] == "group"]


def device_scope(device):
    """``torch.cuda.device(device)`` for a card, else nothing."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_map(f, mesh: Mesh, per_shard_args, shards=None) -> list:
    """``[f(shard, *args) for each shard]``, the shards run at once, each in
    a thread of its own under its device (a one-shard run stays on the
    calling thread). ``per_shard_args``: one tuple of arguments per shard of
    ``shards`` (default: every shard, in flat order). A collective an ``f``
    makes must have its whole group among ``shards``. Raises the first error
    of any shard; the other shards' collectives are aborted, so none hangs."""
    shards = list(range(mesh.size)) if shards is None else list(shards)
    args = [tuple(a) for a in per_shard_args]
    if len(args) != len(shards):
        raise ValueError(f"shard_map: {len(args)} argument tuples for {len(shards)} shards")
    running = set(shards)
    if len(shards) == 1:
        sh = Shard(mesh, shards[0], running)
        with device_scope(sh.device):
            return [f(sh, *args[0])]
    _ensure_groups(mesh)
    for _, g in _groups_of(mesh):
        g.barrier.reset()
        g.inputs = [None] * g.size
    results, errors = [None] * len(shards), [None] * len(shards)

    turns = mesh._groups[("turns",)]

    def run(n: int) -> None:
        sh = Shard(mesh, shards[n], running)
        _CURRENT.turns = turns
        turns.enter()
        try:
            with device_scope(sh.device):
                results[n] = f(sh, *args[n])
        except BaseException as e:  # re-raised on the calling thread
            errors[n] = e
            for _, g in _groups_of(mesh):
                g.barrier.abort()
        finally:
            turns.leave()
            _CURRENT.turns = None

    threads = [threading.Thread(target=run, args=(n,), name=f"shard-{shards[n]}", daemon=True)
               for n in range(len(shards))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [e for e in errors if e is not None]
    if failed:
        first = next((e for e in failed if not isinstance(e, MeshAborted)), failed[0])
        raise first
    return results


def warm_up(mesh: Mesh) -> None:
    """One small gather over every axis of more than one shard, so that a
    transport's set-up (NCCL makes its communicator for a device set at the
    first gather) is paid here and not in the first leg; its counts are
    cleared."""
    axes = [name for name, n in zip(AXES, mesh.devices.shape) if n > 1]
    if not axes:
        return

    def one(sh):
        z = torch.zeros(1, device=sh.device)
        for name in axes:
            sh.axis(name).all_gather(z)

    shard_map(one, mesh, [()] * mesh.size)
    reset_collective_stats(mesh)


def collective_stats(mesh: Mesh) -> dict:
    """Per axis: the gathers made (one per collective per group), the bytes
    gathered, the host seconds of the gathers' launches and the host seconds
    shards spent at the barriers (summed over shards)."""
    out = {}
    for key, g in _groups_of(mesh):
        s = out.setdefault(key[1], {"groups": 0, "gathers": 0, "bytes": 0,
                                    "gather_seconds": 0.0, "wait_seconds": 0.0,
                                    "transport": g.transport})
        s["groups"] += 1
        s["gathers"] += g.gathers
        s["bytes"] += g.bytes
        s["gather_seconds"] += g.gather_seconds
        s["wait_seconds"] += g.wait_seconds
    return out


def reset_collective_stats(mesh: Mesh) -> None:
    for _, g in _groups_of(mesh):
        g.gathers, g.bytes, g.gather_seconds, g.wait_seconds = 0, 0, 0.0, 0.0


def intra_host_pool_merge(mesh: Mesh):
    """The hierarchical exchange's LOCAL stage (the JAX package's
    ``intra_host_pool_merge``): ``merge(parts)``, where ``parts`` holds one
    tuple of pool leaves [I_local, ...] per shard of the mesh in flat order,
    all-gathers the leaves over the 'pop' axis and returns, per shard, the
    merged leaves [I_total, ...] in island order on that shard's device, so
    the host reads the whole local pool from one shard. A rows axis gathers
    within each rows index."""

    def merge(parts) -> list:
        def one(sh: Shard, *leaves):
            ax = sh.axis("pop")
            return tuple(ax.all_gather(lf).reshape((-1,) + tuple(lf.shape[1:]))
                         for lf in leaves)

        return shard_map(one, mesh, parts)

    return merge
