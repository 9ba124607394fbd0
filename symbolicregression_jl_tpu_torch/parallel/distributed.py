"""Multi-process orchestration over a ``torch.distributed`` TCPStore.

Counterpart of ``symbolicregression_jl_tpu/parallel/distributed.py``. Every
process of a search launches the same program; ``initialize()`` joins them
into one world, and the device engine's island axis does the rest: each
process evolves its own slice of the islands (``process_island_slice``),
and once per iteration the processes exchange their compact migration
pools and frontier readbacks, a few KB of flattened trees.

The transport is decided once, for every backend: the exchange is a
host-side allgather over a key-value store (``_kv_allgather``, or an
``ExchangeGroup`` in ``parallel/membership.py``). ``initialize`` creates one
``torch.distributed.TCPStore`` at the coordinator address (rank 0 hosts
it), initializes a ``gloo`` process group on that store and keeps the store
for the coordination layer. The engine's payload is already on the host
(the iteration's one readback), so no collective on the card is needed:
several processes can share one card, each with its own engine. An NCCL
``all_gather`` (one card per rank) is not part of this package.

Payloads are ``np.savez`` bytes of host arrays under the JAX package's key
names, so a JAX process and a process of this package read each other's
posts on one store.

A single process is the degenerate case: ``initialize()`` is a no-op and
every helper below works unchanged.
"""

from __future__ import annotations

import datetime
import hashlib
import io
import os
import time
import warnings

import numpy as np

__all__ = [
    "initialize",
    "is_distributed",
    "world_shape",
    "process_island_slice",
    "all_gather_migration_pool",
    "allgather_transport",
    "DoubleBufferedExchange",
    "PeerLossError",
    "kv_timeout_ms",
    "kv_backoff_ms",
    "kv_backoff_max_ms",
    "live_set_digest",
    "dead_peers",
    "live_process_ids",
    "reset_peer_state",
]

# the TCPStore ``initialize`` created (rank 0 hosts it); the coordination
# layer (membership.coord_store) rides it
_STORE = None


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join a world of ``num_processes`` processes. ``coordinator_address``
    ("host:port", or ``SR_COORDINATOR_ADDRESS``) is where rank 0 hosts the
    world's TCPStore; the others connect to it. A ``gloo`` process group is
    initialized on that store. ``num_processes`` / ``process_id`` default to
    torch's ``WORLD_SIZE`` / ``RANK``. A no-op for a single process, so the
    same script works everywhere."""
    global _STORE
    import torch.distributed as tdist

    coordinator_address = coordinator_address or os.environ.get("SR_COORDINATOR_ADDRESS")
    if coordinator_address is None and num_processes is None:
        return  # single process
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if num_processes <= 1:
        return
    if coordinator_address is None:
        raise ValueError("initialize: a world of more than one process needs a "
                         "coordinator address (host:port or SR_COORDINATOR_ADDRESS)")
    host, _, port = coordinator_address.rpartition(":")
    timeout = datetime.timedelta(milliseconds=max(kv_timeout_ms(), 60_000))
    _STORE = tdist.TCPStore(host or "127.0.0.1", int(port), int(num_processes),
                            is_master=int(process_id) == 0, timeout=timeout,
                            wait_for_workers=False)
    tdist.init_process_group(backend="gloo", store=_STORE, rank=int(process_id),
                             world_size=int(num_processes), timeout=timeout)


def _torch_world() -> tuple[int, int] | None:
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size(), tdist.get_rank()
    return None


def is_distributed() -> bool:
    w = _torch_world()
    return w is not None and w[0] > 1


def world_shape() -> tuple[int, int]:
    """(world size, this process's rank). ``SR_ELASTIC_WORLD`` /
    ``SR_ELASTIC_ID`` override the process group's size and rank: the
    elastic file-store rigs (parallel/membership.py) define a logical world
    WITHOUT a process group, since a restarted process cannot rejoin a
    live one. With neither, (1, 0)."""
    w = os.environ.get("SR_ELASTIC_WORLD")
    if w:
        try:
            return int(w), int(os.environ.get("SR_ELASTIC_ID", "0"))
        except ValueError:
            pass
    return _torch_world() or (1, 0)


def process_island_slice(
    n_islands: int, live: list[int] | None = None
) -> tuple[int, int]:
    """[start, stop) of the island axis owned by this process — the
    multi-process analogue of the reference's WorkerAssignments
    (SymbolicRegression.jl/src/SearchUtils.jl:62-86), but static: islands
    are evenly striped across processes. With ``live`` (graceful
    degradation / resume after a peer loss), the islands re-stripe across
    the surviving processes only."""
    n, p = world_shape()
    if live is not None:
        members = sorted(int(q) for q in live)
        if p not in members:
            raise ValueError(f"process {p} is not in the live set {members}")
        rank, n = members.index(p), len(members)
    else:
        rank = p
    per = -(-n_islands // n)
    start = min(rank * per, n_islands)
    stop = min(start + per, n_islands)
    return start, stop


_KV_SEQ = 0
_KV_DEFAULT_TIMEOUT_MS = 600_000
# processes that failed a KV exchange deadline under on_peer_loss="continue";
# every later gather/barrier excludes them
_DEAD_PEERS: set[int] = set()


def kv_timeout_ms() -> int:
    """Allgather + barrier deadline in ms. ``SR_KV_TIMEOUT_MS`` overrides the
    600000 default — the fault-injection rigs drop it to seconds so injected
    peer loss is detected fast."""
    try:
        return int(os.environ.get("SR_KV_TIMEOUT_MS", _KV_DEFAULT_TIMEOUT_MS))
    except ValueError:
        return _KV_DEFAULT_TIMEOUT_MS


_KV_DEFAULT_BACKOFF_MS = 250
_KV_DEFAULT_BACKOFF_MAX_MS = 5000


def _env_int(name: str, default: int, lo: int = 1) -> int:
    try:
        return max(lo, int(os.environ.get(name, default)))
    except ValueError:
        return default


def kv_backoff_ms() -> int:
    """Initial per-peer poll slice in ms (``SR_KV_BACKOFF_MS``, default 250).
    Each failed poll doubles the slice up to :func:`kv_backoff_max_ms`."""
    return _env_int("SR_KV_BACKOFF_MS", _KV_DEFAULT_BACKOFF_MS)


def kv_backoff_max_ms() -> int:
    """Backoff cap in ms (``SR_KV_BACKOFF_MAX_MS``, default 5000)."""
    return _env_int("SR_KV_BACKOFF_MAX_MS", _KV_DEFAULT_BACKOFF_MAX_MS)


def live_set_digest(epoch: int, seq: int, live) -> str:
    """Short stable digest of (membership epoch, collective seq, live set)
    for barrier ids: O(1) characters at any world size, and disjoint
    partitions — or stale epochs — never collide on one barrier key."""
    text = f"{int(epoch)}:{int(seq)}:" + ",".join(str(int(p)) for p in sorted(live))
    return hashlib.sha1(text.encode()).hexdigest()[:12]


class PeerLossError(RuntimeError):
    """A peer failed to post its exchange payload (or reach a barrier)
    before the deadline. Carries the allgather sequence id (-1 for
    barriers), the missing process ids, and the number of poll attempts
    made under the retry/backoff schedule. ``phase`` overrides the
    "allgather seq N" message lead for non-gather collectives (the
    CoordStore barrier names itself here)."""

    def __init__(
        self,
        seq: int,
        missing,
        timeout_ms: int,
        attempts: int | None = None,
        phase: str | None = None,
    ):
        self.seq = int(seq)
        self.missing = tuple(sorted(int(p) for p in missing))
        self.attempts = None if attempts is None else int(attempts)
        self.phase = phase
        peers = ", ".join(str(p) for p in self.missing)
        tried = (
            f" after {self.attempts} poll attempt(s)"
            if self.attempts is not None
            else ""
        )
        lead = phase if phase is not None else f"allgather seq {self.seq}"
        super().__init__(
            f"{lead}: process(es) {peers} failed to post "
            f"within {timeout_ms} ms (SR_KV_TIMEOUT_MS){tried}; set "
            "on_peer_loss='continue' to keep searching on the survivors"
        )


def dead_peers() -> frozenset[int]:
    """Processes dropped from the exchange so far (on_peer_loss='continue')."""
    return frozenset(_DEAD_PEERS)


def live_process_ids() -> list[int]:
    n, _ = world_shape()
    return [p for p in range(n) if p not in _DEAD_PEERS]


def reset_peer_state() -> None:
    """Forget recorded peer deaths (called at the top of every
    ``equation_search``)."""
    _DEAD_PEERS.clear()


# -- host pytrees: tuples, lists and dicts of arrays (jax.tree_util's order) --


def tree_flatten(tree):
    """(leaves, treedef) of a nest of tuples, lists and dicts (keys sorted,
    as jax.tree_util orders them); anything else is a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return [lf for p in parts for lf in p[0]], ("dict", keys, [p[1] for p in parts])
    if isinstance(tree, (tuple, list)):
        parts = [tree_flatten(t) for t in tree]
        kind = "list" if isinstance(tree, list) else (
            type(tree) if hasattr(tree, "_fields") else "tuple")
        return [lf for p in parts for lf in p[0]], (kind, None, [p[1] for p in parts])
    return [tree], None


def tree_unflatten(treedef, leaves):
    """Inverse of :func:`tree_flatten` over a new list of leaves."""
    it = iter(leaves)

    def build(td):
        if td is None:
            return next(it)
        kind, keys, subs = td
        vals = [build(s) for s in subs]
        if kind == "dict":
            return dict(zip(keys, vals))
        if kind == "list":
            return vals
        if kind == "tuple":
            return tuple(vals)
        return kind(*vals)

    return build(treedef)


def _kv_allgather(arrays, on_peer_loss: str = "raise"):
    """Host-side allgather over the coordination store
    (``membership.coord_store()``: the world's TCPStore, or ``SR_COORD_DIR``).

    Every process posts its ``np.savez`` leaves under a sequence-numbered
    key (``srag/{seq}/{pid}``), reads every peer's, then a barrier and a
    self-delete reclaim the store's memory. The call sequence is lockstep on
    every process (the engine loop guarantees it), so sequence numbers stay
    aligned without extra synchronization.

    Each peer read polls in widening slices (``SR_KV_BACKOFF_MS`` doubling
    to ``SR_KV_BACKOFF_MAX_MS``) against one shared deadline
    (``SR_KV_TIMEOUT_MS``), so a transient hiccup retries while a dead peer
    is named precisely. Peers that miss the deadline raise
    :class:`PeerLossError` (naming the poll-attempt count) — or, under
    ``on_peer_loss='continue'``, are recorded dead and excluded from every
    later gather and barrier; the returned stacks then carry one row per
    SURVIVING process. The barrier id is suffixed with a short digest of the
    live set while degraded."""
    global _KV_SEQ
    from ..utils import faults
    from .membership import _np_dump, _np_load, coord_store

    store = coord_store()
    n, pid = world_shape()
    seq = _KV_SEQ
    _KV_SEQ += 1
    live = [p for p in range(n) if p not in _DEAD_PEERS]
    leaves, treedef = tree_flatten(arrays)
    injector = faults.active()
    if injector.armed("slow_peer"):
        hit = injector.fire("slow_peer")
        if hit is not None:
            time.sleep(float(hit.get("delay_ms", 1000)) / 1000.0)
    store.set(f"srag/{seq}/{pid}", _np_dump(leaves))

    timeout_ms = kv_timeout_ms()
    deadline = time.monotonic() + timeout_ms / 1000.0
    fault_peers: set[int] = set()
    if injector.armed("exchange_timeout"):
        hit = injector.fire("exchange_timeout")
        if hit is not None:
            tgt = hit.get("peer")
            others = [p for p in live if p != pid]
            fault_peers = {int(tgt)} if tgt is not None else set(others[-1:])

    backoff0 = float(kv_backoff_ms())
    backoff_max = float(kv_backoff_max_ms())
    gathered: dict[int, list] = {}
    missing: list[int] = []
    attempts = 0
    for p in live:
        if p in fault_peers:
            missing.append(p)
            continue
        raw = None
        slice_ms = backoff0
        while raw is None:
            remaining_ms = (deadline - time.monotonic()) * 1000.0
            if remaining_ms <= 0:
                break
            attempts += 1
            if injector.armed("kv_flap"):
                hit = injector.fire("kv_flap")
                if hit is not None:
                    # a transient coordination-store failure on this exact
                    # poll attempt: back off and retry
                    slice_ms = min(slice_ms * 2.0, backoff_max)
                    continue
            try:
                raw = store.get(f"srag/{seq}/{p}", int(max(1.0, min(slice_ms, remaining_ms))))
            except Exception:  # noqa: BLE001 — a timed-out poll slice or a
                # transient store error: back off, retry until the deadline
                slice_ms = min(slice_ms * 2.0, backoff_max)
        if raw is None:
            missing.append(p)
            continue
        gathered[p] = _np_load(raw)

    if missing:
        if on_peer_loss != "continue":
            raise PeerLossError(seq, missing, timeout_ms, attempts=attempts)
        _DEAD_PEERS.update(missing)
        live = [p for p in live if p not in missing]
        warnings.warn(
            f"allgather seq {seq}: lost process(es) {sorted(missing)}; "
            f"continuing on survivors {live} (on_peer_loss='continue')",
            stacklevel=2,
        )

    barrier_id = f"srag-done/{seq}"
    if len(live) < n:
        # survivors-only barrier under a short digest of the live set
        barrier_id += "/l" + live_set_digest(0, seq, live)
    try:
        store.barrier(barrier_id, timeout_ms, live, pid)
    except Exception as e:  # noqa: BLE001
        if on_peer_loss != "continue":
            raise RuntimeError(
                f"allgather seq {seq}: barrier failed across processes {live} ({e})"
            ) from e
        # a peer died between posting and the barrier: skip reclamation this
        # round — the next gather's read loop names it missing
    else:
        store.delete(f"srag/{seq}/{pid}")
    stacked = [np.stack([gathered[p][j] for p in live]) for j in range(len(leaves))]
    return tree_unflatten(treedef, stacked)


def allgather_transport() -> str:
    """Which transport ``all_gather_migration_pool`` rides: ``"kv-store"``
    in a world of more than one process (on every backend), ``"local"``
    for a single process."""
    return "kv-store" if world_shape()[0] > 1 else "local"


def all_gather_migration_pool(local_pool_arrays, on_peer_loss: str = "raise"):
    """Gather each process's compact migration pool (flattened best
    members: FlatTrees-style arrays + losses) into the global pool on every
    process, one leading row per process.

    The only cross-process traffic of the island model — a few KB of
    flattened trees once per iteration (the reference ships whole pickled
    Populations over TCP for the same purpose). ``on_peer_loss`` governs the
    deadline behavior (see ``_kv_allgather``); under 'continue' the returned
    stacks have one row per SURVIVING process. A single process gets its
    own payload with a leading axis of one.

    Kept for the JAX package's API: the port's engine exchanges through
    ``membership.ExchangeGroup`` (one transport on the same store), and
    nothing in the port calls this function or ``DoubleBufferedExchange``."""
    if world_shape()[0] > 1:
        return _kv_allgather(local_pool_arrays, on_peer_loss=on_peer_loss)
    leaves, treedef = tree_flatten(local_pool_arrays)
    return tree_unflatten(treedef, [np.asarray(a)[None] for a in leaves])


class DoubleBufferedExchange:
    """One-slot pipelined wrapper around ``all_gather_migration_pool``.

    ``roll(local)`` exchanges the PREVIOUS iteration's payload and stashes
    this iteration's — the caller launches iteration i's device work first,
    so the blocking gather overlaps iteration i's device compute, and
    migration injects a one-iteration-stale global pool (the reference's
    async snapshot migration, SymbolicRegression.jl
    src/SymbolicRegression.jl:933-943).

    Every process must call ``roll``/``flush`` the same number of times in
    the same order (the engine loop is lockstep)."""

    def __init__(self, on_peer_loss: str = "raise"):
        self._pending = None
        self._on_peer_loss = on_peer_loss

    def roll(self, local_pool_arrays):
        """Submit this iteration's local payload; gather and return the
        previous iteration's global payload (None on the first call)."""
        prev, self._pending = self._pending, local_pool_arrays
        if prev is None:
            return None
        return all_gather_migration_pool(prev, on_peer_loss=self._on_peer_loss)

    def flush(self):
        """Drain the slot after the loop: gather and return the last
        submitted payload (None if empty)."""
        prev, self._pending = self._pending, None
        if prev is None:
            return None
        return all_gather_migration_pool(prev, on_peer_loss=self._on_peer_loss)
