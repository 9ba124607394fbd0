"""Elastic membership runtime: epoch-based join/leave over a coordination store.

Counterpart of ``symbolicregression_jl_tpu/parallel/membership.py``: the
key names, epoch records (``srep/...``), control rows and barrier ids are
the JAX package's byte for byte, so members of both packages can share one
group on one store.

Round 8 made the multi-host exchange *leave-only*: a peer that missed the KV
deadline was recorded in a module-global ``_DEAD_PEERS`` set and excluded
forever. A preemptible-VM/TPU-pod fleet also *gains* workers back, so this
module replaces that one-way global with per-search :class:`ExchangeGroup`
state implementing a small membership protocol:

- **Membership epoch** — a monotonically increasing integer bumped on ANY
  join or leave. The epoch is stamped into every gather key and barrier id
  (``srx/{gid}/e{epoch}/s{seq}/{pid}``), so a stale partition that missed a
  membership change can never collide with the current group's collectives.
- **Deterministic membership changes** — peer loss is detected locally
  (deadline misses → *suspicion*), but the membership decision is taken only
  at designated *admission points* (``stop_sync``, the last collective of an
  engine iteration): every member piggybacks its locally-observed joiner and
  suspect sets as a control row in the gather, the rows are unioned, and all
  members apply the same change — the epoch bump is lockstep by
  construction.
- **Join/rejoin** — a joiner announces itself at a fixed per-rank key
  (``srjoin/{gid}/{rank}``; no key listing needed, the world is bounded),
  members admit it at the next admission point, the leader (min live rank)
  publishes an immutable epoch record ``srep/{gid}/{epoch}`` naming the new
  live set and the iteration at which the joiner enters, and publishes a
  **checkpoint shard** (``utils/checkpoint.py`` format-2 bytes, verified on
  load) the joiner adopts as its warm start. The joiner re-enters the
  exchange at seq 0 of the new epoch — one clean iteration boundary later.
- **Heartbeats** — each member republishes ``srhb/{gid}/{pid}`` every
  ``Options.heartbeat_every_seconds`` on a daemon thread; TTL-style ages are
  observability (``peers_alive``) and a joiner's liveness probe, not the
  failure detector (the gather deadline is).
- **Hierarchical topology** — ``topology="ring"`` turns the per-iteration
  payload exchange into a sparse ring: each member posts its payload and
  reads only its ring predecessor's, so per-step cost stops scaling O(N)
  with process count (the JAX package measured the flat gather growing
  with the world: MULTIHOST_COST_r05.json).
  ``stop_sync`` stays flat (a tiny control scalar) and carries the global
  eval count; the once-per-search final hall-of-fame exchange stays flat so
  final frontiers still converge across processes.

Transports: :class:`TorchCoordStore` rides the world's
``torch.distributed`` TCPStore (``distributed.initialize``).
:class:`FileCoordStore` (``SR_COORD_DIR``) uses a shared directory with
atomic writes — it is the transport that makes true *process restart*
rejoin possible, since a restarted process cannot rejoin a live process
group. ``SR_ELASTIC_WORLD`` / ``SR_ELASTIC_ID`` define the world without a
process group (see ``distributed.world_shape``).
"""

from __future__ import annotations

import hashlib
import io
import os
import pickle
import threading
import time
import urllib.parse
import warnings

import numpy as np

from . import distributed as dist

__all__ = [
    "CoordStore",
    "FileCoordStore",
    "TorchCoordStore",
    "PartitionedCoordStore",
    "coord_store",
    "coord_gc_seconds",
    "elastic_enabled",
    "join_pending",
    "should_use_group",
    "ExchangeGroup",
    "next_group_id",
]


# -- coordination stores ------------------------------------------------------


def coord_gc_seconds() -> float:
    """``SR_COORD_GC_S``: TTL past which unprotected coordination keys are
    swept by :meth:`FileCoordStore.gc`. 0 (the default) disables the sweep.
    Read per sweep — a live pod honors changes."""
    try:
        return float(os.environ.get("SR_COORD_GC_S", "0") or 0.0)
    except ValueError:
        return 0.0


# Keys that must outlive any TTL: epoch records are the membership history a
# late joiner replays (srep/), checkpoint shards are a joiner's warm start
# (srshard/), and pod adoption leases / retirement markers are the
# exactly-once guard for journal takeover — sweeping a lease would let a
# second survivor re-adopt (and re-run) a dead host's jobs.
_GC_PROTECTED_PREFIXES = ("srep/", "srshard/")
_GC_PROTECTED_PARTS = ("/claim/", "/retire/")


def _gc_protected(key: str) -> bool:
    return key.startswith(_GC_PROTECTED_PREFIXES) or any(
        part in key for part in _GC_PROTECTED_PARTS
    )


class CoordStore:
    """Minimal KV + barrier interface the membership protocol needs."""

    def set(self, key: str, value: bytes) -> None:  # immutable keys
        raise NotImplementedError

    def set_mutable(self, key: str, value: bytes) -> None:
        """Overwrite-capable set (heartbeats)."""
        raise NotImplementedError

    def set_if_absent(self, key: str, value: bytes) -> bool:
        """Atomic write-once claim: True iff THIS call created the key.
        The pod runtime's adoption leases ride on this — exactly one
        survivor wins the right to replay a dead host's journal."""
        raise NotImplementedError

    def get(self, key: str, timeout_ms: int) -> bytes:
        """Blocking read; raises TimeoutError past the deadline."""
        raise NotImplementedError

    def try_get(self, key: str) -> bytes | None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list(self, prefix: str) -> list[str]:
        """Sorted keys under ``prefix``. Best-effort (a concurrent
        delete may leave a listed key unreadable — callers re-check with
        ``try_get``)."""
        raise NotImplementedError

    def barrier(self, bid: str, timeout_ms: int, ids: list[int], my_id: int) -> None:
        """KV-poll barrier: post my arrival under ``{bid}/{my_id}``, then
        poll every other id's key against one shared deadline. On expiry
        raises :class:`dist.PeerLossError` naming EVERY id that never
        arrived — survivors of a mid-barrier death get the full missing
        set within the deadline instead of hanging (or learning one rank
        at a time)."""
        # the arrival marker is the JAX package's: more than one byte,
        # which its coordination-service client needs to read it back
        self.set_mutable(f"{bid}/{my_id}", b"arrived")
        deadline = time.monotonic() + timeout_ms / 1000.0
        pending = [p for p in ids if p != my_id]
        while pending:
            pending = [
                p for p in pending if self.try_get(f"{bid}/{p}") is None
            ]
            if not pending:
                return
            if time.monotonic() >= deadline:
                raise dist.PeerLossError(
                    -1, pending, timeout_ms, phase=f"barrier {bid}"
                )
            time.sleep(0.01)


class FileCoordStore(CoordStore):
    """Shared-directory store: atomic tmp+rename writes, polling reads.

    The restart-capable transport: any process that can see the directory can
    join the group — no live runtime registration required. Writes are
    crash-atomic (a torn write can only leave a ``.tmp`` orphan)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._gc_at = 0.0

    def _path(self, key: str) -> str:
        return os.path.join(self.root, urllib.parse.quote(key, safe=""))

    def set(self, key: str, value: bytes) -> None:
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(value)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    set_mutable = set

    def get(self, key: str, timeout_ms: int) -> bytes:
        deadline = time.monotonic() + timeout_ms / 1000.0
        path = self._path(key)
        while True:
            try:
                with open(path, "rb") as f:
                    return f.read()
            except OSError:
                if time.monotonic() >= deadline:
                    raise TimeoutError(key) from None
                time.sleep(0.01)

    def try_get(self, key: str) -> bytes | None:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except OSError:
            return None

    def set_if_absent(self, key: str, value: bytes) -> bool:
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(value)
            f.flush()
            os.fsync(f.fileno())
        try:
            # hard-link is the atomic "create iff absent" on a shared fs
            # (os.replace would silently overwrite a racing claimant)
            os.link(tmp, path)
            return True
        except FileExistsError:
            return False
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except OSError:
            pass

    def list(self, prefix: str) -> list[str]:
        try:
            entries = os.listdir(self.root)
        except OSError:
            return []
        out = []
        for fn in entries:
            if ".tmp." in fn:  # in-flight atomic write (or a crash orphan)
                continue
            if os.path.isdir(os.path.join(self.root, fn)):
                continue
            key = urllib.parse.unquote(fn)
            if key.startswith(prefix):
                out.append(key)
        return sorted(out)

    def gc(self, ttl_s: float | None = None) -> int:
        """TTL sweep: heartbeat/gather/barrier keys are
        written forever by long-lived groups and pods, and nothing ever
        reclaims the ones a crashed process left behind — sweep every
        unprotected key whose mtime is older than ``ttl_s`` (default
        ``SR_COORD_GC_S``; 0 disables). Epoch records, checkpoint shards,
        and pod leases/retire markers are exempt (see ``_gc_protected``).
        Env-driven calls (``ttl_s=None``) self-throttle to one sweep per
        quarter-TTL so heartbeat loops can call this every beat for free.
        Returns the number of keys removed."""
        ttl = coord_gc_seconds() if ttl_s is None else float(ttl_s)
        if ttl <= 0:
            return 0
        now = time.time()
        if ttl_s is None and now - self._gc_at < max(1.0, ttl / 4.0):
            return 0
        self._gc_at = now
        removed = 0
        try:
            entries = os.listdir(self.root)
        except OSError:
            return 0
        for fn in entries:
            path = os.path.join(self.root, fn)
            key = urllib.parse.unquote(fn)
            if ".tmp." not in fn and _gc_protected(key):
                continue
            try:
                if os.path.isdir(path):
                    continue
                if now - os.stat(path).st_mtime <= ttl:
                    continue
                os.remove(path)
                removed += 1
            except OSError:
                continue
        return removed


class TorchCoordStore(CoordStore):
    """A ``torch.distributed`` TCPStore as a CoordStore: by default the one
    ``distributed.initialize`` created for the world (or the default process
    group's store); ``store`` injects another (tests bind one on port 0).

    The TCPStore's keys are mutable, so ``set`` and ``set_mutable`` both
    overwrite, as :class:`FileCoordStore`'s do. Reads never block on the
    store's own timeout: ``try_get`` is one ``compare_set`` with a sentinel
    that no writer stores (it returns the present value and writes nothing,
    or the sentinel when the key is absent), and ``get`` polls it against
    its deadline. ``set_if_absent`` claims the key through an atomic counter
    (``add``) in a namespace of its own, so exactly one caller wins; a
    ``delete`` frees the claim with the key. The barrier is the generic
    KV-poll one, which names the ids that never arrived."""

    _ABSENT = "\x00sr-absent\x00"
    _CLAIM = "\x00sr-claim/"

    def __init__(self, store=None):
        if store is None:
            from . import distributed as _d

            store = _d._STORE
            if store is None:
                import torch.distributed as tdist

                if tdist.is_available() and tdist.is_initialized():
                    store = tdist.distributed_c10d._get_default_store()
        assert store is not None, "torch.distributed is not initialized"
        self._store = store

    def set(self, key: str, value: bytes) -> None:
        self._store.set(key, value)

    set_mutable = set

    def set_if_absent(self, key: str, value: bytes) -> bool:
        if self.try_get(key) is not None:
            return False
        if self._store.add(self._CLAIM + key, 1) != 1:
            return False
        self._store.set(key, value)
        return True

    def try_get(self, key: str) -> bytes | None:
        got = self._store.compare_set(key, self._ABSENT, self._ABSENT)
        if got == self._ABSENT.encode():
            return None
        return bytes(got)

    def get(self, key: str, timeout_ms: int) -> bytes:
        deadline = time.monotonic() + timeout_ms / 1000.0
        pause = 0.001
        while True:
            raw = self.try_get(key)
            if raw is not None:
                return raw
            if time.monotonic() >= deadline:
                raise TimeoutError(key)
            time.sleep(min(pause, max(0.0, deadline - time.monotonic())))
            pause = min(pause * 2.0, 0.01)

    def delete(self, key: str) -> None:
        try:
            self._store.delete_key(key)
            self._store.delete_key(self._CLAIM + key)
        except Exception:  # noqa: BLE001
            pass

    def list(self, prefix: str) -> list[str]:
        try:
            keys = self._store.list_keys()
        except Exception:  # noqa: BLE001
            return []
        out = []
        for k in keys:
            if isinstance(k, bytes):
                k = k.decode("utf-8", "replace")
            if k.startswith(prefix) and not k.startswith(self._CLAIM):
                out.append(k)
        return sorted(out)


class PartitionedCoordStore(CoordStore):
    """Chaos wrapper: simulates a network partition between named host
    groups by severing THIS process's view of keys that name hosts on the
    far side, then healing.

    Armed by the ``kv_partition`` fault site: the rule fires at the Nth
    store operation, its ``block`` param is a ``|``-separated list of key
    substrings to sever (host names, since pod ads/inboxes/claims embed
    them), and ``ops`` (default 50) is the number of further store
    operations after which the partition heals. While severed:

    - ``try_get`` on a blocked key returns None, ``get`` raises
      TimeoutError, ``list`` omits blocked keys — the far side's writes
      are invisible, exactly as if its packets were dropped;
    - ``set``/``set_mutable``/``delete`` on a blocked key are silently
      dropped (the write never reaches the shared store);
    - ``set_if_absent`` on a blocked key returns False WITHOUT writing —
      a CAS with no connectivity cannot win. Pod adoption claims for a
      partitioned host simply retry next scan; the write-once done ledger
      keys carry job ids, not host names, so exactly-once result
      publication is never forged by the wrapper itself.

    Everything else delegates to the wrapped store (including attribute
    access — ``.root``, ``.gc`` — so rig plumbing built for
    :class:`FileCoordStore` keeps working). The healed/dropped counters
    feed the chaos auditor through :meth:`partition_stats`."""

    def __init__(self, inner: CoordStore):
        self.inner = inner
        self._plock = threading.Lock()
        self._blocked: tuple[str, ...] = ()
        self._ops_left = 0
        self._partitions = 0
        self._healed = 0
        self._dropped_ops = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _severed(self, key: str) -> bool:
        from ..utils import faults

        inj = faults.active()
        with self._plock:
            if inj.armed("kv_partition"):
                hit = inj.fire("kv_partition")
                if hit is not None:
                    block = str(hit.get("block", ""))
                    self._blocked = tuple(b for b in block.split("|") if b)
                    self._ops_left = max(1, int(hit.get("ops", 50)))
                    if self._blocked:
                        self._partitions += 1
            if not self._blocked:
                return False
            self._ops_left -= 1
            if self._ops_left <= 0:
                self._blocked = ()
                self._healed += 1
                return False
            if any(b in key for b in self._blocked):
                self._dropped_ops += 1
                return True
            return False

    def partition_stats(self) -> dict:
        with self._plock:
            return {
                "active": bool(self._blocked),
                "blocked": list(self._blocked),
                "partitions": self._partitions,
                "healed": self._healed,
                "dropped_ops": self._dropped_ops,
            }

    # -- CoordStore surface, each op consulting the partition state ----------
    def set(self, key: str, value: bytes) -> None:
        if not self._severed(key):
            self.inner.set(key, value)

    def set_mutable(self, key: str, value: bytes) -> None:
        if not self._severed(key):
            self.inner.set_mutable(key, value)

    def set_if_absent(self, key: str, value: bytes) -> bool:
        if self._severed(key):
            return False
        return self.inner.set_if_absent(key, value)

    def get(self, key: str, timeout_ms: int) -> bytes:
        if self._severed(key):
            raise TimeoutError(
                f"kv_partition: {key!r} unreachable (injected partition)"
            )
        return self.inner.get(key, timeout_ms)

    def try_get(self, key: str) -> bytes | None:
        if self._severed(key):
            return None
        return self.inner.try_get(key)

    def delete(self, key: str) -> None:
        if not self._severed(key):
            self.inner.delete(key)

    def list(self, prefix: str) -> list[str]:
        if self._severed(prefix):
            return []
        keys = self.inner.list(prefix)
        with self._plock:
            blocked = self._blocked
        if blocked:
            keys = [k for k in keys if not any(b in k for b in blocked)]
        return keys

    def barrier(self, bid: str, timeout_ms: int, ids, my_id: int) -> None:
        self.inner.barrier(bid, timeout_ms, ids, my_id)


def coord_store() -> CoordStore:
    """The active transport: ``SR_COORD_DIR`` selects the file store (the
    restart-capable rig); otherwise the world's TCPStore. When the
    active fault injector arms ``kv_partition``, the store is wrapped in a
    :class:`PartitionedCoordStore` so every consumer in this process — pod
    node, pod client, exchange group — shares one partition view."""
    root = os.environ.get("SR_COORD_DIR")
    store: CoordStore = FileCoordStore(root) if root else TorchCoordStore()
    from ..utils import faults

    if faults.active().armed("kv_partition"):
        store = PartitionedCoordStore(store)
    return store


def elastic_enabled(options=None) -> bool:
    """Elastic membership active: a file coordination dir is configured, or
    the search opted into ``on_peer_loss="rejoin"``."""
    if os.environ.get("SR_COORD_DIR"):
        return True
    return options is not None and options.on_peer_loss == "rejoin"


def join_pending() -> bool:
    """This process was (re)started to JOIN a search already in progress
    (``SR_ELASTIC_JOIN=1`` — set by restart rigs / fleet managers)."""
    return os.environ.get("SR_ELASTIC_JOIN", "") == "1"


def should_use_group(options=None) -> bool:
    """Route the engine's exchange through an :class:`ExchangeGroup`?

    True in every world of more than one process: the KV store carries the
    exchange on every backend (``distributed.allgather_transport``), where
    the JAX package takes an XLA collective on a TPU pod."""
    return dist.world_shape()[0] > 1


_GROUP_COUNTER = [0]


def next_group_id(out_j: int = 1) -> str:
    """A group id every process derives identically (same program, same
    call sequence): a per-process counter + the output index."""
    _GROUP_COUNTER[0] += 1
    return f"g{_GROUP_COUNTER[0]}o{out_j}"


# -- the exchange group -------------------------------------------------------


def _np_dump(leaves) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, *[np.asarray(a) for a in leaves])
    return buf.getvalue()


def _np_load(raw: bytes) -> list[np.ndarray]:
    with np.load(io.BytesIO(raw)) as z:
        return [z[f"arr_{j}"] for j in range(len(z.files))]


class ExchangeGroup:
    """Per-search exchange membership + collectives over a CoordStore.

    One instance per (search, output); created fresh by the device scheduler,
    so no peer-death state can leak into a later search (the r08
    ``_DEAD_PEERS`` leak). Deaths ARE mirrored into
    ``distributed._DEAD_PEERS`` for observability (``dist.dead_peers()``),
    and un-mirrored when the peer rejoins.

    Collective cadence must be identical on every live member (the engine
    loop is lockstep): ``exchange`` once per iteration, then ``stop_sync``
    (the admission point), then after the loop one final flat ``allgather``.
    """

    def __init__(
        self,
        store: CoordStore,
        gid: str,
        my_id: int,
        world: int,
        *,
        on_peer_loss: str = "raise",
        topology: str = "flat",
        heartbeat_every: float = 5.0,
        shard_provider=None,
        start_heartbeat: bool = True,
    ):
        self.store = store
        self.gid = gid
        self.my_id = int(my_id)
        self.world = int(world)
        self.on_peer_loss = on_peer_loss
        self.topology = topology
        self.shard_provider = shard_provider
        self.epoch = 0
        self.seq = 0
        self.live: list[int] = list(range(self.world))
        self.dead: set[int] = set()
        self._suspects: set[int] = set()
        self._ring_keys: list[str] = []
        self._hb_stop = threading.Event()
        self._hb_thread = None
        self._hb_every = float(heartbeat_every)
        if start_heartbeat and self._hb_every > 0:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name=f"sr-heartbeat-{gid}-{my_id}",
            )
            self._hb_thread.start()

    # -- heartbeats ----------------------------------------------------------

    def _hb_key(self, pid: int) -> str:
        return f"srhb/{self.gid}/{pid}"

    def _heartbeat_loop(self):
        gc = getattr(self.store, "gc", None)
        while not self._hb_stop.is_set():
            try:
                self.store.set_mutable(
                    self._hb_key(self.my_id), pickle.dumps(time.time())
                )
            except Exception:  # noqa: BLE001 — heartbeats are best-effort
                pass
            if gc is not None:
                try:
                    # opportunistic TTL sweep (SR_COORD_GC_S; self-throttled
                    # and a no-op at the default 0) so long-lived groups
                    # reclaim their own gather/barrier/heartbeat litter
                    gc()
                except Exception:  # noqa: BLE001
                    pass
            self._hb_stop.wait(self._hb_every)

    def peers_alive(self) -> dict[int, float]:
        """rank -> heartbeat age in seconds, for every rank with a published
        beat. TTL-style observability; the gather deadline is the detector."""
        now = time.time()
        out = {}
        for p in range(self.world):
            raw = self.store.try_get(self._hb_key(p))
            if raw is not None:
                try:
                    out[p] = now - float(pickle.loads(raw))
                except Exception:  # noqa: BLE001
                    pass
        return out

    # -- key / control helpers ----------------------------------------------

    def _gather_key(self, seq: int, pid: int) -> str:
        return f"srx/{self.gid}/e{self.epoch}/s{seq}/{pid}"

    def _barrier_id(self, seq: int) -> str:
        # short stable digest of (epoch, seq, live): O(1) id length at any
        # world size, and disjoint partitions can never share a barrier key
        return f"srxb/{self.gid}/{dist.live_set_digest(self.epoch, seq, self.live)}"

    def _control_row(self, joiners: set[int]) -> np.ndarray:
        """[n_join, join_ranks..., n_suspect, suspect_ranks...] padded to a
        fixed 2+2*world width so the gather payload shape never varies."""
        row = np.full((2 + 2 * self.world,), -1, np.int64)
        j = sorted(joiners)
        s = sorted(self._suspects)
        row[0] = len(j)
        row[1 : 1 + len(j)] = j
        row[1 + self.world] = len(s)
        row[2 + self.world : 2 + self.world + len(s)] = s
        return row

    @staticmethod
    def _parse_control(row: np.ndarray, world: int) -> tuple[set[int], set[int]]:
        nj = int(row[0])
        ns = int(row[1 + world])
        return (
            set(int(x) for x in row[1 : 1 + nj]),
            set(int(x) for x in row[2 + world : 2 + world + ns]),
        )

    # -- core polling read ---------------------------------------------------

    def _read_peer(self, key: str, deadline: float) -> tuple[bytes | None, int]:
        """Poll one peer's key in widening slices against the shared
        deadline. Returns (payload | None, attempts). ``kv_flap`` forces a
        poll attempt to fail (exact-call-count determinism) to exercise the
        retry/backoff path."""
        from ..utils import faults

        injector = faults.active()
        flap_armed = injector.armed("kv_flap")
        slice_ms = float(dist.kv_backoff_ms())
        max_ms = float(dist.kv_backoff_max_ms())
        attempts = 0
        while True:
            remaining_ms = (deadline - time.monotonic()) * 1000.0
            if remaining_ms <= 0:
                return None, attempts
            attempts += 1
            flapped = flap_armed and injector.fire("kv_flap") is not None
            try:
                raw = self.store.get(
                    key, int(max(1.0, min(slice_ms, remaining_ms)))
                )
                if not flapped:
                    return raw, attempts
            except TimeoutError:
                pass
            slice_ms = min(slice_ms * 2.0, max_ms)

    # -- collectives ---------------------------------------------------------

    def _post(self, seq: int, leaves, control: np.ndarray) -> str:
        from ..utils import faults

        injector = faults.active()
        if injector.armed("slow_peer"):
            hit = injector.fire("slow_peer")
            if hit is not None:
                time.sleep(float(hit.get("delay_ms", 1000.0)) / 1000.0)
        key = self._gather_key(seq, self.my_id)
        self.store.set(key, _np_dump([control, *leaves]))
        return key

    def _fault_missing(self) -> set[int]:
        """The r08 ``exchange_timeout`` site: treat a peer as never having
        posted (param ``peer``; default the highest-id other live rank)."""
        from ..utils import faults

        injector = faults.active()
        if not injector.armed("exchange_timeout"):
            return set()
        hit = injector.fire("exchange_timeout")
        if hit is None:
            return set()
        tgt = hit.get("peer")
        others = [p for p in self.live if p != self.my_id]
        return {int(tgt)} if tgt is not None else set(others[-1:])

    def allgather(self, arrays, *, joiners: set[int] | None = None):
        """Flat epoch-stamped allgather over the live set. Returns
        (tree like ``arrays`` with leading live-row axis, control rows read,
        live order). Missing peers: raise :class:`dist.PeerLossError`
        (``on_peer_loss="raise"``) or become local *suspects* excluded from
        later reads until the next admission point formalizes the change."""
        seq = self.seq
        self.seq += 1
        leaves, treedef = dist.tree_flatten(arrays)
        control = self._control_row(joiners or set())
        self._post(seq, leaves, control)

        timeout_ms = dist.kv_timeout_ms()
        deadline = time.monotonic() + timeout_ms / 1000.0
        fault_peers = self._fault_missing()
        readable = [p for p in self.live if p not in self._suspects]
        gathered: dict[int, list] = {}
        missing: list[int] = []
        total_attempts = 0
        for p in readable:
            if p in fault_peers:
                missing.append(p)
                continue
            raw, attempts = self._read_peer(self._gather_key(seq, p), deadline)
            total_attempts += attempts
            if raw is None:
                missing.append(p)
                continue
            gathered[p] = _np_load(raw)

        if missing:
            if self.on_peer_loss == "raise":
                raise dist.PeerLossError(
                    seq, missing, timeout_ms, attempts=total_attempts
                )
            self._suspects.update(missing)
            # mirror immediately for observability (dist.dead_peers());
            # the epoch-level membership change lands at the next stop_sync
            dist._DEAD_PEERS.update(missing)
            warnings.warn(
                f"group {self.gid} epoch {self.epoch} seq {seq}: lost "
                f"process(es) {sorted(missing)}; continuing on "
                f"{sorted(set(readable) - set(missing))} "
                f"(on_peer_loss={self.on_peer_loss!r})",
                stacklevel=3,
            )
        order = [p for p in readable if p in gathered]

        try:
            self.store.barrier(
                self._barrier_id(seq), timeout_ms, order, self.my_id
            )
        except (TimeoutError, dist.PeerLossError) as e:
            if self.on_peer_loss == "raise":
                if isinstance(e, dist.PeerLossError):
                    raise  # already names the missing ids
                raise RuntimeError(
                    f"group {self.gid}: barrier failed across {order} ({e})"
                ) from e
            # a peer died between posting and the barrier — skip reclamation,
            # the next gather names it missing
        else:
            self.store.delete(self._gather_key(seq, self.my_id))

        controls = [gathered[p][0] for p in order]
        stacked = [
            np.stack([gathered[p][1 + j] for p in order])
            for j in range(len(leaves))
        ]
        return dist.tree_unflatten(treedef, stacked), controls, order

    def exchange(self, arrays):
        """The per-iteration payload exchange. ``topology="flat"``: every
        live member's payload, stacked in live order. ``topology="ring"``:
        post mine, read ONLY my ring predecessor's — rows are [self, pred],
        so per-step cost is O(1) in world size. Ring keys are reclaimed at
        the next ``stop_sync`` (its barrier proves the iteration's ring
        reads are all complete)."""
        if self.topology != "ring" or len(self.live) <= 1:
            out, _, _ = self.allgather(arrays)
            return out
        seq = self.seq
        self.seq += 1
        leaves, treedef = dist.tree_flatten(arrays)
        self._ring_keys.append(self._post(seq, leaves, self._control_row(set())))
        ring = sorted(p for p in self.live if p not in self._suspects)
        if self.my_id not in ring or len(ring) <= 1:
            stacked = [np.stack([leaf, leaf]) for leaf in
                       [np.asarray(a) for a in leaves]]
            return dist.tree_unflatten(treedef, stacked)
        pred = ring[(ring.index(self.my_id) - 1) % len(ring)]
        timeout_ms = dist.kv_timeout_ms()
        deadline = time.monotonic() + timeout_ms / 1000.0
        fault_peers = self._fault_missing()
        raw, attempts = (None, 0) if pred in fault_peers else self._read_peer(
            self._gather_key(seq, pred), deadline
        )
        if raw is None:
            if self.on_peer_loss == "raise":
                raise dist.PeerLossError(
                    seq, [pred], timeout_ms, attempts=attempts
                )
            self._suspects.add(pred)
            dist._DEAD_PEERS.add(pred)
            warnings.warn(
                f"group {self.gid} ring seq {seq}: predecessor {pred} lost; "
                "continuing with the local payload only",
                stacklevel=2,
            )
            rows = [np.asarray(a) for a in leaves]
            stacked = [np.stack([r, r]) for r in rows]
        else:
            pred_leaves = _np_load(raw)[1:]
            stacked = [
                np.stack([np.asarray(mine), theirs])
                for mine, theirs in zip(leaves, pred_leaves)
            ]
        return dist.tree_unflatten(treedef, stacked)

    # -- admission / membership ----------------------------------------------

    def _join_key(self, rank: int) -> str:
        return f"srjoin/{self.gid}/{rank}"

    def _epoch_key(self, epoch: int) -> str:
        return f"srep/{self.gid}/{epoch}"

    def _shard_key(self, epoch: int) -> str:
        return f"srshard/{self.gid}/{epoch}"

    def _observe_joiners(self) -> set[int]:
        """Announcements at the fixed per-rank keys of non-live ranks. Only
        vacant ranks are polled, so this is O(dead), usually zero."""
        out = set()
        for r in range(self.world):
            if r in self.live and r not in self._suspects:
                continue
            if self.store.try_get(self._join_key(r)) is not None:
                out.add(r)
        return out

    def stop_sync(self, stop_code: int, local_evals: float, iteration: int):
        """The iteration's ADMISSION POINT: a tiny flat gather of
        [stop_code, local_evals] + the control row. Every member unions the
        observed joiner/suspect sets across rows, applies the same
        membership change, and bumps the epoch in lockstep. Returns
        (max stop_code, total evals, admitted ranks)."""
        joiners = self._observe_joiners() if self.on_peer_loss == "rejoin" else set()
        payload = np.asarray([float(stop_code), float(local_evals)], np.float64)
        (rows,), controls, order = self.allgather((payload,), joiners=joiners)
        all_join: set[int] = set()
        all_suspect: set[int] = set(self._suspects)
        for row in controls:
            j, s = self._parse_control(row, self.world)
            all_join |= j
            all_suspect |= s
        code = int(np.max(rows[:, 0]))
        evals = float(np.sum(rows[:, 1]))

        if self.my_id in all_suspect:
            raise RuntimeError(
                f"group {self.gid}: this process (rank {self.my_id}) was "
                "voted dead by the surviving members — rejoin at the next "
                "epoch (SR_ELASTIC_JOIN=1) instead of continuing"
            )
        changed = False
        kills = sorted(all_suspect & set(self.live))
        if kills:
            self.live = [p for p in self.live if p not in all_suspect]
            self.dead |= set(kills)
            dist._DEAD_PEERS.update(kills)
            changed = True
        # A rank killed THIS round is admitted no earlier than the NEXT
        # admission point: its announcement stays in the store (the leader
        # only deletes announcements for admitted ranks), so the leave and
        # the rejoin always land on distinct, strictly ordered epochs and
        # the shard published with the admission reflects post-kill state.
        admitted = sorted(
            p for p in all_join if p not in self.live and p not in kills
        )
        if admitted:
            self.live = sorted(set(self.live) | set(admitted))
            self.dead -= set(admitted)
            for p in admitted:
                dist._DEAD_PEERS.discard(p)
            changed = True
        if changed:
            self.epoch += 1
            self.seq = 0
            self._suspects -= set(admitted)
            if self.my_id == min(self.live):
                record = {
                    "epoch": self.epoch,
                    "live": list(self.live),
                    "iteration": int(iteration),
                    "joined": admitted,
                    "left": kills,
                }
                if admitted and self.shard_provider is not None:
                    try:
                        self.store.set(
                            self._shard_key(self.epoch), self.shard_provider()
                        )
                    except Exception as e:  # noqa: BLE001 — a joiner without
                        # a shard warm-starts from random trees
                        warnings.warn(f"shard publish failed: {e}", stacklevel=2)
                try:
                    self.store.set(
                        self._epoch_key(self.epoch), pickle.dumps(record)
                    )
                except Exception as e:  # noqa: BLE001
                    # the epoch record is a CLAIM on a write-once key: under
                    # a symmetric partition each side elects its own leader
                    # and both race to publish the same epoch — first writer
                    # wins (joiners follow the winning partition); the local
                    # partition continues degraded either way
                    warnings.warn(
                        f"group {self.gid}: epoch {self.epoch} record already "
                        f"claimed by a concurrent partition ({e}); continuing "
                        f"on {self.live}",
                        stacklevel=2,
                    )
                for p in admitted:
                    self.store.delete(self._join_key(p))
            if admitted:
                warnings.warn(
                    f"group {self.gid}: rank(s) {admitted} joined at epoch "
                    f"{self.epoch} (iteration {iteration}); live={self.live}",
                    stacklevel=2,
                )
        # the stop_sync barrier proves every live member finished this
        # iteration's ring reads: reclaim our ring keys now
        for k in self._ring_keys:
            self.store.delete(k)
        self._ring_keys.clear()
        return code, evals, admitted

    def join(self, timeout_ms: int | None = None) -> tuple[dict, bytes | None]:
        """JOINER side: fire the ``peer_join`` fault site (param ``defer_ms``
        delays the announcement), announce at this rank's fixed key, then
        poll epoch records ascending until one admits this rank. Returns
        (epoch record, published checkpoint-shard bytes or None); the group's
        epoch/seq/live are synced to the record."""
        from ..utils import faults

        injector = faults.active()
        if injector.armed("peer_join"):
            hit = injector.fire("peer_join")
            if hit is not None:
                time.sleep(float(hit.get("defer_ms", 0.0)) / 1000.0)
        self.store.set_mutable(
            self._join_key(self.my_id),
            pickle.dumps({"rank": self.my_id, "t": time.time()}),
        )
        timeout_ms = dist.kv_timeout_ms() if timeout_ms is None else timeout_ms
        deadline = time.monotonic() + timeout_ms / 1000.0
        epoch = 1
        while True:
            raw = self.store.try_get(self._epoch_key(epoch))
            if raw is None:
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"group {self.gid}: not admitted within {timeout_ms} ms "
                        f"(last epoch record seen: {epoch - 1})"
                    )
                time.sleep(0.05)
                continue
            record = pickle.loads(raw)
            if self.my_id in record["live"]:
                break
            epoch += 1
        self.epoch = int(record["epoch"])
        self.seq = 0
        self.live = sorted(int(p) for p in record["live"])
        self.dead = set(range(self.world)) - set(self.live)
        self._suspects = set()
        for p in self.live:
            dist._DEAD_PEERS.discard(p)
        shard = self.store.try_get(self._shard_key(self.epoch))
        return record, shard

    # -- pipelining / teardown -----------------------------------------------

    def roll(self, arrays):
        """One-slot double buffer over ``exchange`` (the r06 pipelined
        pattern): exchange the PREVIOUS payload, stash this one."""
        prev = getattr(self, "_pending", None)
        self._pending = arrays
        if prev is None:
            return None
        return self.exchange(prev)

    def flush(self):
        prev = getattr(self, "_pending", None)
        self._pending = None
        if prev is None:
            return None
        return self.exchange(prev)

    def close(self) -> None:
        """Stop the heartbeat thread and drop this rank's heartbeat key."""
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
            self._hb_thread = None
        self.store.delete(self._hb_key(self.my_id))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
