"""Unified program cache: ONE thread-safe bounded LRU for everything the
port holds on the card across searches.

Counterpart of ``symbolicregression_jl_tpu/serve/program_cache.py``. The JAX
package memoizes compiled programs here (jitted score fns, AOT executables,
block closures) beside its device-resident datasets. The port compiles
nothing per shape: its kernels are four shared libraries built once per
source (``ops/interp_cuda.build_all``), so the compile kinds have no
counterpart. What the port does keep across searches goes through this
cache, keyed on ``(kind, key)``:

- **Data entries** (``nbytes > 0``), bounded by total BYTES
  (``SR_SCORE_DATA_CACHE_MB``, default 256):

  - ``"score_data"``: the engine's ``ScoreData`` upload of a dataset
    (``models/device_search._cached_score_data``), keyed as the JAX package
    keys it (the dataset's digest, the score norm, the engine dtype and the
    device). A cached ScoreData is never written in place: the fleet stacks
    copies of its lanes' entries (``_FleetData``) and a stream swap writes
    into that stack, and a swap's one-off data is built outside the cache
    (``_FleetLane.rebuild_score_data``).

- **Program entries** (``nbytes == 0``), bounded by entry COUNT
  (``SR_PROGRAM_CACHE_SIZE``, default 64):

  - ``"optab"``: the kernels' operator table on a device
    (``models/scorer.cached_optab``), a few hundred bytes each. Each search's
    scorer looks it up once and hands it to every launch it makes, so the
    kernel layer (``ops/``) never reaches this cache.

Eviction is LRU within each class (a burst of tiny datasets never evicts a
table, and vice versa), and the most-recently-inserted entry is never
evicted: a single dataset larger than the whole byte budget is admitted
alone, so callers always get cache-or-build semantics and eviction only
ever costs a re-upload, never an error. A search that loses an entry
mid-run keeps its reference.

Builds happen OUTSIDE the lock (``get``, then build, then ``put``, where
``put`` has setdefault semantics and returns the winning value), so racing
builders converge on one canonical value.

The JAX package's ``oom_compile`` fault site fires at a miss of its
compile kinds. The port caches no compiled program, so the site is
``oom_site``, called just before the largest allocation a run makes on the
card: the fleet's lane-axis stack (``models/device_search._FleetData``),
under the JAX package's kind name ``"fleet_aot"`` so that its fault specs
carry over. The stack is never cached (stream swaps write into it), and the
site touches no counter: ``get`` counts only real lookups.
"""

from __future__ import annotations

import os
import threading

__all__ = [
    "ProgramCache",
    "global_program_cache",
    "enable_persistent_compilation_cache",
    "is_oom_error",
    "oom_site",
]

_DEFAULT_CAPACITY = 64  # program entries (operator tables)
_DEFAULT_DATA_MB = 256  # ScoreData device-tensor budget


def is_oom_error(exc: BaseException) -> bool:
    """Does this exception mean the card ran out of memory building or
    running a search? Matches ``torch.OutOfMemoryError`` ("CUDA out of
    memory"), the JAX package's ``RESOURCE_EXHAUSTED`` text and the injected
    :class:`~..utils.faults.ResourceExhaustedInjected` with one predicate:
    the serve layer's downshift keys off it, so the simulation exercises the
    production path."""
    import torch

    if isinstance(exc, torch.OutOfMemoryError):
        return True
    text = str(exc)
    return "RESOURCE_EXHAUSTED" in text or "out of memory" in text.lower()


def oom_site(kind: str, key) -> None:
    """The ``oom_compile`` fault site, called just before a build that
    allocates on the card (``kind``: the JAX package's kind name of that
    build). Raises ``ResourceExhaustedInjected`` when an armed rule fires
    and its ``kind`` param, if any, names ``kind``; the rule's call count is
    consumed either way, so it addresses the Nth build."""
    from ..utils import faults

    inj = faults.active()
    if inj.armed("oom_compile"):
        hit = inj.fire("oom_compile")
        if hit is not None and ("kind" not in hit or str(hit["kind"]) == kind):
            raise faults.ResourceExhaustedInjected(kind, key)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}") from None


class ProgramCache:
    """Thread-safe LRU over ``(kind, key)`` with count- and byte-budgets.

    LRU order is dict insertion order: a hit re-inserts at the MRU end,
    eviction pops from the LRU front."""

    def __init__(
        self,
        capacity: int | None = None,
        data_budget_bytes: int | None = None,
    ):
        self.capacity = (
            _env_int("SR_PROGRAM_CACHE_SIZE", _DEFAULT_CAPACITY)
            if capacity is None
            else int(capacity)
        )
        self.data_budget_bytes = (
            _env_int("SR_SCORE_DATA_CACHE_MB", _DEFAULT_DATA_MB) * (1 << 20)
            if data_budget_bytes is None
            else int(data_budget_bytes)
        )
        if self.capacity < 1:
            raise ValueError("program cache capacity must be >= 1")
        if self.data_budget_bytes < 0:
            raise ValueError("score-data byte budget must be >= 0")
        self._lock = threading.RLock()
        self._entries: dict = {}  # (kind, key) -> (value, nbytes)
        self._data_bytes = 0
        self._hits: dict = {}
        self._misses: dict = {}
        self._evictions: dict = {}

    # -- core API ------------------------------------------------------------
    def get(self, kind: str, key):
        """LRU lookup: a hit re-inserts at the MRU end and counts a hit; a
        miss counts a miss and returns None."""
        k = (kind, key)
        with self._lock:
            ent = self._entries.get(k)
            if ent is None:
                self._misses[kind] = self._misses.get(kind, 0) + 1
            else:
                self._entries[k] = self._entries.pop(k)  # refresh to MRU
                self._hits[kind] = self._hits.get(kind, 0) + 1
                return ent[0]
        return None

    def put(self, kind: str, key, value, nbytes: int = 0):
        """Insert with setdefault semantics: if another thread won the build
        race, the existing entry wins and is returned (and refreshed to MRU);
        the loser's build is discarded. ``nbytes > 0`` marks a data entry
        charged against the byte budget instead of the entry-count budget."""
        k = (kind, key)
        nbytes = int(nbytes)
        with self._lock:
            ent = self._entries.get(k)
            if ent is not None:
                self._entries[k] = self._entries.pop(k)
                return ent[0]
            self._entries[k] = (value, nbytes)
            if nbytes > 0:
                self._data_bytes += nbytes
            self._evict_over_budget(keep=k)
            return value

    def get_or_build(self, kind: str, key, build):
        """Convenience wrapper for call sites without side conditions: the
        build runs OUTSIDE the lock; concurrent builders converge on one
        canonical value through ``put``'s setdefault semantics."""
        value = self.get(kind, key)
        if value is not None:
            return value
        return self.put(kind, key, build())

    def _evict_over_budget(self, keep) -> None:
        # caller holds the lock. LRU within each class: over-count evicts the
        # oldest PROGRAM entry, over-bytes the oldest DATA entry; `keep` (the
        # entry just inserted) is exempt, so an oversized entry is admitted
        # alone
        n_programs = sum(1 for (_, nb) in self._entries.values() if nb == 0)
        while n_programs > self.capacity:
            victim = next(
                (k for k, (_, nb) in self._entries.items() if nb == 0 and k != keep),
                None,
            )
            if victim is None:
                break
            self._entries.pop(victim)
            self._evictions[victim[0]] = self._evictions.get(victim[0], 0) + 1
            n_programs -= 1
        while self._data_bytes > self.data_budget_bytes:
            victim = next(
                (k for k, (_, nb) in self._entries.items() if nb > 0 and k != keep),
                None,
            )
            if victim is None:
                break
            _, nb = self._entries.pop(victim)
            self._data_bytes -= nb
            self._evictions[victim[0]] = self._evictions.get(victim[0], 0) + 1

    # -- maintenance -----------------------------------------------------------
    def evict(self, kind: str | None = None) -> int:
        """Evict every entry (or every entry of one kind); returns the
        number evicted."""
        with self._lock:
            victims = [k for k in self._entries if kind is None or k[0] == kind]
            for k in victims:
                _, nb = self._entries.pop(k)
                if nb > 0:
                    self._data_bytes -= nb
                self._evictions[k[0]] = self._evictions.get(k[0], 0) + 1
            return len(victims)

    def clear(self) -> int:
        """Evict everything AND zero the counters (test isolation)."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._data_bytes = 0
            self._hits.clear()
            self._misses.clear()
            self._evictions.clear()
            return n

    # -- introspection ---------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self, kind: str | None = None) -> list:
        with self._lock:
            return [k for k in self._entries if kind is None or k[0] == kind]

    def stats(self) -> dict:
        """Snapshot of the counters and occupancy: the shape of the JAX
        package's, which ``SearchResult.engine_profile["counters"]
        ["program_cache"]`` and the server's ``stats()`` report."""
        with self._lock:
            kinds = set(self._hits) | set(self._misses) | set(self._evictions)
            by_kind = {
                kind: {
                    "hits": self._hits.get(kind, 0),
                    "misses": self._misses.get(kind, 0),
                    "evictions": self._evictions.get(kind, 0),
                }
                for kind in sorted(kinds)
            }
            hits = sum(self._hits.values())
            misses = sum(self._misses.values())
            # kinds prefixed "fleet" roll up apart from the solo ones
            fleet_hits = sum(v for k, v in self._hits.items() if k.startswith("fleet"))
            fleet_misses = sum(v for k, v in self._misses.items() if k.startswith("fleet"))
            return {
                "hits": hits,
                "misses": misses,
                "evictions": sum(self._evictions.values()),
                "entries": len(self._entries),
                "data_bytes": self._data_bytes,
                "capacity": self.capacity,
                "data_budget_bytes": self.data_budget_bytes,
                "hit_ratio": hits / (hits + misses) if hits + misses else 0.0,
                "by_kind": by_kind,
                "fleet": {
                    "hits": fleet_hits,
                    "misses": fleet_misses,
                    "solo_hits": hits - fleet_hits,
                    "solo_misses": misses - fleet_misses,
                },
            }


# ONE process-wide instance: concurrent searches (serve workers, fleets)
# share uploads and tables through it, behind one lock and one budget
_GLOBAL: ProgramCache | None = None
_GLOBAL_LOCK = threading.Lock()


def global_program_cache() -> ProgramCache:
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = ProgramCache()
        return _GLOBAL


def enable_persistent_compilation_cache(path: str | None = None) -> str | None:
    """Keep the port's compiled artifacts on disk across restarts, so a
    restarted server starts warm. The JAX package points XLA's compilation
    cache here; the port's only compiled artifacts are the kernel libraries,
    so this points ``ops/interp_cuda``'s build directory at ``path`` (each
    library is named by the hash of its sources and flags, and a library
    found there is loaded instead of built).

    ``path`` falls back to ``SR_COMPILATION_CACHE_DIR``; returns the
    directory in use, or None when neither is set (feature off)."""
    path = path or os.environ.get("SR_COMPILATION_CACHE_DIR")
    if not path:
        return None
    os.makedirs(path, exist_ok=True)
    from pathlib import Path

    from ..ops import interp_cuda

    interp_cuda.BUILD_DIR = Path(path)
    return path
