"""SR-as-a-service on one card: multi-tenant search serving (the JAX
package's ``serve/``).

- ``program_cache`` — the unified, thread-safe, capacity-bounded LRU of what
  the port keeps on the card across searches (dataset uploads, operator
  tables). Process-global — warm across searches with or without a server.
- ``queue`` — the job model (``JobSpec``/``Job``) and the priority +
  warm-bucket + per-tenant-quota admission queue.
- ``server`` — ``SearchServer``: worker threads multiplexing jobs over the
  card, fleet coalescing and request collapsing, streaming frontier frames
  (format-2 bytes), enforcing deadlines, and preempting/resuming via spool
  checkpoints.
- ``journal`` — ``JobJournal``: the opt-in write-ahead log behind
  ``SearchServer(journal_dir=...)`` crash recovery, retries, and the
  QUARANTINED poison-job state.
- ``pod`` — ``PodNode``/``PodClient``: pod-scale federation — N servers
  over a shared CoordStore presenting one logical service, with
  warmth/load-aware admission, lane migration off dead hosts, and
  SIGTERM graceful drain.
- ``net`` — the network front door: ``NetServer`` (CRC-framed wire
  protocol over asyncio, auth-token→tenant, retryable overload shed)
  and the ``SRClient``/``AsyncSRClient`` SDK with reconnect +
  resume-from-frame-index streaming.
"""

from .journal import JobJournal
from .net import (
    AsyncSRClient,
    ConnectionLost,
    NetError,
    NetServer,
    RetryableWireError,
    SRClient,
    WireError,
)
from .pod import PodClient, PodNode
from .program_cache import (
    ProgramCache,
    enable_persistent_compilation_cache,
    global_program_cache,
)
from .queue import (
    CANCELLED,
    DONE,
    EXPIRED,
    FAILED,
    PREEMPTED,
    QUARANTINED,
    QUEUED,
    RUNNING,
    TERMINAL_STATES,
    Job,
    JobQueue,
    JobSpec,
    ServerOverloaded,
    bucket_digest,
    options_digest,
    queue_age_seconds,
    shape_bucket,
)
from .server import SearchServer

__all__ = [
    "ProgramCache",
    "global_program_cache",
    "enable_persistent_compilation_cache",
    "JobSpec",
    "Job",
    "JobQueue",
    "JobJournal",
    "SearchServer",
    "ServerOverloaded",
    "PodNode",
    "PodClient",
    "NetServer",
    "SRClient",
    "AsyncSRClient",
    "NetError",
    "WireError",
    "RetryableWireError",
    "ConnectionLost",
    "shape_bucket",
    "options_digest",
    "bucket_digest",
    "queue_age_seconds",
    "QUEUED",
    "RUNNING",
    "PREEMPTED",
    "DONE",
    "FAILED",
    "EXPIRED",
    "CANCELLED",
    "QUARANTINED",
    "TERMINAL_STATES",
]
