"""Pod-scale federated serving: N SearchServers, one logical service.

One :class:`PodNode` per host wraps a journaled
:class:`~.server.SearchServer` and federates through a shared
:class:`~..parallel.membership.CoordStore` (the same transport elastic
search membership rides). There is no central scheduler — the pod is a
peer-to-peer protocol over a handful of key namespaces:

- **advertisements** (``srpod/{pod}/ad/{host}``, mutable): each host
  republishes a heartbeat + load/warmth ad every ``SR_POD_HB_S`` — queue
  depth, running count, the digests of its warm shape buckets
  (:func:`~.queue.bucket_digest`: jobs in an advertised bucket find their
  data and operator tables in that host's program cache), draining flag,
  and the journal generation
  it currently owns.
- **federated admission**: a :class:`PodClient` routes each submit by
  reading the ads — alive, non-draining hosts whose warmth block contains
  the job's bucket digest first, then least loaded (queue depth + running
  + submits the client itself sent since the ad was stamped) — and drops
  a pickled JobSpec envelope into the chosen host's **inbox**
  (``srpod/{pod}/inbox/{host}/{pjid}``). The host consumes its inbox into
  its local server (journal first, then envelope delete, so a crash
  between the two dedups by pod job id instead of double-running).
- **results**: hosts republish each job's newest frontier frame under
  ``srpod/{pod}/frame/{pjid}`` (mutable) and its terminal record under
  ``srpod/{pod}/done/{pjid}`` — a WRITE-ONCE key. That write-once claim
  is the zero-duplicates mechanism: if a migration ever raced a job onto
  two hosts, exactly one result publishes and the loser increments its
  ``duplicate_results`` counter (the kill drill asserts it stays 0).
- **lane migration**: when a host's ad heartbeat lapses past
  ``SR_POD_SUSPECT_S`` (or its retirement marker appears), a survivor
  claims the dead host's journal generation via an atomic
  ``set_if_absent`` lease (``srpod/{pod}/claim/{host}/gen-N`` — the
  ExchangeGroup suspicion → epoch-bump shape, with the CoordStore lease
  standing in for the lockstep vote) and replays its journal: terminal
  jobs publish their recorded outcome (never rerun), queued AND running
  search jobs re-enter the survivor's server via
  :meth:`~.server.SearchServer.adopt_external` — attempts preserved, the
  dead host's spool checkpoint adopted, so an exact lockstep snapshot
  resumes BIT-IDENTICALLY — and unconsumed inbox envelopes are drained
  too. Each adoption publishes a pod epoch record
  (``srep/pod:{pod}/{n}``, write-once like search epoch records).
- **graceful drain** (``install_sigterm_drain``): SIGTERM pauses
  admission, preempt-checkpoints every running lane at its next
  iteration boundary (journaled ``requeue`` + format-2 spool snapshot),
  closes the journal, publishes a retirement marker, and exits — a
  survivor adopts the generation exactly like a crash, except nothing is
  lost mid-iteration and the handoff is immediate (no suspicion wait).

Journal generations make restart safe: host journals live under
``{root}/{host}/gen-NNNN``. A restarting host that finds its latest
generation CLAIMED (it was adopted while the host was down) starts a
fresh generation instead of re-running jobs another host now owns.

Counterpart of ``symbolicregression_jl_tpu/serve/pod.py`` over the port's
server, journal and coordination stores: the key names, the ad, lease,
done, epoch and retirement records, the routing and the poll backoff are
the JAX package's byte for byte, so a JAX :class:`PodClient` reads a port
pod's ads and done ledger (its final frames are pickled under the JAX
package's class names, ``utils/checkpoint._JaxNamedPickler``). Everything
the node reads from the store is unpickled by ``queue.safe_loads`` and
every spec by ``queue.decode_spec``, which import nothing of the JAX
package: a JAX envelope in a port node's inbox is a poison envelope and is
deleted. Two transports: :class:`~..parallel.membership.FileCoordStore`
(``SR_COORD_DIR``; the journal root defaults to ``{root}/_pod``) and
:class:`~..parallel.membership.TorchCoordStore` over a TCPStore, whose
journal root must be passed (``root=`` or ``SR_POD_ROOT``) and whose
``set_if_absent`` claims through an atomic counter that ``delete`` frees,
so a released lease can be won again.

Env knobs: ``SR_POD_ID`` (pod namespace, default ``pod0``),
``SR_POD_ROOT`` (shared journal root), ``SR_POD_HB_S`` (ad cadence,
default 0.25), ``SR_POD_SUSPECT_S`` (heartbeat lapse before adoption,
default 5). ``SR_COORD_GC_S`` sweeps the pod's coordination litter
(frames/done/ads of long-gone jobs); leases, retirement markers, and
epoch records are GC-protected.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
import uuid

from ..parallel.distributed import kv_backoff_max_ms, kv_backoff_ms
from ..parallel.membership import CoordStore, FileCoordStore, coord_store
from ..utils import faults
from . import queue as q
from .queue import (
    JobSpec,
    ServerOverloaded,
    bucket_digest,
    decode_spec,
    safe_loads,
    shape_bucket,
)
from .server import SearchServer

__all__ = ["PodNode", "PodClient", "pod_id_env"]


def pod_id_env() -> str:
    return os.environ.get("SR_POD_ID", "pod0") or "pod0"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _poll_backoff(poll: float):
    """Sleep schedule for the ``wait_*`` pollers: stay at the caller's
    ``poll`` interval for the first ``SR_KV_BACKOFF_MS`` of idle waiting
    (keeps first-frame / short-job latency tight), then double each idle
    poll up to ``SR_KV_BACKOFF_MAX_MS`` — the same knobs the KV gather's
    retry loop uses — so a long wait stops hammering the coordination
    store at a fixed interval."""
    fast_for = kv_backoff_ms() / 1000.0
    cap = max(poll, kv_backoff_max_ms() / 1000.0)
    interval = max(1e-4, poll)
    waited = 0.0
    while True:
        yield interval
        waited += interval
        if waited >= fast_for:
            interval = min(interval * 2.0, cap)


class _PodKeys:
    """Key-namespace arithmetic shared by nodes and clients."""

    def __init__(self, pod_id: str):
        self.pod_id = pod_id
        self.ns = f"srpod/{pod_id}"

    def ad(self, host: str) -> str:
        return f"{self.ns}/ad/{host}"

    def ad_prefix(self) -> str:
        return f"{self.ns}/ad/"

    def inbox(self, host: str, pjid: str) -> str:
        return f"{self.ns}/inbox/{host}/{pjid}"

    def inbox_prefix(self, host: str) -> str:
        return f"{self.ns}/inbox/{host}/"

    def frame(self, pjid: str) -> str:
        return f"{self.ns}/frame/{pjid}"

    def done(self, pjid: str) -> str:
        return f"{self.ns}/done/{pjid}"

    def done_prefix(self) -> str:
        return f"{self.ns}/done/"

    def claim(self, host: str, gen: int) -> str:
        return f"{self.ns}/claim/{host}/gen-{int(gen):04d}"

    def retire(self, host: str, gen: int) -> str:
        return f"{self.ns}/retire/{host}/gen-{int(gen):04d}"

    def epoch(self, n: int) -> str:
        # the membership module's epoch-record namespace (GC-protected,
        # write-once): the pod's adoption history is the same kind of
        # artifact as a search group's membership history
        return f"srep/pod:{self.pod_id}/{n}"


class PodNode:
    """One pod host: a journaled SearchServer + the federation loop.

    ``server_kwargs`` pass through to :class:`SearchServer` (worker count,
    fleet mode, retry budget, ...); ``journal_dir`` and ``spool_dir`` are
    owned by the node (the generation directory) and must not be passed.
    """

    def __init__(
        self,
        host_id: str,
        *,
        store: CoordStore | None = None,
        pod_id: str | None = None,
        root: str | None = None,
        hb_seconds: float | None = None,
        suspect_seconds: float | None = None,
        **server_kwargs,
    ):
        if "/" in host_id:
            raise ValueError("host_id must not contain '/'")
        self.host_id = host_id
        self.store = store if store is not None else coord_store()
        self.keys = _PodKeys(pod_id or pod_id_env())
        root = root or os.environ.get("SR_POD_ROOT") or None
        if root is None:
            # unwrap fault-injection decorators (PartitionedCoordStore):
            # the journal root lives on the real file-backed store
            inner = getattr(self.store, "inner", self.store)
            if isinstance(inner, FileCoordStore):
                root = os.path.join(inner.root, "_pod")
            else:
                raise ValueError(
                    "PodNode needs a shared journal root: pass root= or set "
                    "SR_POD_ROOT (required for lane migration — survivors "
                    "replay the dead host's journal from it)"
                )
        self.root = root
        self.hb_s = (
            _env_float("SR_POD_HB_S", 0.25)
            if hb_seconds is None
            else float(hb_seconds)
        )
        self.suspect_s = (
            _env_float("SR_POD_SUSPECT_S", 5.0)
            if suspect_seconds is None
            else float(suspect_seconds)
        )
        self._server_kwargs = dict(server_kwargs)
        self.server: SearchServer | None = None
        self.gen = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._draining = False
        self._drained = threading.Event()
        self.drain_seconds: float | None = None
        self._lock = threading.Lock()
        self._by_pjid: dict[str, str] = {}  # pjid -> local job id
        self._published_frames: dict[str, int] = {}
        self._done_published: set[str] = set()
        self._replayed: set[str] = set()  # pjids whose done may pre-exist
        self._adopted_jobs = 0
        self._adopted_hosts = 0
        self._duplicate_results = 0
        self._skew_suppressed = 0  # suspicions vetoed by ad-stamp progress
        self._last_peer_ad_t: dict[str, float] = {}  # host -> last seen stamp
        # host -> monotonic() when its ad stamp was first seen frozen; a
        # stale-looking peer is only adopted after staying frozen for a
        # full suspect window (see _scan_peers' clock-skew discipline)
        self._frozen_since: dict[str, float] = {}

    # -- generations -----------------------------------------------------------
    def _host_dir(self, host: str) -> str:
        return os.path.join(self.root, host)

    def _gen_dir(self, host: str, gen: int) -> str:
        return os.path.join(self._host_dir(host), f"gen-{int(gen):04d}")

    def _latest_gen(self, host: str) -> int:
        try:
            entries = os.listdir(self._host_dir(host))
        except OSError:
            return 0
        gens = [
            int(e[4:]) for e in entries
            if e.startswith("gen-") and e[4:].isdigit()
        ]
        return max(gens, default=0)

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> "PodNode":
        gen = max(1, self._latest_gen(self.host_id))
        if self.store.try_get(self.keys.claim(self.host_id, gen)) is not None:
            # the previous generation was adopted while this host was down:
            # its jobs belong to the adopter now — never re-run them
            gen += 1
        self.gen = gen
        jdir = self._gen_dir(self.host_id, gen)
        os.makedirs(jdir, exist_ok=True)
        self._publish_ad()  # fresh heartbeat BEFORE the (possibly slow) replay
        server = SearchServer(journal_dir=jdir, **self._server_kwargs)
        if self.store.try_get(self.keys.claim(self.host_id, self.gen)) is not None:
            # lost the boot-vs-adoption race: a survivor claimed this
            # generation while we were replaying it. Its jobs are the
            # adopter's; restart on a fresh generation before running any.
            server.shutdown(wait=False, cancel_queued=False)
            self.gen += 1
            jdir = self._gen_dir(self.host_id, self.gen)
            os.makedirs(jdir, exist_ok=True)
            server = SearchServer(journal_dir=jdir, **self._server_kwargs)
        self.server = server.start()
        self._register_recovered()
        self._publish_ad()
        self._thread = threading.Thread(
            target=self._loop, name=f"sr-pod-{self.host_id}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Hard stop for tests/teardown: no drain, no handoff marker. The
        journal stays adoptable (exactly like a crash, minus the suspicion
        wait a survivor must sit out)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self.server is not None:
            self.server.shutdown(wait=True, cancel_queued=False)

    def __enter__(self) -> "PodNode":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the federation loop ---------------------------------------------------
    def _loop(self) -> None:
        gc = getattr(self.store, "gc", None)
        while not self._stop.is_set():
            try:
                self._tick(gc)
            except Exception:  # noqa: BLE001 — the loop must survive any tick
                pass
            self._stop.wait(self.hb_s)

    def _tick(self, gc=None) -> None:
        self._publish_ad()
        if not self._draining:
            self._consume_inbox(self.host_id)
            self._scan_peers()
        self._publish_progress()
        if gc is not None:
            try:
                gc()  # SR_COORD_GC_S sweep; self-throttled, default off
            except Exception:  # noqa: BLE001
                pass

    def _publish_ad(self) -> None:
        srv = self.server
        stats = {"queued": 0, "running": 0}
        warm: list[str] = []
        if srv is not None:
            warm = srv.warm_digests()
            s = srv.stats()
            stats = {"queued": s["queued"], "running": s["running"]}
        ad = {
            "host": self.host_id,
            # the skewable clock source: a clock_skew rule shifts THIS
            # host's stamps while honest peers keep real time — exactly the
            # failure the scan-side progress veto must absorb
            "t": faults.skewed_time(self.host_id),
            "gen": self.gen,
            "pid": os.getpid(),
            "queue_depth": stats["queued"],
            "running": stats["running"],
            "warm": warm,
            "draining": self._draining,
            "adopted_jobs": self._adopted_jobs,
            "adopted_hosts": self._adopted_hosts,
            "duplicate_results": self._duplicate_results,
            "skew_suspects_suppressed": self._skew_suppressed,
        }
        try:
            self.store.set_mutable(
                self.keys.ad(self.host_id), pickle.dumps(ad)
            )
        except Exception:  # noqa: BLE001 — the next beat republishes
            pass

    def _track(self, pjid: str, local_id: str, replayed: bool = False) -> None:
        with self._lock:
            self._by_pjid[pjid] = local_id
            if replayed:
                self._replayed.add(pjid)

    def _register_recovered(self) -> None:
        """Map this server's journal-recovered jobs back to their pod ids
        (the spec label carries the pjid through the journal), so frames
        and terminals keep publishing after a restart — and so inbox
        envelopes that were journaled-but-not-deleted dedup instead of
        double-running."""
        with self.server._lock:
            jobs = list(self.server._jobs.values())
        for job in jobs:
            pjid = getattr(job.spec, "label", "")
            if pjid.startswith("pj-"):
                self._track(pjid, job.id, replayed=True)

    # -- inbox -----------------------------------------------------------------
    def _consume_inbox(self, host: str) -> None:
        for key in self.store.list(self.keys.inbox_prefix(host)):
            pjid = key.rsplit("/", 1)[-1]
            with self._lock:
                known = pjid in self._by_pjid
            if known or self.store.try_get(self.keys.done(pjid)) is not None:
                self.store.delete(key)  # journaled (or finished) already
                continue
            raw = self.store.try_get(key)
            if raw is None:
                continue
            try:
                env = safe_loads(raw)
                spec = decode_spec(env["spec"])
            except Exception:  # noqa: BLE001 — poison envelope (a JAX
                # JobSpec among them: it decodes to a stand-in, not JobSpec)
                self.store.delete(key)
                continue
            try:
                local_id = self.server.submit(spec)
            except ServerOverloaded:
                continue  # backpressure: leave the envelope for a later beat
            except RuntimeError:
                return  # shutting down
            self._track(pjid, local_id)
            # journal write happened inside submit(); deleting second means
            # a crash here re-offers the envelope and the pjid dedups above
            self.store.delete(key)

    # -- progress / results ----------------------------------------------------
    def _publish_progress(self) -> None:
        srv = self.server
        if srv is None:
            return
        with self._lock:
            tracked = dict(self._by_pjid)
        for pjid, local_id in tracked.items():
            if pjid in self._done_published:
                continue
            try:
                job = srv.job(local_id)
            except KeyError:
                continue
            start = self._published_frames.get(pjid, 0)
            frames = srv.frames(local_id, start=start)
            if frames:
                self._published_frames[pjid] = start + len(frames)
                try:
                    self.store.set_mutable(
                        self.keys.frame(pjid),
                        pickle.dumps({
                            "n": start + len(frames),
                            "frame": frames[-1],
                            "host": self.host_id,
                            "t": time.time(),
                        }),
                    )
                except Exception:  # noqa: BLE001
                    pass
            if job.terminal:
                self._publish_done(pjid, job)

    def _publish_done(self, pjid: str, job) -> None:
        frames = self.server.frames(job.id)
        rec = {
            "pjid": pjid,
            "state": job.state,
            "error": job.error,
            "stop_reason": job.stop_reason,
            "host": self.host_id,
            "attempts": job.attempts,
            "iterations_done": job.iterations_done,
            "resumed_from_iteration": job.resumed_from_iteration,
            "final_frame": frames[-1] if frames else None,
            "t": time.time(),
        }
        won = self.store.set_if_absent(self.keys.done(pjid), pickle.dumps(rec))
        if not won and pjid not in self._replayed:
            # someone else already published this job's terminal record: a
            # migration raced — count it (the kill drill pins this at 0)
            with self._lock:
                self._duplicate_results += 1
        self._done_published.add(pjid)

    # -- peer adoption ---------------------------------------------------------
    def _scan_peers(self) -> None:
        now = faults.skewed_time(self.host_id)
        for key in self.store.list(self.keys.ad_prefix()):
            host = key.rsplit("/", 1)[-1]
            if host == self.host_id:
                continue
            raw = self.store.try_get(key)
            if raw is None:
                continue
            try:
                ad = safe_loads(raw)
            except Exception:  # noqa: BLE001
                continue
            gen = int(ad.get("gen", 1))
            retired = (
                self.store.try_get(self.keys.retire(host, gen)) is not None
            )
            ad_t = float(ad.get("t", 0.0))
            stale = now - ad_t > self.suspect_s
            if not retired and stale:
                # clock-skew veto: an ad can look ancient because OUR clock
                # (or the peer's) is skewed, not because the peer died. A
                # dead host's stamp FREEZES — so if the stamp advanced since
                # the last scan, the host is provably still publishing and
                # suspicion is suppressed. Absolute age alone never migrates
                # lanes away from a live, heartbeating host.
                prev = self._last_peer_ad_t.get(host)
                self._last_peer_ad_t[host] = ad_t
                if prev is None or ad_t > prev:
                    # advanced (or first sight): alive, or not yet observed
                    # long enough to judge — start/restart the freeze clock
                    self._frozen_since.pop(host, None)
                    if prev is not None:
                        with self._lock:
                            self._skew_suppressed += 1
                    continue
                # stamp frozen across scans. One missed beat must NOT
                # migrate lanes away from a live host whose publish jitter
                # straddled two of our scans (with our clock skewed, the
                # absolute age is garbage and this pair-compare is ALL the
                # evidence there is) — so require the stamp to stay frozen
                # for a full suspect window of LOCAL MONOTONIC time, the
                # same no-heartbeat window the honest-clock path demands.
                t_frozen = self._frozen_since.setdefault(
                    host, time.monotonic()
                )
                if time.monotonic() - t_frozen < self.suspect_s:
                    continue
            else:
                self._last_peer_ad_t[host] = ad_t
                self._frozen_since.pop(host, None)
            if not retired and not stale:
                continue
            claim_key = self.keys.claim(host, gen)
            if self.store.try_get(claim_key) is not None:
                continue  # already adopted (possibly by the host's own boot)
            lease = {"by": self.host_id, "t": now, "retired": retired}
            if not self.store.set_if_absent(claim_key, pickle.dumps(lease)):
                continue  # another survivor won the lease
            if not retired:
                # liveness re-check after the claim: ANY stamp advance since
                # we started suspecting proves a live publisher (a dead
                # host's stamp cannot move) — back off and release. No
                # absolute-age clause here: with our clock skewed, a live
                # host's fresh ad still looks ancient, and the old
                # age-qualified check waved exactly those adoptions through.
                raw2 = self.store.try_get(key)
                if raw2 is not None:
                    try:
                        ad2 = safe_loads(raw2)
                        if float(ad2.get("t", 0.0)) > ad_t:
                            self.store.delete(claim_key)
                            self._frozen_since.pop(host, None)
                            continue
                    except Exception:  # noqa: BLE001
                        pass
            self._adopt_host(host, gen, retired=retired)
            self._frozen_since.pop(host, None)
            self.store.delete(key)  # off the routing table

    def _adopt_host(self, host: str, gen: int, retired: bool) -> None:
        """Replay a claimed generation's journal into OUR server: terminal
        jobs publish their recorded outcome exactly once and never rerun;
        live search jobs re-admit with attempts + checkpoint preserved;
        the dead host's unconsumed inbox drains into ours."""
        from .journal import JobJournal

        jdir = self._gen_dir(host, gen)
        adopted = 0
        state: dict[str, dict] = {}
        if os.path.isdir(jdir):
            journal = JobJournal(jdir)
            try:
                state = journal.replay()
            except Exception:  # noqa: BLE001 — unreadable journal: the
                state = {}  # inbox sweep below still rescues queued envelopes
            finally:
                journal.close()
        for st in sorted(state.values(), key=lambda s: s["seq"]):
            spec = None
            if st.get("spec") is not None:
                try:
                    spec = decode_spec(st["spec"])
                except ValueError:
                    spec = None
            pjid = getattr(spec, "label", "") if spec is not None else ""
            if not pjid.startswith("pj-"):
                continue  # not a pod job (or an undurable spec)
            with self._lock:
                if pjid in self._by_pjid:
                    continue  # chained adoption already brought it here
            if st["state"] in q.TERMINAL_STATES:
                # report once from the journal record; never rerun. The
                # victim usually published this itself — set_if_absent
                # makes the replay idempotent either way.
                self._replayed.add(pjid)
                rec = {
                    "pjid": pjid,
                    "state": st["state"],
                    "error": st.get("error"),
                    "stop_reason": None,
                    "host": host,
                    "attempts": int(st.get("attempts", 0)),
                    "iterations_done": int(st.get("iterations_done", 0)),
                    "resumed_from_iteration": None,
                    "final_frame": None,
                    "from_journal_of": host,
                    "t": time.time(),
                }
                self.store.set_if_absent(
                    self.keys.done(pjid), pickle.dumps(rec)
                )
                self._done_published.add(pjid)
                continue
            if spec.kind != "search":
                # a live stream died with its host; the client resubscribes
                self._replayed.add(pjid)
                rec = {
                    "pjid": pjid,
                    "state": q.CANCELLED,
                    "error": f"host {host} lost mid-subscription",
                    "stop_reason": None,
                    "host": host,
                    "attempts": int(st.get("attempts", 0)),
                    "iterations_done": int(st.get("iterations_done", 0)),
                    "resumed_from_iteration": None,
                    "final_frame": None,
                    "from_journal_of": host,
                    "t": time.time(),
                }
                self.store.set_if_absent(
                    self.keys.done(pjid), pickle.dumps(rec)
                )
                self._done_published.add(pjid)
                continue
            try:
                local_id = self.server.adopt_external(
                    spec,
                    attempts=int(st.get("attempts", 0)),
                    iterations_done=int(st.get("iterations_done", 0)),
                    ckpt=st.get("ckpt"),
                    submitted_at=float(st.get("submitted_at") or 0.0) or None,
                    error=st.get("error"),
                )
            except RuntimeError:
                return  # shutting down mid-adoption; lease keeps others out
            self._track(pjid, local_id)
            adopted += 1
        self._consume_inbox(host)
        with self._lock:
            self._adopted_jobs += adopted
            self._adopted_hosts += 1
        self._publish_epoch({
            "event": "handoff" if retired else "adopt",
            "host": host,
            "gen": gen,
            "by": self.host_id,
            "jobs": adopted,
            "t": time.time(),
        })

    def _publish_epoch(self, record: dict) -> None:
        for n in range(1, 100000):
            if self.store.try_get(self.keys.epoch(n)) is not None:
                continue
            record = dict(record, epoch=n)
            if self.store.set_if_absent(
                self.keys.epoch(n), pickle.dumps(record)
            ):
                return

    # -- graceful drain --------------------------------------------------------
    def drain(self, timeout: float = 60.0) -> bool:
        """SIGTERM semantics: stop admission, checkpoint every running lane
        at its next iteration boundary, close the journal, publish the
        retirement marker, and stop. A peer adopts the generation — queued
        and preempt-checkpointed jobs resume elsewhere with zero loss."""
        t0 = time.monotonic()
        self._draining = True
        self._publish_ad()  # routers see draining=True immediately
        srv = self.server
        idle = True
        if srv is not None:
            idle = srv.drain(timeout=timeout)
            self._publish_progress()  # final frames + any terminals
            srv.shutdown(wait=True, cancel_queued=False)
        self._stop.set()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=10)
        self.store.set_if_absent(
            self.keys.retire(self.host_id, self.gen),
            pickle.dumps({
                "host": self.host_id,
                "gen": self.gen,
                "t": time.time(),
                "idle": idle,
            }),
        )
        self._publish_ad()
        self._drained.set()
        self.drain_seconds = time.monotonic() - t0
        return idle

    def install_sigterm_drain(self) -> None:
        """Route SIGTERM (the preemptible-VM shape) to :meth:`drain` then
        a clean exit. The drain runs on a side thread — signal handlers
        must not block — and the process exits 0 once the handoff marker
        is published."""
        import signal

        def _drain_and_exit() -> None:
            try:
                self.drain()
            finally:
                os._exit(0)

        def _handler(signum, frame):  # noqa: ARG001
            threading.Thread(
                target=_drain_and_exit, name="sr-pod-sigterm-drain",
                daemon=True,
            ).start()

        signal.signal(signal.SIGTERM, _handler)

    # -- observability ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            out = {
                "host": self.host_id,
                "pod": self.keys.pod_id,
                "gen": self.gen,
                "draining": self._draining,
                "tracked_jobs": len(self._by_pjid),
                "adopted_jobs": self._adopted_jobs,
                "adopted_hosts": self._adopted_hosts,
                "duplicate_results": self._duplicate_results,
                "skew_suspects_suppressed": self._skew_suppressed,
            }
        if self.server is not None:
            out["server"] = self.server.stats()
        return out


class PodClient:
    """Submit-side view of the pod: route by warmth/load, poll results.

    The client is stateless apart from a routing hint (submits it has sent
    since each host's ad was stamped — ads refresh every ``SR_POD_HB_S``,
    and a burst of submits between beats would otherwise all land on the
    host that happened to look least loaded)."""

    def __init__(
        self,
        store: CoordStore | None = None,
        pod_id: str | None = None,
        suspect_seconds: float | None = None,
    ):
        self.store = store if store is not None else coord_store()
        self.keys = _PodKeys(pod_id or pod_id_env())
        self.suspect_s = (
            _env_float("SR_POD_SUSPECT_S", 5.0)
            if suspect_seconds is None
            else float(suspect_seconds)
        )
        self._sent_since: dict[str, list[float]] = {}

    # -- topology --------------------------------------------------------------
    def hosts(self) -> dict[str, dict]:
        out = {}
        for key in self.store.list(self.keys.ad_prefix()):
            raw = self.store.try_get(key)
            if raw is None:
                continue
            try:
                ad = safe_loads(raw)
            except Exception:  # noqa: BLE001
                continue
            out[key.rsplit("/", 1)[-1]] = ad
        return out

    def live_hosts(self) -> dict[str, dict]:
        now = time.time()
        return {
            h: ad
            for h, ad in self.hosts().items()
            if not ad.get("draining")
            and now - float(ad.get("t", 0.0)) <= self.suspect_s
        }

    def _load(self, host: str, ad: dict) -> int:
        stamped = float(ad.get("t", 0.0))
        pending = [t for t in self._sent_since.get(host, ()) if t > stamped]
        self._sent_since[host] = pending
        return int(ad.get("queue_depth", 0)) + int(ad.get("running", 0)) + len(
            pending
        )

    def route(self, spec: JobSpec) -> str:
        """Warmth-first, least-loaded routing: among alive non-draining
        hosts, those advertising the job's bucket digest (their compiled
        programs fit it) win; ties and cold buckets go to the smallest
        queue+running+recently-routed load."""
        live = self.live_hosts()
        if not live:
            raise RuntimeError(
                f"pod {self.keys.pod_id}: no live hosts advertising"
            )
        digest = bucket_digest(
            shape_bucket(spec.X, spec.y, spec.weights, spec.options)
        )
        warm = {
            h: ad for h, ad in live.items() if digest in ad.get("warm", ())
        }
        pool = warm or live
        return min(pool, key=lambda h: (self._load(h, pool[h]), h))

    # -- submit / results ------------------------------------------------------
    def submit(
        self, spec: JobSpec, host: str | None = None, pjid: str | None = None
    ) -> str:
        """Route ``spec`` and drop it into the chosen host's inbox. Returns
        the pod job id (also stamped into ``spec.label`` — the identity
        that survives journals, migrations, and retries)."""
        pjid = pjid or f"pj-{uuid.uuid4().hex[:16]}"
        spec.label = pjid
        target = host or self.route(spec)
        env = {
            "pjid": pjid,
            "spec": pickle.dumps(spec, protocol=pickle.HIGHEST_PROTOCOL),
            "t": time.time(),
            "host": target,
        }
        self.store.set(self.keys.inbox(target, pjid), pickle.dumps(env))
        self._sent_since.setdefault(target, []).append(time.time())
        return pjid

    def done(self, pjid: str) -> dict | None:
        raw = self.store.try_get(self.keys.done(pjid))
        return None if raw is None else safe_loads(raw)

    def latest_frame(self, pjid: str) -> dict | None:
        raw = self.store.try_get(self.keys.frame(pjid))
        return None if raw is None else safe_loads(raw)

    def wait(self, pjid: str, timeout: float = 300.0, poll: float = 0.05) -> dict:
        deadline = time.monotonic() + timeout
        backoff = _poll_backoff(poll)
        while True:
            rec = self.done(pjid)
            if rec is not None:
                return rec
            now = time.monotonic()
            if now >= deadline:
                raise TimeoutError(f"pod job {pjid} not terminal in {timeout}s")
            time.sleep(min(next(backoff), deadline - now))

    def wait_first_frame(
        self, pjid: str, timeout: float = 300.0, poll: float = 0.02
    ) -> float:
        """Block until the job's first frontier frame (or terminal record)
        is visible; returns the wall-clock time it was observed — the
        client-side TTFF instant."""
        deadline = time.monotonic() + timeout
        backoff = _poll_backoff(poll)
        while True:
            if (
                self.latest_frame(pjid) is not None
                or self.done(pjid) is not None
            ):
                return time.time()
            now = time.monotonic()
            if now >= deadline:
                raise TimeoutError(f"pod job {pjid}: no frame in {timeout}s")
            time.sleep(min(next(backoff), deadline - now))

    def wait_all(
        self, pjids, timeout: float = 600.0, poll: float = 0.05
    ) -> dict[str, dict]:
        deadline = time.monotonic() + timeout
        out: dict[str, dict] = {}
        pending = list(pjids)
        backoff = _poll_backoff(poll)
        while pending:
            progressed = False
            for pjid in list(pending):
                rec = self.done(pjid)
                if rec is not None:
                    out[pjid] = rec
                    pending.remove(pjid)
                    progressed = True
            if not pending:
                break
            now = time.monotonic()
            if now >= deadline:
                raise TimeoutError(
                    f"pod jobs not terminal in {timeout}s: {pending}"
                )
            if progressed:  # results are landing — reset to the fast poll
                backoff = _poll_backoff(poll)
            time.sleep(min(next(backoff), deadline - now))
        return out

    def results(self) -> dict[str, dict]:
        """Every published terminal record in the pod (drill assertions:
        the done-key set IS the exactly-once ledger)."""
        out = {}
        for key in self.store.list(self.keys.done_prefix()):
            raw = self.store.try_get(key)
            if raw is None:
                continue
            try:
                out[key.rsplit("/", 1)[-1]] = safe_loads(raw)
            except Exception:  # noqa: BLE001
                continue
        return out
