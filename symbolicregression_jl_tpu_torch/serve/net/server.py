"""``NetServer``: the asyncio socket front door over a ``SearchServer``.

Counterpart of ``symbolicregression_jl_tpu/serve/net/server.py`` over the
port's server. A submitted spec is unpickled on the loop thread by
``queue.decode_spec``: the port's ``JobSpec`` and ``Options`` unpickle
without touching the card (``Options.__setstate__`` only reruns
``__post_init__``), and the job runs where its ``Options.device`` says. A
spec pickled by the JAX package decodes to stand-ins of its classes, so
the JAX package is never imported, and is refused as ``'spec' decodes to
JobSpec, not JobSpec`` whether or not that package is installed, as the
journal and the pod refuse it.

Everything below the wire is the existing serve stack — admission queue,
per-tenant quotas, fleet coalescing/dedup, journal durability, preemption.
This layer only (a) frames requests/responses with the journal's CRC
discipline (``serve/net/wire.py``), (b) authenticates a token to a tenant
so the queue's quotas apply to network callers, (c) fans frontier frames
out to subscribed connections, and (d) turns overload into a *retryable*
wire error with a retry-after hint instead of a stalled socket.

Threading model (three kinds of thread, one rule each):

- the **asyncio loop thread** owns every connection: reads, dispatch,
  per-connection bounded send queues, and the writer/pusher tasks;
- the **bridge thread** is the only poller: it sleeps on
  ``SearchServer.wait_activity()`` (one condition variable for ALL jobs)
  and tickles the loop when any frame lands or any job goes terminal —
  N subscriptions cost one thread, not N;
- the ``SearchServer``'s own worker threads never learn the network
  exists; ops that take server locks or fsync (submit, push_rows, stats)
  run via ``asyncio.to_thread`` so the loop never blocks on them.

Frame fan-out is pull-from-index, push-on-activity: each connection
remembers the next frame index per subscribed job and drains
``frames_since(job, index)`` — a single-lock consistent snapshot — on
every activity tick. Because delivery is index-addressed, a reconnecting
client resumes from exactly the first frame it never received: the server
replays the stored ``Job.frames`` suffix, and nothing is duplicated.

Backpressure: a client that stops reading fills its bounded send queue or
stalls ``drain()`` past ``SR_NET_SLOW_CLIENT_S`` — either way the
connection is shed (counted in ``dropped_slow``) rather than buffering
without bound; the SDK reconnects and resumes by index. Admission-side
overload (``ServerOverloaded``, connection cap) answers with
``{"error": "overloaded", "retryable": True, "retry_after_s": hint}``.

Env knobs: ``SR_NET_HOST`` (default 127.0.0.1), ``SR_NET_PORT`` (default
0 = ephemeral), ``SR_NET_TOKENS`` (``token=tenant,...`` — when set, ALL
clients must present a known token and their jobs are forced onto that
tenant), ``SR_NET_MAX_CONNS`` (256), ``SR_NET_SEND_QUEUE`` (256 frames),
``SR_NET_SLOW_CLIENT_S`` (10), ``SR_NET_HELLO_S`` (10),
``SR_NET_RETRY_AFTER_S`` (0.25 base hint), ``SR_NET_MAX_FRAME_MB`` (64).

Fault sites (``utils/faults.py``): ``torn_frame`` / ``net_drop`` fire per
*pushed stream frame* in the writer (deterministic counts for a single
subscribed stream); ``slow_client`` lives in the SDK's reader.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import threading
import time
import uuid

from ...utils import faults
from ..queue import ServerOverloaded, decode_spec
from .wire import WIRE_MAGIC, FrameDecoder, WireError, encode_message

__all__ = ["NetServer", "parse_tokens"]


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def parse_tokens(val: str) -> dict[str, str]:
    """``"token=tenant,token2=tenant2"`` → mapping (``SR_NET_TOKENS``)."""
    out: dict[str, str] = {}
    for chunk in (val or "").split(","):
        chunk = chunk.strip()
        if not chunk:
            continue
        tok, sep, tenant = chunk.partition("=")
        if sep and tok.strip():
            out[tok.strip()] = tenant.strip() or "default"
    return out


class _Conn:
    """Loop-thread-only per-connection state."""

    def __init__(self, reader, writer, sendq_max: int):
        self.reader = reader
        self.writer = writer
        self.sendq: asyncio.Queue = asyncio.Queue(maxsize=sendq_max)
        self.tenant: str | None = None
        self.subs: dict[str, int] = {}  # job_id -> next frame index to push
        self.tasks: set[asyncio.Task] = set()
        self.alive = True


_OP_NAMES = frozenset(
    {
        "ping",
        "submit",
        "status",
        "cancel",
        "wait",
        "frames",
        "subscribe",
        "unsubscribe",
        "push_rows",
        "replace_rows",
        "stats",
    }
)


class NetServer:
    """Socket front door over a started :class:`~..server.SearchServer`.

    Usage::

        with SearchServer(max_concurrency=4) as srv:
            net = NetServer(srv, port=0).start()
            ...  # net.port is the bound port
            net.shutdown()

    The caller owns the wrapped server's lifecycle; ``shutdown()`` only
    tears down the network layer.
    """

    def __init__(
        self,
        server,
        host: str | None = None,
        port: int | None = None,
        tokens: dict[str, str] | None = None,
        max_conns: int | None = None,
        send_queue: int | None = None,
        slow_client_s: float | None = None,
    ):
        self.server = server
        self.host = (
            host if host is not None else os.environ.get("SR_NET_HOST", "127.0.0.1")
        )
        self.port = int(port) if port is not None else _env_int("SR_NET_PORT", 0)
        self.tokens = (
            dict(tokens)
            if tokens is not None
            else parse_tokens(os.environ.get("SR_NET_TOKENS", ""))
        )
        self.max_conns = (
            int(max_conns) if max_conns is not None else _env_int("SR_NET_MAX_CONNS", 256)
        )
        self.send_queue = (
            int(send_queue)
            if send_queue is not None
            else _env_int("SR_NET_SEND_QUEUE", 256)
        )
        self.slow_client_s = (
            float(slow_client_s)
            if slow_client_s is not None
            else _env_float("SR_NET_SLOW_CLIENT_S", 10.0)
        )
        self.hello_s = _env_float("SR_NET_HELLO_S", 10.0)
        # Boot id: frame indices are meaningful within one server process.
        # A client that reconnects and sees a different boot knows the
        # server restarted (journal recovery) and must restart its streams
        # from index 0 instead of resuming.
        self.boot = uuid.uuid4().hex[:12]
        self._conns: set[_Conn] = set()
        self._counters = {
            "conns": 0,
            "shed_conns": 0,
            "dropped_slow": 0,
            "auth_failures": 0,
            "requests": 0,
            "frames_pushed": 0,
            "net_faults": 0,
        }
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._bridge: threading.Thread | None = None
        self._stop = threading.Event()
        self._stop_async: asyncio.Event | None = None
        self._started = False
        # loop-thread state for the activity fan-out (condvar pattern:
        # a seq bump between a pusher's pass and its re-wait is never lost)
        self._waiters: set[asyncio.Future] = set()
        self._notify_seq = 0

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> "NetServer":
        if self._started:
            return self
        ready = threading.Event()
        boot_err: list[BaseException] = []
        self._thread = threading.Thread(
            target=self._run_loop, args=(ready, boot_err), name="sr-net-loop",
            daemon=True,
        )
        self._thread.start()
        ready.wait(30.0)
        if boot_err:
            raise boot_err[0]
        if not ready.is_set():
            raise RuntimeError("NetServer event loop failed to start in 30s")
        self._bridge = threading.Thread(
            target=self._bridge_loop, name="sr-net-bridge", daemon=True
        )
        self._bridge.start()
        self._started = True
        return self

    def shutdown(self) -> None:
        if not self._started:
            return
        self._stop.set()
        loop = self._loop
        if loop is not None and not loop.is_closed():
            with contextlib.suppress(RuntimeError):
                loop.call_soon_threadsafe(self._begin_stop)
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        if self._bridge is not None:
            self._bridge.join(timeout=2.0)
        self._started = False

    def __enter__(self) -> "NetServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def net_stats(self) -> dict:
        return {
            "boot": self.boot,
            "host": self.host,
            "port": self.port,
            "active_conns": len(self._conns),
            **dict(self._counters),
        }

    # -- event loop ------------------------------------------------------------
    def _run_loop(self, ready: threading.Event, boot_err: list) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            loop.run_until_complete(self._main(ready, boot_err))
        finally:
            with contextlib.suppress(Exception):
                loop.run_until_complete(loop.shutdown_asyncgens())
            loop.close()

    async def _main(self, ready: threading.Event, boot_err: list) -> None:
        self._stop_async = asyncio.Event()
        try:
            srv = await asyncio.start_server(self._handle, self.host, self.port)
        except OSError as exc:
            boot_err.append(exc)
            ready.set()
            return
        self.port = srv.sockets[0].getsockname()[1]
        ready.set()
        async with srv:
            await self._stop_async.wait()
            for conn in list(self._conns):
                self._abort(conn)
            # reap EVERYTHING still on the loop (handler tasks, writers,
            # pushers, in-flight requests) so no coroutine outlives it;
            # multiple rounds because a cancelled handler's cleanup can
            # itself leave freshly-cancelled children behind
            for _ in range(3):
                pending = [
                    t
                    for t in asyncio.all_tasks()
                    if t is not asyncio.current_task()
                ]
                if not pending:
                    break
                for task in pending:
                    task.cancel()
                with contextlib.suppress(Exception):
                    await asyncio.wait(pending, timeout=1.0)

    def _begin_stop(self) -> None:
        if self._stop_async is not None:
            self._stop_async.set()
        self._notify()

    def _bridge_loop(self) -> None:
        last = 0
        while not self._stop.is_set():
            cur = self.server.wait_activity(last, timeout=0.5)
            if self._stop.is_set():
                return
            if cur == last:
                continue
            last = cur
            loop = self._loop
            if loop is not None and not loop.is_closed():
                with contextlib.suppress(RuntimeError):
                    loop.call_soon_threadsafe(self._notify)

    def _notify(self) -> None:
        self._notify_seq += 1
        for fut in list(self._waiters):
            if not fut.done():
                fut.set_result(None)
        self._waiters.clear()

    async def _wait_notify(self, seen: int, timeout: float) -> int:
        """Wait until the notify seq advances past ``seen`` (or timeout);
        returns the current seq. A bump that happened between the caller's
        last pass and this call returns immediately — no lost wakeups."""
        if self._notify_seq != seen:
            return self._notify_seq
        fut = asyncio.get_running_loop().create_future()
        self._waiters.add(fut)
        try:
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(fut, timeout)
        finally:
            self._waiters.discard(fut)
        return self._notify_seq

    # -- connection handling ---------------------------------------------------
    async def _handle(self, reader, writer) -> None:
        if len(self._conns) >= self.max_conns:
            self._counters["shed_conns"] += 1
            with contextlib.suppress(Exception):
                writer.write(
                    WIRE_MAGIC
                    + encode_message(
                        {
                            "rid": 0,
                            "ok": False,
                            "error": "overloaded",
                            "retryable": True,
                            "retry_after_s": self._retry_after(),
                            "detail": f"connection limit {self.max_conns}",
                        }
                    )
                )
                await writer.drain()
                writer.close()
            return
        conn = _Conn(reader, writer, self.send_queue)
        self._conns.add(conn)
        self._counters["conns"] += 1
        try:
            writer.write(WIRE_MAGIC)
            await writer.drain()
            magic = await asyncio.wait_for(
                reader.readexactly(len(WIRE_MAGIC)), self.hello_s
            )
            if magic != WIRE_MAGIC:
                return
            decoder = FrameDecoder()
            first = await asyncio.wait_for(
                self._read_batch(reader, decoder), self.hello_s
            )
            if not first or first[0].get("op") != "hello":
                return
            ok, resp = self._auth(first[0])
            writer.write(encode_message(resp))
            await writer.drain()
            if not ok:
                return
            conn.tenant = resp["tenant"]
            for task_fn in (self._writer_loop, self._pusher_loop):
                task = asyncio.create_task(task_fn(conn))
                conn.tasks.add(task)
                task.add_done_callback(conn.tasks.discard)
            for msg in first[1:]:  # requests pipelined behind the hello
                self._dispatch(conn, msg)
            while True:
                data = await reader.read(1 << 16)
                if not data:
                    return
                for msg in decoder.feed_messages(data):
                    self._dispatch(conn, msg)
        except (
            asyncio.IncompleteReadError,
            asyncio.TimeoutError,
            ConnectionError,
            OSError,
            WireError,
        ):
            return
        finally:
            conn.alive = False
            tasks = [t for t in conn.tasks if t is not asyncio.current_task()]
            for task in tasks:
                task.cancel()
            if tasks:  # reap, so no coroutine outlives the loop
                with contextlib.suppress(Exception):
                    await asyncio.wait(tasks, timeout=1.0)
            self._conns.discard(conn)
            with contextlib.suppress(Exception):
                writer.close()

    async def _read_batch(self, reader, decoder: FrameDecoder) -> list[dict]:
        """Read until at least one complete message is available."""
        msgs = decoder.feed_messages(b"")
        while not msgs:
            data = await reader.read(1 << 16)
            if not data:
                return []
            msgs = decoder.feed_messages(data)
        return msgs

    def _auth(self, hello: dict) -> tuple[bool, dict]:
        rid = hello.get("rid", 0)
        if self.tokens:
            tenant = self.tokens.get(hello.get("token"))
            if tenant is None:
                self._counters["auth_failures"] += 1
                return False, {
                    "rid": rid,
                    "ok": False,
                    "error": "auth",
                    "retryable": False,
                    "detail": "unknown token",
                }
        else:
            tenant = str(hello.get("tenant") or "default")
        return True, {
            "rid": rid,
            "ok": True,
            "tenant": tenant,
            "boot": self.boot,
            "server": "srnet/1",
        }

    def _dispatch(self, conn: _Conn, msg: dict) -> None:
        self._counters["requests"] += 1
        task = asyncio.create_task(self._serve_one(conn, msg))
        conn.tasks.add(task)
        task.add_done_callback(conn.tasks.discard)

    async def _serve_one(self, conn: _Conn, msg: dict) -> None:
        rid = msg.get("rid", 0)
        op = msg.get("op")
        try:
            if not isinstance(op, str) or op not in _OP_NAMES:
                raise ValueError(f"unknown op {op!r}")
            resp = await getattr(self, f"_op_{op}")(conn, msg)
        except asyncio.CancelledError:
            raise
        except ServerOverloaded as exc:
            resp = {
                "ok": False,
                "error": "overloaded",
                "retryable": True,
                "retry_after_s": self._retry_after(),
                "detail": str(exc),
            }
        except KeyError as exc:
            resp = {"ok": False, "error": "unknown_job", "retryable": False,
                    "detail": str(exc)}
        except (ValueError, TypeError, RuntimeError, WireError) as exc:
            resp = {"ok": False, "error": "bad_request", "retryable": False,
                    "detail": str(exc)}
        except Exception as exc:  # noqa: BLE001 — never let one request kill the conn
            resp = {"ok": False, "error": "internal", "retryable": False,
                    "detail": repr(exc)}
        resp.setdefault("ok", True)
        resp["rid"] = rid
        self._send(conn, resp)

    def _send(self, conn: _Conn, msg: dict) -> None:
        if not conn.alive:
            return
        try:
            conn.sendq.put_nowait(msg)
        except asyncio.QueueFull:
            # A reader this far behind is shed, not buffered without bound;
            # the SDK reconnects and resumes its streams by frame index.
            self._counters["dropped_slow"] += 1
            self._abort(conn)

    def _abort(self, conn: _Conn) -> None:
        conn.alive = False
        with contextlib.suppress(Exception):
            conn.writer.transport.abort()

    async def _writer_loop(self, conn: _Conn) -> None:
        inj = faults.active()
        try:
            while True:
                msg = await conn.sendq.get()
                data = encode_message(msg)
                if msg.get("push") == "frame":
                    # drill sites count per PUSHED stream frame, so
                    # e.g. torn_frame@3 is deterministic for one stream
                    if inj.fire("torn_frame") is not None:
                        self._counters["net_faults"] += 1
                        conn.writer.write(data[: max(1, len(data) // 2)])
                        with contextlib.suppress(Exception):
                            await conn.writer.drain()
                        self._abort(conn)
                        return
                    if inj.fire("net_drop") is not None:
                        self._counters["net_faults"] += 1
                        self._abort(conn)
                        return
                conn.writer.write(data)
                await asyncio.wait_for(conn.writer.drain(), self.slow_client_s)
                if msg.get("push") == "frame":
                    self._counters["frames_pushed"] += 1
        except asyncio.CancelledError:
            raise
        except asyncio.TimeoutError:
            self._counters["dropped_slow"] += 1
            self._abort(conn)
        except (ConnectionError, OSError):
            self._abort(conn)

    async def _pusher_loop(self, conn: _Conn) -> None:
        seen = 0
        try:
            while conn.alive:
                self._push_pass(conn)
                seen = await self._wait_notify(seen, 0.5)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — a broken fan-out sheds the conn, not the loop
            self._abort(conn)

    def _push_pass(self, conn: _Conn) -> None:
        for job_id in list(conn.subs):
            start = conn.subs[job_id]
            try:
                frames, terminal = self.server.frames_since(job_id, start)
            except KeyError:
                conn.subs.pop(job_id, None)
                continue
            for off, frame in enumerate(frames):
                self._send(
                    conn,
                    {
                        "push": "frame",
                        "job": job_id,
                        "index": start + off,
                        "frame": frame,
                        "boot": self.boot,
                    },
                )
                if not conn.alive:
                    return
            conn.subs[job_id] = start + len(frames)
            if terminal:
                job = self.server.job(job_id)
                summary = job.summary()
                summary["resumed_from_iteration"] = job.resumed_from_iteration
                self._send(
                    conn,
                    {
                        "push": "terminal",
                        "job": job_id,
                        "boot": self.boot,
                        "summary": summary,
                    },
                )
                conn.subs.pop(job_id, None)

    def _retry_after(self) -> float:
        """Retry-after hint: the base knob scaled by queue depth per
        worker, capped at 5s. (Reads the queue length directly — a full
        ``stats()`` snapshot per shed would take the big lock.)"""
        base = _env_float("SR_NET_RETRY_AFTER_S", 0.25)
        try:
            depth = len(self.server._queue)
            workers = max(1, int(self.server.max_concurrency))
        except Exception:  # noqa: BLE001
            return base
        return round(min(5.0, base * (1.0 + depth / workers)), 3)

    # -- ops -------------------------------------------------------------------
    @staticmethod
    def _job_id(msg: dict) -> str:
        jid = msg.get("job")
        if not isinstance(jid, str) or not jid:
            raise ValueError("request needs a 'job' id")
        return jid

    async def _op_ping(self, conn: _Conn, msg: dict) -> dict:
        return {"t": time.time(), "boot": self.boot}

    async def _op_submit(self, conn: _Conn, msg: dict) -> dict:
        raw = msg.get("spec")
        if not isinstance(raw, (bytes, bytearray)):
            raise ValueError("submit needs pickled JobSpec bytes under 'spec'")
        spec = decode_spec(raw)
        if self.tokens:
            # the token IS the identity: quotas key off its tenant, not
            # whatever the client stamped into the spec
            spec.tenant = conn.tenant or "default"
        job_id = await asyncio.to_thread(self.server.submit, spec)
        return {"job": job_id, "tenant": spec.tenant, "boot": self.boot}

    async def _op_status(self, conn: _Conn, msg: dict) -> dict:
        job = self.server.job(self._job_id(msg))
        summary = job.summary()
        summary["resumed_from_iteration"] = job.resumed_from_iteration
        return {"summary": summary}

    async def _op_cancel(self, conn: _Conn, msg: dict) -> dict:
        self.server.cancel(self._job_id(msg))
        return {}

    async def _op_wait(self, conn: _Conn, msg: dict) -> dict:
        job_id = self._job_id(msg)
        timeout = float(msg.get("timeout", 300.0))
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        seen = 0
        while True:
            job = self.server.job(job_id)
            if job.terminal:
                return {"summary": job.summary()}
            remaining = deadline - loop.time()
            if remaining <= 0:
                return {"summary": job.summary(), "timed_out": True}
            seen = await self._wait_notify(seen, min(0.5, remaining))

    async def _op_frames(self, conn: _Conn, msg: dict) -> dict:
        start = int(msg.get("start", 0))
        frames, terminal = self.server.frames_since(self._job_id(msg), start)
        return {"start": start, "frames": frames, "terminal": terminal,
                "boot": self.boot}

    async def _op_subscribe(self, conn: _Conn, msg: dict) -> dict:
        job_id = self._job_id(msg)
        self.server.job(job_id)  # KeyError -> unknown_job before registering
        start = int(msg.get("start", 0))
        conn.subs[job_id] = start
        self._notify()  # kick the pusher for the immediate backlog replay
        return {"job": job_id, "start": start, "boot": self.boot}

    async def _op_unsubscribe(self, conn: _Conn, msg: dict) -> dict:
        conn.subs.pop(self._job_id(msg), None)
        return {}

    async def _op_push_rows(self, conn: _Conn, msg: dict) -> dict:
        await asyncio.to_thread(
            self.server.push_rows,
            self._job_id(msg), msg.get("X"), msg.get("y"), msg.get("weights"),
        )
        return {}

    async def _op_replace_rows(self, conn: _Conn, msg: dict) -> dict:
        await asyncio.to_thread(
            self.server.replace_rows,
            self._job_id(msg), msg.get("X"), msg.get("y"), msg.get("weights"),
        )
        return {}

    async def _op_stats(self, conn: _Conn, msg: dict) -> dict:
        server_stats = await asyncio.to_thread(self.server.stats)
        return {"server": server_stats, "net": self.net_stats()}
