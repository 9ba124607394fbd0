"""Client SDK for the network front door: sync ``SRClient`` and asyncio
``AsyncSRClient``.

Counterpart of ``symbolicregression_jl_tpu/serve/net/client.py``; it
speaks to a ``NetServer`` of either package. ``decode_frame`` reads a
frame with the port's ``utils/checkpoint.load_frontier_bytes``.

Both speak the framed protocol of ``serve/net/wire.py`` and share one
resume discipline: every subscribed stream tracks the next frame *index*
it expects, so a dropped connection (server shed us as slow, a
``torn_frame``/``net_drop`` fault, a mid-frame kill) is survivable by
reconnecting and re-subscribing ``from index`` — the server replays the
stored suffix and the client drops nothing and double-delivers nothing.
A torn frame on the wire is detected by the CRC codec (:class:`WireError`)
and treated exactly like a dropped connection.

Boot identity: frame indices are meaningful within one server process.
The hello response carries the server's ``boot`` id; when a reconnect
lands on a *different* boot (the server crashed and journal-recovered),
in-flight stream indices are reset to 0 — the recovered job re-emits
frames from its resume point, and ``_Stream.boots`` counts the restarts
so callers can tell a resumed stream from an uninterrupted one.

The sync client is thread-safe: a background reader thread demultiplexes
rid-keyed responses and pushed frames; any number of caller threads can
submit/wait/iterate concurrently. ``iter_frames`` yields every delivered
frame exactly once and ends at the job's terminal push.

The ``slow_client`` fault site fires in the reader loop (a client that
stops draining its socket) so the server's shed-don't-buffer policy can
be drilled end to end.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import pickle
import socket
import threading
import time

from ...utils import faults
from .wire import WIRE_MAGIC, FrameDecoder, WireError, encode_message

__all__ = [
    "SRClient",
    "AsyncSRClient",
    "NetError",
    "AuthError",
    "RemoteError",
    "RetryableWireError",
    "ConnectionLost",
]


class NetError(RuntimeError):
    """Base class for SDK failures."""


class AuthError(NetError):
    """The server rejected our token — not retryable."""


class ConnectionLost(NetError):
    """The connection died and could not be (or was not) re-established."""


class RetryableWireError(NetError):
    """The server shed this request (overload / connection cap); retry
    after ``retry_after_s``."""

    def __init__(self, detail: str, retry_after_s: float):
        super().__init__(detail or "server overloaded")
        self.retry_after_s = float(retry_after_s)


class RemoteError(NetError):
    """A non-retryable error response (``error`` + ``detail``)."""

    def __init__(self, error: str, detail: str):
        super().__init__(f"{error}: {detail}")
        self.error = error
        self.detail = detail


def _env_ms(name: str, default: int) -> float:
    try:
        return float(os.environ.get(name, "") or default) / 1000.0
    except ValueError:
        return default / 1000.0


def _raise_for(resp: dict) -> dict:
    if resp.get("ok"):
        return resp
    error = str(resp.get("error") or "error")
    detail = str(resp.get("detail") or "")
    if resp.get("retryable"):
        raise RetryableWireError(detail, float(resp.get("retry_after_s", 0.5)))
    if error == "auth":
        raise AuthError(detail or "unknown token")
    if error == "unknown_job":
        raise KeyError(detail or "unknown job")
    raise RemoteError(error, detail)


class _Stream:
    """Per-job receive state: ``frames`` is the exactly-once delivery
    buffer, ``next_index`` the first server-side index not yet received."""

    def __init__(self, start: int = 0):
        self.next_index = start
        self.frames: list[bytes] = []
        self.terminal: dict | None = None
        self.boots = 0  # server restarts observed mid-stream
        self.dup_dropped = 0


class _Waiter:
    __slots__ = ("event", "resp", "exc")

    def __init__(self):
        self.event = threading.Event()
        self.resp: dict | None = None
        self.exc: BaseException | None = None


class SRClient:
    """Synchronous SDK client.

    Usage::

        with SRClient("127.0.0.1", port, token="tok") as cli:
            job = cli.submit(spec)
            for frame in cli.iter_frames(job):
                update = cli.decode_frame(frame)
            summary = cli.wait(job, timeout=120)

    ``auto_reconnect`` (default True) makes dropped connections invisible
    to stream consumers: the reader thread re-dials with exponential
    backoff (``SR_NET_RECONNECT_MS``/``SR_NET_RECONNECT_MAX_MS``, up to
    ``reconnect_deadline_s`` per outage) and re-subscribes every live
    stream from its next frame index.
    """

    def __init__(
        self,
        host: str,
        port: int,
        token: str | None = None,
        tenant: str | None = None,
        connect_timeout: float = 10.0,
        request_timeout: float = 120.0,
        auto_reconnect: bool = True,
        reconnect_deadline_s: float = 60.0,
    ):
        self.host = host
        self.port = int(port)
        self.token = token
        self.tenant = tenant
        self.connect_timeout = float(connect_timeout)
        self.request_timeout = float(request_timeout)
        self.auto_reconnect = bool(auto_reconnect)
        self.reconnect_deadline_s = float(reconnect_deadline_s)
        self.boot: str | None = None
        self._cond = threading.Condition()
        self._wlock = threading.Lock()
        self._sock: socket.socket | None = None
        self._decoder: FrameDecoder | None = None
        self._pending: dict[int, _Waiter] = {}
        self._streams: dict[str, _Stream] = {}
        self._rid = 0
        self._closed = False
        self._dead = False  # reconnect gave up — terminal for this client
        self._connected = False
        self._reconnects = 0
        self._reader: threading.Thread | None = None
        self._establish()
        self._reader = threading.Thread(
            target=self._reader_loop, name="sr-net-client", daemon=True
        )
        self._reader.start()

    # -- lifecycle -------------------------------------------------------------
    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._connected = False
            self._fail_pending(ConnectionLost("client closed"))
            sock = self._sock
            self._cond.notify_all()
        if sock is not None:
            with contextlib.suppress(OSError):
                sock.shutdown(socket.SHUT_RDWR)
            with contextlib.suppress(OSError):
                sock.close()
        if self._reader is not None and self._reader is not threading.current_thread():
            self._reader.join(timeout=5.0)

    def __enter__(self) -> "SRClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def connected(self) -> bool:
        return self._connected

    @property
    def reconnects(self) -> int:
        return self._reconnects

    def stream_state(self, job_id: str) -> _Stream:
        """The receive state for a subscribed job (drill assertions:
        ``next_index``, ``boots``, ``dup_dropped``)."""
        with self._cond:
            return self._streams[job_id]

    # -- connection plumbing ---------------------------------------------------
    def _establish(self) -> None:
        """Dial + magic exchange + hello; on success swap in the new
        socket and re-subscribe live streams from their next index."""
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout
        )
        try:
            sock.sendall(
                WIRE_MAGIC
                + encode_message(
                    {
                        "op": "hello",
                        "rid": 0,
                        "token": self.token,
                        "tenant": self.tenant,
                    }
                )
            )
            magic = self._recv_exact(sock, len(WIRE_MAGIC))
            if magic != WIRE_MAGIC:
                raise NetError(f"peer is not an SRNET server (got {magic!r})")
            decoder = FrameDecoder()
            msgs: list[dict] = []
            while not msgs:
                data = sock.recv(1 << 16)
                if not data:
                    raise ConnectionLost("server closed during hello")
                msgs = decoder.feed_messages(data)
            hello = _raise_for(msgs[0])
        except BaseException:
            with contextlib.suppress(OSError):
                sock.close()
            raise
        sock.settimeout(None)
        resubscribe: list[tuple[str, int]] = []
        with self._cond:
            self._sock = sock
            self._decoder = decoder
            prev_boot = self.boot
            self.boot = hello.get("boot")
            self.tenant = hello.get("tenant", self.tenant)
            if prev_boot is not None and prev_boot != self.boot:
                # server restarted: its frame indices start over
                for st in self._streams.values():
                    if st.terminal is None:
                        st.next_index = 0
                        st.boots += 1
            self._connected = True
            for job_id, st in self._streams.items():
                if st.terminal is None:
                    resubscribe.append((job_id, st.next_index))
            self._cond.notify_all()
        for job_id, start in resubscribe:
            # fire-and-forget: the response rid has no waiter and is dropped
            with contextlib.suppress(ConnectionLost):
                self._send_msg(
                    {
                        "op": "subscribe",
                        "rid": self._next_rid(),
                        "job": job_id,
                        "start": start,
                    }
                )

    @staticmethod
    def _recv_exact(sock: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionLost("server closed during handshake")
            buf += chunk
        return buf

    def _next_rid(self) -> int:
        with self._cond:
            self._rid += 1
            return self._rid

    def _fail_pending(self, exc: BaseException) -> None:
        # caller holds self._cond
        for waiter in self._pending.values():
            waiter.exc = exc
            waiter.event.set()
        self._pending.clear()

    def _reader_loop(self) -> None:
        while True:
            with self._cond:
                if self._closed or self._dead:
                    return
                sock = self._sock
                decoder = self._decoder
            hit = faults.active().fire("slow_client")
            if hit is not None:  # a client that stops draining its socket
                time.sleep(float(hit.get("delay_ms", 1000)) / 1000.0)
            try:
                data = sock.recv(1 << 16) if sock is not None else b""
            except OSError:
                data = b""
            if not data:
                if not self._handle_disconnect():
                    return
                continue
            try:
                msgs = decoder.feed_messages(data)
            except WireError:
                # torn/corrupt stream — same recovery as a dropped conn:
                # reconnect and resume every stream by index
                if not self._handle_disconnect():
                    return
                continue
            for msg in msgs:
                self._on_message(msg)

    def _handle_disconnect(self) -> bool:
        """Reconnect with backoff; returns False when the reader should
        exit (closed, no auto-reconnect, or the deadline ran out)."""
        with self._cond:
            self._connected = False
            sock = self._sock
            self._sock = None
            self._fail_pending(ConnectionLost("connection lost"))
            self._cond.notify_all()
            if self._closed:
                return False
        if sock is not None:
            with contextlib.suppress(OSError):
                sock.close()
        if not self.auto_reconnect:
            self._mark_dead()
            return False
        deadline = time.monotonic() + self.reconnect_deadline_s
        interval = _env_ms("SR_NET_RECONNECT_MS", 100)
        cap = _env_ms("SR_NET_RECONNECT_MAX_MS", 3000)
        while True:
            with self._cond:
                if self._closed:
                    return False
            try:
                self._establish()
                self._reconnects += 1
                return True
            except AuthError:
                self._mark_dead()
                return False
            except (OSError, NetError):
                now = time.monotonic()
                if now >= deadline:
                    self._mark_dead()
                    return False
                time.sleep(min(interval, deadline - now))
                interval = min(interval * 2.0, cap)

    def _mark_dead(self) -> None:
        with self._cond:
            self._dead = True
            self._fail_pending(ConnectionLost("reconnect gave up"))
            self._cond.notify_all()

    def _on_message(self, msg: dict) -> None:
        push = msg.get("push")
        if push is None:
            with self._cond:
                waiter = self._pending.pop(msg.get("rid"), None)
            if waiter is not None:
                waiter.resp = msg
                waiter.event.set()
            return
        job_id = msg.get("job")
        resync_from: int | None = None
        with self._cond:
            st = self._streams.get(job_id)
            if st is None:
                return
            if push == "frame":
                idx = msg.get("index")
                if idx != st.next_index:
                    # behind our cursor = replay overlap → drop (the
                    # exactly-once half of resume); ahead = a gap we can
                    # close by re-subscribing from our cursor
                    if isinstance(idx, int) and idx > st.next_index:
                        resync_from = st.next_index
                    else:
                        st.dup_dropped += 1
                else:
                    st.frames.append(msg.get("frame"))
                    st.next_index += 1
                    self._cond.notify_all()
            elif push == "terminal":
                st.terminal = msg.get("summary") or {}
                self._cond.notify_all()
        if resync_from is not None:  # send outside the cond (lock order)
            self._resync(job_id, resync_from)

    def _resync(self, job_id: str, start: int) -> None:
        with contextlib.suppress(NetError, OSError):
            self._send_msg(
                {"op": "subscribe", "rid": self._next_rid(), "job": job_id,
                 "start": start}
            )

    def _send_msg(self, msg: dict) -> None:
        with self._wlock:
            with self._cond:
                sock = self._sock if self._connected else None
            if sock is None:
                raise ConnectionLost("not connected")
            try:
                sock.sendall(encode_message(msg))
            except OSError as exc:
                raise ConnectionLost(str(exc)) from exc

    def _await_connected(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        with self._cond:
            while not self._connected:
                if self._closed or self._dead:
                    raise ConnectionLost("client is closed or gave up")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ConnectionLost(f"not connected after {timeout}s")
                self._cond.wait(min(0.1, remaining))

    def _request(self, msg: dict, timeout: float | None = None) -> dict:
        timeout = self.request_timeout if timeout is None else float(timeout)
        self._await_connected(min(timeout, self.reconnect_deadline_s))
        rid = self._next_rid()
        msg["rid"] = rid
        waiter = _Waiter()
        with self._cond:
            self._pending[rid] = waiter
        try:
            self._send_msg(msg)
            if not waiter.event.wait(timeout):
                raise NetError(
                    f"timeout ({timeout}s) waiting for {msg.get('op')!r} response"
                )
        finally:
            with self._cond:
                self._pending.pop(rid, None)
        if waiter.exc is not None:
            raise waiter.exc
        return _raise_for(waiter.resp or {})

    # -- public API ------------------------------------------------------------
    def ping(self) -> dict:
        return self._request({"op": "ping"}, timeout=10.0)

    def stats(self) -> dict:
        return self._request({"op": "stats"})

    def submit(self, spec, retries: int = 0) -> str:
        """Submit a JobSpec (pickled client-side); returns the job id.
        ``retries`` > 0 honors the server's retry-after hint on
        ``RetryableWireError`` before giving up."""
        payload = (
            bytes(spec)
            if isinstance(spec, (bytes, bytearray))
            else pickle.dumps(spec, protocol=pickle.HIGHEST_PROTOCOL)
        )
        attempt = 0
        while True:
            try:
                return self._request({"op": "submit", "spec": payload})["job"]
            except RetryableWireError as exc:
                if attempt >= retries:
                    raise
                attempt += 1
                time.sleep(max(0.01, exc.retry_after_s))

    def status(self, job_id: str) -> dict:
        return self._request({"op": "status", "job": job_id})["summary"]

    def cancel(self, job_id: str) -> None:
        self._request({"op": "cancel", "job": job_id})

    def wait(self, job_id: str, timeout: float = 300.0) -> dict:
        """Block (server-side) until the job is terminal; returns the
        summary. Raises TimeoutError if it is still running at timeout."""
        resp = self._request(
            {"op": "wait", "job": job_id, "timeout": timeout},
            timeout=timeout + 30.0,
        )
        if resp.get("timed_out"):
            raise TimeoutError(f"{job_id} not terminal in {timeout}s")
        return resp["summary"]

    def frames(self, job_id: str, start: int = 0) -> list[bytes]:
        return self._request({"op": "frames", "job": job_id, "start": start})[
            "frames"
        ]

    def push_rows(self, job_id: str, X, y, weights=None) -> None:
        self._request(
            {"op": "push_rows", "job": job_id, "X": X, "y": y, "weights": weights}
        )

    def replace_rows(self, job_id: str, X, y, weights=None) -> None:
        self._request(
            {"op": "replace_rows", "job": job_id, "X": X, "y": y,
             "weights": weights}
        )

    def subscribe(self, job_id: str, start: int = 0) -> _Stream:
        """Start (or resume) the pushed frame stream for a job."""
        with self._cond:
            st = self._streams.get(job_id)
            if st is None:
                st = _Stream(start)
                self._streams[job_id] = st
        self._request({"op": "subscribe", "job": job_id, "start": st.next_index})
        return st

    def unsubscribe(self, job_id: str) -> None:
        with self._cond:
            self._streams.pop(job_id, None)
        with contextlib.suppress(NetError):
            self._request({"op": "unsubscribe", "job": job_id}, timeout=10.0)

    def iter_frames(self, job_id: str, timeout: float | None = None):
        """Generator over a job's pushed frames — every delivered frame
        exactly once, ending after the terminal push. Auto-subscribes.
        Survives reconnects transparently; raises :class:`ConnectionLost`
        only when the reconnect loop gave up."""
        with self._cond:
            subscribed = job_id in self._streams
        if not subscribed:
            self.subscribe(job_id)
        deadline = None if timeout is None else time.monotonic() + timeout
        i = 0
        while True:
            with self._cond:
                st = self._streams[job_id]
                while len(st.frames) <= i and st.terminal is None:
                    if self._closed or self._dead:
                        raise ConnectionLost("stream interrupted and not recovered")
                    remaining = (
                        None if deadline is None else deadline - time.monotonic()
                    )
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError(
                            f"no frame for {job_id} within {timeout}s"
                        )
                    self._cond.wait(
                        0.5 if remaining is None else min(0.5, remaining)
                    )
                batch = st.frames[i:]
                done = st.terminal is not None and i + len(batch) >= len(st.frames)
            for frame in batch:
                yield frame
            i += len(batch)
            if done:
                return

    def terminal_summary(self, job_id: str) -> dict | None:
        """The pushed terminal summary for a subscribed job, if any."""
        with self._cond:
            st = self._streams.get(job_id)
            return None if st is None else st.terminal

    @staticmethod
    def decode_frame(frame: bytes):
        """Decode format-2 frontier bytes into a FrontierUpdate."""
        from ...utils.checkpoint import load_frontier_bytes

        return load_frontier_bytes(frame)


class AsyncSRClient:
    """Asyncio variant of :class:`SRClient` — same protocol, same
    index-based resume; awaitable API plus an async-iterator frame stream.

    Usage::

        cli = await AsyncSRClient.connect("127.0.0.1", port)
        job = await cli.submit(spec)
        async for frame in cli.iter_frames(job):
            ...
        await cli.close()
    """

    def __init__(
        self,
        host: str,
        port: int,
        token: str | None = None,
        tenant: str | None = None,
        connect_timeout: float = 10.0,
        request_timeout: float = 120.0,
        auto_reconnect: bool = True,
        reconnect_deadline_s: float = 60.0,
    ):
        self.host = host
        self.port = int(port)
        self.token = token
        self.tenant = tenant
        self.connect_timeout = float(connect_timeout)
        self.request_timeout = float(request_timeout)
        self.auto_reconnect = bool(auto_reconnect)
        self.reconnect_deadline_s = float(reconnect_deadline_s)
        self.boot: str | None = None
        self.reconnects = 0
        self._reader_sock = None  # (StreamReader, StreamWriter)
        self._writer = None
        self._pending: dict[int, "asyncio.Future"] = {}
        self._streams: dict[str, _Stream] = {}
        self._changed: "asyncio.Event | None" = None
        self._rid = 0
        self._closed = False
        self._dead = False
        self._connected = False
        self._reader_task = None

    @classmethod
    async def connect(cls, host: str, port: int, **kw) -> "AsyncSRClient":
        self = cls(host, port, **kw)
        self._changed = asyncio.Event()
        await self._establish()
        self._reader_task = asyncio.create_task(self._reader_loop())
        return self

    async def close(self) -> None:
        self._closed = True
        self._connected = False
        if self._reader_task is not None:
            self._reader_task.cancel()
            with contextlib.suppress(BaseException):
                await self._reader_task
        if self._writer is not None:
            with contextlib.suppress(Exception):
                self._writer.close()
        self._fail_pending(ConnectionLost("client closed"))

    async def _establish(self) -> None:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port), self.connect_timeout
        )
        writer.write(
            WIRE_MAGIC
            + encode_message(
                {"op": "hello", "rid": 0, "token": self.token,
                 "tenant": self.tenant}
            )
        )
        await writer.drain()
        magic = await asyncio.wait_for(
            reader.readexactly(len(WIRE_MAGIC)), self.connect_timeout
        )
        if magic != WIRE_MAGIC:
            writer.close()
            raise NetError(f"peer is not an SRNET server (got {magic!r})")
        decoder = FrameDecoder()
        msgs: list[dict] = []
        while not msgs:
            data = await asyncio.wait_for(reader.read(1 << 16), self.connect_timeout)
            if not data:
                writer.close()
                raise ConnectionLost("server closed during hello")
            msgs = decoder.feed_messages(data)
        try:
            hello = _raise_for(msgs[0])
        except BaseException:
            writer.close()
            raise
        prev_boot = self.boot
        self.boot = hello.get("boot")
        self.tenant = hello.get("tenant", self.tenant)
        if prev_boot is not None and prev_boot != self.boot:
            for st in self._streams.values():
                if st.terminal is None:
                    st.next_index = 0
                    st.boots += 1
        self._reader_sock = (reader, decoder)
        self._writer = writer
        self._connected = True
        for job_id, st in self._streams.items():
            if st.terminal is None:
                await self._send(
                    {"op": "subscribe", "rid": self._next_rid(), "job": job_id,
                     "start": st.next_index}
                )
        self._wake()

    def _wake(self) -> None:
        if self._changed is not None:
            self._changed.set()

    def _next_rid(self) -> int:
        self._rid += 1
        return self._rid

    def _fail_pending(self, exc: BaseException) -> None:
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self._pending.clear()

    async def _reader_loop(self) -> None:
        while not self._closed and not self._dead:
            reader, decoder = self._reader_sock
            try:
                data = await reader.read(1 << 16)
            except (ConnectionError, OSError):
                data = b""
            if not data:
                if not await self._handle_disconnect():
                    return
                continue
            try:
                msgs = decoder.feed_messages(data)
            except WireError:
                if not await self._handle_disconnect():
                    return
                continue
            for msg in msgs:
                self._on_message(msg)

    async def _handle_disconnect(self) -> bool:
        self._connected = False
        if self._writer is not None:
            with contextlib.suppress(Exception):
                self._writer.close()
        self._fail_pending(ConnectionLost("connection lost"))
        self._wake()
        if self._closed or not self.auto_reconnect:
            self._dead = True
            return False
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.reconnect_deadline_s
        interval = _env_ms("SR_NET_RECONNECT_MS", 100)
        cap = _env_ms("SR_NET_RECONNECT_MAX_MS", 3000)
        while not self._closed:
            try:
                await self._establish()
                self.reconnects += 1
                return True
            except AuthError:
                break
            except (OSError, NetError, asyncio.TimeoutError):
                now = loop.time()
                if now >= deadline:
                    break
                await asyncio.sleep(min(interval, deadline - now))
                interval = min(interval * 2.0, cap)
        self._dead = True
        self._fail_pending(ConnectionLost("reconnect gave up"))
        self._wake()
        return False

    def _on_message(self, msg: dict) -> None:
        push = msg.get("push")
        if push is None:
            fut = self._pending.pop(msg.get("rid"), None)
            if fut is not None and not fut.done():
                fut.set_result(msg)
            return
        st = self._streams.get(msg.get("job"))
        if st is None:
            return
        if push == "frame":
            idx = msg.get("index")
            if idx != st.next_index:
                if isinstance(idx, int) and idx < st.next_index:
                    st.dup_dropped += 1
                return
            st.frames.append(msg.get("frame"))
            st.next_index += 1
        elif push == "terminal":
            st.terminal = msg.get("summary") or {}
        self._wake()

    async def _send(self, msg: dict) -> None:
        if not self._connected or self._writer is None:
            raise ConnectionLost("not connected")
        try:
            self._writer.write(encode_message(msg))
            await self._writer.drain()
        except (ConnectionError, OSError) as exc:
            raise ConnectionLost(str(exc)) from exc

    async def _request(self, msg: dict, timeout: float | None = None) -> dict:
        timeout = self.request_timeout if timeout is None else float(timeout)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + min(timeout, self.reconnect_deadline_s)
        while not self._connected:
            if self._closed or self._dead or loop.time() >= deadline:
                raise ConnectionLost("not connected")
            self._changed.clear()
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._changed.wait(), 0.1)
        rid = self._next_rid()
        msg["rid"] = rid
        fut = loop.create_future()
        self._pending[rid] = fut
        try:
            await self._send(msg)
            resp = await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(rid, None)
        return _raise_for(resp)

    # -- public API ------------------------------------------------------------
    async def ping(self) -> dict:
        return await self._request({"op": "ping"}, timeout=10.0)

    async def stats(self) -> dict:
        return await self._request({"op": "stats"})

    async def submit(self, spec, retries: int = 0) -> str:
        payload = (
            bytes(spec)
            if isinstance(spec, (bytes, bytearray))
            else pickle.dumps(spec, protocol=pickle.HIGHEST_PROTOCOL)
        )
        attempt = 0
        while True:
            try:
                resp = await self._request({"op": "submit", "spec": payload})
                return resp["job"]
            except RetryableWireError as exc:
                if attempt >= retries:
                    raise
                attempt += 1
                await asyncio.sleep(max(0.01, exc.retry_after_s))

    async def status(self, job_id: str) -> dict:
        return (await self._request({"op": "status", "job": job_id}))["summary"]

    async def cancel(self, job_id: str) -> None:
        await self._request({"op": "cancel", "job": job_id})

    async def wait(self, job_id: str, timeout: float = 300.0) -> dict:
        resp = await self._request(
            {"op": "wait", "job": job_id, "timeout": timeout},
            timeout=timeout + 30.0,
        )
        if resp.get("timed_out"):
            raise TimeoutError(f"{job_id} not terminal in {timeout}s")
        return resp["summary"]

    async def frames(self, job_id: str, start: int = 0) -> list[bytes]:
        resp = await self._request(
            {"op": "frames", "job": job_id, "start": start}
        )
        return resp["frames"]

    async def push_rows(self, job_id: str, X, y, weights=None) -> None:
        await self._request(
            {"op": "push_rows", "job": job_id, "X": X, "y": y, "weights": weights}
        )

    async def replace_rows(self, job_id: str, X, y, weights=None) -> None:
        await self._request(
            {"op": "replace_rows", "job": job_id, "X": X, "y": y,
             "weights": weights}
        )

    async def subscribe(self, job_id: str, start: int = 0) -> _Stream:
        st = self._streams.get(job_id)
        if st is None:
            st = _Stream(start)
            self._streams[job_id] = st
        await self._request(
            {"op": "subscribe", "job": job_id, "start": st.next_index}
        )
        return st

    async def iter_frames(self, job_id: str, timeout: float | None = None):
        if job_id not in self._streams:
            await self.subscribe(job_id)
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + timeout
        i = 0
        while True:
            st = self._streams[job_id]
            while len(st.frames) <= i and st.terminal is None:
                if self._closed or self._dead:
                    raise ConnectionLost("stream interrupted and not recovered")
                remaining = None if deadline is None else deadline - loop.time()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"no frame for {job_id} within {timeout}s")
                self._changed.clear()
                with contextlib.suppress(asyncio.TimeoutError):
                    await asyncio.wait_for(
                        self._changed.wait(),
                        0.5 if remaining is None else min(0.5, remaining),
                    )
            batch = st.frames[i:]
            done = st.terminal is not None and i + len(batch) >= len(st.frames)
            for frame in batch:
                yield frame
            i += len(batch)
            if done:
                return
