"""The port's network front door (``serve/net/``) against the JAX package's,
on the CPU.

- The codec, exactly: the same magic, the same bytes for the same message,
  the same decoder payloads and buffered counts at every cut, the same
  ``WireError`` on the same garbage, the same ``max_frame_bytes`` and
  ``parse_tokens``.
- Mirrors of tests/test_net.py's tests that need no pod, against the
  port's ``NetServer`` and SDK over the port's ``SearchServer`` (lockstep,
  ``device="cpu"``).
- Interop both ways: a JAX client on the port's server and the port's
  client on a JAX server; each server refuses the other package's
  ``JobSpec``.
- The whole slice: a job through the port's wire ends with the frontier and
  num_evals of the same search run by ``equation_search`` directly, bit for
  bit, on lockstep, on the event leg and on the block's plain version
  (``SR_ENGINE_BLOCK=1``); a subscription takes ``push_rows`` and
  ``cancel`` over the wire.
- The net modules import with ``jax`` blocked.

Every wait has a timeout.
"""

import asyncio
import os
import pickle
import socket
import struct
import subprocess
import sys
import textwrap
import time
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu.serve as jserve
import symbolicregression_jl_tpu.serve.net as jnet
from symbolicregression_jl_tpu.utils import faults as jfaults
from symbolicregression_jl_tpu.utils.checkpoint import load_frontier_bytes as j_load_frontier_bytes
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu_torch.complexity import compute_complexity
from symbolicregression_jl_tpu_torch.serve import (
    JobSpec,
    NetServer,
    SearchServer,
    SRClient,
)
from symbolicregression_jl_tpu_torch.serve import net
from symbolicregression_jl_tpu_torch.serve.journal import JOURNAL_MAGIC
from symbolicregression_jl_tpu_torch.serve.net import (
    WIRE_MAGIC,
    AsyncSRClient,
    AuthError,
    FrameDecoder,
    RemoteError,
    RetryableWireError,
    WireError,
    decode_message,
    encode_frame,
    encode_message,
    max_frame_bytes,
)
from symbolicregression_jl_tpu_torch.utils import faults
from symbolicregression_jl_tpu_torch.utils.checkpoint import load_frontier_bytes

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _cpu_numerics():
    """Keep JAX in 32-bit mode (a test module run earlier in this process
    may have enabled x64) and torch on one thread (sums split by thread
    count would make results depend on the machine)."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", x64)


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    faults.install(None)
    jfaults.install(None)


def _problem(n=60, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2, n)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    return X, y


_BASE = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=2,
             population_size=8, ncycles_per_iteration=8, maxsize=10, save_to_file=False,
             seed=0, scheduler="lockstep")


def _opts(**kw):
    return T.Options(**{**_BASE, "device": "cpu", "progress": False, **kw})


def _spec(X, y, **kw):
    kw.setdefault("options", _opts())
    kw.setdefault("niterations", 2)
    return JobSpec(X, y, **kw)


def _jspec(X, y, **kw):
    kw.setdefault("options", J.Options(**_BASE))
    kw.setdefault("niterations", 2)
    return jserve.JobSpec(X, y, **kw)


# -- the codec against the JAX package's, exactly ------------------------------


def _messages(seed=0):
    """Seeded messages of plain types, bytes and numpy arrays."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        out.append({
            "op": ["ping", "submit", "frames", "push_rows"][i % 4],
            "rid": int(rng.integers(0, 1 << 30)),
            "start": i,
            "t": float(rng.normal()),
            "ok": bool(i % 2),
            "none": None,
            "tags": ["a", "b", str(i)],
            "blob": rng.bytes(int(rng.integers(0, 300))),
            "X": rng.normal(size=(2, int(rng.integers(1, 40)))).astype(np.float32),
            "idx": rng.integers(0, 9, size=5).astype(np.int64),
        })
    return out


def _feed_all(decoder, chunks):
    got = []
    for c in chunks:
        got += decoder.feed(c)
    return got


def test_codec_bytes_equal_jax():
    assert WIRE_MAGIC == jnet.WIRE_MAGIC
    for msg in _messages():
        assert encode_message(msg) == jnet.encode_message(msg)
        raw = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        assert encode_frame(raw) == jnet.encode_frame(raw)
        assert encode_frame(b"") == jnet.encode_frame(b"")


def test_decoder_equal_jax_at_every_cut():
    """A stream of three frames cut at every byte offset, and fed one byte
    at a time: the same payload lists and the same buffered counts."""
    wire = b"".join(encode_message(m) for m in _messages(1)[:3])
    for cut in range(len(wire) + 1):
        t, j = FrameDecoder(), jnet.FrameDecoder()
        assert t.feed(wire[:cut]) == j.feed(wire[:cut])
        assert t.buffered == j.buffered
        assert t.feed(wire[cut:]) == j.feed(wire[cut:])
        assert t.buffered == j.buffered == 0
    bytewise = [wire[i:i + 1] for i in range(len(wire))]
    t, j = FrameDecoder(), jnet.FrameDecoder()
    got = _feed_all(t, bytewise)
    assert got == _feed_all(j, bytewise) and len(got) == 3
    torn = wire[: len(wire) - 5]
    t, j = FrameDecoder(), jnet.FrameDecoder()
    assert t.feed(torn) == j.feed(torn)
    assert t.buffered == j.buffered > 0


def _garbage_feeds():
    payload = pickle.dumps([1, 2, 3])
    nondict = struct.pack("<II", len(payload), zlib.crc32(payload)) + payload
    junk = b"\x00\x01\x02 not a pickle"
    unpicklable = struct.pack("<II", len(junk), zlib.crc32(junk)) + junk
    crc = bytearray(encode_message({"a": 1}))
    crc[-1] ^= 0xFF
    return {
        "oversized": struct.pack("<II", 1 << 31, 0) + b"junk",
        "crc": bytes(crc),
        "nondict": nondict,
        "undecodable": unpicklable,
    }


@pytest.mark.parametrize("case", ["oversized", "crc", "nondict", "undecodable"])
def test_wire_error_on_the_same_feed(case):
    data = _garbage_feeds()[case]
    errs = []
    for mod in (net, jnet):
        with pytest.raises(mod.WireError) as exc:
            mod.FrameDecoder().feed_messages(data)
        errs.append(str(exc.value))
    # the same text, apart from the unpickler's own exception repr
    assert errs[0].split(":")[0] == errs[1].split(":")[0]


@pytest.mark.parametrize("mb", [None, "64", "0.001", "junk"])
def test_max_frame_bytes_equal_jax(monkeypatch, mb):
    if mb is None:
        monkeypatch.delenv("SR_NET_MAX_FRAME_MB", raising=False)
    else:
        monkeypatch.setenv("SR_NET_MAX_FRAME_MB", mb)
    assert max_frame_bytes() == jnet.max_frame_bytes()
    big = b"x" * (max_frame_bytes() + 1)
    for mod in (net, jnet):
        with pytest.raises(mod.WireError, match="exceeds"):
            mod.encode_frame(big)


def test_parse_tokens_equal_jax():
    cases = ["", "a=alice", "a=alice,b=bob", " a = alice , , b= ", "=x,y=,z", "t=1=2,u",
             "tok-a=lab,tok-a=other", ",,,", "k=v,k2=v2,k3"]
    for s in cases:
        assert net.parse_tokens(s) == jnet.parse_tokens(s), s


def test_net_exports_equal_jax():
    assert net.__all__ == jnet.__all__
    for name in net.__all__:
        assert hasattr(net, name), name


# -- mirrors of tests/test_net.py: the codec -----------------------------------


def test_wire_magic_is_distinct_from_journal():
    assert len(WIRE_MAGIC) == len(JOURNAL_MAGIC) == 8
    assert WIRE_MAGIC != JOURNAL_MAGIC


def test_codec_roundtrip_single_and_batched():
    msgs = [{"op": "ping", "rid": i, "blob": bytes(range(i % 7))} for i in range(5)]
    wire = b"".join(encode_message(m) for m in msgs)
    assert FrameDecoder().feed_messages(wire) == msgs


def test_codec_truncation_at_every_byte_offset():
    msg = {"op": "submit", "rid": 7, "payload": b"x" * 37}
    frame = encode_message(msg)
    for cut in range(len(frame)):
        dec = FrameDecoder()
        assert dec.feed_messages(frame[:cut]) == []
        assert dec.buffered == cut
        assert dec.feed_messages(frame[cut:]) == [msg]
        assert dec.buffered == 0


def test_codec_interleaved_partial_reads():
    msgs = [{"rid": i, "data": bytes([i]) * (3 * i + 1)} for i in range(8)]
    wire = b"".join(encode_message(m) for m in msgs)
    dec = FrameDecoder()
    got = []
    for i in range(len(wire)):
        got += dec.feed_messages(wire[i:i + 1])
    assert got == msgs
    dec = FrameDecoder()
    got, i = [], 0
    for step in [1, 2, 3, 5, 7, 11, 13] * 200:
        if i >= len(wire):
            break
        got += dec.feed_messages(wire[i:i + step])
        i += step
    got += dec.feed_messages(wire[i:])
    assert got == msgs


def test_codec_oversized_length_header_rejected():
    with pytest.raises(WireError, match="length header"):
        FrameDecoder().feed(struct.pack("<II", 1 << 31, 0) + b"junk")
    with pytest.raises(WireError, match="length header"):
        FrameDecoder(max_bytes=1024).feed(struct.pack("<II", 2048, 0))
    with pytest.raises(WireError, match="exceeds"):
        encode_frame(b"x" * (max_frame_bytes() + 1))


def test_codec_crc_mismatch_garbage():
    frame = bytearray(encode_message({"a": 1}))
    frame[-1] ^= 0xFF
    with pytest.raises(WireError, match="CRC"):
        FrameDecoder().feed(bytes(frame))
    frame = bytearray(encode_message({"a": 1}))
    frame[4] ^= 0xFF
    with pytest.raises(WireError, match="CRC"):
        FrameDecoder().feed(bytes(frame))


def test_codec_valid_crc_nondict_payload_rejected():
    (raw,) = FrameDecoder().feed(_garbage_feeds()["nondict"])
    with pytest.raises(WireError, match="expected dict"):
        decode_message(raw)


def test_codec_unpicklable_garbage_with_valid_crc():
    (raw,) = FrameDecoder().feed(_garbage_feeds()["undecodable"])
    with pytest.raises(WireError, match="undecodable"):
        decode_message(raw)


# -- mirrors: frames_since / wait_activity --------------------------------------


def test_frames_since_single_snapshot_and_stream_parity():
    X, y = _problem()
    with SearchServer(max_concurrency=1) as srv:
        jid = srv.submit(_spec(X, y, niterations=3, stream_every=1))
        streamed = list(srv.stream(jid, timeout=TIMEOUT))
        frames, terminal = srv.frames_since(jid, 0)
        assert terminal and frames == streamed and len(frames) >= 1
        tail, terminal2 = srv.frames_since(jid, len(frames) - 1)
        assert terminal2 and tail == frames[-1:]
        with pytest.raises(KeyError):
            srv.frames_since("job-99999", 0)


def test_wait_activity_advances_on_frames_and_terminal():
    """The counter the bridge thread sleeps on moves on every appended frame
    and on the terminal transition."""
    X, y = _problem()
    with SearchServer(max_concurrency=1) as srv:
        before = srv.wait_activity(0, timeout=0.0)
        jid = srv.submit(_spec(X, y, niterations=2, stream_every=1))
        srv.wait(jid, timeout=TIMEOUT)
        after = srv.wait_activity(before, timeout=5.0)
        assert after >= before + len(srv.frames(jid)) + 1
        assert srv.wait_activity(after, timeout=0.05) == after


# -- mirrors: NetServer + SDK round trips (lockstep on the CPU) ----------------


def test_wire_submit_stream_wait_roundtrip():
    X, y = _problem()
    with SearchServer(max_concurrency=2) as srv:
        with NetServer(srv, port=0) as nsrv:
            with SRClient("127.0.0.1", nsrv.port, tenant="t0") as cli:
                assert cli.ping()["boot"] == nsrv.boot
                jid = cli.submit(_spec(X, y, niterations=3, stream_every=1))
                frames = list(cli.iter_frames(jid, timeout=TIMEOUT))
                summary = cli.wait(jid, timeout=TIMEOUT)
                assert summary["state"] == "done"
                assert len(frames) == summary["frames"] >= 1
                assert cli.frames(jid, 0) == frames
                update = cli.decode_frame(frames[-1])
                assert update.members and update.iteration >= 1
                assert cli.status(jid)["state"] == "done"
                stats = cli.stats()
                assert stats["net"]["frames_pushed"] >= len(frames)
                assert stats["server"]["jobs"].get("done", 0) >= 1


def test_wire_cancel_and_unknown_job():
    X, y = _problem()
    with SearchServer(max_concurrency=1) as srv:
        with NetServer(srv, port=0) as nsrv:
            with SRClient("127.0.0.1", nsrv.port) as cli:
                blocker = cli.submit(_spec(X, y, niterations=50, stream_every=1))
                queued = cli.submit(_spec(X, y, niterations=50))
                cli.cancel(queued)
                cli.cancel(blocker)
                assert cli.wait(blocker, timeout=TIMEOUT)["state"] in ("cancelled", "done")
                assert cli.wait(queued, timeout=TIMEOUT)["state"] == "cancelled"
                with pytest.raises(KeyError):
                    cli.status("job-99999")
                with pytest.raises(RemoteError):
                    cli._request({"op": "bogus"})


def test_wire_auth_token_maps_tenant_and_rejects_unknown():
    X, y = _problem()
    tokens = {"sekrit-a": "alice", "sekrit-b": "bob"}
    with SearchServer(max_concurrency=1) as srv:
        with NetServer(srv, port=0, tokens=tokens) as nsrv:
            with SRClient("127.0.0.1", nsrv.port, token="sekrit-a") as cli:
                assert cli.tenant == "alice"
                jid = cli.submit(_spec(X, y, tenant="mallory"))
                assert cli.wait(jid, timeout=TIMEOUT)["tenant"] == "alice"
            with pytest.raises(AuthError):
                SRClient("127.0.0.1", nsrv.port, token="wrong", auto_reconnect=False)
            assert nsrv.net_stats()["auth_failures"] == 1


def test_wire_overload_is_retryable_with_hint():
    X, y = _problem()
    with SearchServer(max_concurrency=1, queue_max_depth=1) as srv:
        with NetServer(srv, port=0) as nsrv:
            with SRClient("127.0.0.1", nsrv.port) as cli:
                jids = [cli.submit(_spec(X, y, niterations=60))]
                shed = None
                for _ in range(8):
                    try:
                        jids.append(cli.submit(_spec(X, y, niterations=60)))
                    except RetryableWireError as exc:
                        shed = exc
                        break
                assert shed is not None, "queue_max_depth=1 never shed"
                assert shed.retry_after_s > 0
                for jid in jids:
                    cli.cancel(jid)
                for jid in jids:
                    cli.wait(jid, timeout=TIMEOUT)


def test_wire_reconnect_resumes_stream_exactly_once():
    """torn_frame cuts the connection half-way through a pushed frame: the
    client's codec rejects the torn tail, reconnects, re-subscribes from its
    index, and the stream has no gap and no duplicate."""
    X, y = _problem()
    faults.install("torn_frame@2")
    with SearchServer(max_concurrency=1) as srv:
        with NetServer(srv, port=0) as nsrv:
            with SRClient("127.0.0.1", nsrv.port) as cli:
                jid = cli.submit(_spec(X, y, niterations=8, stream_every=1))
                frames = list(cli.iter_frames(jid, timeout=TIMEOUT))
                assert cli.reconnects >= 1
                assert frames == srv.frames(jid)
                assert cli.stream_state(jid).next_index == len(frames)
                assert nsrv.net_stats()["net_faults"] == 1


def test_wire_net_drop_reconnect():
    X, y = _problem()
    faults.install("net_drop@1")
    with SearchServer(max_concurrency=1) as srv:
        with NetServer(srv, port=0) as nsrv:
            with SRClient("127.0.0.1", nsrv.port) as cli:
                jid = cli.submit(_spec(X, y, niterations=6, stream_every=1))
                frames = list(cli.iter_frames(jid, timeout=TIMEOUT))
                assert cli.reconnects >= 1
                assert frames == srv.frames(jid)
                assert nsrv.net_stats()["net_faults"] == 1


def test_wire_slow_client_fault_stalls_but_loses_nothing():
    X, y = _problem()
    faults.install("slow_client@2:delay_ms=300")
    with SearchServer(max_concurrency=1) as srv:
        with NetServer(srv, port=0) as nsrv:
            with SRClient("127.0.0.1", nsrv.port) as cli:
                jid = cli.submit(_spec(X, y, niterations=5, stream_every=1))
                frames = list(cli.iter_frames(jid, timeout=TIMEOUT))
                assert frames == srv.frames(jid)
    assert faults.active()._counts.get("slow_client", 0) > 2


def test_async_client_submit_and_stream():
    X, y = _problem()

    async def run(port):
        cli = await AsyncSRClient.connect("127.0.0.1", port)
        try:
            jid = await cli.submit(_spec(X, y, niterations=3, stream_every=1))
            frames = [f async for f in cli.iter_frames(jid, timeout=TIMEOUT)]
            summary = await cli.wait(jid, timeout=TIMEOUT)
            assert summary["state"] == "done"
            assert len(frames) == summary["frames"] >= 1
            assert (await cli.frames(jid)) == frames
            return True
        finally:
            await cli.close()

    with SearchServer(max_concurrency=1) as srv:
        with NetServer(srv, port=0) as nsrv:
            assert asyncio.run(run(nsrv.port))


def test_non_protocol_peer_is_dropped_cleanly():
    with SearchServer(max_concurrency=1) as srv:
        with NetServer(srv, port=0) as nsrv:
            s = socket.create_connection(("127.0.0.1", nsrv.port), timeout=5)
            try:
                s.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
                s.settimeout(5)
                data = b""
                while True:
                    try:
                        chunk = s.recv(4096)
                    except OSError:
                        break
                    if not chunk:
                        break
                    data += chunk
                assert data.startswith(WIRE_MAGIC)
            finally:
                s.close()


# -- interop with the JAX package, both ways -----------------------------------


def _keys(members):
    return [(m.loss, m.tree.structure_key()) for m in members]


def test_jax_client_against_port_server():
    """A JAX SRClient submits a pickled port JobSpec to the port's server and
    subscribes: its frames equal the port client's byte for byte, and the
    JAX package's decoder reads them to the port decoder's trees."""
    X, y = _problem()
    raw = pickle.dumps(_spec(X, y, niterations=3, stream_every=1))
    with SearchServer(max_concurrency=1) as srv:
        with NetServer(srv, port=0) as nsrv:
            with jnet.SRClient("127.0.0.1", nsrv.port) as jcli, \
                    SRClient("127.0.0.1", nsrv.port) as cli:
                jid = jcli.submit(raw)
                jframes = list(jcli.iter_frames(jid, timeout=TIMEOUT))
                tframes = list(cli.iter_frames(jid, timeout=TIMEOUT))
                assert jcli.wait(jid, timeout=TIMEOUT)["state"] == "done"
    assert jframes == tframes == srv.frames(jid) and len(jframes) == 4
    for frame in jframes:
        ju, tu = j_load_frontier_bytes(frame), load_frontier_bytes(frame)
        assert (ju.iteration, ju.num_evals) == (tu.iteration, tu.num_evals)
        assert _keys(ju.members) == _keys(tu.members) and tu.members


def test_port_client_against_jax_server():
    """The port's SRClient drives a JAX NetServer running a JAX lockstep
    job: ping, submit, subscribe, status, wait, frames and stats."""
    X, y = _problem()
    with jserve.SearchServer(max_concurrency=1) as jsrv:
        with jnet.NetServer(jsrv, port=0) as jnsrv:
            with SRClient("127.0.0.1", jnsrv.port, tenant="t1") as cli:
                assert cli.ping()["boot"] == jnsrv.boot and cli.tenant == "t1"
                jid = cli.submit(_jspec(X, y, niterations=2, stream_every=1, tenant="t1"))
                pushed = list(cli.iter_frames(jid, timeout=TIMEOUT))
                summary = cli.wait(jid, timeout=TIMEOUT)
                assert summary["state"] == "done" and summary["tenant"] == "t1"
                assert cli.status(jid)["state"] == "done"
                assert cli.frames(jid) == pushed == jsrv.frames(jid)
                stats = cli.stats()
                assert stats["net"]["frames_pushed"] >= len(pushed) >= 1
                assert stats["server"]["jobs"] == {"done": 1}
    for frame in pushed:
        assert _keys(cli.decode_frame(frame).members) == _keys(
            j_load_frontier_bytes(frame).members)


def test_each_server_refuses_the_other_packages_jobspec():
    X, y = _problem()
    with SearchServer(max_concurrency=1) as srv, NetServer(srv, port=0) as nsrv, \
            SRClient("127.0.0.1", nsrv.port) as cli:
        with pytest.raises(RemoteError, match="'spec' decodes to JobSpec, not JobSpec"):
            cli.submit(_jspec(X, y))
    with jserve.SearchServer(max_concurrency=1) as jsrv, jnet.NetServer(jsrv, port=0) as jn, \
            jnet.SRClient("127.0.0.1", jn.port) as jcli:
        with pytest.raises(jnet.RemoteError, match="'spec' decodes to JobSpec, not JobSpec"):
            jcli.submit(_spec(X, y))


# -- the whole slice: a job through the wire equals its direct run -------------


def _frontier(members, options):
    return [(compute_complexity(m.tree, options), m.loss, m.tree.structure_key())
            for m in members]


@pytest.mark.parametrize("leg", ["lockstep", "event", "block"])
def test_wire_job_equals_direct_run(monkeypatch, leg):
    """The frontier (complexity, loss, tree with its constants) and
    num_evals of the last frame pushed over the wire equal the same search
    run directly, bit for bit."""
    if leg == "block":
        monkeypatch.setenv("SR_ENGINE_BLOCK", "1")
    else:
        monkeypatch.delenv("SR_ENGINE_BLOCK", raising=False)
    X, y = _problem(n=64)
    kw = {} if leg == "lockstep" else dict(scheduler="device", population_size=12,
                                          ncycles_per_iteration=10)
    direct = T.equation_search(X, y, options=_opts(**kw), niterations=2, verbosity=0)
    with SearchServer(max_concurrency=1) as srv, NetServer(srv, port=0) as nsrv, \
            SRClient("127.0.0.1", nsrv.port) as cli:
        jid = cli.submit(_spec(X, y, options=_opts(**kw), niterations=2, stream_every=1))
        frames = list(cli.iter_frames(jid, timeout=TIMEOUT))
        assert cli.wait(jid, timeout=TIMEOUT)["state"] == "done"
        block = srv.job(jid).result.engine_stats.get("block") if leg != "lockstep" else None
    assert block == ("plain" if leg == "block" else None)
    last = cli.decode_frame(frames[-1])
    o = direct.options
    assert _frontier(last.members, o) == _frontier(direct.pareto_frontier, o)
    assert last.num_evals == direct.num_evals


def test_wire_subscription_push_rows_and_cancel():
    """A subscription on the event leg (as scripts/net_smoke.py runs it):
    rows pushed over the wire land in the live lane, the stream keeps
    producing frames, and a cancel over the wire ends it DONE."""
    X, y = _problem(n=60)
    sub_opts = _opts(scheduler="device", population_size=12, ncycles_per_iteration=10)
    with SearchServer(max_concurrency=1) as srv, NetServer(srv, port=0) as nsrv, \
            SRClient("127.0.0.1", nsrv.port, tenant="smoke") as cli:
        sub = cli.submit(JobSpec(X=X, y=y, options=sub_opts, kind="subscription",
                                 stream_config={"row_bucket": 64}))
        stream = cli.iter_frames(sub, timeout=TIMEOUT)
        assert load_frontier_bytes(next(stream)).members
        Xn, yn = _problem(4, seed=5)
        cli.push_rows(sub, Xn, yn)
        job = srv.job(sub)
        deadline = time.monotonic() + TIMEOUT
        while job.session.stats.rows != 64:
            assert time.monotonic() < deadline, job.session.stats.summary()
            time.sleep(0.02)
        seen = len(srv.frames(sub))
        while len(srv.frames(sub)) <= seen:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        cli.cancel(sub)
        summary = cli.wait(sub, timeout=TIMEOUT)
        assert summary["state"] == "done" and summary["stop_reason"] == "cancelled"
        frames = list(stream)
        assert len(frames) + 1 == summary["frames"] >= 3
        assert cli.frames(sub) == srv.frames(sub)
        assert cli.stats()["net"]["frames_pushed"] >= summary["frames"]
        assert cli.reconnects == 0


# -- isolation ------------------------------------------------------------------


def test_net_imports_with_jax_blocked():
    """The net modules import, and a wire round trip runs, in a process
    where importing jax or the JAX package fails; they import no torch."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "symbolicregression_jl_tpu"):
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        from symbolicregression_jl_tpu_torch.serve.net import wire, server, client
        import symbolicregression_jl_tpu_torch.serve.net as net
        msg = {{"op": "ping", "rid": 1}}
        assert net.FrameDecoder().feed_messages(net.encode_message(msg)) == [msg]
        for mod in (wire, server, client):
            src = open(mod.__file__).read()
            assert "import torch" not in src and "import jax" not in src, mod
        assert not any(m == "jax" or m.startswith(("jax.", "symbolicregression_jl_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=TIMEOUT, env={**os.environ})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
