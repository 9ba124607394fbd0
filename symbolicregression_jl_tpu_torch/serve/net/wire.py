"""Wire framing for the network front door.

Counterpart of ``symbolicregression_jl_tpu/serve/net/wire.py``, byte for
byte: the two packages speak one protocol, so a client of either reaches a
server of either.

The protocol carries pickled message dicts in CRC-framed binary frames —
the exact framing discipline of ``serve/journal.py`` (``u32 length |
u32 crc32 | payload`` after an 8-byte magic), applied to a socket instead
of a file. The property this buys is identical: a torn frame (connection
killed mid-write, a ``torn_frame`` fault, a proxy truncating the stream)
is *detected* — length bound, CRC, pickle validation — never mis-parsed
into a plausible-but-wrong message. A reader that cannot validate a frame
raises :class:`WireError` and drops the connection; the index-based resume
in the SDK then replays exactly the frames the client never saw.

Layout per direction (both sides send the magic first, so each end can
fail fast on a non-SRNET peer)::

    SRNET/1\\n                          8-byte connection magic
    u32 LE length | u32 LE crc32 | payload   ... repeated frames

``length`` counts payload bytes only and is bounded by
``SR_NET_MAX_FRAME_MB`` (default 64 — a pushed frontier frame is a few KB;
submit frames carry the job's dataset). Payloads are pickles of plain
dicts; :func:`decode_message` rejects non-dict payloads. Pickle implies
the classic caveat: this protocol authenticates tenants, it does NOT
sandbox peers — run it on trusted networks (localhost, a pod's VPC), the
same trust domain the journal and the pod CoordStore already assume.

:class:`FrameDecoder` is incremental: feed it whatever ``recv`` returned —
half a header, three frames and a torn tail, one byte at a time — and it
yields exactly the complete payloads, keeping partial bytes buffered.
"""

from __future__ import annotations

import os
import pickle
import struct
import zlib

__all__ = [
    "WIRE_MAGIC",
    "WireError",
    "FrameDecoder",
    "encode_frame",
    "encode_message",
    "decode_message",
    "max_frame_bytes",
]

WIRE_MAGIC = b"SRNET/1\n"  # 8 bytes, like JOURNAL_MAGIC
_HDR = struct.Struct("<II")  # payload length, crc32(payload)


class WireError(RuntimeError):
    """The byte stream violated the framing contract (oversized length
    header, CRC mismatch, bad magic, non-dict payload). Connection-fatal:
    after garbage there is no way to resynchronise a length-prefixed
    stream, so the peer must reconnect and resume by frame index."""


def max_frame_bytes() -> int:
    """Frame payload bound (``SR_NET_MAX_FRAME_MB``, default 64). A length
    header past this is treated as corruption, exactly like the journal's
    ``_MAX_RECORD`` guard — it bounds how much a torn/garbage header can
    make a reader buffer before the CRC would catch it."""
    try:
        mb = float(os.environ.get("SR_NET_MAX_FRAME_MB", "64"))
    except ValueError:
        mb = 64.0
    return int(mb * (1 << 20))


def encode_frame(payload: bytes) -> bytes:
    """One wire frame around raw payload bytes."""
    if len(payload) > max_frame_bytes():
        raise WireError(
            f"frame payload {len(payload)} bytes exceeds "
            f"SR_NET_MAX_FRAME_MB={max_frame_bytes() >> 20}"
        )
    return _HDR.pack(len(payload), zlib.crc32(payload)) + payload


def encode_message(msg: dict) -> bytes:
    """Pickle a message dict and frame it."""
    return encode_frame(pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL))


def decode_message(payload: bytes) -> dict:
    """Unpickle a frame payload; :class:`WireError` on anything that is
    not a pickled dict (a CRC collision or a non-protocol peer)."""
    try:
        msg = pickle.loads(payload)
    except Exception as exc:  # noqa: BLE001 — any unpickle failure is protocol garbage
        raise WireError(f"undecodable frame payload: {exc!r}") from exc
    if not isinstance(msg, dict):
        raise WireError(f"frame payload is {type(msg).__name__}, expected dict")
    return msg


class FrameDecoder:
    """Incremental frame reassembler for one connection direction.

    ``feed(data)`` returns the list of complete payloads the new bytes
    finish (possibly empty); incomplete trailing bytes stay buffered for
    the next feed. Interleaved partial reads therefore cost nothing, and a
    stream that ENDS mid-frame simply never completes that frame — the
    torn-tail analogue of journal replay's truncation. Corruption that can
    be proven (length header over the bound, CRC mismatch) raises
    :class:`WireError` immediately.
    """

    def __init__(self, max_bytes: int | None = None):
        self._buf = bytearray()
        self._max = max_frame_bytes() if max_bytes is None else int(max_bytes)

    @property
    def buffered(self) -> int:
        """Bytes held waiting for the rest of a frame."""
        return len(self._buf)

    def feed(self, data: bytes) -> list[bytes]:
        self._buf.extend(data)
        out: list[bytes] = []
        while True:
            if len(self._buf) < _HDR.size:
                return out
            length, crc = _HDR.unpack_from(self._buf)
            if length > self._max:
                raise WireError(
                    f"frame length header {length} exceeds {self._max} bytes "
                    "(corrupt or hostile stream)"
                )
            end = _HDR.size + length
            if len(self._buf) < end:
                return out
            payload = bytes(self._buf[_HDR.size : end])
            if zlib.crc32(payload) != crc:
                raise WireError(
                    f"frame CRC mismatch over {length}-byte payload"
                )
            del self._buf[:end]
            out.append(payload)

    def feed_messages(self, data: bytes) -> list[dict]:
        """feed() + decode_message() per completed frame."""
        return [decode_message(p) for p in self.feed(data)]
