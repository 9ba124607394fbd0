"""Network front door for the serve stack.

Counterpart of ``symbolicregression_jl_tpu/serve/net/``: the same protocol,
bytes, ops, counters and ``SR_NET_*`` knobs, over the port's
:class:`~..server.SearchServer`. Host-side asyncio and sockets only: the
modules import no ``torch``, and a submitted job runs on the device its
``Options.device`` names.

- ``wire`` — the CRC-framed binary codec (journal framing discipline on a
  socket): :class:`FrameDecoder`, :func:`encode_message`, :class:`WireError`.
- ``server`` — :class:`NetServer`: the asyncio socket server wrapping a
  :class:`~..server.SearchServer` (auth→tenant, frame fan-out, retryable
  overload, slow-client shed).
- ``client`` — the SDK: sync :class:`SRClient` and :class:`AsyncSRClient`,
  both with reconnect + resume-from-frame-index streams.
"""

from .client import (
    AsyncSRClient,
    AuthError,
    ConnectionLost,
    NetError,
    RemoteError,
    RetryableWireError,
    SRClient,
)
from .server import NetServer, parse_tokens
from .wire import (
    WIRE_MAGIC,
    FrameDecoder,
    WireError,
    decode_message,
    encode_frame,
    encode_message,
    max_frame_bytes,
)

__all__ = [
    "NetServer",
    "SRClient",
    "AsyncSRClient",
    "NetError",
    "AuthError",
    "RemoteError",
    "RetryableWireError",
    "ConnectionLost",
    "WireError",
    "FrameDecoder",
    "WIRE_MAGIC",
    "encode_frame",
    "encode_message",
    "decode_message",
    "max_frame_bytes",
    "parse_tokens",
]
