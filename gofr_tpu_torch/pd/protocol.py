"""The KV-ship wire protocol between prefill and decode workers (the
port's own copy of gofr_tpu/pd/protocol.py: the same frames byte for
byte, so a JAX worker and a port worker ship to each other).

One persistent TCP connection per (prefill worker, decode worker) pair,
multiplexing any number of in-flight requests by ``req_id``. Every
message is one length-prefixed frame::

    [u32 length][u8 type][u32 req_id][payload]

``length`` covers everything after itself (type + req_id + payload).
Payloads are JSON except KV frames, whose payload is::

    [u32 start][kvcache.quant.encode_block frame]

— the SAME checksummed int8 block frame the Redis tier stores, reused
verbatim as the transfer codec: the decode side validates every frame
(magic, version, shape-vs-layout, sha256 digest) with
``quant.decode_block`` before any byte goes near a pool row, so a
truncated or corrupted frame is a typed per-request failure, never a
poisoned cache row and never a dead ingest loop.

Flow (prefill -> decode unless noted)::

    HELLO {fingerprint, layers, kv_heads, head_dim, version}
    <- HELLO_OK {}                      (or ERR req_id=0: refuse + close)
    REQ  {prompt, max_new, temperature, top_k, eos, adapter,
          slo_class, deadline_s, traceparent, plen, seed,
          resume_emitted?}              (resume_emitted marks a durable-
                                         stream re-handoff: the decode
                                         side admits prompt+emitted as a
                                         ``continue_from`` continuation)
    KV   [start][frame] ...             (streamed per ship block, in
                                         token order, as prefill chunks
                                         complete — ingest assembly
                                         overlaps prefill compute and
                                         wire transfer)
    KV_EOF {first_token, first_lp, plen, blocks}
    <- TOK [i32 token][i32 cursor][f32 lp] ...
                                        (decode -> prefill, per token;
                                         cursor = absolute generated-
                                         token index of the ORIGINAL
                                         request — the stream resume
                                         contract's monotone cursor,
                                         so a re-handoff splices
                                         token-exact)
    <- END {tokens}                     (or <- ERR {code, message,
                                         retry_after})
    CANCEL {}                           (prefill -> decode, either
                                         direction of giving up)

Writes ride the ``wire.py`` fast path: frames append to an ``Outbox``
drained into a vectored ``SocketWriter`` (token bursts coalesce into
one ``sendmsg``), and the ship window (``TPU_PD_WINDOW_MB``) bounds
outbox + writer backlog — a KV send past the window blocks the
producer until the peer drains, which is the honest flow control the
backlog alone would hide.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time

from ..errors import (ConnectionLost, DeadlineExceeded, HTTPError,
                      ServiceUnavailable, TooManyRequests,
                      format_retry_after)
from ..wire import Outbox, SocketWriter

PD_VERSION = 2  # v2: TOK carries the resume cursor; REQ carries
#                 seed / resume_emitted (durable streams)

# message types
HELLO = 0
HELLO_OK = 1
REQ = 2
KV = 3
KV_EOF = 4
TOK = 5
END = 6
ERR = 7
CANCEL = 8

_HEAD = struct.Struct("<IBI")   # length, type, req_id
_KV_START = struct.Struct("<I")
_TOK = struct.Struct("<iif")    # token id, cursor, logprob (f32: wire
#                                 precision)

# one message may carry at most this much (a KV frame for one ship
# block of a 70B-class model is ~MBs; anything past this is a framing
# error, not a legitimate payload)
MAX_MSG = 256 << 20


class KVTransferError(HTTPError):
    """A KV frame failed validation at the transfer boundary (bad
    checksum, truncated payload, layout mismatch) or the stream was cut
    mid-transfer. Fails the ONE request it belongs to — 502 on HTTP,
    INTERNAL on gRPC — and never touches device state."""

    status_code = 502


class DecodePeerUnavailable(ServiceUnavailable):
    """The decode pool peer is down/unreachable: the request is SHED
    with a Retry-After (the prefill worker keeps serving and the
    reconnect loop re-arms the path), the 503 sibling of the gate's
    429 — clients retry exactly like any other shed."""

    def __init__(self, message: str = "decode peer unavailable",
                 retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = retry_after
        self.headers = {"Retry-After": format_retry_after(retry_after)}


def error_to_wire(e: BaseException) -> dict:
    """Exception -> ERR payload. The http status code IS the type on
    the wire; retry_after survives so the prefill side re-raises a
    shed that still advises honest backoff."""
    code = getattr(e, "status_code", 500)
    return {"code": int(code), "message": str(e)[:500],
            "retry_after": getattr(e, "retry_after", None)}


def error_from_wire(p: dict) -> BaseException:
    """ERR payload -> the typed exception the prefill worker delivers
    into the client's stream: sheds stay sheds (429 + Retry-After),
    deadline stays 504, transfer faults stay 502 — the process
    boundary never flattens the error contract to a bare 500."""
    code = int(p.get("code", 500))
    msg = p.get("message", "decode worker error")
    retry_after = p.get("retry_after")
    if code == 429:
        return TooManyRequests(msg, retry_after=retry_after)
    if code == 504:
        return DeadlineExceeded(msg)
    if code == 502:
        return KVTransferError(msg)
    if code == 503:
        return DecodePeerUnavailable(msg, retry_after=retry_after or 1.0)
    return HTTPError(msg, status_code=code)


def pack_msg(mtype: int, req_id: int, payload: bytes = b"") -> bytes:
    return _HEAD.pack(5 + len(payload), mtype, req_id) + payload


def pack_json(mtype: int, req_id: int, obj: dict) -> bytes:
    return pack_msg(mtype, req_id, json.dumps(obj).encode())


def pack_kv(req_id: int, start: int, frame: bytes) -> bytes:
    return pack_msg(KV, req_id, _KV_START.pack(start) + frame)


def pack_tok(req_id: int, token: int, cursor: int,
             lp: float | None) -> bytes:
    return pack_msg(TOK, req_id, _TOK.pack(
        int(token), int(cursor), 0.0 if lp is None else float(lp)))


def unpack_tok(payload) -> tuple[int, int, float]:
    return _TOK.unpack(bytes(payload[:_TOK.size]))


def unpack_kv(payload) -> tuple[int, bytes]:
    (start,) = _KV_START.unpack(bytes(payload[:_KV_START.size]))
    return start, bytes(payload[_KV_START.size:])


def _read_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def read_msg(sock: socket.socket) -> tuple[int, int, bytes] | None:
    """One framed message off the socket, or None on EOF/close. A
    length past MAX_MSG is treated as EOF (protocol desync: nothing
    after it can be trusted, the connection is torn down)."""
    head = _read_exact(sock, 4)
    if head is None:
        return None
    (length,) = struct.unpack("<I", head)
    if length < 5 or length > MAX_MSG:
        return None
    body = _read_exact(sock, length)
    if body is None:
        return None
    mtype, req_id = struct.unpack_from("<BI", body)
    return mtype, req_id, body[5:]


class Conn:
    """One PD connection's send half: an ``Outbox`` (ordered,
    thread-combining — token bursts from the serving loop coalesce)
    draining into a vectored ``SocketWriter``. ``send`` is the
    nonblocking fast path (stalls park in the writer backlog and ride
    out with the next frame); ``send_windowed`` is the KV-ship path —
    it blocks once ``pending_bytes`` crosses the ship window, which is
    the backpressure contract: a slow decode peer slows the prefill
    worker's ship loop instead of ballooning its memory."""

    def __init__(self, sock: socket.socket, window_bytes: int = 8 << 20):
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.sock = sock
        self.writer = SocketWriter(sock)
        self.window = int(window_bytes)
        self._pending = 0
        self._plock = threading.Lock()
        self.outbox = Outbox(self._drain)
        self.closed = False
        self.bytes_sent = 0
        self.kv_frames = 0

    def _drain(self, batch, block: bool) -> int:
        n = sum(len(b) for b in batch)
        try:
            self.writer.write(batch, block=block)
        except OSError as e:
            # a dying socket (BrokenPipe/ConnectionReset/...) is ONE
            # failure class for every caller: EOFError, with the conn
            # marked closed — the prefill side maps it to the typed
            # 503 shed instead of leaking a raw OSError to the client
            self.closed = True
            raise ConnectionLost(f"pd connection lost: {e!r}") from e
        finally:
            # parked-in-backlog bytes still count as pending until a
            # later drain flushes them — backlog_bytes tracks that side
            with self._plock:
                self._pending -= n
        self.bytes_sent += n
        return len(batch)

    def pending_bytes(self) -> int:
        with self._plock:
            p = self._pending
        return p + self.writer.backlog_bytes

    def send(self, msg: bytes, block: bool = False) -> None:
        if self.closed:
            raise ConnectionLost("pd connection closed")
        with self._plock:
            self._pending += len(msg)
        self.outbox.append(msg)
        self.outbox.pump(block=block)

    def send_windowed(self, msg: bytes, deadline_s: float = 30.0) -> None:
        """KV-ship send: wait (bounded) for the window to open, then
        send. Raises ``KVTransferError`` when the peer cannot drain a
        window's worth within ``deadline_s`` — the request fails typed
        instead of the ship loop hanging forever on a wedged peer."""
        t_end = time.monotonic() + max(deadline_s, 0.05)
        while self.pending_bytes() + len(msg) > self.window:
            if self.closed:
                raise ConnectionLost("pd connection closed")
            if time.monotonic() >= t_end:
                raise KVTransferError(
                    f"kv ship window stalled: {self.pending_bytes()} bytes "
                    f"pending > {self.window} window")
            # try to move bytes: drain the outbox and poke the writer's
            # backlog nonblocking, then yield briefly
            self.outbox.pump(block=False)
            try:
                self.writer.write([], block=False)
            except EOFError:
                self.closed = True
                raise
            time.sleep(0.001)
        self.kv_frames += 1
        self.send(msg, block=False)

    def flush(self) -> None:
        self.outbox.pump(block=True)

    def close(self) -> None:
        self.closed = True
        try:
            self.writer.close()
        except Exception:
            pass


def hello_payload(fingerprint: str, layout) -> dict:
    return {"version": PD_VERSION, "fingerprint": fingerprint,
            "layers": int(layout.layers), "kv_heads": int(layout.kv_heads),
            "head_dim": int(layout.head_dim)}


def hello_mismatch(mine: dict, theirs: dict) -> str | None:
    """None when the peer may ship KV here; else the reason to refuse.
    Dtype/quantization may differ (the frame codec carries per-vector
    scales and the decode side rehydrates into ITS cache dtype), but
    model identity and attention geometry must match exactly — a wrong
    fingerprint would serve another model's KV as attention state."""
    if theirs.get("version") != mine["version"]:
        return f"pd protocol version {theirs.get('version')} != {mine['version']}"
    if theirs.get("fingerprint") != mine["fingerprint"]:
        return "model fingerprint mismatch"
    for k in ("layers", "kv_heads", "head_dim"):
        if theirs.get(k) != mine[k]:
            return f"kv layout mismatch: {k} {theirs.get(k)} != {mine[k]}"
    return None
