"""HTTP/2 (RFC 9113) framing: the wire layer under the native gRPC
transport (the port's own copy of gofr_tpu/grpcx/http2.py, over the
port's wire.SocketWriter).

The reference gets this from grpc-go (google.golang.org/grpc
on GRPC_PORT); this framework owns its wire layer. Blocking sockets with a
thread per connection and a thread per stream — the Python mirror of
goroutine-per-stream — with writes serialized through one lock and both
levels of flow control (connection + stream send windows, §5.2) enforced.

Scope: server + client framing for gRPC's HTTP/2 profile — no push,
no priority scheduling (PRIORITY frames are parsed and ignored), TLS-free
prior-knowledge connections (h2c), as used for in-cluster gRPC.
"""

from __future__ import annotations

import socket
import struct
import threading

from ..errors import ConnectionLost
from ..wire import SocketWriter

# frame types (§6)
DATA = 0x0
HEADERS = 0x1
PRIORITY = 0x2
RST_STREAM = 0x3
SETTINGS = 0x4
PUSH_PROMISE = 0x5
PING = 0x6
GOAWAY = 0x7
WINDOW_UPDATE = 0x8
CONTINUATION = 0x9

# flags
FLAG_END_STREAM = 0x1   # DATA, HEADERS
FLAG_ACK = 0x1          # SETTINGS, PING
FLAG_END_HEADERS = 0x4  # HEADERS, CONTINUATION
FLAG_PADDED = 0x8       # DATA, HEADERS
FLAG_PRIORITY = 0x20    # HEADERS

# settings ids (§6.5.2)
SETTINGS_HEADER_TABLE_SIZE = 0x1
SETTINGS_ENABLE_PUSH = 0x2
SETTINGS_MAX_CONCURRENT_STREAMS = 0x3
SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5
SETTINGS_MAX_HEADER_LIST_SIZE = 0x6

# error codes (§7)
NO_ERROR = 0x0
PROTOCOL_ERROR = 0x1
INTERNAL_ERROR = 0x2
FLOW_CONTROL_ERROR = 0x3
STREAM_CLOSED = 0x5
FRAME_SIZE_ERROR = 0x6
REFUSED_STREAM = 0x7
CANCEL = 0x8

CLIENT_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
DEFAULT_WINDOW = 65535
DEFAULT_MAX_FRAME = 16384
MAX_WINDOW = (1 << 31) - 1

# lazy receive-window replenish threshold: WINDOW_UPDATEs batch until a
# quarter of the default window is consumed instead of going out per
# DATA frame — the dominant per-token syscall on the streaming path
WINDOW_REPLENISH = DEFAULT_WINDOW // 4


class ConnectionError_(Exception):
    """Fatal connection-level error (mapped to GOAWAY)."""

    def __init__(self, code: int, msg: str = ""):
        super().__init__(msg or f"http2 connection error {code}")
        self.code = code


class StreamError(Exception):
    """Stream-level error (mapped to RST_STREAM)."""

    def __init__(self, stream_id: int, code: int, msg: str = ""):
        super().__init__(msg or f"http2 stream {stream_id} error {code}")
        self.stream_id = stream_id
        self.code = code


class Frame:
    __slots__ = ("type", "flags", "stream_id", "payload")

    def __init__(self, type_: int, flags: int, stream_id: int, payload: bytes):
        self.type = type_
        self.flags = flags
        self.stream_id = stream_id
        self.payload = payload

    def __repr__(self):  # pragma: no cover - debug aid
        names = {0: "DATA", 1: "HEADERS", 2: "PRIORITY", 3: "RST_STREAM",
                 4: "SETTINGS", 5: "PUSH_PROMISE", 6: "PING", 7: "GOAWAY",
                 8: "WINDOW_UPDATE", 9: "CONTINUATION"}
        return (f"<{names.get(self.type, self.type)} flags={self.flags:#x} "
                f"sid={self.stream_id} len={len(self.payload)}>")


def encode_settings(settings: dict[int, int]) -> bytes:
    return b"".join(struct.pack(">HI", k, v) for k, v in settings.items())


def decode_settings(payload: bytes) -> dict[int, int]:
    if len(payload) % 6:
        raise ConnectionError_(FRAME_SIZE_ERROR, "bad SETTINGS length")
    out = {}
    for off in range(0, len(payload), 6):
        k, v = struct.unpack_from(">HI", payload, off)
        out[k] = v
    return out


class FrameIO:
    """Thread-safe framed socket: one reader thread, many writer threads.

    Writes go through a wire.SocketWriter: one vectored syscall carries
    any number of frames, and ``block=False`` sends never stall the
    caller (bytes park in the writer's ordered backlog under contention
    or a full socket buffer — the zero-handoff delivery path relies on
    this)."""

    def __init__(self, sock: socket.socket, max_frame: int = DEFAULT_MAX_FRAME):
        self.sock = sock
        self.max_frame = max_frame          # what we accept (our SETTINGS)
        self.peer_max_frame = DEFAULT_MAX_FRAME  # what the peer accepts
        self._rbuf = b""
        self.writer = SocketWriter(sock)

    # -- reads (single reader thread) ----------------------------------------
    def _read_exact(self, n: int) -> bytes:
        while len(self._rbuf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionLost("peer closed connection")
            self._rbuf += chunk
        out, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        return out

    def read_preface(self) -> None:
        got = self._read_exact(len(CLIENT_PREFACE))
        if got != CLIENT_PREFACE:
            raise ConnectionError_(PROTOCOL_ERROR, "bad client preface")

    def recv_frame(self) -> Frame:
        head = self._read_exact(9)
        length = int.from_bytes(head[:3], "big")
        type_, flags = head[3], head[4]
        stream_id = int.from_bytes(head[5:9], "big") & 0x7FFFFFFF
        if length > self.max_frame:
            raise ConnectionError_(FRAME_SIZE_ERROR,
                                   f"frame of {length} bytes exceeds {self.max_frame}")
        payload = self._read_exact(length) if length else b""
        return Frame(type_, flags, stream_id, payload)

    # -- writes (any thread) -------------------------------------------------
    def send_frame(self, type_: int, flags: int, stream_id: int,
                   payload: bytes = b"") -> None:
        self.send_frames([(type_, flags, stream_id, payload)])

    def send_frames(self, frames, block: bool = True) -> bool:
        """Write one or more frames in ONE vectored write — the
        first-token fast path coalesces the response HEADERS and the
        first DATA frame so a streaming client sees one packet (one
        syscall, one wakeup) instead of two back-to-back; fused decode
        blocks batch their DATA frames the same way. ``block=False``
        commits the bytes without ever stalling the caller (see
        SocketWriter); returns False when they were parked in the
        backlog, in which case the caller must arrange a later flush."""
        bufs = []
        for type_, flags, stream_id, payload in frames:
            if len(payload) > self.peer_max_frame:
                raise ConnectionError_(FRAME_SIZE_ERROR,
                                       "frame too large for peer")
            bufs.append(len(payload).to_bytes(3, "big") + bytes((type_, flags))
                        + stream_id.to_bytes(4, "big"))
            if payload:
                bufs.append(payload)
        return self.writer.write(bufs, block=block)

    def send_raw(self, data: bytes) -> None:
        """Raw blocking write outside the framing (client preface)."""
        self.writer.write(data, block=True)

    def flush(self) -> None:
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()


class WindowReplenisher:
    """Receive-window replenish policy, shared by the server connection
    and the client channel so the two sides of the own wire can never
    drift apart.

    Debt batches until WINDOW_REPLENISH and the connection + stream
    updates ship in ONE write: an update per received DATA frame would
    be the dominant per-token syscall on a streaming path. ``holder`` is
    the per-stream state carrying ``recv_debt`` (server ``_Stream`` /
    client ``_Call``), or None when the stream is already gone
    (connection-level accounting still applies)."""

    __slots__ = ("io", "_debt")

    def __init__(self, io: "FrameIO"):
        self.io = io
        self._debt = 0  # connection-level consumed-but-unannounced bytes

    def on_data(self, holder, sid: int, n: int, stream_open: bool) -> None:
        ups = []
        self._debt += n
        if self._debt >= WINDOW_REPLENISH:
            ups.append((WINDOW_UPDATE, 0, 0, struct.pack(">I", self._debt)))
            self._debt = 0
        if holder is not None and stream_open:
            holder.recv_debt += n
            if holder.recv_debt >= WINDOW_REPLENISH:
                ups.append((WINDOW_UPDATE, 0, sid,
                            struct.pack(">I", holder.recv_debt)))
                holder.recv_debt = 0
        if ups:
            self.io.send_frames(ups)


class FlowWindow:
    """A send window: block until credit, credit on WINDOW_UPDATE (§5.2)."""

    def __init__(self, initial: int = DEFAULT_WINDOW):
        self.value = initial
        self._cond = threading.Condition()
        self._dead = False

    def consume(self, want: int, timeout: float | None = None) -> int:
        """Block until some credit exists; returns min(want, credit)."""
        with self._cond:
            while self.value <= 0 and not self._dead:
                if not self._cond.wait(timeout):
                    raise TimeoutError("flow-control window starved")
            if self._dead:
                raise ConnectionLost("stream/connection closed")
            take = min(want, self.value)
            self.value -= take
            return take

    def try_consume(self, want: int) -> bool:
        """All-or-nothing nonblocking claim — the zero-handoff fast path
        takes a whole message's credit or falls back to the worker
        thread (which can afford to block in ``consume``)."""
        with self._cond:
            if self._dead or self.value < want:
                return False
            self.value -= want
            return True

    def credit(self, n: int) -> None:
        with self._cond:
            self.value += n
            if self.value > MAX_WINDOW:
                raise ConnectionError_(FLOW_CONTROL_ERROR, "window overflow")
            self._cond.notify_all()

    def adjust(self, delta: int) -> None:
        """INITIAL_WINDOW_SIZE change retro-adjusts open streams (§6.9.2)."""
        with self._cond:
            self.value += delta
            self._cond.notify_all()

    def kill(self) -> None:
        with self._cond:
            self._dead = True
            self._cond.notify_all()


def strip_padding(frame: Frame) -> bytes:
    """Remove PADDED/PRIORITY decorations from HEADERS/DATA payloads."""
    data = frame.payload
    if frame.flags & FLAG_PADDED:
        if not data:
            raise ConnectionError_(PROTOCOL_ERROR, "padded frame w/o pad length")
        pad = data[0]
        data = data[1:]
        if pad > len(data):
            raise ConnectionError_(PROTOCOL_ERROR, "padding exceeds payload")
        data = data[: len(data) - pad]
    if frame.type == HEADERS and frame.flags & FLAG_PRIORITY:
        if len(data) < 5:
            raise ConnectionError_(PROTOCOL_ERROR, "short priority block")
        data = data[5:]
    return data
