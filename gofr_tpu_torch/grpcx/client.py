"""Native gRPC client: unary + server-streaming calls over one HTTP/2 conn
(the port's own copy of gofr_tpu/grpcx/client.py).

The reference consumes gRPC through generated grpc-go stubs (e.g.
examples/grpc-server/main_test.go dials with grpc.Dial); this client is the
framework-side equivalent for tests and inter-service calls. One connection
multiplexes concurrent calls (odd client stream ids); a reader thread
dispatches frames to per-call queues.
"""

from __future__ import annotations

import queue
import socket
import threading
import urllib.parse

from ..errors import ConnectionLost
from . import http2 as h2
from . import service as svc
from .hpack import Decoder, Encoder


def _q_get(q: queue.Queue, timeout: float | None):
    try:
        return q.get(timeout=timeout)
    except queue.Empty:
        raise svc.GRPCError(svc.DEADLINE_EXCEEDED,
                            f"no response within {timeout}s") from None


class _Call:
    __slots__ = ("sid", "q", "headers", "trailers", "send_window", "buffer",
                 "done", "recv_debt")

    def __init__(self, sid: int, initial_window: int):
        self.sid = sid
        self.q: queue.Queue = queue.Queue()  # message bytes | GRPCError | None
        self.headers: dict[str, str] = {}
        self.trailers: dict[str, str] = {}
        self.send_window = h2.FlowWindow(initial_window)
        self.buffer = bytearray()
        self.done = threading.Event()
        self.recv_debt = 0  # bytes received since the last WINDOW_UPDATE


class GRPCChannel:
    """h2c (prior-knowledge) gRPC channel to host:port."""

    def __init__(self, host: str, port: int, connect_timeout: float = 5.0):
        self.target = f"{host}:{port}"
        self.sock = socket.create_connection((host, port), connect_timeout)
        # create_connection leaves connect_timeout as the PER-READ timeout;
        # a server-stream gap longer than it (first-request compile, long
        # decode) would kill the whole channel with a reader TimeoutError.
        # Reads block indefinitely; close() wakes the reader via the
        # shutdown-then-close in FrameIO.close, and per-CALL deadlines are
        # carried by grpc-timeout, not the socket.
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.io = h2.FrameIO(self.sock)
        self.encoder = Encoder()
        self.decoder = Decoder()
        self._enc_lock = threading.Lock()
        self.conn_window = h2.FlowWindow(h2.DEFAULT_WINDOW)
        self.peer_initial_window = h2.DEFAULT_WINDOW
        self._calls: dict[int, _Call] = {}
        self._lock = threading.Lock()
        self._next_sid = 1
        self._closed = False
        self._error: Exception | None = None
        self._replenisher = h2.WindowReplenisher(self.io)

        self.io.send_raw(h2.CLIENT_PREFACE)
        self.io.send_frame(h2.SETTINGS, 0, 0, h2.encode_settings({
            h2.SETTINGS_HEADER_TABLE_SIZE: 4096,
            h2.SETTINGS_MAX_FRAME_SIZE: h2.DEFAULT_MAX_FRAME,
        }))
        self._reader = threading.Thread(target=self._read_loop,
                                        name="gofr-grpc-client", daemon=True)
        self._reader.start()

    # -- reader --------------------------------------------------------------
    def _read_loop(self) -> None:
        try:
            while True:
                self._dispatch(self.io.recv_frame())
        except Exception as e:  # noqa: BLE001
            self._error = e
            self._teardown()

    def _teardown(self) -> None:
        with self._lock:
            calls = list(self._calls.values())
            self._calls.clear()
            self._closed = True
        for c in calls:
            c.send_window.kill()
            c.q.put(None)
        self.conn_window.kill()

    def _dispatch(self, f: h2.Frame) -> None:
        if f.type == h2.SETTINGS:
            if not f.flags & h2.FLAG_ACK:
                settings = h2.decode_settings(f.payload)
                if h2.SETTINGS_MAX_FRAME_SIZE in settings:
                    self.io.peer_max_frame = settings[h2.SETTINGS_MAX_FRAME_SIZE]
                if h2.SETTINGS_INITIAL_WINDOW_SIZE in settings:
                    new = settings[h2.SETTINGS_INITIAL_WINDOW_SIZE]
                    delta = new - self.peer_initial_window
                    self.peer_initial_window = new
                    with self._lock:
                        for c in self._calls.values():
                            c.send_window.adjust(delta)
                if h2.SETTINGS_HEADER_TABLE_SIZE in settings:
                    with self._enc_lock:
                        self.encoder.set_max_table_size(
                            settings[h2.SETTINGS_HEADER_TABLE_SIZE])
                self.io.send_frame(h2.SETTINGS, h2.FLAG_ACK, 0)
        elif f.type == h2.HEADERS:
            self._on_headers(f)
        elif f.type == h2.DATA:
            self._on_data(f)
        elif f.type == h2.WINDOW_UPDATE:
            inc = int.from_bytes(f.payload, "big") & 0x7FFFFFFF
            if f.stream_id == 0:
                self.conn_window.credit(inc)
            else:
                call = self._calls.get(f.stream_id)
                if call is not None:
                    call.send_window.credit(inc)
        elif f.type == h2.PING:
            if not f.flags & h2.FLAG_ACK:
                self.io.send_frame(h2.PING, h2.FLAG_ACK, 0, f.payload)
        elif f.type == h2.RST_STREAM:
            call = self._pop_call(f.stream_id)
            if call is not None:
                code = int.from_bytes(f.payload[:4], "big") if f.payload else 0
                call.q.put(svc.GRPCError(svc.UNAVAILABLE,
                                         f"stream reset (http2 code {code})"))
                call.q.put(None)
        elif f.type == h2.GOAWAY:
            raise ConnectionLost("server sent GOAWAY")

    def _pop_call(self, sid: int) -> _Call | None:
        with self._lock:
            return self._calls.pop(sid, None)

    def _cancel_call(self, call: _Call) -> None:
        """Release a call the consumer abandoned (iterator dropped, timeout,
        deserialization error): RST_STREAM(CANCEL) tells the server to stop
        generating into the dead stream, and popping the entry stops it
        consuming window credit. No-op if the call already finished."""
        if self._pop_call(call.sid) is None:
            return
        try:
            self.io.send_frame(h2.RST_STREAM, 0, call.sid,
                               h2.CANCEL.to_bytes(4, "big"))
        except OSError:
            pass  # connection already gone — nothing to release
        call.done.set()

    def _on_headers(self, f: h2.Frame) -> None:
        call = self._calls.get(f.stream_id)
        block = h2.strip_padding(f)
        if not f.flags & h2.FLAG_END_HEADERS:
            # collect CONTINUATIONs inline (reader thread owns recv)
            while True:
                nxt = self.io.recv_frame()
                if nxt.type != h2.CONTINUATION or nxt.stream_id != f.stream_id:
                    raise h2.ConnectionError_(h2.PROTOCOL_ERROR,
                                              "expected CONTINUATION")
                block += nxt.payload
                if nxt.flags & h2.FLAG_END_HEADERS:
                    break
        headers = {k.decode("ascii"): v.decode("utf-8", "replace")
                   for k, v in self.decoder.decode(block)}
        if call is None:
            return
        if "grpc-status" in headers:
            call.trailers.update(headers)
        else:
            call.headers.update(headers)
        if f.flags & h2.FLAG_END_STREAM:
            self._pop_call(f.stream_id)
            self._finish_call(call)

    def _finish_call(self, call: _Call) -> None:
        status = int(call.trailers.get("grpc-status", svc.UNKNOWN))
        if status != svc.OK:
            msg = urllib.parse.unquote(call.trailers.get("grpc-message", ""))
            call.q.put(svc.GRPCError(status, msg))
        call.q.put(None)
        call.done.set()

    def _on_data(self, f: h2.Frame) -> None:
        call = self._calls.get(f.stream_id)
        if f.payload:
            self._replenisher.on_data(
                call, f.stream_id, len(f.payload),
                not f.flags & h2.FLAG_END_STREAM)
        if call is None:
            return
        call.buffer.extend(h2.strip_padding(f))
        while len(call.buffer) >= 5:
            length = int.from_bytes(call.buffer[1:5], "big")
            if len(call.buffer) < 5 + length:
                break
            call.q.put(bytes(call.buffer[5 : 5 + length]))
            del call.buffer[: 5 + length]
        if f.flags & h2.FLAG_END_STREAM:
            self._pop_call(f.stream_id)
            self._finish_call(call)

    # -- calls ---------------------------------------------------------------
    def _request_headers(self, method: str, timeout: float | None,
                         metadata=None) -> list[tuple[str, str]]:
        headers = [(":method", "POST"), (":scheme", "http"),
                   (":path", method), (":authority", self.target),
                   ("content-type", "application/grpc"),
                   ("te", "trailers")]
        if timeout is not None:
            headers.append(("grpc-timeout", f"{int(timeout * 1000)}m"))
        for k, v in (metadata or {}).items():
            headers.append((k.lower(), v))
        return headers

    def _open_call(self, method: str, timeout: float | None,
                   metadata=None) -> _Call:
        """Allocate a stream and send HEADERS (no END_STREAM): the request
        side stays open for streaming sends."""
        if self._closed:
            raise svc.GRPCError(svc.UNAVAILABLE,
                                f"channel closed: {self._error!r}")
        headers = self._request_headers(method, timeout, metadata)
        # Stream ids must reach the server strictly increasing (RFC 9113
        # §5.1.1): allocate the id and emit HEADERS under one lock so
        # concurrent calls can't reorder. DATA may interleave freely after.
        with self._lock:
            sid = self._next_sid
            self._next_sid += 2
            call = _Call(sid, self.peer_initial_window)
            self._calls[sid] = call
            with self._enc_lock:
                block = self.encoder.encode(headers)
            self.io.send_frame(h2.HEADERS, h2.FLAG_END_HEADERS, sid, block)
        return call

    def _half_close(self, call: _Call) -> None:
        """End the request side (empty DATA + END_STREAM)."""
        self.io.send_frame(h2.DATA, h2.FLAG_END_STREAM, call.sid)

    def _send_message(self, call: _Call, payload: bytes, *,
                      end: bool, timeout: float | None) -> None:
        """One gRPC length-prefixed message as flow-controlled DATA;
        ``end=True`` half-closes the request side with the final frame."""
        data = svc.grpc_frame(payload)
        view = memoryview(data)
        while view:
            want = min(len(view), self.io.peer_max_frame)
            n_stream = call.send_window.consume(want, timeout=timeout or 30.0)
            n = self.conn_window.consume(n_stream, timeout=timeout or 30.0)
            if n < n_stream:  # refund credit the connection couldn't cover
                call.send_window.credit(n_stream - n)
            last = end and n == len(view)
            self.io.send_frame(h2.DATA,
                               h2.FLAG_END_STREAM if last else 0, call.sid,
                               bytes(view[:n]))
            view = view[n:]

    def _start_call(self, method: str, payload: bytes,
                    timeout: float | None, metadata=None) -> _Call:
        """Open a one-message request (unary / server-stream): on the
        fast path the WHOLE request — HEADERS + DATA + END_STREAM —
        leaves in ONE vectored write (one syscall, one packet, one
        server-reader wakeup) instead of three back-to-back. Falls back
        to open+send when the message needs multiple frames or the
        windows lack instant credit."""
        data = svc.grpc_frame(payload)
        if (not self._closed and len(data) <= self.io.peer_max_frame
                and self.conn_window.try_consume(len(data))):
            headers = self._request_headers(method, timeout, metadata)
            with self._lock:
                sid = self._next_sid
                self._next_sid += 2
                call = _Call(sid, self.peer_initial_window)
                if not call.send_window.try_consume(len(data)):
                    # a tiny INITIAL_WINDOW_SIZE: refund and fall back
                    self.conn_window.credit(len(data))
                else:
                    self._calls[sid] = call
                    with self._enc_lock:
                        block = self.encoder.encode(headers)
                    self.io.send_frames([
                        (h2.HEADERS, h2.FLAG_END_HEADERS, sid, block),
                        (h2.DATA, h2.FLAG_END_STREAM, sid, data)])
                    return call
        call = self._open_call(method, timeout, metadata)
        self._send_message(call, payload, end=True, timeout=timeout)
        return call

    def unary(self, method: str, request, *, codec=None, response_codec=None,
              timeout: float | None = 30.0, metadata=None):
        """Call /pkg.Service/Method; JSON codec unless codecs given."""
        codec = codec or svc.JSONCodec()
        response_codec = response_codec or codec
        call = self._start_call(method, codec.serialize(request), timeout,
                                metadata)
        try:
            msg = _q_get(call.q, timeout)
            if isinstance(msg, svc.GRPCError):
                raise msg
            if msg is None:
                raise svc.GRPCError(svc.UNAVAILABLE,
                                    f"connection lost: {self._error!r}")
            # drain trailers sentinel
            tail = _q_get(call.q, timeout)
            if isinstance(tail, svc.GRPCError):
                raise tail
            return response_codec.deserialize(msg)
        finally:
            self._cancel_call(call)  # no-op unless the call is still open

    def server_stream(self, method: str, request, *, codec=None,
                      response_codec=None, timeout: float | None = 60.0,
                      metadata=None):
        """Iterate streamed responses for /pkg.Service/Method."""
        codec = codec or svc.JSONCodec()
        response_codec = response_codec or codec
        call = self._start_call(method, codec.serialize(request), timeout,
                                metadata)
        try:
            while True:
                msg = _q_get(call.q, timeout)
                if isinstance(msg, svc.GRPCError):
                    raise msg
                if msg is None:
                    if not call.done.is_set() and self._error is not None:
                        raise svc.GRPCError(svc.UNAVAILABLE,
                                            f"connection lost: {self._error!r}")
                    return
                yield response_codec.deserialize(msg)
        finally:
            # GeneratorExit (consumer stopped iterating), _q_get timeout, or
            # any downstream error: cancel so the server releases its slot
            self._cancel_call(call)

    def client_stream(self, method: str, requests, *, codec=None,
                      response_codec=None, timeout: float | None = 30.0,
                      metadata=None):
        """Stream ``requests`` (an iterable) in, receive ONE response."""
        codec = codec or svc.JSONCodec()
        response_codec = response_codec or codec
        call = self._open_call(method, timeout, metadata)
        try:
            for r in requests:
                self._send_message(call, codec.serialize(r), end=False,
                                   timeout=timeout)
            self._half_close(call)
            msg = _q_get(call.q, timeout)
            if isinstance(msg, svc.GRPCError):
                raise msg
            if msg is None:
                raise svc.GRPCError(svc.UNAVAILABLE,
                                    f"connection lost: {self._error!r}")
            tail = _q_get(call.q, timeout)
            if isinstance(tail, svc.GRPCError):
                raise tail
            return response_codec.deserialize(msg)
        finally:
            self._cancel_call(call)  # no-op unless the call is still open

    def bidi_stream(self, method: str, *, codec=None, response_codec=None,
                    timeout: float | None = 60.0, metadata=None) -> "BidiCall":
        """Open a bidirectional stream: returns a handle with ``send()``,
        ``close_send()``, iteration over responses, and ``cancel()`` —
        requests and responses interleave freely (incremental prompts in,
        tokens out, mid-stream cancel)."""
        codec = codec or svc.JSONCodec()
        response_codec = response_codec or codec
        call = self._open_call(method, timeout, metadata)
        return BidiCall(self, call, codec, response_codec, timeout)

    def close(self) -> None:
        # _closed is written under _lock everywhere else (_teardown);
        # an unlocked flip here can interleave with a streamer checking
        # it mid-open. io.close() stays outside: it wakes the read loop,
        # whose _teardown needs the lock.
        with self._lock:
            self._closed = True
        self.io.close()


class BidiCall:
    """Client handle for one bidi RPC. Thread-safe for one sender + one
    receiver; dropping the response iterator (or ``cancel()``) sends
    RST_STREAM so the server releases whatever the stream holds."""

    def __init__(self, channel: GRPCChannel, call: _Call, codec,
                 response_codec, timeout: float | None):
        self._channel = channel
        self._call = call
        self._codec = codec
        self._response_codec = response_codec
        self._timeout = timeout
        self._send_closed = False

    def send(self, msg) -> None:
        if self._send_closed:
            raise svc.GRPCError(svc.INTERNAL, "send side already closed")
        self._channel._send_message(self._call, self._codec.serialize(msg),
                                    end=False, timeout=self._timeout)

    def close_send(self) -> None:
        """Half-close: no more requests; responses keep flowing."""
        if not self._send_closed:
            self._send_closed = True
            self._channel._half_close(self._call)

    def cancel(self) -> None:
        self._channel._cancel_call(self._call)

    def __iter__(self):
        try:
            while True:
                msg = _q_get(self._call.q, self._timeout)
                if isinstance(msg, svc.GRPCError):
                    raise msg
                if msg is None:
                    if (not self._call.done.is_set()
                            and self._channel._error is not None):
                        raise svc.GRPCError(
                            svc.UNAVAILABLE,
                            f"connection lost: {self._channel._error!r}")
                    return
                yield self._response_codec.deserialize(msg)
        finally:
            self._channel._cancel_call(self._call)


def dial(address: str, **kw) -> GRPCChannel:
    """address "host:port" -> channel (the grpc.Dial shape)."""
    host, _, port = address.partition(":")
    return GRPCChannel(host or "127.0.0.1", int(port), **kw)
