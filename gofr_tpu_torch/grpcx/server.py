"""Native gRPC server: HTTP/2 transport + method dispatch + interceptors
(the port's own copy of gofr_tpu/grpcx/server.py).

Reference: pkg/gofr/grpc.go:20-46 -- grpc-go server on GRPC_PORT with
chained unary interceptors (panic recovery + logging/tracing,
grpc.go:22-26) -- and grpc/log.go:19-68 (RPCLog with microsecond latency
and a span per RPC). This server reproduces that contract on its own
wire layer, and adds server streaming, which the reference lacks but
Llama token streaming requires.

Model: thread per connection (frame loop) + thread per stream (handler),
the Python mirror of grpc-go's goroutine per stream. Writes are
serialized by FrameIO; DATA sends respect both flow-control windows.

The request metadata reaches the port's serving policies as it does in
JAX: ``grpc-timeout`` becomes the handler thread's ambient Deadline,
``slo-class`` its SLO class, ``x-tenant-id`` its tenant (canonicalised
through the engine's tenancy plane, when there is one) and
``traceparent`` the RPC span's parent.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time
import traceback
import urllib.parse

from . import http2 as h2
from . import service as svc
from .hpack import Decoder, encode_stateless
from .. import chaos, tracing, wire
from ..errors import format_retry_after
from ..resilience import (Deadline, deadline_scope, parse_slo_class,
                          slo_scope)
from ..tenancy.registry import tenant_scope
from ..wire import Outbox

_GRPC_CONTENT_TYPES = ("application/grpc",)
_TIMEOUT_UNITS = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6, "n": 1e-9}


def parse_grpc_timeout(val: str | None) -> float | None:
    if not val:
        return None
    try:
        return int(val[:-1]) * _TIMEOUT_UNITS[val[-1]]
    except (KeyError, ValueError):
        return None


class _Stream:
    __slots__ = ("id", "headers", "recv_q", "buffer", "send_window",
                 "cancelled", "end_received", "headers_sent", "worker",
                 "recv_debt")

    def __init__(self, sid: int, headers: dict[str, str], initial_window: int):
        self.id = sid
        self.headers = headers
        self.recv_q: queue.Queue = queue.Queue()
        self.buffer = bytearray()
        self.send_window = h2.FlowWindow(initial_window)
        self.cancelled = threading.Event()
        self.end_received = False
        self.headers_sent = False
        self.worker: threading.Thread | None = None
        self.recv_debt = 0  # bytes received since the last WINDOW_UPDATE


class _Connection:
    """One accepted socket: owns the frame loop and all stream state."""

    def __init__(self, sock: socket.socket, addr, server: "GRPCServer"):
        self.io = h2.FrameIO(sock)
        self.addr = addr
        self.server = server
        self.decoder = Decoder()
        self._replenisher = h2.WindowReplenisher(self.io)
        self.conn_window = h2.FlowWindow(h2.DEFAULT_WINDOW)
        self.peer_initial_window = h2.DEFAULT_WINDOW
        self.streams: dict[int, _Stream] = {}
        self._streams_lock = threading.Lock()
        self._goaway = False
        self._last_stream = 0
        # header block being assembled across HEADERS/CONTINUATION
        self._hdr_sid = 0
        self._hdr_block = b""
        self._hdr_end_stream = False

    # -- lifecycle -----------------------------------------------------------
    def run(self) -> None:
        try:
            self.io.read_preface()
            self.io.send_frame(h2.SETTINGS, 0, 0, h2.encode_settings({
                h2.SETTINGS_HEADER_TABLE_SIZE: 4096,
                h2.SETTINGS_MAX_FRAME_SIZE: h2.DEFAULT_MAX_FRAME,
                h2.SETTINGS_MAX_CONCURRENT_STREAMS: 1024,
            }))
            while True:
                frame = self.io.recv_frame()
                self._dispatch(frame)
        except (EOFError, OSError):
            pass
        except h2.ConnectionError_ as e:
            self._send_goaway(e.code, str(e))
        except Exception as e:  # noqa: BLE001
            log = self.server.logger
            if log is not None:
                log.error({"event": "grpc connection crashed", "error": repr(e)})
            self._send_goaway(h2.INTERNAL_ERROR, "internal error")
        finally:
            self._teardown()

    def _teardown(self) -> None:
        with self._streams_lock:
            streams = list(self.streams.values())
            self.streams.clear()
        for st in streams:
            st.cancelled.set()
            st.send_window.kill()
            st.recv_q.put(None)
        self.conn_window.kill()
        self.io.close()
        self.server._conn_done(self)

    def _send_goaway(self, code: int, msg: str = "") -> None:
        try:
            payload = struct.pack(">II", self._last_stream, code) + msg.encode()[:128]
            self.io.send_frame(h2.GOAWAY, 0, 0, payload)
        except (EOFError, OSError):  # noqa: GL303 — best-effort GOAWAY:
            pass  # the peer this goodbye is FOR is the thing that died

    # -- frame dispatch ------------------------------------------------------
    def _dispatch(self, f: h2.Frame) -> None:
        if self._hdr_sid and f.type != h2.CONTINUATION:
            raise h2.ConnectionError_(h2.PROTOCOL_ERROR,
                                      "expected CONTINUATION")
        if f.type == h2.SETTINGS:
            self._on_settings(f)
        elif f.type == h2.HEADERS:
            self._on_headers(f)
        elif f.type == h2.CONTINUATION:
            self._on_continuation(f)
        elif f.type == h2.DATA:
            self._on_data(f)
        elif f.type == h2.WINDOW_UPDATE:
            self._on_window_update(f)
        elif f.type == h2.RST_STREAM:
            self._on_rst(f)
        elif f.type == h2.PING:
            if not f.flags & h2.FLAG_ACK:
                self.io.send_frame(h2.PING, h2.FLAG_ACK, 0, f.payload)
        elif f.type == h2.GOAWAY:
            self._goaway = True
        elif f.type == h2.PUSH_PROMISE:
            raise h2.ConnectionError_(h2.PROTOCOL_ERROR, "client push")
        # PRIORITY and unknown frame types are ignored (RFC 9113 §4.1)

    def _on_settings(self, f: h2.Frame) -> None:
        if f.flags & h2.FLAG_ACK:
            return
        if f.stream_id != 0:
            raise h2.ConnectionError_(h2.PROTOCOL_ERROR, "SETTINGS on stream")
        settings = h2.decode_settings(f.payload)
        if h2.SETTINGS_MAX_FRAME_SIZE in settings:
            self.io.peer_max_frame = settings[h2.SETTINGS_MAX_FRAME_SIZE]
        # SETTINGS_HEADER_TABLE_SIZE needs no answer: every block this
        # server sends is stateless (hpack.encode_stateless) and never
        # touches the peer's dynamic table
        if h2.SETTINGS_INITIAL_WINDOW_SIZE in settings:
            new = settings[h2.SETTINGS_INITIAL_WINDOW_SIZE]
            if new > h2.MAX_WINDOW:
                raise h2.ConnectionError_(h2.FLOW_CONTROL_ERROR, "bad window")
            delta = new - self.peer_initial_window
            self.peer_initial_window = new
            with self._streams_lock:
                for st in self.streams.values():
                    st.send_window.adjust(delta)
        self.io.send_frame(h2.SETTINGS, h2.FLAG_ACK, 0)

    def _on_headers(self, f: h2.Frame) -> None:
        if f.stream_id == 0 or f.stream_id % 2 == 0:
            raise h2.ConnectionError_(h2.PROTOCOL_ERROR, "bad stream id")
        block = h2.strip_padding(f)
        if f.flags & h2.FLAG_END_HEADERS:
            self._open_stream(f.stream_id, block,
                              bool(f.flags & h2.FLAG_END_STREAM))
        else:
            self._hdr_sid = f.stream_id
            self._hdr_block = block
            self._hdr_end_stream = bool(f.flags & h2.FLAG_END_STREAM)

    def _on_continuation(self, f: h2.Frame) -> None:
        if f.stream_id != self._hdr_sid:
            raise h2.ConnectionError_(h2.PROTOCOL_ERROR, "bad CONTINUATION")
        self._hdr_block += f.payload
        if f.flags & h2.FLAG_END_HEADERS:
            sid, block = self._hdr_sid, self._hdr_block
            end = self._hdr_end_stream
            self._hdr_sid, self._hdr_block = 0, b""
            self._open_stream(sid, block, end)

    def _open_stream(self, sid: int, block: bytes, end_stream: bool) -> None:
        headers = {k.decode("ascii"): v.decode("utf-8", "replace")
                   for k, v in self.decoder.decode(block)}
        if sid <= self._last_stream:
            raise h2.ConnectionError_(h2.PROTOCOL_ERROR, "stream id reuse")
        self._last_stream = sid
        st = _Stream(sid, headers, self.peer_initial_window)
        st.end_received = end_stream
        if end_stream:
            st.recv_q.put(None)
        with self._streams_lock:
            if self._goaway:
                self.io.send_frame(h2.RST_STREAM, 0, sid,
                                   struct.pack(">I", h2.REFUSED_STREAM))
                return
            self.streams[sid] = st
        st.worker = threading.Thread(target=self.server._handle_stream,
                                     args=(self, st), daemon=True,
                                     name=f"grpc-stream-{sid}")
        st.worker.start()

    def _on_data(self, f: h2.Frame) -> None:
        with self._streams_lock:
            st = self.streams.get(f.stream_id)
        if st is None:
            # closed/unknown stream: still account connection flow control
            if f.payload:
                self._replenisher.on_data(None, f.stream_id,
                                          len(f.payload), False)
            return
        data = h2.strip_padding(f)
        st.buffer.extend(data)
        # gRPC length-prefixed messages (compressed-flag byte + u32 length)
        while len(st.buffer) >= 5:
            compressed, length = st.buffer[0], int.from_bytes(st.buffer[1:5], "big")
            if len(st.buffer) < 5 + length:
                break
            msg = bytes(st.buffer[5 : 5 + length])
            del st.buffer[: 5 + length]
            if compressed:
                st.recv_q.put(svc.GRPCError(svc.UNIMPLEMENTED,
                                            "compression not supported"))
            else:
                st.recv_q.put(msg)
        if f.flags & h2.FLAG_END_STREAM:
            st.end_received = True
            st.recv_q.put(None)
        # replenish receive windows (we buffer in-process, never stall reads)
        if f.payload:
            self._replenisher.on_data(st, st.id, len(f.payload),
                                      not st.end_received)

    def _on_window_update(self, f: h2.Frame) -> None:
        if len(f.payload) != 4:
            raise h2.ConnectionError_(h2.FRAME_SIZE_ERROR, "bad WINDOW_UPDATE")
        inc = int.from_bytes(f.payload, "big") & 0x7FFFFFFF
        if inc == 0:
            raise h2.ConnectionError_(h2.PROTOCOL_ERROR, "zero window increment")
        if f.stream_id == 0:
            self.conn_window.credit(inc)
        else:
            with self._streams_lock:
                st = self.streams.get(f.stream_id)
            if st is not None:
                st.send_window.credit(inc)

    def _on_rst(self, f: h2.Frame) -> None:
        with self._streams_lock:
            st = self.streams.pop(f.stream_id, None)
        if st is not None:
            st.cancelled.set()
            st.send_window.kill()
            st.recv_q.put(None)

    # -- stream sends (called from worker threads) ---------------------------
    def send_headers(self, st: _Stream, headers, end_stream: bool = False) -> None:
        flags = h2.FLAG_END_HEADERS | (h2.FLAG_END_STREAM if end_stream else 0)
        # stateless block (static-exact + literal-without-indexing):
        # touches no dynamic table, so there is no ordering constraint
        # with other encodes and no lock to hold
        self.io.send_frame(h2.HEADERS, flags, st.id, encode_stateless(headers))

    def send_message(self, st: _Stream, payload: bytes,
                     headers=None, stages: "dict | None" = None) -> None:
        """One gRPC length-prefixed message as flow-controlled DATA.

        ``headers``: response headers to coalesce with the FIRST data
        frame in a single socket write — the first-token fast path for
        streaming RPCs (one packet on the wire instead of HEADERS then
        DATA; saves a syscall and a client-reader wakeup on the latency
        path of the first token).

        ``stages``: optional dict the coalesced HEADERS+DATA send fills
        with monotonic stamps (enc0/enc1/write0/write1) — the source of
        the grpc.hpack / grpc.frame-write TTFT decomposition spans."""
        data = svc.grpc_frame(payload)
        view = memoryview(data)
        while view:
            if st.cancelled.is_set():
                raise svc.GRPCError(svc.CANCELLED, "client cancelled")
            want = min(len(view), self.io.peer_max_frame)
            n_stream = st.send_window.consume(want, timeout=30.0)
            n = self.conn_window.consume(n_stream, timeout=30.0)
            if n < n_stream:  # refund stream credit the connection couldn't cover
                st.send_window.credit(n_stream - n)
            if headers is not None:
                t_enc0 = time.monotonic()
                block = self.server.resp_block(headers)
                t_enc1 = time.monotonic()
                self.io.send_frames([
                    (h2.HEADERS, h2.FLAG_END_HEADERS, st.id, block),
                    (h2.DATA, 0, st.id, bytes(view[:n]))])
                if stages is not None:
                    stages.update(enc0=t_enc0, enc1=t_enc1, write0=t_enc1,
                                  write1=time.monotonic())
                # flag only AFTER the frames hit the wire: an earlier
                # flow-control timeout/cancel must leave headers_sent
                # False so _finish still emits a full trailers-only
                # response (:status + grpc-status), not bare trailers
                st.headers_sent = True
                headers = None
            else:
                self.io.send_frame(h2.DATA, 0, st.id, bytes(view[:n]))
            view = view[n:]

    def close_stream(self, st: _Stream) -> None:
        with self._streams_lock:
            self.streams.pop(st.id, None)


class _PushSender:
    """One stream's zero-handoff delivery state (GRPCServer._serve_push).

    All response DATA for the stream flows through ONE wire.Outbox in
    FIFO order, drained by whichever thread is available:

      - the producing thread (the engine serving loop, via the
        GenStream sink) appends and pumps NONBLOCKING — flow-control
        credit is claimed with try_consume and bytes leave through the
        writer's MSG_DONTWAIT path, so token delivery can never stall
        behind a slow client;
      - on any obstacle (no credit, oversized message, serialize
        failure, deadline, cancel) the sender DOWNGRADES permanently:
        later items go back to the stream queue and the RPC's worker
        thread serves them with the blocking path. Latency is already
        lost at that point; ordering never is, because every DATA byte
        passes through the outbox.
    """

    __slots__ = ("server", "conn", "st", "codec", "map_fn", "source",
                 "deadline", "outbox", "downgraded", "_spans_done")

    def __init__(self, server: "GRPCServer", conn: _Connection, st: _Stream,
                 codec, map_fn, source, deadline: float | None):
        self.server = server
        self.conn = conn
        self.st = st
        self.codec = codec
        self.map_fn = map_fn
        self.source = source
        self.deadline = deadline
        self.outbox = Outbox(self._drain)
        self.downgraded = False
        self._spans_done = False

    # -- producing thread ----------------------------------------------------
    def sink(self, item) -> bool:
        if self.downgraded or self.st.cancelled.is_set():
            return False
        if self.deadline is not None and time.monotonic() > self.deadline:
            self.downgraded = True  # the worker raises DEADLINE_EXCEEDED
            return False
        try:
            payload = self.codec.serialize(self.map_fn(item))
        except Exception:
            self.downgraded = True
            return False
        if len(payload) + 5 > self.conn.io.peer_max_frame:
            self.downgraded = True  # multi-frame message: worker path
            return False
        self.outbox.append(payload)
        try:
            self.outbox.pump(block=False)
        except Exception:
            self.downgraded = True
            self._wake_worker()  # committed bytes need a flusher
            return True
        if self.outbox.stalled:
            self.downgraded = True
            # the stalled item has NO other waker: the worker is parked
            # in q.get and the next token may be a decode block away —
            # without this the first byte waits for the second token
            self._wake_worker()
        return True

    def _wake_worker(self) -> None:
        w = getattr(self.source, "wake", None)
        if w is not None:
            w()

    # -- worker thread -------------------------------------------------------
    def send(self, item) -> None:
        self.outbox.append(self.codec.serialize(self.map_fn(item)))
        self.outbox.pump(block=True)

    def finish(self) -> None:
        self.outbox.pump(block=True)
        # a deferred nonblocking write may have parked bytes in the
        # WRITER's backlog (one layer below the outbox) — drain that too
        self.conn.io.flush()

    # -- outbox drain (single flusher at a time; see wire.Outbox) ------------
    def _drain(self, batch, block: bool) -> int:
        conn, st = self.conn, self.st
        if block:
            for payload in batch:
                got = time.monotonic()
                if st.headers_sent:
                    conn.send_message(st, payload)
                else:
                    stages: dict = {}
                    conn.send_message(st, payload,
                                      headers=_response_headers(),
                                      stages=stages)
                    self._spans(got, stages)
            return len(batch)
        frames = []
        stages = {}
        got = time.monotonic()
        n = 0
        for payload in batch:
            if st.cancelled.is_set():
                break
            data = svc.grpc_frame(payload)
            if len(data) > conn.io.peer_max_frame:
                break  # the worker sends it multi-frame
            if not st.send_window.try_consume(len(data)):
                break
            if not conn.conn_window.try_consume(len(data)):
                st.send_window.credit(len(data))
                break
            if not st.headers_sent:
                stages["enc0"] = time.monotonic()
                block_b = self.server.resp_block(_response_headers())
                stages["enc1"] = time.monotonic()
                frames.append((h2.HEADERS, h2.FLAG_END_HEADERS, st.id,
                               block_b))
                st.headers_sent = True
            frames.append((h2.DATA, 0, st.id, data))
            n += 1
        if frames:
            t0 = time.monotonic()
            on_wire = conn.io.send_frames(frames, block=False)
            if "enc0" in stages:
                stages["write0"], stages["write1"] = t0, time.monotonic()
                self._spans(got, stages)
            if not on_wire:
                # bytes parked in the writer backlog (socket full /
                # write lock contended): same no-waker hazard as an
                # outbox stall one layer up — the backlog would sit
                # until the NEXT write on the connection. Downgrade and
                # wake the worker, whose finish() flushes the writer.
                self.downgraded = True
                self._wake_worker()
        return n

    def _spans(self, got: float, stages: dict) -> None:
        if self._spans_done:
            return
        self._spans_done = True
        self.server._first_send_spans(self.st, self.source, got, stages)


class GRPCServer:
    """Accept loop + RPC dispatch with recovery/logging/tracing interceptors
    (reference grpc.go:22-26 chain order)."""

    def __init__(self, services, port: int, container=None):
        self.services: dict[str, svc.GRPCService] = {
            s.name: s for s in services}
        self._draining = False
        self._drain_retry_after: float | None = None
        if "grpc.health.v1.Health" not in self.services:
            self._install_health_service()
        self.port = port
        self.container = container
        self.logger = container.logger if container is not None else None
        self.tracer = getattr(container, "tracer", None)
        # the static response header block, pre-encoded ONCE per server:
        # stateless (see hpack.encode_stateless), so it is valid on
        # every connection at any point in its lifetime
        self._resp_block = encode_stateless(_RESPONSE_HEADERS)
        self._sock: socket.socket | None = None
        self._conns: set[_Connection] = set()
        self._conns_lock = threading.Lock()
        self._accept_thread: threading.Thread | None = None
        self._stopping = False

    def _install_health_service(self) -> None:
        """Built-in readiness service (grpc.health.v1 shape, JSON codec):
        load balancers poll Check and see NOT_SERVING the moment a
        graceful drain starts — BEFORE the engine stops taking work —
        so routing moves away while in-flight streams finish."""
        health = svc.GRPCService("grpc.health.v1.Health")

        def check(ctx, req):
            return {"status": "NOT_SERVING" if self._draining else "SERVING"}

        health.unary("Check", check)
        self.services[health.name] = health

    def start_draining(self, retry_after: float | None = None) -> None:
        """Flip readiness for a graceful drain: health reports
        NOT_SERVING and NEW RPCs are refused with UNAVAILABLE (+
        retry-after trailer) while streams already dispatched run to
        completion over their live connections.

        A stream whose client has not half-closed (a Chat between
        turns) would wait for its next request message with nothing to
        end the wait, and hold the drain for its whole grace: it gets
        the same UNAVAILABLE as its next message, so its handler ends
        once the work it already holds is done."""
        self._draining = True
        self._drain_retry_after = retry_after
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            with c._streams_lock:
                idle = [st for st in c.streams.values()
                        if not st.end_received
                        and not st.headers.get(":path", "").startswith(
                            _HEALTH_PREFIX)]
            for st in idle:
                st.recv_q.put(self._drain_error())
        if self.logger is not None:
            self.logger.info({"event": "grpc server draining",
                              "retry_after_s": retry_after})

    def _drain_error(self) -> svc.GRPCError:
        e = svc.GRPCError(svc.UNAVAILABLE, "server draining")
        e.retry_after = self._drain_retry_after
        return e

    def resp_block(self, headers) -> bytes:
        """Pre-encoded stateless block for the standard response
        headers; arbitrary header lists fall through to
        encode_stateless (whose per-pair fragments memoize)."""
        if tuple(headers) == _RESPONSE_HEADERS:
            return self._resp_block
        return encode_stateless(headers)

    # -- lifecycle (reference grpc.go:31-46 Run) -----------------------------
    def start(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", self.port))
        self._sock.listen(128)
        self.port = self._sock.getsockname()[1]
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               name="gofr-grpc-accept",
                                               daemon=True)
        self._accept_thread.start()
        if self.logger is not None:
            self.logger.info({"event": "grpc server listening",
                              "port": self.port,
                              "services": sorted(self.services)})

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                sock, addr = self._sock.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Connection(sock, addr, self)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=conn.run, daemon=True,
                             name=f"gofr-grpc-conn-{addr[1]}").start()

    def _conn_done(self, conn: _Connection) -> None:
        with self._conns_lock:
            self._conns.discard(conn)

    def inflight(self) -> int:
        """RPCs whose handler has not yet written its trailers, over
        every connection: what a graceful drain waits for before
        ``stop`` sends GOAWAY."""
        with self._conns_lock:
            conns = list(self._conns)
        n = 0
        for c in conns:
            with c._streams_lock:
                n += len(c.streams)
        return n

    def stop(self) -> None:
        self._stopping = True
        if self._sock is not None:
            try:
                # shutdown() BEFORE close(): on Linux a thread blocked in
                # accept() is NOT woken by close() from another thread
                # (the in-progress syscall pins the open file
                # description) — shutdown is what interrupts it. Without
                # this every stopped server leaked its accept thread
                # (caught by the conftest session-teardown assertion).
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            c._send_goaway(h2.NO_ERROR)
            c.io.close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)

    # -- RPC dispatch --------------------------------------------------------
    def _handle_stream(self, conn: _Connection, st: _Stream) -> None:
        path = st.headers.get(":path", "")
        start = time.monotonic()
        status, message = svc.OK, ""
        retry_after: float | None = None
        span = None
        if self.tracer is not None:
            span = self.tracer.start_span(
                f"grpc{path}", traceparent=st.headers.get("traceparent"),
                attributes={"rpc.system": "grpc", "rpc.method": path})
        try:
            chaos.fire(chaos.GRPC_STREAM)
            status, message = self._invoke(conn, st, path)
        except svc.GRPCError as e:
            status, message = e.code, e.message
            retry_after = getattr(e, "retry_after", None)
        except (EOFError, OSError, TimeoutError) as e:
            status, message = svc.UNAVAILABLE, f"transport: {e!r}"
        except Exception as e:  # noqa: BLE001 — recovery interceptor
            if hasattr(e, "status_code"):
                # framework HTTPError: one status vocabulary across
                # transports (DeadlineExceeded -> DEADLINE_EXCEEDED,
                # TooManyRequests shed -> RESOURCE_EXHAUSTED + retry-after)
                ge = svc.from_http_error(e)
                status, message = ge.code, ge.message
                retry_after = getattr(e, "retry_after", None)
            else:
                status, message = svc.INTERNAL, "internal error"
                if self.logger is not None:
                    self.logger.error({
                        "event": "grpc panic recovered",
                        "method": path, "error": repr(e),
                        "traceback": traceback.format_exc(limit=8)})
        finally:
            self._finish(conn, st, status, message, retry_after=retry_after)
            if span is not None:
                span.set_attribute("rpc.grpc.status_code", status)
                span.end()
            # RPCLog mirror of reference grpc/log.go:19-25
            if self.logger is not None:
                self.logger.info({
                    "id": span.trace_id if span is not None else "",
                    "method": path,
                    "status_code": status,
                    "duration": int((time.monotonic() - start) * 1e6),
                    "rpc": True,
                })

    def _invoke(self, conn: _Connection, st: _Stream, path: str):
        ct = st.headers.get("content-type", "")
        if not any(ct.startswith(t) for t in _GRPC_CONTENT_TYPES):
            raise svc.GRPCError(svc.INTERNAL, f"bad content-type {ct!r}")
        try:
            _, service_name, method_name = path.split("/")
        except ValueError:
            raise svc.GRPCError(svc.UNIMPLEMENTED, f"malformed path {path!r}")
        service = self.services.get(service_name)
        method = service.lookup(method_name) if service is not None else None
        if method is None:
            raise svc.GRPCError(svc.UNIMPLEMENTED,
                                f"unknown method {path!r}")
        if self._draining and service_name != "grpc.health.v1.Health":
            # readiness flipped first (App.stop grace window): streams
            # already dispatched finish; NEW ones are refused fast with
            # a retry hint. Health stays reachable so pollers observe
            # NOT_SERVING rather than a vanished endpoint.
            raise self._drain_error()

        timeout = parse_grpc_timeout(st.headers.get("grpc-timeout"))
        deadline = time.monotonic() + timeout if timeout else None
        metadata = {k: v for k, v in st.headers.items()
                    if not k.startswith(":")}
        ctx = svc.GRPCContext(self.container, path, metadata,
                              deadline=deadline,
                              peer=f"{conn.addr[0]}:{conn.addr[1]}")
        ctx.cancelled = st.cancelled

        def check_alive():
            if st.cancelled.is_set():
                raise svc.GRPCError(svc.CANCELLED, "client cancelled")
            if deadline is not None and time.monotonic() > deadline:
                raise svc.GRPCError(svc.DEADLINE_EXCEEDED, "deadline exceeded")

        def one_message():
            try:
                msg = st.recv_q.get(timeout=timeout or 60.0)
            except queue.Empty:
                raise svc.GRPCError(
                    svc.DEADLINE_EXCEEDED,
                    "no request message before deadline") from None
            if isinstance(msg, svc.GRPCError):
                raise msg
            if msg is None:
                return None
            try:
                return method.request_codec.deserialize(msg)
            except Exception as e:
                raise svc.GRPCError(svc.INVALID_ARGUMENT,
                                    f"bad request: {e!r}") from None

        # the wire deadline and SLO class become AMBIENT for the
        # handler thread: ctx.tpu.predict / generate pick them up
        # without per-call plumbing, so expired work is dropped before
        # the device sees it and ``slo-class: throughput`` metadata
        # routes the request through the batch-traffic line
        slo_class = parse_slo_class(metadata.get("slo-class"))
        # x-tenant-id metadata is the gRPC face of the HTTP X-Tenant-Id
        # header: the same ambient scope, the same canonicalisation
        tenant = (metadata.get("x-tenant-id") or "").strip() or None
        if tenant is not None:
            plane = getattr(getattr(self.container, "tpu", None),
                            "tenancy", None)
            if plane is not None:
                try:
                    tenant = plane.resolve(tenant).tenant_id
                except Exception:  # noqa: BLE001 — a registry fault
                    pass           # scopes the raw id
        rpc_span = tracing.current_span()
        if rpc_span is not None:
            # the RPC root span carries the class and the tenant, as the
            # HTTP request span does
            rpc_span.set_attribute("slo_class", slo_class)
            if tenant is not None:
                rpc_span.set_attribute("tenant", tenant)

        with deadline_scope(Deadline(deadline) if deadline is not None
                            else None), \
                slo_scope(slo_class), tenant_scope(tenant):
            if method.client_streaming:
                # handler receives a lazy iterator over the request
                # stream; it ends at the client's half-close
                # (END_STREAM), errors surface in-loop, and
                # cancellation/deadline are re-checked per message
                def request_iter():
                    while True:
                        check_alive()
                        msg = one_message()
                        if msg is None:
                            return
                        yield msg

                check_alive()
                result = method.handler(ctx, request_iter())
            else:
                request = one_message()
                if request is None:
                    raise svc.GRPCError(svc.INVALID_ARGUMENT,
                                        "no request message")
                check_alive()
                result = method.handler(ctx, request)

            if method.server_streaming:
                try:
                    if (isinstance(result, svc.ServerStream)
                            and hasattr(result.source, "set_sink")):
                        self._serve_push(conn, st, method, result,
                                         check_alive, deadline)
                    else:
                        self._serve_iter(conn, st, method, result,
                                         check_alive)
                finally:
                    # ServerStream.close cancels the source (slot
                    # release); plain generators get their normal close
                    close = getattr(result, "close", None)
                    if close is not None:
                        close()
            else:
                check_alive()
                payload = method.response_codec.serialize(result)
                conn.send_message(st, payload, headers=_response_headers())
        return svc.OK, ""

    def _serve_iter(self, conn: _Connection, st: _Stream, method, result,
                    check_alive) -> None:
        """Pull-based server streaming: iterate the handler's generator
        on this worker thread (plain generator handlers, bidi Chat
        included)."""
        for item in result:
            check_alive()
            payload = method.response_codec.serialize(item)
            # coalesced HEADERS+DATA: one write for the first token;
            # send_message flips headers_sent once they're on the wire
            if st.headers_sent:
                conn.send_message(st, payload)
            else:
                got = time.monotonic()
                stages: dict = {}
                conn.send_message(st, payload, headers=_response_headers(),
                                  stages=stages)
                self._first_send_spans(st, result, got, stages)

    def _serve_push(self, conn: _Connection, st: _Stream, method, result,
                    check_alive, deadline) -> None:
        """Zero-handoff server streaming: the producing thread delivers
        serialized messages straight into the connection's write
        scheduler — first-token bytes go from the engine's _deliver to
        the socket without waking this worker. The worker only clears
        backpressure stalls, serves fallback items, and owns
        end-of-stream (trailers follow in _finish)."""
        src = result.source
        sender = _PushSender(self, conn, st, method.response_codec,
                             result.map_fn, src, deadline)
        src.set_sink(sender.sink)
        try:
            for item in src:  # items the sink declined + end-of-stream
                check_alive()
                if item is wire.WAKE:
                    sender.finish()  # flush a stalled outbox (sink woke us)
                    continue
                sender.send(item)
            check_alive()
            sender.finish()
        finally:
            # detach BEFORE trailers: a sink firing after END_STREAM
            # would corrupt the stream
            clear = getattr(src, "clear_sink", None)
            if clear is not None:
                clear()

    def _first_send_spans(self, st: _Stream, source, got: float,
                          stages: dict) -> None:
        """TTFT decomposition spans for the FIRST streamed message:
        grpc.handoff (producer _deliver -> transport), grpc.hpack
        (header block encode) and grpc.frame-write (the coalesced
        HEADERS+DATA write). Exported once per stream."""
        tracer = self.tracer
        if tracer is None:
            return
        tp = st.headers.get("traceparent")
        trace = getattr(source, "trace", None)
        if isinstance(trace, dict):
            first_put = trace.get("first_put")
            if first_put is not None and first_put <= got:
                tracer.record_span("grpc.handoff", first_put, got,
                                   traceparent=tp,
                                   attributes={"stream": st.id})
        if "enc0" in stages:
            tracer.record_span("grpc.hpack", stages["enc0"], stages["enc1"],
                               traceparent=tp,
                               attributes={"stream": st.id})
        if "write0" in stages:
            tracer.record_span("grpc.frame-write", stages["write0"],
                               stages["write1"], traceparent=tp,
                               attributes={"stream": st.id})

    def _finish(self, conn: _Connection, st: _Stream, status: int,
                message: str, retry_after: float | None = None) -> None:
        try:
            trailers = [("grpc-status", str(status))]
            if message:
                trailers.append(("grpc-message",
                                 urllib.parse.quote(message, safe=" ")))
            if retry_after is not None:
                # shed/drain backpressure hint the client-side retry
                # policy reads before computing its own backoff
                trailers.append(("retry-after",
                                 format_retry_after(retry_after)))
            if not st.headers_sent:
                # trailers-only response
                trailers = _response_headers() + trailers
            conn.send_headers(st, trailers, end_stream=True)
        except (EOFError, OSError, h2.ConnectionError_):
            pass
        finally:
            conn.close_stream(st)


_RESPONSE_HEADERS = ((":status", "200"), ("content-type", "application/grpc"))
_HEALTH_PREFIX = "/grpc.health.v1.Health/"


def _response_headers() -> list[tuple[str, str]]:
    return list(_RESPONSE_HEADERS)
