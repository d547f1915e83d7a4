"""Threaded HTTP/1.1 server flushing Router-produced responses.

Reference: pkg/gofr/httpServer.go:12-36 wraps net/http.Server on HTTP_PORT
(default 8000, default.go:4) with a 5s read-header timeout. Python
equivalent: a ThreadingHTTPServer with a per-request dispatch into the
router. Supports chunked streaming responses (needed for token streaming;
the reference has no HTTP streaming path).
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import chaos
from ..wire import SocketWriter, WAKE
from .request import Request
from .responder import ResponseWriter
from .router import Router


def _chunk(data: bytes) -> bytes:
    return b"%x\r\n" % len(data) + data + b"\r\n"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    router: Router = None  # type: ignore[assignment]
    logger = None
    timeout = 5  # read timeout, mirrors the reference's ReadHeaderTimeout

    # silence default stderr access logs — the logging middleware owns this
    def log_message(self, fmt: str, *args) -> None:
        pass

    def _handle(self) -> None:
        chaos.fire(chaos.HTTP_REQUEST)
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        req = Request(
            method=self.command,
            path=self.path,
            headers=dict(self.headers.items()),
            body=body,
            remote_addr=self.client_address[0],
        )
        w = ResponseWriter()
        stream_started = threading.Event()
        # streaming writes bypass wfile: one SocketWriter per request
        # carries status+headers+first chunk in a single vectored write
        # and lets a zero-handoff sink park bytes nonblocking (wfile is
        # an unbuffered per-write sendall)
        raw: list[SocketWriter] = []

        def _writer() -> SocketWriter:
            if not raw:
                raw.append(SocketWriter(self.connection))
            return raw[0]

        def _stream_head() -> bytes:
            """Status line + headers, assembled by hand so they can ride
            in the same syscall as the first chunk (BaseHTTPRequestHandler
            flushes its header buffer on end_headers)."""
            phrase = self.responses.get(w.status, ("", ""))[0]
            head = [f"{self.protocol_version} {w.status} {phrase}",
                    f"Server: {self.version_string()}",
                    f"Date: {self.date_time_string()}"]
            head += [f"{k}: {v}" for k, v in w.headers.items()]
            head.append("Transfer-Encoding: chunked")
            return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1")

        def _emit_chunk(data: bytes, block: bool) -> bool:
            if not stream_started.is_set():
                stream_started.set()
                # headers + first chunk: ONE write, one packet on the
                # wire — the HTTP mirror of the gRPC HEADERS+DATA
                # coalescing on the first-token path
                return _writer().write([_stream_head(), _chunk(data)],
                                       block=block)
            return _writer().write(_chunk(data), block=block)

        try:
            # streaming: if a handler writes chunks, flush them live
            original_write_chunk = w.write_chunk
            original_stream_from = w.stream_from

            def live_chunk(data: bytes) -> None:
                _emit_chunk(data, block=True)

            def live_stream_from(source) -> None:
                """Zero-handoff chunk streaming: a push-capable source
                (GenStream.map(...)) delivers each chunk on the
                PRODUCING thread via a nonblocking sink; this handler
                thread only waits for end-of-stream and flushes."""
                w._streaming = True

                wake = getattr(source, "wake", None)

                def sink(data: bytes) -> bool:
                    if not _emit_chunk(bytes(data), block=False) \
                            and wake is not None:
                        # bytes parked in the writer backlog have no
                        # other waker until the next chunk — rouse this
                        # handler thread to flush them
                        wake()
                    return True

                set_sink = getattr(source, "set_sink", None)
                if set_sink is not None:
                    set_sink(sink)
                try:
                    for chunk in source:  # declined items + end detection
                        if chunk is WAKE:
                            _writer().flush()  # drain sink-parked bytes
                            continue
                        live_chunk(bytes(chunk))
                finally:
                    clear = getattr(source, "clear_sink", None)
                    if clear is not None:
                        clear()
                _writer().flush()  # drain bytes the sink parked

            w.write_chunk = live_chunk  # type: ignore[method-assign]
            w.stream_from = live_stream_from  # type: ignore[method-assign]
            self.router(req, w)
            w.write_chunk = original_write_chunk  # type: ignore[method-assign]
            w.stream_from = original_stream_from  # type: ignore[method-assign]
        except (BrokenPipeError, ConnectionResetError):
            return
        except Exception as e:  # router middleware should have caught this
            if self.logger is not None:
                self.logger.error({"event": "unhandled server error", "error": repr(e)})
            w = ResponseWriter()
            w.status = 500
            w.set_header("Content-Type", "application/json")
            w.write(b'{"error":{"message":"internal server error"}}')

        try:
            if stream_started.is_set():
                # blocking terminal chunk: drains any sink backlog first
                _writer().write(b"0\r\n\r\n", block=True)
                return
            self.send_response(w.status)
            for k, v in w.headers.items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(w.body)))
            self.end_headers()
            if self.command != "HEAD":
                self.wfile.write(w.body)
        except (BrokenPipeError, ConnectionResetError):  # noqa: GL303
            pass  # client hung up while we wrote its response: there
            # is no one left to route the failure to

    do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = do_OPTIONS = do_HEAD = _handle


class _ListeningServer(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 makes the kernel
    # reset connections of a burst that arrives at once (a few dozen
    # clients), before the accept loop can take them
    request_queue_size = 128
    daemon_threads = True


class HTTPServer:
    def __init__(self, router: Router, port: int = 8000, logger=None, host: str = "0.0.0.0"):
        self.router = router
        self.port = port
        self.host = host
        self.logger = logger
        self._server: _ListeningServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        handler_cls = type("BoundHandler", (_Handler,),
                           {"router": self.router, "logger": self.logger})
        self._server = _ListeningServer((self.host, self.port), handler_cls)
        self.port = self._server.server_address[1]  # resolve port 0
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name=f"http-server-{self.port}")
        self._thread.start()
        if self.logger is not None:
            self.logger.info({"event": "http server started", "port": self.port})

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self.logger is not None:
            self.logger.info({"event": "http server stopped", "port": self.port})
