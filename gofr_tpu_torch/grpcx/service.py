"""gRPC service model: method registry, codecs, status codes, handler
context (the port's own copy of gofr_tpu/grpcx/service.py).

Reference: App.RegisterService (pkg/gofr/gofr.go:49-53) registers
protoc-generated servers on a grpc-go server. Here a service is declared
directly in Python -- method name, handler, codec -- and the transport
handles the wire. Two codecs:

  - JSON (default): request/response are dicts, the protoless path,
    symmetric with the HTTP responder envelope.
  - Protobuf: pass generated message classes (``request_type`` /
    ``response_type``); the codec only calls their
    ``SerializeToString``/``FromString`` and imports nothing itself.

Unlike the reference (unary-only interceptors, grpc.go:22-26), methods may
be server-streaming (the handler returns or yields an iterator), which is
what token streaming needs.
"""

from __future__ import annotations

import json
from typing import Any, Callable

# gRPC status codes (subset used by the framework)
OK = 0
CANCELLED = 1
UNKNOWN = 2
INVALID_ARGUMENT = 3
DEADLINE_EXCEEDED = 4
NOT_FOUND = 5
PERMISSION_DENIED = 7
RESOURCE_EXHAUSTED = 8
UNIMPLEMENTED = 12
INTERNAL = 13
UNAVAILABLE = 14
UNAUTHENTICATED = 16

STATUS_NAMES = {
    0: "OK", 1: "CANCELLED", 2: "UNKNOWN", 3: "INVALID_ARGUMENT",
    4: "DEADLINE_EXCEEDED", 5: "NOT_FOUND", 7: "PERMISSION_DENIED",
    8: "RESOURCE_EXHAUSTED", 12: "UNIMPLEMENTED", 13: "INTERNAL",
    14: "UNAVAILABLE", 16: "UNAUTHENTICATED",
}

# One status vocabulary across both transports: a framework error raised
# with an HTTP status (errors.HTTPError subclasses — DeadlineExceeded 504,
# TooManyRequests 429, ServiceUnavailable 503, ...) maps to the
# equivalent gRPC code, so ``ctx.tpu.predict`` raising past its deadline
# is DEADLINE_EXCEEDED on gRPC and 504 on HTTP from the same exception.
HTTP_TO_GRPC_STATUS = {
    400: INVALID_ARGUMENT,
    401: UNAUTHENTICATED,
    403: PERMISSION_DENIED,
    404: NOT_FOUND,
    408: DEADLINE_EXCEEDED,
    429: RESOURCE_EXHAUSTED,
    499: CANCELLED,
    501: UNIMPLEMENTED,
    503: UNAVAILABLE,
    504: DEADLINE_EXCEEDED,
}


def from_http_error(e: BaseException) -> "GRPCError":
    """Bridge an errors.HTTPError-shaped exception into a GRPCError."""
    code = HTTP_TO_GRPC_STATUS.get(getattr(e, "status_code", 500), INTERNAL)
    return GRPCError(code, str(e) or STATUS_NAMES.get(code, str(code)))


def grpc_frame(payload: bytes) -> bytes:
    """gRPC length-prefixed message framing (RFC: compressed-flag byte,
    always 0 here, + u32 big-endian length). THE single definition —
    both transports' fast and fallback send paths must stay
    byte-compatible."""
    return b"\x00" + len(payload).to_bytes(4, "big") + payload


class GRPCError(Exception):
    """Raise from a handler to return a specific gRPC status."""

    def __init__(self, code: int, message: str = ""):
        super().__init__(message or STATUS_NAMES.get(code, str(code)))
        self.code = code
        self.message = message or STATUS_NAMES.get(code, str(code))


class JSONCodec:
    """dict <-> UTF-8 JSON bytes."""

    @staticmethod
    def serialize(obj: Any) -> bytes:
        return json.dumps(obj, default=str).encode()

    @staticmethod
    def deserialize(data: bytes) -> Any:
        return json.loads(data) if data else None


class ProtoCodec:
    """Codec over a generated protobuf message class."""

    def __init__(self, message_type):
        self.message_type = message_type

    def serialize(self, msg) -> bytes:
        return msg.SerializeToString()

    def deserialize(self, data: bytes):
        return self.message_type.FromString(data)


class Method:
    __slots__ = ("name", "handler", "request_codec", "response_codec",
                 "server_streaming", "client_streaming")

    def __init__(self, name: str, handler: Callable, request_codec,
                 response_codec, server_streaming: bool,
                 client_streaming: bool = False):
        self.name = name
        self.handler = handler
        self.request_codec = request_codec
        self.response_codec = response_codec
        self.server_streaming = server_streaming
        self.client_streaming = client_streaming


class ServerStream:
    """Server-streaming response wrapper that unlocks the transport's
    zero-handoff fast path.

    ``source`` is a push-capable stream — anything with the
    ``set_sink``/iterator protocol of ``gofr_tpu_torch.wire.PushStream``
    (``GenStream`` qualifies) — and ``map_fn`` turns each item into the
    response message::

        @llm.server_stream("Generate")
        def generate(ctx, req):
            s = ctx.tpu.generate(req["tokens"], max_new_tokens=64)
            return ServerStream(s, lambda tok: {"token": tok})

    With a ServerStream the transport serializes and writes each token
    ON THE PRODUCING THREAD (no worker wakeup between the engine's
    ``_deliver`` and the socket); a plain generator handler keeps the
    classic pull path. Iterating a ServerStream degrades gracefully to
    the mapped items, so the same handler works when zero-handoff is
    disabled. ``close()`` is called by the transport when the RPC ends
    and cancels the source, releasing whatever it holds (engine slot)."""

    __slots__ = ("source", "map_fn")

    def __init__(self, source, map_fn: "Callable | None" = None):
        self.source = source
        self.map_fn = map_fn or (lambda item: item)

    def __iter__(self):
        for item in self.source:
            yield self.map_fn(item)

    def close(self) -> None:
        cancel = getattr(self.source, "cancel", None)
        if cancel is not None:
            cancel()

    @property
    def trace(self):
        """Delivery stamps of the source (GenStream sets first_put) —
        feeds the transport's grpc.handoff span."""
        return getattr(self.source, "trace", None)


class GRPCContext:
    """Per-RPC context handed to handlers: the container behind the
    facade the port's HTTP Context offers (``logger``, ``metrics``,
    ``config``, ``tpu``, ``redis``, ``slo_class``, ``tenant``,
    ``trace``), plus the metadata, the deadline and the peer. The port
    has no SQL or outbound HTTP service clients yet, so neither has
    this context."""

    def __init__(self, container, method: str, metadata: dict[str, str],
                 deadline: float | None = None, peer: str = ""):
        self.container = container
        self.method = method
        self.metadata = metadata
        self.deadline = deadline  # monotonic deadline or None
        self.peer = peer
        self.cancelled = None  # threading.Event set on RST_STREAM

    @property
    def logger(self):
        return self.container.logger if self.container else None

    @property
    def metrics(self):
        return self.container.metrics if self.container else None

    @property
    def config(self):
        return self.container.config if self.container else None

    @property
    def tpu(self):
        return self.container.tpu if self.container else None

    @property
    def redis(self):
        return self.container.redis if self.container else None

    @property
    def slo_class(self) -> str:
        """The RPC's serving class (``slo-class`` metadata; ``latency``
        by default), ambient for ``ctx.tpu.generate`` as on HTTP."""
        from ..resilience import current_slo_class

        return current_slo_class()

    @property
    def tenant(self) -> str:
        """The RPC's tenant (``x-tenant-id`` metadata, canonicalised
        through the registry; ``default`` when untagged), ambient for
        ``ctx.tpu.generate`` as on HTTP."""
        from ..tenancy.registry import current_tenant

        return current_tenant()

    def trace(self, name: str):
        """Context manager opening a user span under the RPC's span."""
        return self.container.tracer.span(name)

    def is_cancelled(self) -> bool:
        return self.cancelled is not None and self.cancelled.is_set()


class GRPCService:
    """A named service with registered methods.

    svc = GRPCService("demo.Echo")

    @svc.unary("Say")
    def say(ctx, req): return {"msg": req["msg"]}

    @svc.server_stream("Tokens", request_type=Req, response_type=Tok)
    def tokens(ctx, req):
        for t in ...: yield t
    """

    def __init__(self, name: str):
        if not name:
            raise ValueError("service name required")
        self.name = name
        self.methods: dict[str, Method] = {}

    def _codecs(self, request_type, response_type):
        req = ProtoCodec(request_type) if request_type is not None else JSONCodec()
        res = ProtoCodec(response_type) if response_type is not None else JSONCodec()
        return req, res

    def _register(self, name: str, fn: Callable, request_type, response_type,
                  streaming: bool, client_streaming: bool = False):
        req_c, res_c = self._codecs(request_type, response_type)
        self.methods[name] = Method(name, fn, req_c, res_c, streaming,
                                    client_streaming)
        return fn

    def _decorator(self, name, fn, request_type, response_type,
                   server_streaming, client_streaming):
        if fn is None:
            return lambda f: self._register(name, f, request_type,
                                            response_type, server_streaming,
                                            client_streaming)
        return self._register(name, fn, request_type, response_type,
                              server_streaming, client_streaming)

    def unary(self, name: str, fn: Callable | None = None, *,
              request_type=None, response_type=None):
        return self._decorator(name, fn, request_type, response_type,
                               False, False)

    def server_stream(self, name: str, fn: Callable | None = None, *,
                      request_type=None, response_type=None):
        return self._decorator(name, fn, request_type, response_type,
                               True, False)

    def client_stream(self, name: str, fn: Callable | None = None, *,
                      request_type=None, response_type=None):
        """handler(ctx, request_iterator) -> single response. The iterator
        yields deserialized messages as the client sends them and ends at
        the client's half-close."""
        return self._decorator(name, fn, request_type, response_type,
                               False, True)

    def bidi_stream(self, name: str, fn: Callable | None = None, *,
                    request_type=None, response_type=None):
        """handler(ctx, request_iterator) -> yields responses. Requests and
        responses interleave freely on one stream — the shape for
        incremental prompts / cancellable token generation."""
        return self._decorator(name, fn, request_type, response_type,
                               True, True)

    def lookup(self, method: str) -> Method | None:
        return self.methods.get(method)
