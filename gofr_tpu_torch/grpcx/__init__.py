"""grpcx: native gRPC over an in-tree HTTP/2 + HPACK wire layer (the
port's own copy of gofr_tpu/grpcx, which imports no JAX; the port keeps
its own all the same, as it does every framework piece).

Reference: pkg/gofr/grpc.go (server, grpc-go based) and grpc/log.go
(logging interceptor). The framework needs no grpc runtime: the
transport is part of it — which is also what lets it support
server streaming (needed for token streaming; the reference is
unary-only).

Public surface:
  GRPCService / GRPCError / status codes  — declare services
  GRPCServer                              — app-run transport (app.py wires it)
  GRPCChannel / dial                      — client side
  JSONCodec / ProtoCodec                  — message codecs
"""

from .client import BidiCall, GRPCChannel, dial
from .server import GRPCServer
from .service import (CANCELLED, DEADLINE_EXCEEDED, GRPCContext, GRPCError,
                      GRPCService, INTERNAL, INVALID_ARGUMENT, JSONCodec,
                      NOT_FOUND, OK, ProtoCodec, RESOURCE_EXHAUSTED,
                      STATUS_NAMES, ServerStream, UNAUTHENTICATED,
                      UNAVAILABLE, UNIMPLEMENTED, UNKNOWN)

__all__ = [
    "BidiCall", "GRPCChannel", "dial", "GRPCServer", "ServerStream",
    "GRPCContext", "GRPCError", "GRPCService", "JSONCodec", "ProtoCodec",
    "STATUS_NAMES", "OK", "CANCELLED", "UNKNOWN", "INVALID_ARGUMENT",
    "DEADLINE_EXCEEDED", "NOT_FOUND", "RESOURCE_EXHAUSTED", "UNIMPLEMENTED",
    "INTERNAL", "UNAVAILABLE", "UNAUTHENTICATED",
]
