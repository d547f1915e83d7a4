"""HTTP middleware chain: drain gate, tracer, in-flight registry,
logging+recovery, deadline, SLO-class and tenant scopes, CORS, metrics
(the port's own copy of gofr_tpu/http/middleware.py, over the port's
``resilience`` and ``tenancy`` scopes and ``tracing``; the auth
middlewares are not ported).

Reference: pkg/gofr/http/middleware/ —
  - tracer.go:14-30   extract W3C traceparent, start span "METHOD /path"
  - logger.go:42-117  status-capturing request log with trace/span ids and
                      microsecond latency, X-Correlation-ID header, panic
                      recovery -> 500 JSON
  - cors.go:5-19      Access-Control-Allow-* headers, short-circuit OPTIONS
  - metrics.go:20-41  app_http_response histogram labeled path/method/status
"""

from __future__ import annotations

import time
from typing import Callable

from .. import tracing
from ..errors import format_retry_after
from ..resilience import (Deadline, deadline_scope, parse_http_timeout,
                          parse_slo_class, slo_scope)
from ..tenancy.registry import tenant_scope
from .request import Request
from .responder import ResponseWriter
from .router import Handler, Middleware


class RequestLog:
    """Structured request log entry (reference middleware/logger.go:33-40)."""

    def __init__(self, trace_id: str, span_id: str, method: str, uri: str,
                 status: int, duration_us: int, ip: str):
        self.trace_id = trace_id
        self.span_id = span_id
        self.method = method
        self.uri = uri
        self.status = status
        self.duration_us = duration_us
        self.ip = ip

    def log_fields(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "method": self.method,
            "uri": self.uri,
            "response": self.status,
            "duration": self.duration_us,
            "ip": self.ip,
        }

    def pretty_print(self) -> str:
        return (f"{self.trace_id[:8]} {self.status} {self.duration_us:>8}µs "
                f"{self.method:<7} {self.uri}")


def get_ip_address(req: Request) -> str:
    """reference middleware/logger.go:75-92 getIPAddress."""
    fwd = req.header("X-Forwarded-For")
    if fwd:
        return fwd.split(",")[0].strip()
    return req.remote_addr


def tracer_middleware(tracer) -> Middleware:
    def mw(next_h: Handler) -> Handler:
        def wrapped(req: Request, w: ResponseWriter) -> None:
            span = tracer.start_span(
                f"{req.method} {req.path}",
                traceparent=req.header("traceparent") or None,
                attributes={"http.method": req.method, "http.target": req.path},
            )
            try:
                next_h(req, w)
                span.set_attribute("http.status_code", w.status)
            finally:
                span.end()
        return wrapped
    return mw


def logging_middleware(logger) -> Middleware:
    """Request log + panic recovery (reference logger.go:42-73 and :94-117)."""
    def mw(next_h: Handler) -> Handler:
        def wrapped(req: Request, w: ResponseWriter) -> None:
            start = time.monotonic_ns()
            span = tracing.current_span()
            trace_id = span.trace_id if span else ""
            span_id = span.span_id if span else ""
            if trace_id:
                w.set_header("X-Correlation-ID", trace_id)
            try:
                next_h(req, w)
            except Exception as e:  # recovery: never let a handler kill the server
                logger.error({"event": "panic recovered", "error": repr(e), "uri": req.path})
                w.status = 500
                w.headers.setdefault("Content-Type", "application/json")
                w.body = b'{"error":{"message":"internal server error"}}'
            finally:
                dur_us = (time.monotonic_ns() - start) // 1000
                logger.info(RequestLog(trace_id, span_id, req.method, req.path,
                                       w.status, dur_us, get_ip_address(req)))
        return wrapped
    return mw


def cors_middleware(allowed_origin: str = "*",
                    allowed_headers: str = ("Authorization, Content-Type, "
                                            "x-requested-with, origin, "
                                            "true-client-ip, X-Correlation-ID"),
                    allowed_methods: str = "GET, POST, PUT, PATCH, DELETE, OPTIONS") -> Middleware:
    def mw(next_h: Handler) -> Handler:
        def wrapped(req: Request, w: ResponseWriter) -> None:
            w.set_header("Access-Control-Allow-Origin", allowed_origin)
            w.set_header("Access-Control-Allow-Headers", allowed_headers)
            w.set_header("Access-Control-Allow-Methods", allowed_methods)
            if req.method == "OPTIONS":
                w.status = 200
                return
            next_h(req, w)
        return wrapped
    return mw


def deadline_middleware(header: str = "X-Request-Timeout") -> Middleware:
    """Parse the request's timeout header into an AMBIENT deadline
    (resilience.deadline_scope) for the handler's thread. Downstream,
    ``ctx.tpu.generate`` reads it: a request whose deadline runs out
    in the queue, between lattice chunks or while it decodes stops its
    device work and fails with DeadlineExceeded (-> 504, with
    ``app_tpu_expired_dropped_total`` incremented)."""
    def mw(next_h: Handler) -> Handler:
        def wrapped(req: Request, w: ResponseWriter) -> None:
            timeout = parse_http_timeout(req.header(header))
            if timeout is None:
                return next_h(req, w)
            with deadline_scope(Deadline.after(timeout)):
                next_h(req, w)
        return wrapped
    return mw


def slo_class_middleware(header: str = "X-SLO-Class") -> Middleware:
    """Parse the request's SLO class header into the AMBIENT class
    (resilience.slo_scope) for the handler's thread. Downstream,
    ``ctx.tpu.generate`` picks it up: ``throughput`` (aliases: batch,
    bulk, offline) marks the request as deprioritizable batch work --
    its own line, shed and browned out first under overload -- while
    anything else (including no header) keeps the latency class."""
    def mw(next_h: Handler) -> Handler:
        def wrapped(req: Request, w: ResponseWriter) -> None:
            with slo_scope(parse_slo_class(req.header(header))) as cls:
                span = tracing.current_span()
                if span is not None:
                    # the root span carries the class (inside the
                    # tracer middleware, the span is the request's)
                    span.set_attribute("slo_class", cls)
                next_h(req, w)
        return wrapped
    return mw


def tenant_middleware(resolver: Callable[[], object] | None = None,
                      header: str = "X-Tenant-Id") -> Middleware:
    """Parse the request's tenant header into the AMBIENT tenant
    (tenancy.tenant_scope) for the handler's thread: the HTTP face of
    gRPC's ``x-tenant-id`` metadata. ``resolver`` is a lazy callable
    returning the engine's TenantPlane or None (the chain is built
    before the container's engine, and tenancy may be off). With a
    plane the raw header is canonicalised through the registry (an
    unknown id is the default tenant, so the configured tenants bound
    the label cardinality downstream); without one the header still
    scopes, and no quota, weight or cache policy applies."""
    def mw(next_h: Handler) -> Handler:
        def wrapped(req: Request, w: ResponseWriter) -> None:
            raw = (req.header(header) or "").strip()
            plane = resolver() if resolver is not None else None
            tid = raw
            if plane is not None and raw:
                try:
                    tid = plane.resolve(raw).tenant_id
                except Exception:  # noqa: BLE001 — a registry fault
                    tid = raw      # scopes the raw id
            with tenant_scope(tid or None) as tenant:
                span = tracing.current_span()
                if span is not None:
                    span.set_attribute("tenant", tenant)
                next_h(req, w)
        return wrapped
    return mw


def drain_middleware(is_draining: Callable[[], bool],
                     retry_after: Callable[[], float | None]) -> Middleware:
    """Readiness gate for graceful shutdown: once the app starts
    draining, NEW requests get 503 + Retry-After immediately (load
    balancers stop routing; clients back off) while requests already
    inside a handler run to completion on their own threads. The
    liveness probe stays 200 — the process is healthy, just leaving."""
    def mw(next_h: Handler) -> Handler:
        def wrapped(req: Request, w: ResponseWriter) -> None:
            if is_draining() and req.path != "/.well-known/alive":
                w.status = 503
                ra = retry_after()
                if ra is not None:
                    w.set_header("Retry-After", format_retry_after(ra))
                w.set_header("Content-Type", "application/json")
                w.write(b'{"error":{"message":"server draining"}}')
                return
            next_h(req, w)
        return wrapped
    return mw


def inflight_middleware(registry) -> Middleware:
    """Register every request in the in-flight registry for the lifetime
    of its handler, so the App's graceful stop can wait for every
    handler -- streaming responses included -- to finish. Runs inside
    the tracer middleware so the entry carries the request's trace
    id."""
    def mw(next_h: Handler) -> Handler:
        def wrapped(req: Request, w: ResponseWriter) -> None:
            span = tracing.current_span()
            entry = registry.add(
                "http", f"{req.method} {req.path}",
                span.trace_id if span else "", stage="handler")
            try:
                next_h(req, w)
            finally:
                registry.remove(entry)
        return wrapped
    return mw


def metrics_middleware(metrics) -> Middleware:
    def mw(next_h: Handler) -> Handler:
        def wrapped(req: Request, w: ResponseWriter) -> None:
            start = time.monotonic()
            try:
                next_h(req, w)
            finally:
                # label by route template, not raw URI, to bound cardinality
                # (the reference gets this via mux route templates); unmatched
                # requests share one fixed label for the same reason
                path = getattr(req, "matched_route", None) or "unmatched"
                span = tracing.current_span()
                metrics.record_histogram(
                    "app_http_response", time.monotonic() - start,
                    exemplar=span.trace_id if span is not None else None,
                    path=path, method=req.method, status=str(w.status),
                )
        return wrapped
    return mw
