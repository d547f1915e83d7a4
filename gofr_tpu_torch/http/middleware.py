"""HTTP middleware chain: drain gate, tracer, in-flight registry,
logging+recovery, deadline, SLO-class and tenant scopes, CORS, metrics,
and the three auth schemes (the port's own copy of
gofr_tpu/http/middleware.py, over the port's ``resilience`` and
``tenancy`` scopes and ``tracing``).

Reference: pkg/gofr/http/middleware/ —
  - tracer.go:14-30   extract W3C traceparent, start span "METHOD /path"
  - logger.go:42-117  status-capturing request log with trace/span ids and
                      microsecond latency, X-Correlation-ID header, panic
                      recovery -> 500 JSON
  - cors.go:5-19      Access-Control-Allow-* headers, short-circuit OPTIONS
  - metrics.go:20-41  app_http_response histogram labeled path/method/status
  - basic_auth.go, apikey_auth.go, oauth.go — the three auth schemes
"""

from __future__ import annotations

import base64
import hmac
import json
import threading
import time
from typing import Callable, Iterable

from .. import tracing
from ..errors import HTTPError, format_retry_after
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


def _unauthorized(w: ResponseWriter, message: str = "Unauthorized") -> None:
    w.status = 401
    w.set_header("Content-Type", "application/json")
    w.write(json.dumps({"error": {"message": message}}).encode())


_WELL_KNOWN_SKIP = ("/.well-known/health", "/.well-known/alive", "/metrics")


def basic_auth_middleware(users: dict[str, str] | None = None,
                          validate: Callable[[str, str], bool] | None = None) -> Middleware:
    """reference middleware/basic_auth.go:16-58 — map of user->password or a
    validation function."""
    def check(user: str, password: str) -> bool:
        if validate is not None:
            return validate(user, password)
        expected = (users or {}).get(user)
        # compare bytes: compare_digest raises TypeError on non-ASCII str
        return expected is not None and hmac.compare_digest(
            expected.encode(), password.encode())

    def mw(next_h: Handler) -> Handler:
        def wrapped(req: Request, w: ResponseWriter) -> None:
            if req.path in _WELL_KNOWN_SKIP:
                return next_h(req, w)
            header = req.header("Authorization")
            if not header.startswith("Basic "):
                return _unauthorized(w)
            try:
                decoded = base64.b64decode(header[6:]).decode()
                user, _, password = decoded.partition(":")
            except Exception:
                return _unauthorized(w, "invalid authorization header")
            if not check(user, password):
                return _unauthorized(w)
            next_h(req, w)
        return wrapped
    return mw


def apikey_auth_middleware(keys: Iterable[str] = (),
                           validate: Callable[[str], bool] | None = None) -> Middleware:
    """reference middleware/apikey_auth.go:7-41 — X-API-KEY header."""
    keyset = set(keys)

    def mw(next_h: Handler) -> Handler:
        def wrapped(req: Request, w: ResponseWriter) -> None:
            if req.path in _WELL_KNOWN_SKIP:
                return next_h(req, w)
            key = req.header("X-API-KEY")
            if not key:
                return _unauthorized(w)
            ok = validate(key) if validate is not None else key in keyset
            if not ok:
                return _unauthorized(w)
            next_h(req, w)
        return wrapped
    return mw


class JWKSKeyProvider:
    """Background-refreshed JWKS key cache
    (reference middleware/oauth.go:47-84: refresh goroutine + JWKS parsing
    :126-180). Fetching uses urllib; RSA verification uses ``cryptography``
    when available and falls back to rejecting RS256 otherwise."""

    def __init__(self, jwks_url: str, refresh_interval: float = 300.0, http_get=None):
        self.jwks_url = jwks_url
        self.refresh_interval = refresh_interval
        self._keys: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._http_get = http_get or self._default_get
        self._stop = threading.Event()
        self.refresh()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="jwks-refresh")
        self._thread.start()

    @staticmethod
    def _default_get(url: str) -> bytes:
        import urllib.request

        with urllib.request.urlopen(url, timeout=5) as r:
            return r.read()

    def _loop(self) -> None:
        while not self._stop.wait(self.refresh_interval):
            self.refresh()

    def refresh(self) -> None:
        try:
            data = json.loads(self._http_get(self.jwks_url))
            keys = {k.get("kid", ""): k for k in data.get("keys", [])}
            with self._lock:
                self._keys = keys
        except Exception:
            pass

    def get(self, kid: str) -> dict | None:
        with self._lock:
            return self._keys.get(kid)

    def shutdown(self) -> None:
        self._stop.set()


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def verify_jwt(token: str, key_provider: JWKSKeyProvider) -> dict:
    """Validate an RS256 JWT against JWKS keys; returns claims.
    Reference: middleware/oauth.go:86-123."""
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
        header = json.loads(_b64url_decode(header_b64))
        payload = json.loads(_b64url_decode(payload_b64))
        signature = _b64url_decode(sig_b64)
    except Exception as e:
        raise HTTPError("invalid token", 401) from e

    if header.get("alg") != "RS256":
        raise HTTPError("unsupported signing algorithm", 401)
    jwk = key_provider.get(header.get("kid", ""))
    if jwk is None:
        raise HTTPError("unknown signing key", 401)

    try:
        from cryptography.hazmat.primitives.asymmetric import padding, rsa
        from cryptography.hazmat.primitives import hashes
    except ImportError as e:  # pragma: no cover - env-dependent
        raise HTTPError("RS256 verification unavailable", 401) from e

    n = int.from_bytes(_b64url_decode(jwk["n"]), "big")
    e = int.from_bytes(_b64url_decode(jwk["e"]), "big")
    pub = rsa.RSAPublicNumbers(e, n).public_key()
    try:
        pub.verify(signature, f"{header_b64}.{payload_b64}".encode(),
                   padding.PKCS1v15(), hashes.SHA256())
    except Exception as ex:
        raise HTTPError("invalid token signature", 401) from ex

    exp = payload.get("exp")
    if exp is not None and time.time() > float(exp):
        raise HTTPError("token expired", 401)
    return payload


def oauth_middleware(key_provider: JWKSKeyProvider) -> Middleware:
    def mw(next_h: Handler) -> Handler:
        def wrapped(req: Request, w: ResponseWriter) -> None:
            if req.path in _WELL_KNOWN_SKIP:
                return next_h(req, w)
            header = req.header("Authorization")
            if not header.startswith("Bearer "):
                return _unauthorized(w)
            try:
                req.claims = verify_jwt(header[7:], key_provider)
            except HTTPError as e:
                return _unauthorized(w, e.message)
            next_h(req, w)
        return wrapped
    return mw
