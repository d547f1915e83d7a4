"""Core HTTP service client: verbs, tracing, logging, metrics (the port's
own copy of gofr_tpu/service/client.py).

Reference: pkg/gofr/service/new.go —
  - verb set (new.go:35-64): get/post/put/patch/delete, each with a
    ``*_with_headers`` variant
  - createAndSendRequest (new.go:135-192): span per call, traceparent
    injection, structured Log/ErrorLog, ``app_http_service_response``
    histogram labeled path/method/status
  - encodeQueryParameters (new.go:196)
"""

from __future__ import annotations

import http.client
import json
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from typing import Any, Mapping

from .. import chaos
from ..datasource import Health, STATUS_DOWN, STATUS_UP
from ..errors import HTTPError, ServiceUnavailable
from ..resilience import current_deadline
from .wrap import VerbSurface, hop_context


class Response:
    """Thin response carrier (reference service/response.go)."""

    def __init__(self, status_code: int, body: bytes, headers: Mapping[str, str]):
        self.status_code = status_code
        self.body = body
        self.headers = {k.lower(): v for k, v in dict(headers).items()}

    def json(self) -> Any:
        return json.loads(self.body) if self.body else None

    def header(self, key: str, default: str = "") -> str:
        return self.headers.get(key.lower(), default)

    @property
    def ok(self) -> bool:
        return 200 <= self.status_code < 300


def _encode_query(params: Mapping[str, Any] | None) -> str:
    """reference new.go:196 encodeQueryParameters — list values repeat the key."""
    if not params:
        return ""
    pairs: list[tuple[str, str]] = []
    for k, v in params.items():
        if isinstance(v, (list, tuple)):
            pairs.extend((k, str(x)) for x in v)
        else:
            pairs.append((k, str(v)))
    return urllib.parse.urlencode(pairs)


class HTTPService(VerbSurface):
    """The innermost client every decorator wraps (reference new.go:89).
    The verb surface (reference new.go:35-64) comes from VerbSurface; here
    ``_do`` IS the network hop."""

    def __init__(self, address: str, logger=None, metrics=None, tracer=None,
                 timeout: float = 30.0):
        self.address = address.rstrip("/")
        self.logger = logger
        self.metrics = metrics
        self.tracer = tracer
        self.timeout = timeout

    # -- the one network hop (reference new.go:135-192) ----------------------
    def _do(self, method: str, path: str, params, body, headers) -> Response:
        url = f"{self.address}/{path.lstrip('/')}" if path else self.address
        q = _encode_query(params)
        if q:
            url = f"{url}?{q}"

        hdrs = {k: str(v) for k, v in (headers or {}).items()}
        data: bytes | None = None
        if body not in (None, b"", ""):
            if isinstance(body, bytes):
                data = body
            else:
                data = json.dumps(body, default=str).encode()
                hdrs.setdefault("Content-Type", "application/json")

        span = None
        if self.tracer is not None:
            span = self.tracer.start_span(f"http-service {method} {path}")
            hdrs.setdefault("traceparent", span.traceparent())

        # ambient request context crosses the hop (the gateway-forward
        # contract): one convention, service/wrap.hop_context
        timeout = hop_context(hdrs, self.timeout)

        start = time.perf_counter()
        status = 0
        try:
            chaos.fire(chaos.SERVICE_REQUEST)
            req = urllib.request.Request(url, data=data, method=method, headers=hdrs)
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    status = resp.status
                    out = Response(resp.status, resp.read(), dict(resp.headers))
            except urllib.error.HTTPError as e:
                # non-2xx is still a response, not an exception (Go semantics)
                status = e.code
                out = Response(e.code, e.read(), dict(e.headers))
            dur = time.perf_counter() - start
            self._observe(method, path, status, dur, None)
            return out
        except Exception as e:
            dur = time.perf_counter() - start
            self._observe(method, path, status, dur, e)
            raise
        finally:
            if span is not None:
                span.end()

    def _observe(self, method, path, status, dur, err) -> None:
        if self.metrics is not None:
            try:
                self.metrics.record_histogram(
                    "app_http_service_response", dur,
                    path=path or "/", method=method, status=str(status))
            except Exception:
                pass
        if self.logger is None:
            return
        entry = {"event": "http-service call", "address": self.address,
                 "method": method, "path": path, "status": status,
                 "duration_us": int(dur * 1e6)}
        if err is not None:
            entry["error"] = repr(err)
            self.logger.error(entry)
        else:
            self.logger.debug(entry)

    # -- health (reference service/health.go:18-48) --------------------------
    def health_check(self) -> Health:
        from .health import DEFAULT_HEALTH_ENDPOINT

        try:
            resp = self.get(DEFAULT_HEALTH_ENDPOINT)
            if resp.ok:
                return Health(status=STATUS_UP, details={"host": self.address})
            return Health(status=STATUS_DOWN,
                          details={"host": self.address, "status": resp.status_code})
        except Exception as e:
            return Health(status=STATUS_DOWN,
                          details={"host": self.address, "error": repr(e)})

    def close(self) -> None:  # decorators forward this inward
        pass


def new_http_service(address: str, logger=None, metrics=None, *options,
                     tracer=None, timeout: float = 30.0):
    """Build the decorator chain inside-out (reference new.go:68-87)."""
    svc = HTTPService(address, logger, metrics, tracer=tracer, timeout=timeout)
    for opt in options:
        svc = opt.add_option(svc)
    return svc


def stream_generate(service, body: Mapping[str, Any],
                    path: str = "/generate", *, max_resumes: int = 3):
    """Streaming ``/generate`` call honoring the durable-streams
    resume contract (serving.py's POST /generate) — gofr-to-gofr
    calls get mid-stream durability without a gateway hop.

    Yields token ids as ndjson lines arrive. On a mid-stream loss —
    the typed error line's resume token, or raw transport truncation
    after >= 1 token — the call re-POSTs the continuation (prompt +
    received tokens, same ``request_id``/``seed``) under the ambient
    Deadline, bounded by ``max_resumes``; replayed duplicates (cursor
    below our position) are swallowed, so the yielded stream is
    token-exact across any number of server deaths.

    ``service`` is an HTTPService (or any object with ``address``) or
    a bare ``host:port`` string. Pre-first-token failures raise typed
    (the caller's own retry policy owns those — nothing was
    delivered)."""
    address = str(getattr(service, "address", service)).rstrip("/")
    if not address.startswith("http"):
        address = f"http://{address}"
    url = f"{address}/{path.lstrip('/')}"
    base_timeout = float(getattr(service, "timeout", 120.0))
    payload = dict(body)
    emitted = [int(t) for t in (payload.get("emitted") or [])]
    if not payload.get("request_id"):
        # the dedup identity a resumed replay carries — chosen before
        # the first POST so a dead server never holds the only copy
        payload["request_id"] = f"cl-{uuid.uuid4().hex[:16]}"
    resumes = 0
    while True:
        hdrs = {"Content-Type": "application/json"}
        timeout = hop_context(hdrs, base_timeout)
        resume: dict | None = None
        try:
            chaos.fire(chaos.SERVICE_REQUEST)
            req = urllib.request.Request(
                url, data=json.dumps(payload).encode(), method="POST",
                headers=hdrs)
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                for raw in resp:
                    line = raw.strip()
                    if not line:
                        continue
                    obj = json.loads(line)
                    if "token" in obj:
                        cursor = int(obj.get("cursor", len(emitted)))
                        if cursor < len(emitted):
                            continue  # replayed duplicate: we have it
                        emitted.append(int(obj["token"]))
                        yield int(obj["token"])
                        continue
                    err = (obj.get("error") or {}) \
                        if isinstance(obj, dict) else {}
                    resume = err.get("resume")
                    if resume is None:
                        raise HTTPError(
                            str(err.get("message", "stream failed")),
                            status_code=int(err.get("status", 503)))
                    break
            if resume is None:
                return  # clean end: the stream completed
            if isinstance(resume, dict) and resume.get("seed") \
                    is not None and payload.get("seed") is None:
                payload["seed"] = int(resume["seed"])
        except urllib.error.HTTPError as e:
            # a buffered non-2xx (shed, drain, bad request): typed,
            # never resumed blind — nothing streamed on this attempt
            data = e.read()
            try:
                msg = json.loads(data)["error"]["message"]
            except Exception:  # noqa: BLE001 — non-envelope body
                msg = data.decode("utf-8", "replace")[:200]
            raise HTTPError(msg, status_code=e.code) from e
        except (OSError, http.client.HTTPException,
                urllib.error.URLError):
            if not emitted:
                raise  # pre-first-token: the caller's retry owns it
            resume = {}  # transport truncation mid-stream: resume blind
        resumes += 1
        dl = current_deadline()
        if resumes > max_resumes or (dl is not None
                                     and dl.remaining() <= 0):
            raise ServiceUnavailable(
                f"stream lost after {len(emitted)} tokens and client "
                f"resume is exhausted ({resumes - 1} resumes)")
        payload["resume_from"] = len(emitted)
        payload["emitted"] = list(emitted)
