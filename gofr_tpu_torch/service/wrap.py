"""Shared decorator plumbing for service options (the port's own copy of
gofr_tpu/service/wrap.py).

The reference re-implements the 10-verb surface in every decorator
(e.g. service/basic_auth.go:46-125, circuit_breaker.go:171-269). Here a
single base class forwards every verb through one ``_do`` choke point, so
each decorator overrides exactly one method.
"""

from __future__ import annotations

from typing import Any, Mapping


def set_header_default(headers: dict, key: str, value: str) -> None:
    """setdefault with case-insensitive key matching — a caller-supplied
    'authorization' must win over a decorator's 'Authorization'."""
    lower = key.lower()
    if any(k.lower() == lower for k in headers):
        return
    headers[key] = value


def hop_context(headers: dict, timeout: float | None = None) -> float | None:
    """Apply the ambient request context to an outbound hop, in ONE
    place for every cross-process client (HTTPService and the gateway
    relay): the SLO class rides ``X-SLO-Class`` so per-class accounting
    survives the hop (only a non-default class is worth a header byte —
    absent means latency on both sides), and the remaining deadline
    rides ``X-Request-Timeout`` so the peer's budget is the CALLER's
    remaining budget, not a fresh one. Returns ``timeout`` tightened to
    that same remaining budget — with the retry decorator's pause
    check this is what keeps a retry loop from outliving the caller."""
    from ..resilience import SLO_LATENCY, current_deadline, current_slo_class

    slo = current_slo_class()
    if slo != SLO_LATENCY:
        set_header_default(headers, "X-SLO-Class", slo)
    dl = current_deadline()
    if dl is not None:
        set_header_default(headers, "X-Request-Timeout",
                           f"{max(dl.remaining(), 0.001):.6f}s")
        if timeout is not None:
            timeout = max(0.05, dl.budget(timeout))
    return timeout


class VerbSurface:
    """The 10-verb client surface, all flowing through one ``_do`` choke
    point. Shared by the innermost HTTPService and every decorator so the
    verb list exists exactly once."""

    def _do(self, method: str, path: str, params, body, headers) -> Any:
        raise NotImplementedError

    def get(self, path: str, params: Mapping[str, Any] | None = None):
        return self._do("GET", path, params, None, None)

    def get_with_headers(self, path, params=None, headers=None):
        return self._do("GET", path, params, None, headers)

    def post(self, path: str, params=None, body=b""):
        return self._do("POST", path, params, body, None)

    def post_with_headers(self, path, params=None, body=b"", headers=None):
        return self._do("POST", path, params, body, headers)

    def put(self, path: str, params=None, body=b""):
        return self._do("PUT", path, params, body, None)

    def put_with_headers(self, path, params=None, body=b"", headers=None):
        return self._do("PUT", path, params, body, headers)

    def patch(self, path: str, params=None, body=b""):
        return self._do("PATCH", path, params, body, None)

    def patch_with_headers(self, path, params=None, body=b"", headers=None):
        return self._do("PATCH", path, params, body, headers)

    def delete(self, path: str, body=b""):
        return self._do("DELETE", path, None, body, None)

    def delete_with_headers(self, path, body=b"", headers=None):
        return self._do("DELETE", path, None, body, headers)


class ServiceWrapper(VerbSurface):
    def __init__(self, inner):
        self.inner = inner

    def _do(self, method: str, path: str, params, body, headers) -> Any:
        return _dispatch(self.inner, method, path, params, body, headers)

    def health_check(self):
        return self.inner.health_check()

    def close(self) -> None:
        self.inner.close()

    def __getattr__(self, name: str):
        # delegate state inspection (is_open, address, timeout, ...) through
        # the decorator chain so wrapping order never hides it
        return getattr(self.inner, name)


def _dispatch(svc, method: str, path: str, params, body, headers):
    """Call the matching ``*_with_headers`` verb on any client layer."""
    m = method.upper()
    if m == "GET":
        return svc.get_with_headers(path, params, headers)
    if m == "POST":
        return svc.post_with_headers(path, params, body, headers)
    if m == "PUT":
        return svc.put_with_headers(path, params, body, headers)
    if m == "PATCH":
        return svc.patch_with_headers(path, params, body, headers)
    if m == "DELETE":
        return svc.delete_with_headers(path, body, headers)
    from ..errors import BadRequest
    raise BadRequest(f"unsupported method {method!r}")
