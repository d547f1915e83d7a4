"""The port's error hierarchy (its own copy of the part of
gofr_tpu/errors.py that the App, the service clients and the gateway
raise or map). An error carries its
HTTP status: any handler may raise ``HTTPError`` (or a subclass) with an
explicit ``status_code``; the responder answers with it and with the
error's ``headers`` (a shed's ``Retry-After``), and an unexpected
exception becomes a 500 in the recovery middleware."""

from __future__ import annotations

import math


def format_retry_after(seconds: float) -> str:
    """Retry-After as delta-seconds (RFC 9110 §10.2.3): the ceiling, so
    a 90.4 s estimate never advises 90, and at least 1, because 0
    invites an instant retry storm."""
    return str(max(1, math.ceil(seconds)))


def parse_retry_after(value: str | None) -> float | None:
    """The Retry-After reader of the retry decorator, the gateway relay
    and the replica table: delta-seconds to a non-negative float;
    ``None`` for absent, garbage, or the HTTP-date form (callers fall
    back to their own backoff)."""
    try:
        return max(0.0, float(value)) if value else None
    except (TypeError, ValueError):
        return None


class GofrError(Exception):
    """Base class for all framework errors."""


class HTTPError(GofrError):
    """An error with an explicit HTTP status code."""

    status_code: int = 500

    def __init__(self, message: str = "", status_code: int | None = None):
        super().__init__(message or type(self).__name__)
        if status_code is not None:
            self.status_code = status_code
        self.message = message or type(self).__name__

    def to_dict(self) -> dict:
        return {"message": self.message}


class BadRequest(HTTPError):
    status_code = 400


class Unauthorized(HTTPError):
    status_code = 401


class Forbidden(HTTPError):
    status_code = 403


class NotFound(HTTPError):
    status_code = 404


class EntityNotFound(NotFound):
    """No entity of that name for that value -> 404."""

    def __init__(self, name: str = "entity", value: str = ""):
        super().__init__(f"No {name} found for value {value!r}")
        self.name = name
        self.value = value


class ProgramNotFound(NotFound, KeyError):
    """A predict call named a program the engine never registered: 404
    with the registered names, not the 500 a bare KeyError becomes. A
    KeyError still, so dict-style lookup-miss handling keeps working."""

    def __init__(self, program: str, registered: list[str] | None = None):
        known = f"; registered: {sorted(registered)}" if registered else ""
        super().__init__(f"no TPU program {program!r}{known}")
        self.program = program

    # KeyError.__str__ repr()s its message; the wire renders plain text
    __str__ = Exception.__str__


class InvalidParameter(BadRequest):
    def __init__(self, *params: str):
        super().__init__(f"Invalid parameter(s): {', '.join(params)}")
        self.params = params


class MissingParameter(BadRequest):
    def __init__(self, *params: str):
        super().__init__(f"Missing parameter(s): {', '.join(params)}")
        self.params = params


class ShardingConfigError(GofrError, ValueError):
    """A ``TPU_SHARDING`` configuration the engine refuses to serve
    with: raised when the engine is built, before any weights or
    request, naming the offending row (``sharding_row``) so the
    operator fixes the config line. A ValueError, so config-validation
    callers that catch ValueError keep working."""

    def __init__(self, message: str, sharding_row: str = ""):
        super().__init__(message)
        self.sharding_row = sharding_row


class InternalServerError(HTTPError):
    status_code = 500


class ServiceUnavailable(HTTPError):
    status_code = 503


class TooManyRequests(HTTPError):
    """Shed by an admission gate (resilience.AdmissionGate): the queue is
    over its bound, so the request fails fast instead of joining a line
    that would outlast its caller's budget. ``Retry-After`` carries the
    gate's wait estimate; ``reason`` (``X-Shed-Reason``) names a pressure
    other than the queue's (``hbm`` for device memory)."""

    status_code = 429

    def __init__(self, message: str = "", retry_after: float | None = None,
                 reason: str | None = None):
        super().__init__(message or "too many requests")
        self.retry_after = retry_after
        self.reason = reason
        self.headers: dict[str, str] = {}
        if retry_after is not None:
            self.headers["Retry-After"] = format_retry_after(retry_after)
        if reason:
            self.headers["X-Shed-Reason"] = reason


class DeadlineExceeded(HTTPError):
    """The caller's deadline expired before the work completed: before
    the request was queued, while it waited, or while it was being
    prefilled or decoded (the engine stopped its device work then)."""

    status_code = 504

    def __init__(self, message: str = "deadline exceeded"):
        super().__init__(message)


class ConnectionLost(HTTPError, EOFError):
    """A transport peer vanished mid-exchange: socket closed, GOAWAY,
    half-read frame. 502 on HTTP (the upstream died, not us). An
    EOFError too, so every ``except (EOFError, OSError)`` arm of the
    transports (wire, grpcx) catches it."""

    status_code = 502

    def __init__(self, message: str = "connection lost"):
        super().__init__(message)


class CircuitOpenError(ServiceUnavailable):
    """Raised by the client-side circuit breaker while it is open: the
    call fails at once instead of waiting on a peer known to be down."""

    def __init__(self, address: str = "") -> None:
        suffix = f" for {address}" if address else ""
        super().__init__(f"circuit breaker is open{suffix}")
        self.address = address


def status_from_error(err: BaseException | None) -> int:
    """Map an exception to an HTTP status: None is 200, an HTTPError its
    own status, anything else 500."""
    if err is None:
        return 200
    if isinstance(err, HTTPError):
        return err.status_code
    return 500
