"""The errors the port's admission gate and generation engine raise to a
caller (counterpart of the part of gofr_tpu/errors.py they use): a shed
(429 with ``Retry-After``) and an expired deadline (504). Each carries
its HTTP ``status_code``, and a shed its response ``headers``."""

from __future__ import annotations

import math


def format_retry_after(seconds: float) -> str:
    """Retry-After as delta-seconds (RFC 9110 §10.2.3): the ceiling, so
    a 90.4 s estimate never advises 90, and at least 1, because 0
    invites an instant retry storm."""
    return str(max(1, math.ceil(seconds)))


class HTTPError(Exception):
    """An error with an HTTP status code."""

    status_code: int = 500

    def __init__(self, message: str = ""):
        super().__init__(message or type(self).__name__)
        self.message = message or type(self).__name__

    def to_dict(self) -> dict:
        return {"message": self.message}


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
