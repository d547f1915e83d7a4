"""Lazy-connect reconnect backoff: the one client-side convention (the
port's own copy of gofr_tpu/service/reconnect.py).

Every client that holds a connection to a peer it must reconnect to
on loss -- in the port, the gateway's replica relays (gateway/) --
needs the same three rules:

  1. a failed connect arms a backoff window; attempts inside the
     window fail fast WITHOUT touching the socket (a down peer must
     cost one connect per window, not one per request);
  2. consecutive failures double the window up to a cap (full
     recovery pressure decays exponentially);
  3. a configuration-class failure (refused handshake, wrong service)
     holds at the cap immediately -- retrying faster cannot fix a
     wrong deploy.

It tracks state only -- callers own the socket and the typed error
they raise; ``blocked()``'s return value is the honest ``Retry-After``
for that error.

Thread model: every method takes the internal lock, so one instance
may be shared by a connect path and a reader-thread loss path without
external locking.
"""

from __future__ import annotations

import threading
import time

__all__ = ["ReconnectBackoff"]


class ReconnectBackoff:
    #: first failure's window (seconds) unless overridden
    BASE_S = 0.5
    #: ceiling the doubling stops at; also the config-error hold
    CAP_S = 15.0

    def __init__(self, base_s: float | None = None,
                 cap_s: float | None = None, clock=time.monotonic):
        self.base_s = float(self.BASE_S if base_s is None else base_s)
        self.cap_s = float(self.CAP_S if cap_s is None else cap_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._delay = self.base_s
        self._until = 0.0

    # -- state reads ----------------------------------------------------------
    @property
    def delay(self) -> float:
        """The window the NEXT failure will arm — the honest
        ``Retry-After`` for a typed error raised while this path is
        failing (the peer won't be re-probed sooner)."""
        with self._lock:
            return self._delay

    def blocked(self) -> float:
        """Seconds left in the current backoff window; 0.0 means an
        attempt may proceed (callers raise their typed unavailable
        error with the returned value as ``retry_after``)."""
        with self._lock:
            return max(0.0, self._until - self._clock())

    def retry_after(self) -> float:
        """The honest ``Retry-After`` for an error raised NOW: the
        remaining ARMED window if one is armed (the peer won't be
        re-probed sooner), else the base window. NOT ``delay`` — that
        is the already-doubled next window, and advertising it would
        systematically tell clients to wait twice as long as the
        actual re-probe point."""
        with self._lock:
            return max(0.0, self._until - self._clock()) or self.base_s

    # -- state transitions ----------------------------------------------------
    def failure(self) -> float:
        """A connect/hold attempt failed: arm the current window,
        double the next one (up to the cap), and return the armed
        window — the ``retry_after`` this failure should advertise."""
        with self._lock:
            armed = self._delay
            self._until = self._clock() + armed
            self._delay = min(self._delay * 2, self.cap_s)
            return armed

    def hold(self, seconds: float | None = None) -> float:
        """Arm a FIXED window (default: the cap) without consuming the
        doubling ladder — the configuration-error class (refused
        handshake, wrong weights behind the address): backing off
        faster cannot fix it, so park at the long window at once."""
        armed = self.cap_s if seconds is None else float(seconds)
        with self._lock:
            self._until = self._clock() + armed
            return armed

    def success(self) -> None:
        """Connected (or the peer answered): clear the window, reset
        the ladder to the base."""
        with self._lock:
            self._delay = self.base_s
            self._until = 0.0

    # alias so call sites read as intent ("reset after manual repoint")
    reset = success

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (f"ReconnectBackoff(delay={self.delay:.3f}s, "
                f"blocked={self.blocked():.3f}s)")
