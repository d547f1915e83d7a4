"""Client-side circuit breaker (the port's own copy of
gofr_tpu/service/circuit_breaker.py).

Reference: pkg/gofr/service/circuit_breaker.go —
  - two states Closed/Open (circuit_breaker.go:12-15)
  - consecutive-failure count reaching ``threshold`` opens the circuit
    (executeWithCircuitBreaker, :57-88)
  - while open: background ticker health-checks the target (:106-118) and
    an inline recovery probe is allowed once ``interval`` has elapsed
    (:149-156); a successful probe closes the circuit
  - wraps every verb (:171-269) — here via ServiceWrapper._do
"""

from __future__ import annotations

import threading
import time

from ..errors import CircuitOpenError
from .wrap import ServiceWrapper

CLOSED, OPEN = 0, 1

__all__ = ["CircuitBreaker", "CircuitBreakerOption", "CircuitOpenError"]


def _orderly_drain(resp) -> bool:
    """A 503 carrying Retry-After is the drain contract's readiness
    answer — a live peer asking for patience, not a dead one."""
    return (getattr(resp, "status_code", 0) == 503
            and hasattr(resp, "header")
            and bool(resp.header("Retry-After")))


class CircuitBreaker(ServiceWrapper):
    def __init__(self, inner, threshold: int = 5, interval: float = 10.0,
                 start_background_probe: bool = True):
        super().__init__(inner)
        self.threshold = max(1, threshold)
        self.interval = interval
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._last_probe = 0.0
        self._lock = threading.Lock()
        self._probe_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._start_background_probe = start_background_probe
        # the recovery probe's health source; a HealthOption applied later in
        # the chain re-points this at the custom endpoint (health.py)
        self.health_probe = lambda: self.inner.health_check()

    # -- state inspection ---------------------------------------------------
    @property
    def is_open(self) -> bool:
        with self._lock:
            return self._state == OPEN

    def _open(self) -> None:
        self._state = OPEN
        self._opened_at = time.monotonic()
        self._last_probe = 0.0
        if self._start_background_probe and (
                self._probe_thread is None or not self._probe_thread.is_alive()):
            self._stop.clear()
            self._probe_thread = threading.Thread(
                target=self._probe_loop, daemon=True,
                name=f"cb-probe-{getattr(self.inner, 'address', '')}")
            self._probe_thread.start()

    def _close_circuit(self) -> None:
        self._state = CLOSED
        self._failures = 0
        self._stop.set()

    # -- background recovery (reference :106-118) ----------------------------
    def _probe_loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                h = self.health_probe()
                healthy = getattr(h, "status", "DOWN") == "UP"
            except Exception:
                healthy = False
            if healthy:
                with self._lock:
                    self._close_circuit()
                return

    # -- the guarded call (reference :57-88, :149-156) -----------------------
    def _do(self, method, path, params, body, headers):
        with self._lock:
            if self._state == OPEN:
                now = time.monotonic()
                # inline recovery probe: let one real request through once
                # `interval` has elapsed since opening / the last probe
                ref = max(self._opened_at, self._last_probe)
                if now - ref < self.interval:
                    raise CircuitOpenError(getattr(self.inner, "address", ""))
                self._last_probe = now
        try:
            resp = super()._do(method, path, params, body, headers)
        except Exception:
            self._record_failure()
            raise
        status = getattr(resp, "status_code", 0)
        if status >= 500 and not _orderly_drain(resp):
            self._record_failure()
        else:
            # 2xx-4xx — or a 503 WITH Retry-After: the framework's
            # drain answer (App.stop readiness flip, resilience.md).
            # The peer is alive and told us when to come back; the
            # breaker's job is failing fast against a DEAD peer, so an
            # orderly drain longer than threshold x poll-interval must
            # not reclassify it as down (the gateway's replica table
            # polls through this breaker every second of a rolling
            # restart)
            with self._lock:
                if self._state == OPEN:
                    self._close_circuit()
                self._failures = 0
        return resp

    def _record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._failures >= self.threshold and self._state == CLOSED:
                self._open()

    def close(self) -> None:
        self._stop.set()
        super().close()


class CircuitBreakerOption:
    """reference CircuitBreakerConfig (circuit_breaker.go:24-27) applied via
    Options.addOption (options.go:3)."""

    def __init__(self, threshold: int = 5, interval: float = 10.0,
                 start_background_probe: bool = True):
        self.threshold = threshold
        self.interval = interval
        self.start_background_probe = start_background_probe

    def add_option(self, svc):
        return CircuitBreaker(svc, self.threshold, self.interval,
                              self.start_background_probe)
