"""Retry-with-backoff decorator for the outbound HTTP service client (the
port's own copy of gofr_tpu/service/retry.py).

No reference equivalent (the reference's resilience decorator is the
circuit breaker only). Policy follows the AWS-style "full jitter"
discipline: attempt ``i`` sleeps ``U[0, min(max_delay, base * 2**i))``,
which decorrelates a thundering herd better than equal-jitter or
fixed-exponential; a server-supplied ``Retry-After`` (shed/drain
backpressure from resilience.AdmissionGate or a draining peer) OVERRIDES
the computed backoff — the server knows its queue better than we do —
bounded only by ``retry_after_cap`` (default 30 s, so a buggy header
can't park the caller) and the caller's ambient deadline.

What retries:
  - connection errors and timeouts, for IDEMPOTENT methods only by
    default (GET/HEAD/PUT/DELETE/OPTIONS — RFC 9110 §9.2.2; a POST that
    died mid-flight may have committed);
  - retryable statuses (default 429/502/503/504) for idempotent methods
    (``retry_non_idempotent=True`` opts POSTs in when the caller knows
    the endpoint is safe to replay).

Composition with the circuit breaker: order the options so the breaker
wraps the retrier —

    new_http_service(addr, log, metrics,
                     RetryOption(max_attempts=3),
                     CircuitBreakerOption(threshold=5))

options apply inside-out, so the LAST option is the OUTERMOST wrapper.
With the breaker outside, one logical call counts as ONE breaker
failure no matter how many attempts the retrier burned (N quick
failures must not slam the breaker open N times as fast), and while the
circuit is open ``CircuitOpenError`` fires before any attempt is made.
If the retrier ends up outside a breaker anyway, it refuses to retry
``CircuitOpenError`` — hammering an open circuit defeats both.

The ambient request deadline (resilience.current_deadline) is honored:
no retry starts if its backoff sleep would outlive the caller's budget.
"""

from __future__ import annotations

import random
import time

from ..errors import CircuitOpenError, parse_retry_after
from ..resilience import current_deadline
from .wrap import ServiceWrapper

IDEMPOTENT_METHODS = frozenset({"GET", "HEAD", "PUT", "DELETE", "OPTIONS"})
DEFAULT_RETRY_STATUSES = (429, 502, 503, 504)


class Retry(ServiceWrapper):
    #: ceiling on a server-supplied Retry-After (seconds): the hint is
    #: honored past max_delay — the server knows its queue — but bounded
    #: so a buggy/hostile header can't park the caller indefinitely
    RETRY_AFTER_CAP = 30.0

    def __init__(self, inner, max_attempts: int = 3, base_delay: float = 0.1,
                 max_delay: float = 2.0,
                 retry_statuses=DEFAULT_RETRY_STATUSES,
                 retry_non_idempotent: bool = False,
                 rng: random.Random | None = None, sleep=time.sleep,
                 retry_after_cap: float | None = None):
        super().__init__(inner)
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.retry_after_cap = (self.RETRY_AFTER_CAP if retry_after_cap is None
                                else float(retry_after_cap))
        self.retry_statuses = frozenset(int(s) for s in retry_statuses)
        self.retry_non_idempotent = retry_non_idempotent
        # injectable rng/sleep: deterministic jitter under test/chaos
        self._rng = rng or random.Random()
        self._sleep = sleep
        self.retries = 0  # attempts beyond the first, across all calls

    def _may_retry(self, method: str) -> bool:
        return (method.upper() in IDEMPOTENT_METHODS
                or self.retry_non_idempotent)

    def _backoff(self, attempt: int, retry_after: float | None) -> float:
        if retry_after is not None:
            # the server's hint beats the computed backoff, even past
            # max_delay (a draining peer saying "30" means 30) — bounded
            # only by retry_after_cap and the caller's ambient deadline
            return min(retry_after, self.retry_after_cap)
        cap = min(self.max_delay, self.base_delay * (2 ** attempt))
        return self._rng.uniform(0.0, cap)  # full jitter

    def _pause(self, delay: float) -> bool:
        """Sleep before the next attempt — unless it would outlive the
        caller's ambient deadline (then stop retrying: the caller will
        time out before the retry could answer). The deadline caps the
        CUMULATIVE retry loop, not just this sleep: the ambient
        ``Deadline`` is absolute, so each pass re-reads the shrinking
        budget (attempt time included — the transport tightens its own
        socket timeout to the same budget, client.py ``_do``), and the
        loop can never outlive the caller by more than one bounded
        attempt."""
        dl = current_deadline()
        if dl is not None and dl.remaining() <= delay:
            return False
        if delay > 0:
            self._sleep(delay)
        return True

    @staticmethod
    def _retry_after(resp) -> float | None:
        val = resp.header("Retry-After") if hasattr(resp, "header") else ""
        return parse_retry_after(val)

    def _do(self, method, path, params, body, headers):
        last_exc: BaseException | None = None
        resp = None
        for attempt in range(self.max_attempts):
            if attempt > 0:
                self.retries += 1
            try:
                resp = super()._do(method, path, params, body, headers)
            except CircuitOpenError:
                raise  # never hammer an open circuit (see module doc)
            except Exception as e:  # noqa: BLE001 — transport failures
                last_exc = e
                if (attempt + 1 >= self.max_attempts
                        or not self._may_retry(method)
                        or not self._pause(self._backoff(attempt, None))):
                    raise
                continue
            status = getattr(resp, "status_code", 0)
            if (status in self.retry_statuses
                    and self._may_retry(method)
                    and attempt + 1 < self.max_attempts
                    and self._pause(
                        self._backoff(attempt, self._retry_after(resp)))):
                continue
            return resp
        if last_exc is not None:  # pragma: no cover - loop always returns/raises
            raise last_exc
        return resp


class RetryOption:
    """Applied via new_http_service(...) like every other option. Place
    it BEFORE CircuitBreakerOption in the argument list so the breaker
    ends up outermost (options wrap inside-out)."""

    def __init__(self, max_attempts: int = 3, base_delay: float = 0.1,
                 max_delay: float = 2.0,
                 retry_statuses=DEFAULT_RETRY_STATUSES,
                 retry_non_idempotent: bool = False,
                 rng: random.Random | None = None,
                 retry_after_cap: float | None = None):
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.retry_statuses = retry_statuses
        self.retry_non_idempotent = retry_non_idempotent
        self.rng = rng
        self.retry_after_cap = retry_after_cap

    def add_option(self, svc):
        return Retry(svc, self.max_attempts, self.base_delay, self.max_delay,
                     retry_statuses=self.retry_statuses,
                     retry_non_idempotent=self.retry_non_idempotent,
                     rng=self.rng, retry_after_cap=self.retry_after_cap)
