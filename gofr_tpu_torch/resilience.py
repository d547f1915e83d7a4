"""Serving policies of the port (counterpart of gofr_tpu/resilience.py):
deadlines, SLO classes, the admission gate with its brownout band, and
the decode pipeline's depth policy.

  - ``Deadline``: one absolute expiry on the monotonic clock, carried
    from the wire (``X-Request-Timeout``, ``parse_http_timeout``) to
    the engine, which refuses an expired request before queueing it and
    stops the device work of one that expires while queued, prefilled
    or decoded. ``deadline_scope`` makes one ambient for a handler
    thread; ``generate`` reads it when it is given none.
  - SLO classes: ``latency`` (interactive, the default) and
    ``throughput`` (batch, tagged explicitly). The class rides the same
    thread-local channel as the deadline (``slo_scope``), and overload
    degrades the classes in order: the gate sheds and browns out
    throughput at a fraction of the latency bounds.
  - ``AdmissionGate``: a bounded gate in front of the engine's pending
    line. Past its queue depth, or past its wait estimate, it fails the
    excess fast (``TooManyRequests``, 429 with ``Retry-After``); between
    healthy and shedding, ``cap_tokens`` caps ``max_new_tokens``.

The ambient deadline and class are ``threading.local``; the gate's wait
estimate is guarded by one small lock and touched only at admission."""

from __future__ import annotations

import contextlib
import threading
import time

from .errors import DeadlineExceeded, TooManyRequests

__all__ = [
    "AdmissionGate",
    "Deadline",
    "DeadlineExceeded",
    "DecodePipelinePolicy",
    "SLO_CLASSES",
    "SLO_LATENCY",
    "SLO_THROUGHPUT",
    "TooManyRequests",
    "current_deadline",
    "current_slo_class",
    "deadline_scope",
    "gate_from_config",
    "parse_http_timeout",
    "parse_slo_class",
    "slo_scope",
]


class Deadline:
    """An absolute expiry on the monotonic clock, built once at the edge
    and carried by reference: every layer asks the same object, so the
    budget shrinks as work progresses (it covers the whole request, not
    each hop)."""

    __slots__ = ("at",)

    def __init__(self, at: float):
        self.at = float(at)

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + float(seconds))

    def remaining(self) -> float:
        """Seconds left; <= 0 once expired."""
        return self.at - time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() >= self.at

    def budget(self, timeout: float | None) -> float:
        """Tighten a layer's own timeout to what the deadline allows."""
        rem = self.remaining()
        return rem if timeout is None else min(timeout, rem)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Deadline(in {self.remaining() * 1e3:.1f}ms)"


_scope = threading.local()


def current_deadline() -> Deadline | None:
    """The ambient deadline of the calling thread (None outside any
    scope)."""
    return getattr(_scope, "deadline", None)


@contextlib.contextmanager
def deadline_scope(deadline: Deadline | None):
    """Make ``deadline`` ambient for the calling thread. Nested scopes
    keep the tighter deadline (a sub-deadline may shrink the budget,
    never extend the caller's)."""
    prev = getattr(_scope, "deadline", None)
    if deadline is not None and prev is not None and prev.at < deadline.at:
        deadline = prev
    _scope.deadline = deadline if deadline is not None else prev
    try:
        yield deadline
    finally:
        _scope.deadline = prev


class DecodePipelinePolicy:
    """Depth policy for the generator's decode dispatch pipeline.

    ``depth`` is the configured ceiling (TPU_DECODE_PIPELINE): how many
    fused decode blocks may be in flight on the device stream at once.
    Depth 2 is the steady-state win -- the host reaps block N while
    block N+1 computes, so the device never idles between blocks -- but
    a deeper queue also means anything dispatched NEXT (a latency-class
    admission's prefill, a chunk-lattice slice) waits behind more queued
    compute. ``target()`` is consulted before every pipeline top-up and
    collapses to 1 exactly when that wait would cost an SLO:

      - a latency-class request is waiting for admission (its prefill
        must queue behind at most ONE in-flight block);
      - a chunk-lattice admission was deferred by the in-flight pass
        (the lattice needs a fully reaped loop);
      - speculative decoding is active (verify windows are built from
        host-delivered history, which only exists after a reap).

    Pure and lock-free: callers pass the facts, the policy returns a
    depth."""

    __slots__ = ("depth",)

    def __init__(self, depth: int = 2):
        self.depth = max(1, int(depth))

    def target(self, *, latency_waiting: bool = False,
               lattice_deferred: bool = False,
               spec_decode: bool = False) -> int:
        if latency_waiting or lattice_deferred or spec_decode:
            return 1
        return self.depth


# -- SLO classes ------------------------------------------------------------
# Two classes, not N priorities: a latency SLO for interactive traffic and
# a drain guarantee for batch traffic.
SLO_LATENCY = "latency"
SLO_THROUGHPUT = "throughput"
SLO_CLASSES = (SLO_LATENCY, SLO_THROUGHPUT)

_THROUGHPUT_ALIASES = frozenset({"throughput", "batch", "bulk", "offline",
                                 "best-effort", "besteffort"})


def parse_slo_class(val: str | None) -> str:
    """``X-SLO-Class`` header -> class. Unknown or absent values are
    latency: opting into deprioritization must be explicit (a typo in a
    batch job's header costs capacity, never an interactive user's
    latency)."""
    if not val:
        return SLO_LATENCY
    return (SLO_THROUGHPUT if val.strip().lower() in _THROUGHPUT_ALIASES
            else SLO_LATENCY)


def current_slo_class() -> str:
    """The ambient SLO class of the calling thread (latency outside any
    scope)."""
    return getattr(_scope, "slo_class", None) or SLO_LATENCY


@contextlib.contextmanager
def slo_scope(slo_class: str | None):
    """Make ``slo_class`` ambient for the calling thread. None keeps the
    enclosing scope's class; a nested explicit class wins."""
    prev = getattr(_scope, "slo_class", None)
    _scope.slo_class = slo_class if slo_class is not None \
        else (prev or SLO_LATENCY)
    try:
        yield _scope.slo_class
    finally:
        _scope.slo_class = prev


_HTTP_TIMEOUT_UNITS = (("ms", 1e-3), ("us", 1e-6), ("s", 1.0), ("m", 60.0))


def parse_http_timeout(val: str | None) -> float | None:
    """``X-Request-Timeout`` header -> seconds: a bare float (seconds)
    or a unit suffix (``50ms``, ``2s``, ``250us``, ``1m``). Malformed
    or non-positive values read as None: a bad client header never
    fails the request itself."""
    if not val:
        return None
    val = val.strip().lower()
    scale = 1.0
    for suffix, s in _HTTP_TIMEOUT_UNITS:
        if val.endswith(suffix):
            val, scale = val[: -len(suffix)], s
            break
    try:
        seconds = float(val) * scale
    except ValueError:
        return None
    return seconds if seconds > 0 else None


class AdmissionGate:
    """Bounded admission with early shedding and a brownout band.

    One gate fronts one queue (the generation engine's pending line).
    ``admit(depth)`` raises ``TooManyRequests`` when either bound is
    crossed:

      - ``max_queue_depth``: this many waiters already queued;
      - ``max_queue_delay``: the EWMA of observed queue waits exceeds
        it (every request is already slow, which depth alone misses
        when service time varies).

    The engine feeds the estimate (``note_wait``) with each admission's
    queue wait, and a shed's ``Retry-After`` is that estimate.

    Brownout: with ``brownout_delay`` set, ``cap_tokens`` caps
    ``max_new_tokens`` while the estimate sits above it -- shorter
    answers instead of shed streams.

    Throughput-class requests see every bound scaled by
    ``throughput_factor`` (default 0.5), so batch traffic sheds and
    browns out first; 1.0 is class-blind gating. Both bounds 0: the
    gate admits everything."""

    # EWMA smoothing of the observed wait: heavy enough to ride out one
    # odd admission, light enough to follow a load swing within a few
    ALPHA = 0.3

    def __init__(self, max_queue_depth: int = 0, max_queue_delay: float = 0.0,
                 brownout_delay: float = 0.0, brownout_max_new: int = 32,
                 throughput_factor: float = 0.5, name: str = "",
                 metrics=None, logger=None):
        self.max_queue_depth = int(max_queue_depth)
        self.max_queue_delay = float(max_queue_delay)
        self.brownout_delay = float(brownout_delay)
        self.brownout_max_new = int(brownout_max_new)
        # clamped to (0, 1]: 0 would shed all throughput traffic even at
        # idle, > 1 would invert the degradation order
        self.throughput_factor = min(1.0, max(0.01, float(throughput_factor)))
        self.name = name
        self.metrics = metrics
        self.logger = logger
        self.enabled = self.max_queue_depth > 0 or self.max_queue_delay > 0
        self._lock = threading.Lock()
        self._wait_ewma = 0.0
        # per-class brownout band state, logged and gauged on each edge
        self._brownout_on = {c: False for c in SLO_CLASSES}
        self.sheds = 0
        self.sheds_by_class = {c: 0 for c in SLO_CLASSES}
        self.brownout_capped = 0

    def clone(self, name: str) -> "AdmissionGate":
        """A fresh gate with the same bounds and telemetry but its OWN
        state: one gate fronts one queue, so an engine with several
        predict programs clones its configured gate per program (a
        shared wait estimate would let a backlogged program shed a
        healthy one's traffic)."""
        return AdmissionGate(
            max_queue_depth=self.max_queue_depth,
            max_queue_delay=self.max_queue_delay,
            brownout_delay=self.brownout_delay,
            brownout_max_new=self.brownout_max_new,
            throughput_factor=self.throughput_factor,
            name=name, metrics=self.metrics, logger=self.logger)

    # -- dispatcher side ------------------------------------------------------
    def note_wait(self, wait_s: float) -> None:
        """Feed one observed queue wait (seconds) into the estimate."""
        with self._lock:
            self._wait_ewma += self.ALPHA * (wait_s - self._wait_ewma)

    @property
    def estimated_wait(self) -> float:
        return self._wait_ewma

    # -- admission side -------------------------------------------------------
    def admit(self, depth: int, program: str = "",
              slo_class: str = SLO_LATENCY, tenant: str = "") -> None:
        """Admit or raise ``TooManyRequests``. ``depth``: the queue's
        current depth, read lock-free by the caller (a race moves the
        shed boundary by that much). Throughput-class requests are held
        to bounds scaled by ``throughput_factor``. ``tenant`` only
        labels the shed's telemetry (the engines pass it when a tenancy
        plane is installed); the pressure bounds stay tenant-blind."""
        if not self.enabled:
            return
        f = (self.throughput_factor if slo_class == SLO_THROUGHPUT else 1.0)
        wait = self._wait_ewma
        over_depth = (self.max_queue_depth > 0
                      and depth >= max(1, int(self.max_queue_depth * f)))
        over_delay = (self.max_queue_delay > 0 and depth > 0
                      and wait > self.max_queue_delay * f)
        if not (over_depth or over_delay):
            return
        self._record_shed(program, slo_class, tenant=tenant)
        # the current wait estimate, floored so that an early shed does
        # not invite an instant retry storm
        raise TooManyRequests(
            f"{self.name or 'admission'}: queue depth {depth}, "
            f"estimated wait {wait * 1e3:.0f}ms — shed ({slo_class})",
            retry_after=max(0.05, wait))

    def admit_tenant(self, spec, quotas, program: str = "",
                     slo_class: str = SLO_LATENCY) -> None:
        """Per-tenant quota admission (the rps token bucket and the
        concurrency bound of ``quotas``, a ``tenancy.QuotaBook``)
        through the gate's one shed-bookkeeping path. Over quota raises
        ``TooManyRequests`` with ``reason`` ``tenant_quota``: a 429 for
        this tenant while everyone else keeps flowing. On success the
        quota is consumed; the caller releases the concurrency slot at
        the request's terminal (``quotas.release(tenant_id)``)."""
        why, retry_after = quotas.check(spec)
        if why is None:
            return
        tid = spec.tenant_id
        self._record_shed(program, slo_class, tenant=tid)
        raise TooManyRequests(
            f"{self.name or 'admission'}: tenant {tid!r} over {why} "
            f"quota — shed ({slo_class})",
            retry_after=max(0.05, retry_after), reason="tenant_quota")

    def _record_shed(self, program: str, slo_class: str,
                     trace_id: str = "", tenant: str = "") -> None:
        """The one shed-bookkeeping path (queue, memory and tenant-quota
        pressure): the counters and ``app_tpu_shed_total``, exemplar'd
        by ``trace_id`` when the caller knows the request's trace. The
        ``tenant`` label appears only on engines with a tenancy plane:
        without one the series' labels are the ones they always were."""
        self.sheds += 1
        if slo_class in self.sheds_by_class:
            self.sheds_by_class[slo_class] += 1
        if self.metrics is not None:
            try:
                labels = {"program": program or self.name,
                          "slo_class": slo_class}
                if tenant:
                    labels["tenant"] = tenant
                self.metrics.increment_counter(
                    "app_tpu_shed_total", exemplar=trace_id or None,
                    **labels)
            except Exception:  # noqa: BLE001 — telemetry never sheds twice
                pass

    def shed_memory(self, program: str = "", slo_class: str = SLO_LATENCY,
                    retry_after: float = 1.0,
                    trace_id: str = "") -> TooManyRequests:
        """A device-memory shortage through the gate's shed surface: the
        same counters and 429 + ``Retry-After`` as a queue shed, with
        ``reason`` ``hbm``. Returns the error; the caller raises it or
        delivers it into a stream that already exists."""
        self._record_shed(program, slo_class, trace_id=trace_id)
        return TooManyRequests(
            f"{self.name or 'admission'}: device memory exhausted — "
            f"shed ({slo_class})", retry_after=max(0.05, retry_after),
            reason="hbm")

    def cap_tokens(self, max_new_tokens: int,
                   slo_class: str = SLO_LATENCY) -> int:
        """Brownout: cap a request's token budget while the wait estimate
        sits above ``brownout_delay`` (``brownout_delay *
        throughput_factor`` for throughput-class requests)."""
        if self.brownout_delay <= 0:
            return max_new_tokens
        active = self._refresh_brownout(self._wait_ewma)[slo_class]
        if not active or max_new_tokens <= self.brownout_max_new:
            return max_new_tokens
        self.brownout_capped += 1
        if self.metrics is not None:
            try:
                self.metrics.increment_counter("app_tpu_brownout_capped_total",
                                               slo_class=slo_class)
            except Exception:  # noqa: BLE001 — telemetry only
                pass
        return self.brownout_max_new

    def _band_threshold(self, slo_class: str) -> float:
        return self.brownout_delay * (
            self.throughput_factor if slo_class == SLO_THROUGHPUT else 1.0)

    def _refresh_brownout(self, wait: float) -> dict:
        """Every class's band state from the current estimate, so that a
        class whose traffic vanished still clears once the estimate
        recovers; the gauge and the log follow each edge."""
        states = {c: wait > self._band_threshold(c) for c in SLO_CLASSES}
        if states != self._brownout_on:
            with self._lock:
                changed = {c: a for c, a in states.items()
                           if a != self._brownout_on.get(c, False)}
                if changed:
                    self._brownout_on = states
                    self._note_brownout(changed, states, wait)
        return states

    def _note_brownout(self, changed: dict, states: dict,
                       wait: float) -> None:
        for cls, active in changed.items():
            if self.metrics is not None:
                try:
                    self.metrics.set_gauge("app_tpu_brownout_active",
                                           1.0 if active else 0.0,
                                           slo_class=cls)
                except Exception:  # noqa: BLE001 — telemetry only
                    pass
            if self.logger is not None:
                self.logger.warn({
                    "event": "brownout " + ("entered" if active
                                            else "cleared"),
                    "gate": self.name, "slo_class": cls,
                    "wait_ewma_ms": round(wait * 1e3, 1)})
        if self.metrics is not None:
            try:  # the unlabeled any-class series
                self.metrics.set_gauge("app_tpu_brownout_active",
                                       1.0 if any(states.values()) else 0.0)
            except Exception:  # noqa: BLE001 — telemetry only
                pass

    def stats(self) -> dict:
        # brownout_active derives from the live estimate, not the edge
        # flags: it reads False after recovery even if no request has
        # touched cap_tokens since
        wait = self._wait_ewma
        active = (self.brownout_delay > 0
                  and any(wait > self._band_threshold(c)
                          for c in SLO_CLASSES))
        return {
            "enabled": self.enabled,
            "max_queue_depth": self.max_queue_depth,
            "max_queue_delay": self.max_queue_delay,
            "throughput_factor": self.throughput_factor,
            "wait_ewma_ms": round(wait * 1e3, 3),
            "sheds": self.sheds,
            "sheds_by_class": dict(self.sheds_by_class),
            "brownout_active": active,
            "brownout_capped": self.brownout_capped,
        }


def gate_from_config(cfg, name: str, metrics=None,
                     logger=None) -> AdmissionGate | None:
    """A gate from ``TPU_MAX_QUEUE_DEPTH``, ``TPU_MAX_QUEUE_DELAY``,
    ``TPU_BROWNOUT_DELAY``, ``TPU_BROWNOUT_MAX_NEW`` and
    ``TPU_SLO_THROUGHPUT_FACTOR``; every bound defaults off (load
    shedding is a capacity-planning decision). None when all are off."""
    depth = cfg.get_int("TPU_MAX_QUEUE_DEPTH", 0)
    delay = cfg.get_float("TPU_MAX_QUEUE_DELAY", 0.0)
    b_delay = cfg.get_float("TPU_BROWNOUT_DELAY", 0.0)
    if depth <= 0 and delay <= 0 and b_delay <= 0:
        return None
    return AdmissionGate(
        max_queue_depth=depth, max_queue_delay=delay,
        brownout_delay=b_delay,
        brownout_max_new=cfg.get_int("TPU_BROWNOUT_MAX_NEW", 32),
        throughput_factor=cfg.get_float("TPU_SLO_THROUGHPUT_FACTOR", 0.5),
        name=name, metrics=metrics, logger=logger)
