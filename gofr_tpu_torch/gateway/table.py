"""Replica table: health, drain, and memory-pressure state per replica
(the port's own copy of gofr_tpu/gateway/table.py).

The gateway's view of the cluster is this table. Each replica carries:

  - a ``service/`` client (circuit breaker wrapped) used for health
    polling — the SAME breaker discipline every inter-service call in
    the framework uses, so a dead replica costs microseconds, not
    connect timeouts;
  - a :class:`~gofr_tpu_torch.service.reconnect.ReconnectBackoff` gating
    relay re-probes of a down replica (one real connect per backoff
    window — traffic itself is the recovery probe between health
    polls, and a down fleet never gets hammered);
  - drain state: a 503 from the replica (its ``drain_middleware``
    answering, or its health endpoint once readiness flips) marks it
    draining until the advertised ``Retry-After`` — the gateway stops
    routing NEW requests there the moment readiness drops, while
    streams already relaying finish on the old process (zero-loss
    rolling drain);
  - a decaying **memory-pressure score** fed by typed sheds: a 429
    with ``X-Shed-Reason: hbm`` scores a full point and holds the
    replica's ``Retry-After`` window; a plain queue shed scores a
    quarter point. The router reads the score to drain cache-heavy
    (long-prefix) traffic off a memory-pressured replica FIRST —
    short requests still land (they cost little KV), so pressure
    relief is graded, never a cliff.

Scores decay exponentially (half-life ``PRESSURE_HALF_LIFE_S``): a
replica that stops shedding earns its traffic back without any reset
call, on the same curve everywhere.
"""

from __future__ import annotations

import threading
import time

from ..errors import parse_retry_after
from ..service import (CircuitBreaker, CircuitBreakerOption, HealthOption,
                       ReconnectBackoff, new_http_service)

__all__ = ["Replica", "ReplicaTable",
           "PRESSURE_HBM", "PRESSURE_QUEUE", "PRESSURE_HALF_LIFE_S"]

#: score added per memory-typed shed (429 + X-Shed-Reason: hbm)
PRESSURE_HBM = 1.0
#: score added per plain queue shed (429 without a memory reason)
PRESSURE_QUEUE = 0.25
#: exponential decay half-life of the pressure score, seconds
PRESSURE_HALF_LIFE_S = 10.0

#: drain window assumed when a 503 carries no Retry-After
DEFAULT_DRAIN_S = 5.0

STATE_READY = "ready"
STATE_DRAINING = "draining"
STATE_DOWN = "down"


class Replica:
    """One serving replica's routing state. Mutators are called from
    handler threads (relay outcomes) AND the health-poll thread; every
    mutable field sits behind ``_lock``."""

    def __init__(self, idx: int, address: str, client, *,
                 clock=time.monotonic):
        self.idx = int(idx)
        self.address = address  # "host:port"
        host, _, port = address.rpartition(":")
        self.host = host
        self.port = int(port)
        self.client = client
        self.reconnect = ReconnectBackoff()
        self._clock = clock
        self._lock = threading.Lock()
        # optimistic start: the first poll (or first relay) corrects —
        # a gateway must route before its first health sweep completes
        self._healthy = True
        self._drain_until = 0.0
        self._hold_until = 0.0  # hbm Retry-After window
        self._pressure = 0.0
        self._pressure_ts = clock()
        self.inflight = 0
        self.relayed = 0
        self.sheds_hbm = 0
        self.sheds_queue = 0
        self.losses = 0

    # -- derived state --------------------------------------------------------
    @property
    def breaker_open(self) -> bool:
        layer = self.client
        while layer is not None:
            if isinstance(layer, CircuitBreaker):
                return layer.is_open
            layer = getattr(layer, "inner", None)
        return False

    def draining(self) -> bool:
        with self._lock:
            return self._clock() < self._drain_until

    def hbm_hold(self) -> bool:
        """Inside a memory-shed Retry-After window: the replica TOLD us
        when to come back with cache-heavy work — routing long-prefix
        traffic at it sooner is hammering, not balancing."""
        with self._lock:
            return self._clock() < self._hold_until

    def pressure(self) -> float:
        with self._lock:
            return self._decayed_locked()

    def _decayed_locked(self) -> float:
        dt = self._clock() - self._pressure_ts
        if dt > 0 and self._pressure > 0:
            self._pressure *= 0.5 ** (dt / PRESSURE_HALF_LIFE_S)
            self._pressure_ts += dt
        return self._pressure

    def routable(self) -> bool:
        """May NEW requests be routed here right now?"""
        with self._lock:
            healthy = self._healthy
            draining = self._clock() < self._drain_until
        return healthy and not draining and not self.breaker_open

    def probeable(self) -> bool:
        """A down replica out of its reconnect-backoff window: real
        traffic may re-probe it (lazy recovery between health polls)."""
        return not self.routable() and not self.draining() \
            and self.reconnect.blocked() == 0.0

    def state(self) -> str:
        if self.draining():
            return STATE_DRAINING
        if self.routable():
            return STATE_READY
        return STATE_DOWN

    # -- transitions ----------------------------------------------------------
    def note_shed(self, reason: str, retry_after: float | None) -> None:
        with self._lock:
            self._decayed_locked()
            if reason == "hbm":
                self.sheds_hbm += 1
                self._pressure += PRESSURE_HBM
                self._hold_until = max(
                    self._hold_until,
                    self._clock() + (retry_after or 1.0))
            else:
                self.sheds_queue += 1
                self._pressure += PRESSURE_QUEUE

    def mark_drain(self, retry_after: float | None = None) -> None:
        with self._lock:
            self._drain_until = self._clock() + (retry_after
                                                 or DEFAULT_DRAIN_S)

    def mark_down(self) -> None:
        with self._lock:
            self._healthy = False
            self.losses += 1
        self.reconnect.failure()

    def mark_up(self) -> None:
        with self._lock:
            self._healthy = True
            self._drain_until = 0.0
        self.reconnect.success()

    def retry_after_hint(self) -> float:
        """How soon is it worth trying THIS replica again — the honest
        component of a gateway-level 503's Retry-After."""
        with self._lock:
            drain = max(0.0, self._drain_until - self._clock())
        return max(drain, self.reconnect.blocked()) or 1.0

    def stats(self) -> dict:
        return {"address": self.address, "state": self.state(),
                "pressure": round(self.pressure(), 4),
                "hbm_hold": self.hbm_hold(),
                "breaker_open": self.breaker_open,
                "inflight": self.inflight, "relayed": self.relayed,
                "sheds_hbm": self.sheds_hbm,
                "sheds_queue": self.sheds_queue, "losses": self.losses}


class ReplicaTable:
    """The replica set + its background health poller.

    Health polling goes through the ``service/`` client chain (breaker
    + custom health endpoint), reading the replica's
    ``/.well-known/health``:

      - 2xx            -> up (clears down AND drain state)
      - 503            -> draining for the advertised Retry-After (the
                          ``drain_middleware`` readiness contract)
      - anything else / transport error / open breaker -> down

    Relay outcomes update the same state inline (a drain 503 or a
    connection loss re-routes the NEXT pick immediately); the poller
    is the recovery path and the steady-state confirmation.
    """

    def __init__(self, addresses: list[str], *, logger=None, metrics=None,
                 tracer=None, observe=None, poll_interval_s: float = 1.0,
                 breaker_threshold: int = 3,
                 breaker_interval_s: float = 2.0,
                 health_timeout_s: float = 2.0):
        if not addresses:
            raise ValueError("gateway needs at least one replica "
                             "(TPU_GATEWAY_REPLICAS=host:port,...)")
        self.logger = logger
        self.metrics = metrics
        self.observe = observe  # clock registry host (fleet alignment)
        self.poll_interval_s = float(poll_interval_s)
        self.replicas: list[Replica] = []
        for i, addr in enumerate(addresses):
            client = new_http_service(
                f"http://{addr}", logger, metrics,
                CircuitBreakerOption(threshold=breaker_threshold,
                                     interval=breaker_interval_s,
                                     start_background_probe=False),
                HealthOption("/.well-known/health"),
                tracer=tracer, timeout=health_timeout_s)
            self.replicas.append(Replica(i, addr, client))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def __len__(self) -> int:
        return len(self.replicas)

    # -- health polling -------------------------------------------------------
    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._poll_loop,
                                            name="gateway-health",
                                            daemon=True)
            self._thread.start()

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the poller must survive
                if self.logger is not None:
                    self.logger.error({"event": "gateway health poll failed",
                                       "error": repr(e)})

    def poll_once(self) -> None:
        """One health sweep over every replica (public: tests and the
        bench drive it deterministically instead of sleeping)."""
        for r in self.replicas:
            self._poll_replica(r)
        self.push_metrics()

    def _poll_replica(self, r: Replica) -> None:
        was = r.state()
        t0 = time.time()
        try:
            resp = r.client.get("/.well-known/health")
        except Exception:  # noqa: BLE001 — open breaker / transport loss
            if r.state() != STATE_DOWN:
                r.mark_down()
            self._log_transition(r, was)
            return
        t3 = time.time()
        if resp.ok:
            r.mark_up()
            self._note_replica_clock(r, t0, t3, resp)
        elif resp.status_code == 503:
            ra = parse_retry_after(resp.header("Retry-After"))
            r.mark_drain(ra)
        else:
            if r.state() != STATE_DOWN:
                r.mark_down()
        self._log_transition(r, was)

    def _note_replica_clock(self, r: Replica, t0: float, t3: float,
                            resp) -> None:
        """The health poll as a free NTP carrier: the replica's health
        body stamps its send wall time (``obs.wall_s`` — t1 == t2, the
        handler stamps once) and advertises its metrics/debug port, so
        every poll refreshes the offset estimate and the peer's debug
        URL without a single extra connection."""
        clock = getattr(self.observe, "clock", None)
        if clock is None:
            return
        try:
            obs = (resp.json() or {}).get("obs") or {}
            wall = obs.get("wall_s")
            if wall is None:
                return  # pre-clock replica: nothing to sample
            mp = obs.get("metrics_port")
            url = (f"http://{r.address.split(':')[0]}:{int(mp)}"
                   if mp else None)
            clock.observe(f"replica:{r.address}", t0, float(wall),
                          float(wall), t3, debug_url=url)
        except Exception:
            pass  # telemetry must never fail the poller

    def _log_transition(self, r: Replica, was: str) -> None:
        now = r.state()
        if now != was and self.logger is not None:
            self.logger.info({"event": "gateway replica state",
                              "replica": r.address, "from": was, "to": now})

    def push_metrics(self) -> None:
        if self.metrics is None:
            return
        counts = {STATE_READY: 0, STATE_DRAINING: 0, STATE_DOWN: 0}
        try:
            for r in self.replicas:
                counts[r.state()] += 1
                self.metrics.set_gauge("app_tpu_gateway_pressure",
                                       r.pressure(), replica=r.address)
            for state, n in counts.items():
                self.metrics.set_gauge("app_tpu_gateway_replicas", n,
                                       state=state)
        except Exception:
            pass

    # -- aggregate reads ------------------------------------------------------
    def retry_after_hint(self) -> float:
        """Soonest any replica is worth retrying — the gateway-level
        503's honest Retry-After when nothing is routable."""
        return min((r.retry_after_hint() for r in self.replicas),
                   default=1.0)

    def stats(self) -> dict:
        return {"replicas": [r.stats() for r in self.replicas],
                "poll_interval_s": self.poll_interval_s}

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        for r in self.replicas:
            try:
                r.client.close()
            except Exception:
                pass
