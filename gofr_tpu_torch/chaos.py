"""Fault injection at the generator's, the batcher's, the memory
arbiter's, the HTTP and gRPC servers', the service clients', the
gateway's and the P/D ingest server's seams: the port's own copy of the
part of gofr_tpu/chaos.py that the serving loop, the predict path, the
arbiter, the App's transports, ``service/``, ``gateway/`` and ``pd/``
use.

A ``ChaosSchedule`` holds per-seam rules (latency, injected errors, or
both); the engine and the server call ``chaos.fire(SEAM)`` at a fixed
set of seams, which is one global read when no schedule is installed.
It runs on the host between dispatches, never inside a captured CUDA
graph. Decisions are deterministic: every firing is derived from
``(seed, seam, call_index)`` only, so a schedule driven by the same call
counts makes the same injections.

Seams (grep for ``chaos.fire``):

  ==================  =====================================================
  BATCHER_DISPATCH    tpu/batcher._run_one, before the runner executes a
                      coalesced predict batch (a slow or failing dispatch)
  GENERATOR_PREFILL   tpu/generator._start, before the prefill dispatch:
                      a raised error fails that stream, then the loop
                      recovers
  GENERATOR_CHUNK     tpu/generator._chunk_lattice, before each mid-chunk
                      dispatch of a chunked prefill (a schedule can kill
                      chunk N of a long admission)
  GATEWAY_PICK        gateway/router.pick, before each replica-pick
                      decision: injected latency widens the pick/drain
                      race; an injected error fails that pick (a typed
                      503 to the client, never a gateway crash)
  GATEWAY_RELAY       gateway, before each forward attempt: an injected
                      error is that attempt's transport loss, driving
                      the pre-first-token failover on attempt N
                      (``every=N``)
  GATEWAY_MIDSTREAM   gateway relay loop, before each relayed token line
                      after the first: an injected error is that line's
                      transport loss, driving the post-commit
                      auto-resume after exactly N relayed tokens
                      (``every=N, limit=1``)
  GENERATOR_STEP      tpu/generator._loop, once a loop pass before the
                      pipeline's top-up: a raised ``DeviceLost`` takes
                      the loop's recovery path
  GENERATOR_MIDKILL   tpu/generator._deliver, after each delivered token:
                      an injected error kills that one stream after
                      exactly N tokens (``every=N, limit=1``) with a
                      typed error; the engine keeps serving
  GRPC_STREAM         grpcx/server._handle_stream, before dispatch:
                      transport-level latency or errors per RPC (a
                      raised error ends the RPC UNAVAILABLE)
  HBM_ALLOC           tpu/hbm lease points (lease/alloc/check): an
                      injected ``ResourceExhausted`` models a device
                      allocation failure that survived reclaim and
                      retry; the arbiter sheds that request (429 /
                      RESOURCE_EXHAUSTED + Retry-After) and the process
                      keeps serving. ``every=N`` kills allocation N
  HTTP_REQUEST        http/server._Handler._handle, as each request
                      arrives, before routing
  PD_INGEST           pd/ingest._on_kv, before each received KV frame
                      is validated and assembled: an injected error is
                      THAT transfer's fault; the ingest server rejects
                      the one request typed (502 KVTransferError over
                      the wire) and the reader loop keeps serving every
                      other stream on the connection
  SERVICE_REQUEST     service/client, before the network hop of
                      ``HTTPService._do`` and of ``stream_generate``
  ==================  =====================================================
"""

from __future__ import annotations

import contextlib
import hashlib
import random
import threading
import time

__all__ = [
    "BATCHER_DISPATCH", "GATEWAY_MIDSTREAM", "GATEWAY_PICK",
    "GATEWAY_RELAY", "GENERATOR_CHUNK", "GENERATOR_MIDKILL",
    "GENERATOR_PREFILL", "GENERATOR_STEP", "GRPC_STREAM", "HBM_ALLOC",
    "HTTP_REQUEST", "PD_INGEST", "SERVICE_REQUEST", "SEAMS",
    "ChaosSchedule", "DeviceLost", "ResourceExhausted", "Rule", "active",
    "fire", "install", "scope", "uninstall",
]

BATCHER_DISPATCH = "batcher.dispatch"
GATEWAY_MIDSTREAM = "gateway.midstream"
GATEWAY_PICK = "gateway.pick"
GATEWAY_RELAY = "gateway.relay"
GENERATOR_CHUNK = "generator.chunk"
GENERATOR_MIDKILL = "generator.midkill"
GENERATOR_PREFILL = "generator.prefill"
GENERATOR_STEP = "generator.step"
GRPC_STREAM = "grpc.stream"
HBM_ALLOC = "hbm.alloc"
HTTP_REQUEST = "http.request"
PD_INGEST = "pd.ingest"
SERVICE_REQUEST = "service.request"

SEAMS = (BATCHER_DISPATCH, GATEWAY_MIDSTREAM, GATEWAY_PICK, GATEWAY_RELAY,
         GENERATOR_CHUNK, GENERATOR_MIDKILL, GENERATOR_PREFILL,
         GENERATOR_STEP, GRPC_STREAM, HBM_ALLOC, HTTP_REQUEST, PD_INGEST,
         SERVICE_REQUEST)


class DeviceLost(RuntimeError):
    """Injected stand-in for a device runtime failure. Raised at
    GENERATOR_STEP it takes the path a failed dispatch takes."""


class ResourceExhausted(RuntimeError):
    """Injected stand-in for a device allocation failure. Raised at
    HBM_ALLOC it takes the arbiter's shed path; raised at
    BATCHER_DISPATCH it exercises the batcher's reclaim-then-retry. The
    message carries the marker ``tpu.hbm.is_oom_error`` keys on, so
    injected and real out-of-memory errors classify alike."""

    def __init__(self, msg: str = "injected RESOURCE_EXHAUSTED: device "
                                  "memory exhausted (chaos)"):
        super().__init__(msg)


class Rule:
    """One seam's injection policy.

    latency/jitter: every call sleeps ``latency + U[0, jitter)`` seconds
      (the uniform draw is deterministic per call index).
    error: exception instance, class, or zero-argument factory raised
      on firing calls.
    every: fire on every Nth call, OR
    p: fire with probability ``p`` a call (a deterministic draw per call
      index from the schedule's seed).
    limit: stop firing errors after this many (0 = unlimited); latency
      keeps applying.
    """

    __slots__ = ("latency", "jitter", "error", "every", "p", "limit")

    def __init__(self, latency: float = 0.0, jitter: float = 0.0,
                 error=None, every: int = 0, p: float = 0.0,
                 limit: int = 0):
        if every and p:
            raise ValueError("rule takes every= OR p=, not both")
        self.latency = float(latency)
        self.jitter = float(jitter)
        self.error = error
        self.every = int(every)
        self.p = float(p)
        self.limit = int(limit)

    def _make_error(self) -> BaseException:
        err = self.error
        if isinstance(err, BaseException):
            return err
        return err()  # class or factory

    def decide(self, seed: int, seam: str, idx: int) -> tuple[bool, float]:
        """(fire_error, sleep_s) for call ``idx``: a pure function of
        (seed, seam, idx), which makes schedules replayable."""
        rng = random.Random(f"{seed}:{seam}:{idx}")
        sleep_s = self.latency + (rng.random() * self.jitter
                                  if self.jitter > 0 else 0.0)
        fire = False
        if self.error is not None:
            if self.every > 0:
                fire = (idx % self.every) == self.every - 1
            elif self.p > 0:
                fire = rng.random() < self.p
        return fire, sleep_s


class ChaosSchedule:
    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rules: dict[str, Rule] = {}
        self._lock = threading.Lock()
        self._calls: dict[str, int] = {}
        self._fired: dict[str, int] = {}
        self._slept: dict[str, float] = {}

    def on(self, seam: str, *, latency: float = 0.0, jitter: float = 0.0,
           error=None, every: int = 0, p: float = 0.0,
           limit: int = 0) -> "ChaosSchedule":
        """Attach a rule to a seam; chainable."""
        self._rules[seam] = Rule(latency=latency, jitter=jitter, error=error,
                                 every=every, p=p, limit=limit)
        return self

    def fire(self, seam: str) -> None:
        rule = self._rules.get(seam)
        if rule is None:
            return
        with self._lock:
            idx = self._calls.get(seam, 0)
            self._calls[seam] = idx + 1
        fire_error, sleep_s = rule.decide(self.seed, seam, idx)
        if sleep_s > 0:
            with self._lock:
                self._slept[seam] = self._slept.get(seam, 0.0) + sleep_s
            time.sleep(sleep_s)
        if fire_error:
            with self._lock:
                fired = self._fired.get(seam, 0)
                if rule.limit and fired >= rule.limit:
                    return
                self._fired[seam] = fired + 1
            raise rule._make_error()

    def decisions(self, seam: str, n: int) -> list[tuple[bool, float]]:
        """The first ``n`` decisions a seam will make: a pure replay
        that touches no state."""
        rule = self._rules.get(seam)
        if rule is None:
            return [(False, 0.0)] * n
        return [rule.decide(self.seed, seam, i) for i in range(n)]

    def digest(self, calls_per_seam: int = 256) -> str:
        """Hex digest of the decision stream over every configured seam:
        two schedules with the same seed and rules give the same one."""
        h = hashlib.sha256()
        for seam in sorted(self._rules):
            for fire, sleep_s in self.decisions(seam, calls_per_seam):
                h.update(f"{seam}|{int(fire)}|{sleep_s:.9f};".encode())
        return h.hexdigest()

    def stats(self) -> dict:
        with self._lock:
            return {"seed": self.seed,
                    "calls": dict(self._calls),
                    "errors_fired": dict(self._fired),
                    "injected_sleep_s": {k: round(v, 6)
                                         for k, v in self._slept.items()}}


# -- module-level installation (what the seams consult) -----------------------
_ACTIVE: ChaosSchedule | None = None


def install(schedule: ChaosSchedule) -> ChaosSchedule:
    global _ACTIVE
    _ACTIVE = schedule
    return schedule


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> ChaosSchedule | None:
    return _ACTIVE


def fire(seam: str) -> None:
    """Called by the engine at each seam: one global read when no
    schedule is installed."""
    s = _ACTIVE
    if s is not None:
        s.fire(seam)


@contextlib.contextmanager
def scope(schedule: ChaosSchedule):
    """Install for the duration of a with-block."""
    install(schedule)
    try:
        yield schedule
    finally:
        uninstall()
