"""Prefix-affinity routing: consistent hash ring + pressure-aware pick
(the port's own copy of gofr_tpu/gateway/router.py).

**Why consistent hashing on the first KV block chain.** Every turn of
a multi-turn conversation shares its first ``block`` prompt tokens, so
the chain hash of that block (``tpu/kvcache/first_block_hash`` — the
SAME hashing the radix index and the T2 fingerprint keys use) is a
session-stable key: hash it onto a ring of replica virtual nodes and
the whole session lands where its T0/T1 cache is warm, while distinct
sessions spread uniformly. Consistent (rather than modular) hashing
means a replica joining or leaving remaps only the ring arcs it
owned — the rest of the fleet keeps its warm traffic.

**The pick, in preference order** (``AffinityRouter.pick``):

  1. the affinity OWNER (first live ring successor), unless it is
     unroutable (down / draining / open breaker) or it is inside an
     hbm-shed hold AND the request is cache-heavy (prompt >=
     ``long_prefix`` tokens) — a memory-pressured replica is drained
     of the traffic class that costs it KV first, never hammered;
  2. further ring successors under the same rules (these keep SOME
     affinity: the same spill target for the same key);
  3. least-pressure routable replica (pressure score, then in-flight
     count as the tie-break);
  4. a down-but-probeable replica (reconnect window expired — real
     traffic is the recovery probe);
  5. nothing -> :class:`GatewayUnavailable` (typed 503 with the
     table's honest Retry-After).

Prompts shorter than one affinity block skip the ring entirely
(label ``short``): their key would change every turn, so pressure
balance IS the right placement for them.

**Retry budget** (:class:`RetryBudget`): failover is what turns one
replica's death into zero client-visible failures — and what turns a
DYING FLEET's correlated failures into a retry storm if unbounded.
The budget is a token bucket deposited per first attempt and
withdrawn per failover, so retries are capped at ``ratio`` of live
traffic (plus ``burst`` for isolated incidents). Drain re-picks are
deliberately NOT charged: a rolling deploy is an orderly, bounded
event the gateway must absorb silently even while the budget is
drained by a real incident elsewhere.
"""

from __future__ import annotations

import bisect
import hashlib
import threading

from .. import chaos
from ..errors import ServiceUnavailable, format_retry_after
from .table import Replica, ReplicaTable

__all__ = ["AffinityRouter", "GatewayUnavailable", "HashRing",
           "RetryBudget", "PICK_HIT", "PICK_SHORT", "PICK_SPILL"]

PICK_HIT = "hit"
PICK_SPILL = "spill"
PICK_SHORT = "short"


class GatewayUnavailable(ServiceUnavailable):
    """No routable replica (all down/draining/held) or the failover
    retry budget is spent: a typed 503 + Retry-After — the same shed
    discipline every other pressure surface in the framework uses."""

    def __init__(self, message: str, retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = retry_after
        self.headers = {"Retry-After": format_retry_after(retry_after)}


class HashRing:
    """Consistent hash ring over replica indices. ``vnodes`` virtual
    points per replica smooth the arc distribution (the classic
    Karger construction); points are derived from the replica
    ADDRESS, so every gateway instance fronting the same replica set
    builds the identical ring — affinity agrees across gateways with
    no coordination."""

    def __init__(self, addresses: list[str], vnodes: int = 64):
        points: list[tuple[int, int]] = []
        for idx, addr in enumerate(addresses):
            for v in range(max(1, int(vnodes))):
                digest = hashlib.sha256(f"{addr}#{v}".encode()).digest()
                points.append((int.from_bytes(digest[:8], "big"), idx))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._owners = [o for _, o in points]
        self._n = len(addresses)

    def order(self, key: bytes) -> list[int]:
        """Replica indices in ring-successor preference order for
        ``key`` — position 0 is the affinity owner; later positions
        are the deterministic spill sequence."""
        h = int.from_bytes(hashlib.sha256(key).digest()[:8], "big")
        start = bisect.bisect_right(self._hashes, h)
        seen: list[int] = []
        for i in range(len(self._owners)):
            owner = self._owners[(start + i) % len(self._owners)]
            if owner not in seen:
                seen.append(owner)
                if len(seen) == self._n:
                    break
        return seen


class RetryBudget:
    """Token-bucket failover budget: ``deposit()`` per first attempt
    adds ``ratio`` tokens (capped at ``burst``), ``withdraw()`` per
    failover spends one. Deterministic, clock-free, thread-safe —
    the storm brake the failover contract names."""

    def __init__(self, ratio: float = 0.1, burst: float = 10.0):
        self.ratio = max(0.0, float(ratio))
        self.burst = max(1.0, float(burst))
        self._tokens = self.burst
        self._lock = threading.Lock()
        self.spent = 0
        self.denied = 0

    def deposit(self) -> None:
        with self._lock:
            self._tokens = min(self.burst, self._tokens + self.ratio)

    def withdraw(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.spent += 1
                return True
            self.denied += 1
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def stats(self) -> dict:
        return {"tokens": round(self.tokens, 3), "ratio": self.ratio,
                "burst": self.burst, "spent": self.spent,
                "denied": self.denied}


class AffinityRouter:
    def __init__(self, table: ReplicaTable, *, block: int = 16,
                 vnodes: int = 64, long_prefix: int | None = None,
                 metrics=None):
        self.table = table
        self.block = max(1, int(block))
        # "cache-heavy": the class whose KV footprint is worth draining
        # off a memory-pressured replica first — default 4 blocks
        self.long_prefix = (4 * self.block if long_prefix is None
                            else int(long_prefix))
        self.ring = HashRing([r.address for r in table.replicas],
                             vnodes=vnodes)
        self.metrics = metrics
        self.picks = {PICK_HIT: 0, PICK_SPILL: 0, PICK_SHORT: 0}
        self._lock = threading.Lock()

    def _count(self, label: str) -> None:
        with self._lock:
            self.picks[label] += 1
        if self.metrics is not None:
            try:
                self.metrics.increment_counter(
                    "app_tpu_gateway_affinity_total", result=label)
            except Exception:
                pass

    def _usable(self, r: Replica, cache_heavy: bool) -> bool:
        if not r.routable():
            return False
        return not (cache_heavy and r.hbm_hold())

    @staticmethod
    def _least_pressure(cands: list[Replica]) -> Replica | None:
        best = None
        for r in cands:
            if best is None or (r.pressure(), r.inflight) \
                    < (best.pressure(), best.inflight):
                best = r
        return best

    def pick(self, key: bytes | None, prompt_len: int,
             exclude: frozenset | set = frozenset()) -> tuple[Replica, str]:
        """One routing decision. ``key`` is the first-block chain hash
        (None for sub-block prompts); ``exclude`` holds replica
        indices already tried by this request's failover loop.
        Raises :class:`GatewayUnavailable` when nothing is routable.
        Errors injected at the ``GATEWAY_PICK`` seam surface as that
        same typed 503 — a chaos schedule can starve pick N without
        ever crashing the gateway (the handler maps them)."""
        chaos.fire(chaos.GATEWAY_PICK)
        reps = self.table.replicas
        cache_heavy = prompt_len >= self.long_prefix
        if key is not None:
            order = self.ring.order(key)
            for pos, idx in enumerate(order):
                if idx in exclude:
                    continue
                r = reps[idx]
                if self._usable(r, cache_heavy):
                    label = PICK_HIT if pos == 0 else PICK_SPILL
                    self._count(label)
                    return r, label
        # pressure-balanced fallback (short prompts land here directly)
        cands = [r for r in reps
                 if r.idx not in exclude and self._usable(r, cache_heavy)]
        best = self._least_pressure(cands)
        if best is not None:
            label = PICK_SHORT if key is None else PICK_SPILL
            self._count(label)
            return best, label
        # last resort: a held replica for a cache-heavy request beats a
        # 503 IF it is otherwise routable (the hold is advice, the
        # request is real) — prefer the least-pressured one
        cands = [r for r in reps if r.idx not in exclude and r.routable()]
        best = self._least_pressure(cands)
        if best is not None:
            label = PICK_SHORT if key is None else PICK_SPILL
            self._count(label)
            return best, label
        # nothing routable: allow one lazy re-probe of a down replica
        # whose reconnect window expired (traffic as recovery probe)
        for r in reps:
            if r.idx not in exclude and r.probeable():
                self._count(PICK_SPILL)
                return r, PICK_SPILL
        raise GatewayUnavailable(
            "no routable replica (all down, draining, or already "
            "tried)", retry_after=self.table.retry_after_hint())

    def stats(self) -> dict:
        with self._lock:
            picks = dict(self.picks)
        total = sum(picks.values()) or 1
        return {"picks": picks,
                "affinity_hit_rate": round(picks[PICK_HIT] / total, 4),
                "block": self.block, "long_prefix": self.long_prefix}
