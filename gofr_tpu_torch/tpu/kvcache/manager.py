"""CacheManager: one facade over the three-tier prefix-KV hierarchy (the
port's own copy of gofr_tpu/tpu/kvcache/manager.py).

The engine's serving loop talks ONLY to this class (plus its own row
copies -- device memory stays engine-owned):

  match()  -> best Match across T0 (device pool rows), T1 (host RAM),
              T2 (Redis). Pure w.r.t. counters: the engine decides
              whether the match is USABLE (long enough, on the chunk
              lattice) and reports back via accept()/reject().
  store()  -> claim a T0 row for a fresh prefix; hands back the LRU
              victim so the engine can spill its row to T1 first.
  offload()/store_shared() -> the T1 spill and T2 write-through.
  clear_device() -> recovery: T0 entries die with the pool, T1 and T2
              survive (the whole point of the hierarchy).
  shrink() -> the memory arbiter's reclaim: T0 gives up rows.

Tier precedence on lookup: longest match wins; ties go to the cheaper
restore (T0 row copy < T1 upload < T2 network + upload). T2 is only
consulted -- and only wins -- when it could beat the local tiers by at
least one full block: its hit pays MGET + host->device upload + a
pool-row promotion, never worth less than a block of saved prefill.

``invalidate_adapter`` is the LoRA hot-swap: every tier drops the
adapter's entries. The tenancy hooks (``set_tenancy``,
``tenant_budget``, ``evict_tenant``, the ``tenant=`` arguments) come
with tenancy (ROADMAP queue 1 item 10); they keep the JAX package's
call shapes and raise until then.
"""

from __future__ import annotations

import numpy as np

from .hbm import HBMTier
from .host import HostTier
from .quant import HostKV, KVLayout
from .radix import Entry
from .redis_tier import RedisTier


def clamp_restore_len(matched: int, prompt_len: int) -> int:
    """A full-prompt hit must restore at most ``prompt_len - 1``
    positions: the final position is always prefilled so the dispatch
    has logits to sample the first generated token from (the restore
    path copies KV, not logits)."""
    return min(int(matched), prompt_len - 1)


def _no_tenancy(tenant) -> None:
    if tenant is not None:
        raise NotImplementedError(
            "per-tenant cache budgets come with tenancy (ROADMAP queue 1 "
            "item 10)")


class Match:
    """One lookup's winner. ``row`` for T0; ``hostkv``+``key`` for
    T1/T2 promotions; ``consulted`` drives per-tier miss counters."""

    __slots__ = ("tier", "entry", "matched_len", "row", "hostkv", "key",
                 "adapter", "consulted")

    def __init__(self, tier: str, matched_len: int, adapter: int,
                 entry: Entry | None = None, row: int | None = None,
                 hostkv: HostKV | None = None,
                 key: np.ndarray | None = None, consulted=()):
        self.tier = tier
        self.entry = entry
        self.matched_len = int(matched_len)
        self.row = row
        self.hostkv = hostkv
        self.key = key
        self.adapter = int(adapter)
        self.consulted = tuple(consulted)


class CacheManager:
    def __init__(self, slots: int, layout: KVLayout, *, block: int = 16,
                 host_bytes: int = 0, redis=None, redis_ttl_s: float = 300.0,
                 epoch_refresh_s: float = 5.0, fingerprint: str = "",
                 metrics=None, logger=None):
        self.block = max(1, int(block))
        self.layout = layout
        self.t0 = HBMTier(slots, self.block)
        self.host = HostTier(host_bytes, self.block) if host_bytes > 0 \
            else None
        self.redis = RedisTier(redis, fingerprint, layout, self.block,
                               ttl_s=redis_ttl_s,
                               epoch_refresh_s=epoch_refresh_s,
                               logger=logger) if redis is not None else None
        self.metrics = metrics
        self.logger = logger
        # bumped on any mutation that can change a match verdict: the
        # engine memoizes per-request lattice peeks against it
        self.version = 0
        self.hits = 0
        self.misses = 0
        self._tier_hits = {"t0": 0, "t1": 0, "t2": 0}
        self._tier_misses = {"t0": 0, "t1": 0, "t2": 0}

    # -- tenancy (ROADMAP queue 1 item 10) -----------------------------------
    def set_tenancy(self, shares_fn, row_bytes: int = 0) -> None:
        _no_tenancy(shares_fn)

    def tenant_budget(self, tenant: str) -> int | None:
        _no_tenancy(tenant)

    def evict_tenant(self, tenant: str, rows: int | None = None
                     ) -> list[Entry]:
        _no_tenancy(tenant)

    # -- engine-facing surface ----------------------------------------------
    def __len__(self) -> int:
        return len(self.t0)

    @property
    def slots(self) -> int:
        return self.t0.slots

    @property
    def wants_offload(self) -> bool:
        return self.host is not None

    @property
    def shares(self) -> bool:
        return self.redis is not None

    def match(self, prompt: np.ndarray, adapter: int = 0) -> Match | None:
        """Best match across enabled tiers; None when no tier has a
        single usable token. No counter/LRU side effects: report the
        engine's verdict via accept()/reject()."""
        prompt = np.asarray(prompt, np.int32)
        consulted = ["t0"]
        e0, m0 = self.t0.match(prompt, adapter)
        best = Match("t0", m0, adapter, entry=e0, row=e0.row,
                     key=e0.key) if e0 is not None else None
        if self.host is not None:
            consulted.append("t1")
            e1, m1 = self.host.match(prompt, adapter)
            if e1 is not None and m1 > (best.matched_len if best else 0):
                best = Match("t1", m1, adapter, entry=e1,
                             hostkv=e1.payload, key=e1.key)
        if self.redis is not None and self.redis.available:
            # consult the shared tier only when it could beat the local
            # tiers by at least one FULL block (and not at all inside
            # the post-error backoff window)
            full = (len(prompt) // self.block) * self.block
            local = best.matched_len if best else 0
            if local + self.block <= full:
                consulted.append("t2")
                m2, kv2 = self.redis.match(prompt, adapter)
                if kv2 is not None and m2 >= local + self.block:
                    best = Match("t2", m2, adapter, hostkv=kv2,
                                 key=prompt[:m2].copy())
        if best is not None:
            best.consulted = tuple(consulted)
            return best
        return None

    def accept(self, match: Match, restore_s: float | None = None,
               tenant: str | None = None) -> None:
        """The engine restored this match: count the hit on the serving
        tier, a miss on every cheaper tier it had to fall through, and
        refresh the winning entry's LRU position."""
        _no_tenancy(tenant)
        self.hits += 1
        self._tier_hits[match.tier] += 1
        for tier in match.consulted:
            if tier != match.tier:
                self._tier_misses[tier] += 1
        if match.tier == "t0" and match.entry is not None:
            self.t0.touch(match.entry)
        elif match.tier == "t1" and match.entry is not None:
            self.host.touch(match.entry)
        self._count("app_tpu_kvcache_hits_total", match.tier)
        for tier in match.consulted:
            if tier != match.tier:
                self._count("app_tpu_kvcache_misses_total", tier)
        if restore_s is not None and self.metrics is not None:
            try:
                self.metrics.record_histogram(
                    "app_tpu_kvcache_restore_duration", restore_s,
                    tier=match.tier)
            except Exception:  # noqa: BLE001 — telemetry only
                pass

    def reject(self, match: Match | None = None,
               prompt: np.ndarray | None = None) -> None:
        """No usable match for this admission (nothing found, or the
        engine discarded it as too short / off the chunk lattice).
        Without a match, reconstruct which tiers match() consulted:
        T0 always, T1 when enabled, T2 only when the prompt had full
        blocks to look up."""
        self.misses += 1
        if match is not None:
            consulted = match.consulted
        else:
            consulted = ["t0"]
            if self.host is not None:
                consulted.append("t1")
            if self.redis is not None and self.redis.available and (
                    prompt is None or len(prompt) >= self.block):
                consulted.append("t2")
        for tier in consulted:
            self._tier_misses[tier] += 1
            self._count("app_tpu_kvcache_misses_total", tier)

    def covered(self, prompt: np.ndarray, adapter: int = 0) -> bool:
        return self.t0.covered(np.asarray(prompt, np.int32), adapter)

    def store(self, key: np.ndarray, adapter: int = 0,
              tenant: str | None = None) -> tuple[int, Entry | None]:
        """Claim a T0 row (see HBMTier.store). The caller spills the
        returned victim's row via offload() BEFORE overwriting it."""
        _no_tenancy(tenant)
        self.version += 1
        row, victim = self.t0.store(np.asarray(key, np.int32), adapter)
        if victim is not None:
            self._count("app_tpu_kvcache_evictions_total", "t0")
        self._gauges()
        return row, victim

    def offload(self, victim: Entry, kv: HostKV) -> bool:
        """Spill an evicted T0 entry's row into the host tier."""
        if self.host is None:
            return False
        before = self.host.evictions
        ok = self.host.put(victim.key, victim.adapter, kv)
        for _ in range(self.host.evictions - before):
            self._count("app_tpu_kvcache_evictions_total", "t1")
        if ok:
            self.version += 1
        self._gauges()
        return ok

    def store_shared(self, key: np.ndarray, adapter: int,
                     kv: HostKV) -> int:
        """Write-through the new prefix's full blocks to Redis."""
        if self.redis is None:
            return 0
        return self.redis.put(np.asarray(key, np.int32), adapter, kv)

    def shrink(self, new_slots: int) -> int:
        """Memory-arbiter reclaim: resize T0 to ``new_slots`` rows,
        dropping every entry (the caller -- the engine's pool-reclaim
        callback -- spills each entry's row to the host tier first,
        then reallocates the pool itself at the new size). The version
        bump drops memoized match verdicts that referenced dead rows;
        future hits rewarm from T1/T2 exactly like post-recovery."""
        self.version += 1
        n = self.t0.resize(new_slots)
        self._gauges()
        return n

    def clear_device(self) -> int:
        """Recovery: the pool was reallocated, so T0 entries point at
        zeroed rows -- drop them. T1 snapshots and T2 blocks are device-
        independent and SURVIVE: the next admission rewarms the fresh
        pool from them instead of paying a full prefill."""
        self.version += 1
        n = self.t0.clear()
        self._gauges()
        return n

    def invalidate_adapter(self, adapter: int) -> dict:
        """LoRA hot-swap: stored KV was computed through the OLD wk/wv,
        so every tier drops the adapter's entries (T0 and T1 here, T2 by
        an epoch bump, which invalidates OTHER replicas' reads of this
        adapter too). Returns the entries dropped per tier."""
        self.version += 1
        out = {"t0": self.t0.invalidate_adapter(adapter)}
        if self.host is not None:
            out["t1"] = self.host.invalidate_adapter(adapter)
        if self.redis is not None:
            self.redis.invalidate_adapter(adapter)
            out["t2"] = "epoch_bumped"
        self._gauges()
        return out

    # -- observability -------------------------------------------------------
    def _count(self, name: str, tier: str) -> None:
        if self.metrics is not None:
            try:
                self.metrics.increment_counter(name, tier=tier)
            except Exception:  # noqa: BLE001 — telemetry only
                pass

    def _gauges(self) -> None:
        if self.metrics is None:
            return
        try:
            self.metrics.set_gauge("app_tpu_kvcache_entries",
                                   float(len(self.t0)), tier="t0")
            if self.host is not None:
                self.metrics.set_gauge("app_tpu_kvcache_entries",
                                       float(len(self.host)), tier="t1")
                self.metrics.set_gauge("app_tpu_kvcache_bytes",
                                       float(self.host.bytes), tier="t1")
        except Exception:  # noqa: BLE001 — telemetry only
            pass

    def stats(self) -> dict:
        """Top-level keys keep the flat index's contract (slots/entries/
        hits/misses); tier detail nests under ``tiers``."""
        lookups = self.hits + self.misses
        out = {
            "slots": self.t0.slots,
            "entries": len(self.t0),
            "hits": self.hits,
            "misses": self.misses,
            "hit_ratio": round(self.hits / lookups, 4) if lookups else None,
            "block": self.block,
            "tiers": {
                "t0": {**self.t0.stats(), "hits": self._tier_hits["t0"],
                       "misses": self._tier_misses["t0"]},
            },
        }
        if self.host is not None:
            out["tiers"]["t1"] = {**self.host.stats(),
                                  "hits": self._tier_hits["t1"],
                                  "misses": self._tier_misses["t1"]}
        if self.redis is not None:
            out["tiers"]["t2"] = {**self.redis.stats(),
                                  "hits": self._tier_hits["t2"],
                                  "misses": self._tier_misses["t2"]}
        return out
