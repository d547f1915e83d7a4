"""T1: the host-RAM offload tier (the port's own copy of
gofr_tpu/tpu/kvcache/host.py).

Effective prefix-cache capacity stops being bounded by device pool
rows: when T0 evicts an entry, the engine copies the victim's pool row
(positions [0, plen)) to CPU tensors and parks it here under a byte
budget. A T1 hit is promoted back into a pool row (a host -> device
upload + the usual row copy), which still beats recomputing the prefix
by a wide margin -- and, unlike T0, this tier SURVIVES a failed step:
engine recovery clears T0 (its rows point into a reallocated pool)
while T1 rewarms the fresh pool without a single prefill dispatch.
"""

from __future__ import annotations

import numpy as np

from .quant import HostKV
from .radix import Entry, RadixIndex


class HostTier:
    tier = "t1"

    def __init__(self, max_bytes: int, block: int = 16):
        self.max_bytes = int(max_bytes)
        self.index = RadixIndex(block)
        self._entries: dict[int, Entry] = {}
        self._tick = 0
        self.bytes = 0
        self.evictions = 0
        # successful spills accepted from T0 (LRU eviction AND the
        # arbiter's pool shrink both land here): the counter that
        # shows "shrink T0 toward the host tier" actually moved KV
        # down a tier instead of dropping it
        self.spills = 0

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, prompt: np.ndarray, adapter: int = 0
              ) -> tuple[Entry | None, int]:
        return self.index.match(prompt, adapter)

    def touch(self, entry: Entry) -> None:
        self._tick += 1
        entry.tick = self._tick

    def put(self, key: np.ndarray, adapter: int, kv: HostKV) -> bool:
        """Park a spilled row. Skips entries a stored one already
        covers (duplicate bytes for no extra match length), drops
        stored entries the NEW key strictly covers (every probe they
        can serve the superset serves at least as well — under the
        growing-prefix multi-turn workload each turn would otherwise
        leave the previous turn's snapshot burning budget), and skips
        entries larger than the whole budget; evicts LRU until it
        fits."""
        need = kv.nbytes
        if need > self.max_bytes:
            return False
        _, m = self.index.match(key, adapter)
        if m >= len(key):
            return False
        adapter = int(adapter)
        for e in [e for e in self._entries.values()
                  if e.adapter == adapter and len(e.key) < len(key)
                  and np.array_equal(e.key, key[:len(e.key)])]:
            self._drop(e)  # dominated, not pressure: no eviction count
        while self.bytes + need > self.max_bytes and self._entries:
            self._evict_lru()
        entry = Entry(key, adapter, payload=kv)
        self.index.insert(entry)
        self._entries[entry.eid] = entry
        self.bytes += need
        self.spills += 1
        self.touch(entry)
        return True

    def _evict_lru(self) -> None:
        victim = min(self._entries.values(), key=lambda e: e.tick)
        self._drop(victim)
        self.evictions += 1

    def _drop(self, entry: Entry) -> None:
        self.index.remove(entry)
        self._entries.pop(entry.eid, None)
        self.bytes -= entry.payload.nbytes

    def invalidate_adapter(self, adapter: int) -> int:
        n = self.index.invalidate_adapter(adapter)
        for e in [e for e in self._entries.values()
                  if e.adapter == int(adapter)]:
            self._entries.pop(e.eid, None)
            self.bytes -= e.payload.nbytes
        return n

    def clear(self) -> int:
        n = len(self._entries)
        self.index.clear()
        self._entries.clear()
        self.bytes = 0
        return n

    def stats(self) -> dict:
        return {"entries": len(self), "bytes": self.bytes,
                "max_bytes": self.max_bytes, "evictions": self.evictions,
                "spills": self.spills}
