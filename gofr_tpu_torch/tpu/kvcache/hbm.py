"""T0: the device tier -- radix-indexed bookkeeping for the pool rows
(the port's own copy of gofr_tpu/tpu/kvcache/hbm.py).

The ENGINE owns the device pool rows and every row copy; this class is
the host-side map from token prefixes to rows, behind the block-hash
radix tree. A hit costs one device row copy; entries are LRU-evicted
on store, and the evicted entry is handed BACK to the caller so the
engine can spill the row's KV to the host tier before the pool row is
overwritten.
"""

from __future__ import annotations

import numpy as np

from .radix import Entry, RadixIndex


class HBMTier:
    tier = "t0"

    def __init__(self, slots: int, block: int = 16):
        self.slots = int(slots)
        self.index = RadixIndex(block)
        self._rows: list[Entry | None] = [None] * self.slots
        self._tick = 0
        self.evictions = 0

    def __len__(self) -> int:
        return sum(1 for e in self._rows if e is not None)

    def match(self, prompt: np.ndarray, adapter: int = 0
              ) -> tuple[Entry | None, int]:
        """PURE longest-prefix lookup (see RadixIndex.match); the
        manager reports usability via touch() on accept."""
        return self.index.match(prompt, adapter)

    def touch(self, entry: Entry) -> None:
        self._tick += 1
        entry.tick = self._tick

    def covered(self, prompt: np.ndarray, adapter: int = 0) -> bool:
        """True when a stored entry already contains ``prompt`` as a
        prefix — storing it again would only duplicate a row."""
        _, m = self.index.match(prompt, adapter)
        return m >= len(prompt)

    def store(self, key: np.ndarray, adapter: int = 0,
              prefer=None) -> tuple[int, Entry | None]:
        """Claim a row for a new entry: a free row, else the LRU
        victim's. Returns (row, victim) with the victim ALREADY
        unindexed but its key/payload intact -- the caller must read the
        victim's pool row (for host-tier spill) BEFORE dispatching the
        store that overwrites it.

        ``prefer``: optional set of entry ids (``Entry.eid``) to
        victimize FIRST: the cache manager passes the over-budget
        tenants' entries here so a tenant past its share evicts its own
        blocks before touching anyone else's). LRU order applies within
        the preferred set; an empty/absent set is plain global LRU."""
        victim = None
        row = next((i for i, e in enumerate(self._rows) if e is None), None)
        if row is None:
            candidates = None
            if prefer:
                candidates = [i for i in range(self.slots)
                              if self._rows[i].eid in prefer]
            if not candidates:
                candidates = range(self.slots)
            row = min(candidates, key=lambda i: self._rows[i].tick)
            victim = self._rows[row]
            self.index.remove(victim)
            self.evictions += 1
        entry = Entry(key, adapter, payload=row)
        self.index.insert(entry)
        self._rows[row] = entry
        self.touch(entry)
        return row, victim

    def entry_at(self, row: int) -> Entry | None:
        return self._rows[row] if 0 <= row < self.slots else None

    def evict(self, entry: Entry) -> bool:
        """Targeted eviction: unindex ``entry`` and free its row (the
        caller spills the row's KV first, exactly like a store-path
        victim). Used by the per-tenant cache-quota reclaim."""
        row = entry.payload
        if not (0 <= row < self.slots) or self._rows[row] is not entry:
            return False
        self.index.remove(entry)
        self._rows[row] = None
        self.evictions += 1
        return True

    def entries(self) -> list[Entry]:
        """The live entries (arbitrary order) — the arbiter's pool
        shrink reads them to spill each entry's row to the host tier
        before the pool is reallocated smaller."""
        return [e for e in self._rows if e is not None]

    def clear(self) -> int:
        """Drop every entry — engine recovery calls this after
        reallocating the side pool (stored keys would otherwise match
        prompts against zeroed rows and restore all-zero KV)."""
        n = len(self)
        self.index.clear()
        self._rows = [None] * self.slots
        return n

    def resize(self, slots: int) -> int:
        """Shrink (or regrow) the row table to ``slots``, dropping
        EVERY entry — the HBM arbiter's reclaim path reallocates the
        pool itself, so surviving row indices would point into a dead
        buffer. Callers spill entries to the host tier first; returns
        the number dropped."""
        n = len(self)
        self.index.clear()
        self.slots = max(1, int(slots))
        self._rows = [None] * self.slots
        return n

    def invalidate_adapter(self, adapter: int) -> int:
        n = self.index.invalidate_adapter(adapter)
        for i, e in enumerate(self._rows):
            if e is not None and e.adapter == int(adapter):
                self._rows[i] = None
        return n

    def stats(self) -> dict:
        return {"slots": self.slots, "entries": len(self),
                "evictions": self.evictions}
