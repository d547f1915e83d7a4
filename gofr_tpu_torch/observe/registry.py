"""In-flight request registry: "what is this server doing right now?"
(the port's own copy of gofr_tpu/observe/registry.py).

Modeled on golang.org/x/net/trace's active-request pages: every request
the server is working on (an HTTP request in its handler, a generation
stream between submission and its terminal, a predict call waiting on
a coalesced batch) registers an entry at start and removes it at the
end. ``/debug/requests`` renders the live table, and the App's graceful
stop waits for it to empty.

The hot paths touch entries thousands of times per second, so the
design keeps mutation free of the registry lock: ``add``/``remove``
take the lock once per request; per-token updates (``stage``,
``tokens``) are plain attribute writes, atomic under the GIL. A scrape
snapshots under the lock and reads possibly-torn per-entry fields —
acceptable for a diagnostics page, never for correctness.
"""

from __future__ import annotations

import itertools
import threading
import time

_ENTRY_IDS = itertools.count(1)


class InflightRequest:
    """One active request. Mutate ``stage``/``tokens`` freely from the
    owning thread; everything else is set once at registration."""

    __slots__ = ("id", "kind", "name", "trace_id", "start", "stage",
                 "tokens", "detail")

    def __init__(self, kind: str, name: str, trace_id: str = "",
                 stage: str = "start", detail: dict | None = None):
        self.id = next(_ENTRY_IDS)
        self.kind = kind          # "http" | "generate" | "predict" | ...
        self.name = name          # route template / program name
        self.trace_id = trace_id
        self.start = time.monotonic()
        self.stage = stage
        self.tokens = 0
        self.detail = detail or {}

    @property
    def age_s(self) -> float:
        return time.monotonic() - self.start

    def snapshot(self) -> dict:
        return {
            "id": self.id,
            "kind": self.kind,
            "name": self.name,
            "trace_id": self.trace_id,
            "stage": self.stage,
            "age_s": round(self.age_s, 6),
            "tokens": self.tokens,
            **({"detail": dict(self.detail)} if self.detail else {}),
        }


class RequestRegistry:
    """Thread-safe table of the server's active requests."""

    def __init__(self) -> None:
        self._entries: dict[int, InflightRequest] = {}
        self._lock = threading.Lock()
        self.total_started = 0

    def add(self, kind: str, name: str, trace_id: str = "",
            stage: str = "start", detail: dict | None = None) -> InflightRequest:
        entry = InflightRequest(kind, name, trace_id, stage, detail)
        with self._lock:
            self._entries[entry.id] = entry
            self.total_started += 1
        return entry

    def remove(self, entry: InflightRequest | None) -> None:
        if entry is None:
            return
        with self._lock:
            self._entries.pop(entry.id, None)

    def __len__(self) -> int:
        return len(self._entries)

    def snapshot(self) -> list[dict]:
        """Active requests, oldest first (the stuck ones float to the top)."""
        with self._lock:
            entries = list(self._entries.values())
        return [e.snapshot() for e in
                sorted(entries, key=lambda e: e.start)]
