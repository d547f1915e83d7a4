"""Flight recorder: a bounded ring buffer of request lifecycle events.

The port's own copy of gofr_tpu/observe/recorder.py (the port imports
nothing of the JAX package).

Post-hoc triage without an external trace backend: when a request
misbehaved thirty seconds ago, ``/debug/events`` still holds its
lifecycle (submitted, admitted, first-token, finished/failed) with
durations and trace ids — the serving-path equivalent of a cockpit
flight recorder. The buffer is fixed-size (oldest events fall off) so
an always-on recorder can never grow without bound; a ``dropped``
counter records how much history has scrolled away.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque


class FlightRecorder:
    def __init__(self, capacity: int = 2048):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._buf: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self.total_recorded = 0

    def record(self, event: str, *, request_id=None, trace_id: str = "",
               **fields) -> None:
        """Append one event. ``fields`` are free-form (durations, token
        counts, error strings) and must be JSON-serializable."""
        entry = {
            "seq": next(self._seq),
            "ts": time.time(),
            "event": event,
        }
        if request_id is not None:
            entry["request_id"] = request_id
        if trace_id:
            entry["trace_id"] = trace_id
        entry.update(fields)
        with self._lock:
            self._buf.append(entry)
            self.total_recorded += 1

    def events(self, limit: int | None = None, event: str | None = None,
               request_id=None, since_seq: int | None = None) -> list[dict]:
        """Most-recent-last slice of the buffer, optionally filtered."""
        with self._lock:
            items = list(self._buf)
        if event is not None:
            items = [e for e in items if e["event"] == event]
        if request_id is not None:
            items = [e for e in items if e.get("request_id") == request_id]
        if since_seq is not None:
            items = [e for e in items if e["seq"] > since_seq]
        if limit is not None and limit >= 0:
            # explicit slice arithmetic: items[-0:] would be the WHOLE
            # buffer, so limit=0 must short-circuit to nothing
            items = items[-limit:] if limit else []
        return items

    def stats(self) -> dict:
        with self._lock:
            buffered = len(self._buf)
            total = self.total_recorded
        return {
            "capacity": self.capacity,
            "buffered": buffered,
            "total_recorded": total,
            "dropped": total - buffered,
        }
