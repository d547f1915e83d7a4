"""Queue-backed item stream: the port's own copy of the part of
gofr_tpu/wire.py ``PushStream`` that the generator's token streams use.
(The JAX package's zero-handoff transport sink arrives with the HTTP and
gRPC wiring.)"""

from __future__ import annotations

import queue


class PushStream:
    """Producer side calls ``_push(item)``; ``None`` ends the stream and
    a queued ``BaseException`` re-raises in the consumer."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()

    def _push(self, item) -> None:
        self._q.put(item)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
