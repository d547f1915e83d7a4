"""Queue-backed item stream with an optional zero-handoff sink: the
port's own copy of the part of gofr_tpu/wire.py ``PushStream`` that the
generator's token streams use, the sink protocol included (a transport
such as the App's ``POST /generate`` registers a sink and the serving
loop hands each token to it on its own thread)."""

from __future__ import annotations

import queue
import threading

# a marker a producer-side sink can enqueue (PushStream.wake) to rouse the
# consuming thread without delivering an item; iterating consumers that
# never call wake() never see it
WAKE = object()


class PushStream:
    """Producer side calls ``_push(item)``; ``None`` ends the stream and
    a queued ``BaseException`` re-raises in the consumer. When a
    consumer registers a sink, items are handed to it on the producing
    thread; the sink returns True to consume or False to fall back to
    the queue (the consumer's iterator). Terminal items always go to the
    queue, so the consuming thread observes the end.

    A decline is permanent: the first False detaches the sink and every
    later item rides the queue, so no item can overtake one that waits
    in the queue. A sink that raises is dropped the same way."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._sink = None
        self._sink_lock = threading.Lock()

    def _sink_try(self, sink, item) -> bool:
        try:
            return bool(sink(item))
        except Exception:
            self._sink = None
            return False

    def _push(self, item) -> None:
        with self._sink_lock:
            sink = self._sink
            if (sink is not None and item is not None
                    and not isinstance(item, BaseException)):
                if self._sink_try(sink, item):
                    return
                self._sink = None  # declines are permanent
            self._q.put(item)

    def set_sink(self, sink) -> None:
        """Register ``sink`` and drain already-queued items through it
        under the delivery lock, so delivery order holds across the
        registration. Terminal items (and everything after a declined
        item) stay queued for the iterator."""
        with self._sink_lock:
            pending = []
            while True:
                try:
                    pending.append(self._q.get_nowait())
                except queue.Empty:
                    break
            self._sink = sink
            for idx, item in enumerate(pending):
                if (item is None or isinstance(item, BaseException)
                        or not self._sink_try(sink, item)):
                    if item is not None and not isinstance(item,
                                                           BaseException):
                        self._sink = None  # declined: permanent fallback
                    for rest in pending[idx:]:
                        self._q.put(rest)
                    break

    def clear_sink(self) -> None:
        with self._sink_lock:
            self._sink = None

    def wake(self) -> None:
        """Rouse the consuming thread with a WAKE marker. Safe from
        inside a sink callback (no lock taken)."""
        self._q.put(WAKE)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
