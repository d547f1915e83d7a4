"""Transport primitives: the port's own copy of the part of
gofr_tpu/wire.py that the generator's token streams and the App's HTTP
server use.

  SocketWriter -- vectored (``sendmsg``) writes with an ordered backlog,
      so a producer thread can hand bytes to the wire without blocking
      on the socket or on another writer (the HTTP server's streaming
      responses write through one).
  PushStream -- a queue-backed item stream with an optional
      zero-handoff sink: a transport such as the App's ``POST
      /generate`` registers a sink and the serving loop hands each
      token to it on its own thread.
"""

from __future__ import annotations

import queue
import socket
import threading

# sendmsg buffer-list cap per syscall — far below any platform IOV_MAX
# (Linux: 1024) while keeping per-call bookkeeping bounded
_IOV_CAP = 64


class SocketWriter:
    """Vectored, backlog-capable socket writer.

    Guarantees:
      - wire byte order equals commit order: a write's bytes are
        committed (to the socket or the backlog) under the internal
        locks before the call returns;
      - ``write(..., block=False)`` NEVER blocks on the socket or on a
        concurrent writer — bytes that cannot leave immediately park in
        the backlog;
      - every blocking write drains the backlog ahead of its own bytes,
        so any stream that *ends* with a blocking write (the terminal
        HTTP chunk) leaves the wire fully flushed.
    """

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._lock = threading.Lock()   # serializes actual socket sends
        self._blk = threading.Lock()    # guards _backlog
        self._backlog = bytearray()

    # -- internals -----------------------------------------------------------
    def _take(self, bufs) -> list[memoryview]:
        """Swap out the backlog and append ``bufs`` — the commit point."""
        with self._blk:
            views: list[memoryview] = []
            if self._backlog:
                views.append(memoryview(bytes(self._backlog)))
                self._backlog.clear()
            views.extend(memoryview(b) for b in bufs if len(b))
            return views

    def _send_vec(self, views: list[memoryview], flags: int) -> int:
        """One bounded sendmsg; returns bytes sent (0 on would-block)."""
        try:
            return self.sock.sendmsg(views[:_IOV_CAP], [], flags)
        except (BlockingIOError, InterruptedError):
            return 0

    def _drain(self, views: list[memoryview], flags: int) -> int:
        """Send as much of ``views`` as the socket takes; returns bytes
        sent. With ``flags=0`` this blocks until everything is out."""
        total = sum(len(v) for v in views)
        sent = 0
        while sent < total:
            # advance past fully-sent buffers; slice the partial one
            while views and len(views[0]) == 0:
                views.pop(0)
            n = self._send_vec(views, flags)
            if n == 0 and flags:
                return sent
            sent += n
            while n and views:
                if n >= len(views[0]):
                    n -= len(views.pop(0))
                else:
                    views[0] = views[0][n:]
                    n = 0
        return sent

    # -- API -----------------------------------------------------------------
    def write(self, bufs, block: bool = True) -> bool:
        """Write ``bufs`` (an iterable of bytes-likes, or one bytes-like)
        in order. ``block=False`` returns immediately: contended or
        would-block bytes park in the backlog and are flushed by the
        next write on this connection.

        Returns True when everything (backlog included) reached the
        socket, False when bytes were parked — a nonblocking caller
        that gets False must arrange for SOME later write/flush on the
        connection, or the parked bytes sit until the next traffic."""
        if isinstance(bufs, (bytes, bytearray, memoryview)):
            bufs = [bufs]
        if block:
            with self._lock:
                views = self._take(bufs)
                self._drain(views, 0)
            return True
        if not self._lock.acquire(blocking=False):
            # a writer holds the socket: it already swapped the backlog
            # out, so parking here lands AFTER its bytes — commit order
            # is preserved. The next write on the connection flushes.
            with self._blk:
                for b in bufs:
                    self._backlog += b
            return False
        try:
            views = self._take(bufs)
            total = sum(len(v) for v in views)
            sent = self._drain(views, socket.MSG_DONTWAIT)
            if sent < total:
                # _drain advanced ``views`` in place: what remains is
                # exactly the unsent tail
                rest = b"".join(views)
                with self._blk:
                    # unsent tail goes back to the FRONT: bytes parked by
                    # other threads during this send came later
                    self._backlog[:0] = rest
                return False
            return True
        finally:
            self._lock.release()

    def flush(self) -> None:
        """Blocking drain of any backlog left by nonblocking writes."""
        self.write([], block=True)


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
