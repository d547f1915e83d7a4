"""Transport primitives: the port's own copy of gofr_tpu/wire.py, shared
by the gRPC transport (grpcx) and the App's HTTP streamer.

  SocketWriter -- vectored (``sendmsg``) frame writes with an ordered
      backlog, so a producer thread can hand bytes to the wire without
      ever blocking on the socket or on another writer. One syscall
      carries many frames; partial or contended writes park in the
      backlog and ride out with the next write. ``backlog_bytes`` is
      the parked total, which ``observe_backlog`` exports as a gauge
      and the P/D ship window (pd/protocol) bounds.
  Outbox -- an ordered multi-producer send queue drained by whichever
      thread is available (thread-combining), never by a dedicated
      flusher thread: a fused decode block delivering K tokens back to
      back coalesces into one vectored write.
  PushStream / MappedStream -- a queue-backed item stream with an
      optional zero-handoff sink: when a consumer registers one, the
      producing thread delivers items straight into the consumer's send
      path instead of waking a reader thread. GenStream
      (tpu/generator) extends PushStream, which is how first-token
      bytes go from the serving loop's ``_deliver`` to the socket
      without an intermediate thread; ``GenStream.map`` gives one
      source a per-consumer transform (gRPC messages, HTTP ndjson
      lines).

Everything here is stdlib-only and transport-agnostic; grpcx frames,
HTTP chunked encoding and the P/D KV-ship frames (pd/) sit on top.
"""

from __future__ import annotations

import collections
import queue
import socket
import threading
import time

from .errors import ConnectionLost

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
        so any stream that *ends* with a blocking write (gRPC trailers,
        the terminal HTTP chunk) leaves the wire fully flushed.
    """

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._lock = threading.Lock()   # serializes actual socket sends
        self._blk = threading.Lock()    # guards _backlog and _closed
        self._backlog = bytearray()
        self._closed = False

    # -- internals -----------------------------------------------------------
    def _take(self, bufs) -> list[memoryview]:
        """Swap out the backlog and append ``bufs`` — the commit point."""
        with self._blk:
            if self._closed:
                raise ConnectionLost("connection closed")
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
                if self._closed:
                    raise ConnectionLost("connection closed")
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

    @property
    def backlog_bytes(self) -> int:
        """Bytes parked by nonblocking writes and not yet on the wire:
        the flow-control signal a windowed producer (the P/D KV-ship
        path) bounds itself against, instead of letting the backlog grow
        without limit behind a stalled peer."""
        with self._blk:
            return len(self._backlog)

    def close(self) -> None:
        with self._blk:
            self._closed = True
            self._backlog.clear()
        try:
            # shutdown BEFORE close: it wakes a writer blocked in sendmsg
            # (close alone would deadlock behind the in-progress syscall)
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def observe_backlog(metrics, backlog_bytes: int, **labels) -> None:
    """Export one outbox-backlog sample (``app_tpu_wire_backlog_bytes``,
    labelled by the caller's role): the flow-control signal
    ``backlog_bytes`` tracks, made scrapeable so a stalled peer shows on
    a dashboard before it shows as a deadline storm. Swallows every
    failure: telemetry must never take a send path down."""
    if metrics is None:
        return
    try:
        metrics.set_gauge("app_tpu_wire_backlog_bytes",
                          float(backlog_bytes), **labels)
    except Exception:  # noqa: BLE001 — telemetry only
        pass


class Outbox:
    """Ordered send queue with thread-combining flush.

    Producers ``append()`` then ``pump(block=False)`` — which never
    blocks the producer; whichever thread wins the flusher role drains
    everything pending (its own items plus anything other threads
    appended meanwhile) in FIFO order. The owning worker thread calls
    ``pump(block=True)`` to clear stalls and at end-of-stream.

    ``drain(batch, block)`` is the send callback: it consumes a PREFIX
    of ``batch`` and returns how many items it consumed. A blocking
    drain must consume the whole batch; a nonblocking drain may stop
    early (no flow-control credit), which sets ``stalled`` so the
    producer can stop fast-pathing.
    """

    def __init__(self, drain):
        self._drain_cb = drain
        self._items: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._flushing = False
        self.stalled = False

    def append(self, item) -> None:
        with self._lock:
            self._items.append(item)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def pump(self, block: bool = False) -> None:
        while True:
            with self._lock:
                if self._flushing:
                    if not block:
                        return   # the active flusher will see our items
                    busy = True
                else:
                    if not self._items:
                        return
                    self._flushing = True
                    busy = False
            if busy:
                # a nonblocking flusher is mid-drain; it is brief — yield
                # once and retake (only blocking pumps ever spin here)
                time.sleep(0)
                continue
            try:
                while True:
                    with self._lock:
                        batch = list(self._items)
                    if not batch:
                        break
                    n = self._drain_cb(batch, block)
                    with self._lock:
                        for _ in range(n):
                            self._items.popleft()
                    if n < len(batch):
                        self.stalled = True
                        return
                    self.stalled = False
            finally:
                with self._lock:
                    self._flushing = False
            # items appended between the final emptiness check and the
            # flag clear are picked up by looping (no lost wakeup)


# sentinel a producer-side sink can enqueue (PushStream.wake) to rouse
# the consuming worker without delivering an item — e.g. "the outbox
# stalled with your bytes in it, come flush". Iterating consumers that
# never call wake() never see it.
WAKE = object()


class PushStream:
    """Queue-backed item stream with an optional zero-handoff sink.

    Producer side calls ``_push(item)``; ``None`` ends the stream and a
    queued ``BaseException`` re-raises in the consumer. When a consumer
    registers a sink, items are handed to it ON THE PRODUCING THREAD;
    the sink returns True to consume or False to fall back to the queue
    (the consumer's iterator). Terminal items always go to the queue so
    the consuming thread observes the end.

    A decline is PERMANENT: the first False detaches the sink and every
    later item rides the queue. This is what makes the ordering
    guarantee structural — if a sink could decline item N and accept
    item N+1, the producing thread would write N+1 to the wire while N
    waited for the consumer thread. (In-tree sinks downgrade themselves
    on any obstacle anyway; the detach enforces it for everyone.)

    The sink MUST be non-blocking and exception-free in spirit: a sink
    that raises is dropped (the stream falls back to queue delivery)
    rather than killing the producer.
    """

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
                self._sink = None  # declines are permanent (see class doc)
            self._q.put(item)

    def set_sink(self, sink) -> None:
        """Register ``sink`` and drain already-queued items through it
        under the delivery lock, so delivery order is preserved across
        the registration boundary. Terminal items (and everything after
        a declined item) stay queued for the iterator."""
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
        inside a sink callback (no locks taken)."""
        self._q.put(WAKE)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def map(self, fn) -> "MappedStream":
        return MappedStream(self, fn)


class MappedStream:
    """A PushStream view with a per-item transform — lets one source
    serve different consumers (gRPC messages, HTTP ndjson chunks)
    while keeping the zero-handoff sink protocol intact."""

    def __init__(self, source, fn):
        self._source = source
        self._fn = fn

    def set_sink(self, sink) -> None:
        fn = self._fn
        self._source.set_sink(lambda item: sink(fn(item)))

    def clear_sink(self) -> None:
        cs = getattr(self._source, "clear_sink", None)
        if cs is not None:
            cs()

    def __iter__(self):
        for item in self._source:
            yield item if item is WAKE else self._fn(item)

    def map(self, fn) -> "MappedStream":
        return MappedStream(self, fn)

    def wake(self) -> None:
        w = getattr(self._source, "wake", None)
        if w is not None:
            w()

    def cancel(self) -> None:
        c = getattr(self._source, "cancel", None)
        if c is not None:
            c()

    @property
    def trace(self):
        """TTFT decomposition stamps of the underlying source (GenStream
        sets ``first_put``), for the transport's grpc.handoff span."""
        return getattr(self._source, "trace", None)
