"""Request-coalescing batcher (the port's own copy of
gofr_tpu/tpu/batcher.py, its Python condition-variable line).

Handler threads block in ``submit()``; one dispatcher thread coalesces
whatever is queued into the largest ready batch and runs it, so the
card's utilization scales with offered load while the latency of a lone
request stays one ``max_delay`` away from a solo dispatch.

Dispatch policy (deadline-based flush):
  - flush at once when ``max_batch`` items are waiting;
  - otherwise flush when the OLDEST waiting item has waited ``max_delay``;
  - an idle queue sleeps on a condition variable (no spinning).

SLO-class scheduling (``class_policy``): with a ``ClassPolicy`` the wait
line splits in two. Latency-class items flush on ``max_delay`` and fill
batches first; throughput-class items tolerate ``throughput_delay`` and
are picked up through a reserved share of each batch, so saturating
latency traffic never starves them. Items are tagged per request
(``submit(slo_class=...)``, defaulted from the ambient class).

Deadlines: an item whose deadline expires while it waits is dropped
unexecuted and counted through ``on_expired``; a waiter that times out
reaps its item, so the runner never executes it.

Device memory: a runner that raises a device out-of-memory error
(``hbm.is_oom_error``: ``torch.OutOfMemoryError`` among them) gets one
reclaim pass of the memory arbiter (every reclaimable lease asked, the
caching allocator's free blocks given back) and the SAME batch retried
once; a second failure sheds the batch with ``TooManyRequests`` (429,
``Retry-After: 1``, counted as the arbiter's ``batcher`` shed) rather
than a 500.

The runner receives a list of payloads and returns a list of results of
the same length; a runner error is raised in every submitting thread of
that batch. The JAX package's native FIFO line (its C scheduler) is not
ported: this is its Python line.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Sequence

import torch

from .. import chaos
from ..errors import DeadlineExceeded, TooManyRequests
from ..resilience import SLO_LATENCY, SLO_THROUGHPUT, current_slo_class
from . import hbm
from .hbm import is_oom_error

__all__ = ["BatchItem", "BatcherClosed", "ClassPolicy", "CoalescingBatcher",
           "is_oom_error", "pad_bucket"]


@dataclasses.dataclass(frozen=True)
class ClassPolicy:
    """Per-SLO-class dispatch policy for a CoalescingBatcher.

    throughput_delay: seconds the oldest THROUGHPUT item may wait
        before it alone forces a flush (None -> 4x the batcher's
        max_delay).
    throughput_share: fraction of each full batch reserved for waiting
        throughput items (>= 1 slot) when latency traffic would
        otherwise fill it. 0 disables the reserve.
    """

    throughput_delay: float | None = None
    throughput_share: float = 0.25

    def reserve(self, max_batch: int) -> int:
        if self.throughput_share <= 0:
            return 0
        return max(1, int(max_batch * min(self.throughput_share, 1.0)))


class BatchItem:
    __slots__ = ("payload", "result", "error", "done", "enqueued_at",
                 "deadline", "cancelled", "claimed", "slo_class")

    def __init__(self, payload: Any, deadline=None,
                 slo_class: str = SLO_LATENCY):
        self.payload = payload
        self.slo_class = slo_class
        self.result: Any = None
        self.error: BaseException | None = None
        self.done = threading.Event()
        self.enqueued_at = time.monotonic()
        # resilience.Deadline or None; an expired item is dropped at
        # dispatch, never executed
        self.deadline = deadline
        # both guarded by the batcher lock: ``cancelled`` -- the waiter
        # stopped waiting, so nothing may deliver into the item or
        # overwrite the error it raised; ``claimed`` -- the item is inside
        # a dispatched batch and can no longer be reaped from the line
        self.cancelled = False
        self.claimed = False


class BatcherClosed(RuntimeError):
    pass


def _reclaim() -> None:
    """Before the retry: one reclaim pass of the memory arbiter over
    every reclaimable lease (the transient deficit is unknowable), then
    the caching allocator's free blocks back to the card, where the
    reclaimed tensors went."""
    hbm.reclaim()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


class CoalescingBatcher:
    """Coalesce concurrent ``submit`` calls into batched ``runner`` calls.

    runner:    Callable[[list[payload]], Sequence[result]]
    max_batch: hard cap per dispatch (the largest batch bucket).
    max_delay: seconds the oldest request may wait before a partial flush.
    """

    def __init__(self, runner: Callable[[list], Sequence], max_batch: int,
                 max_delay: float = 0.005, name: str = "batcher",
                 on_dispatch: Callable[[int, float], None] | None = None,
                 on_queue_depth: Callable[[int], None] | None = None,
                 on_expired: Callable[[int], None] | None = None,
                 class_policy: ClassPolicy | None = None,
                 timeline=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.runner = runner
        self.max_batch = max_batch
        self.max_delay = max_delay
        self.name = name
        # serving timeline (observe/timeline.py): an expiry lands as a
        # scheduler instant, so a trace shows why a queued item never
        # dispatched (None: emission off)
        self._timeline = timeline
        self.class_policy = class_policy
        self._thr: list[BatchItem] = []
        self._thr_delay = (max_delay * 4 if class_policy is None
                           or class_policy.throughput_delay is None
                           else class_policy.throughput_delay)
        self.on_dispatch = on_dispatch  # (batch_size, oldest_wait_s)
        self.on_expired = on_expired    # (n_dropped,): expired, unexecuted
        self.on_queue_depth = on_queue_depth  # (queued_items,)
        self._queue: list[BatchItem] = []
        # expired items dropped under the lock, reported outside it
        self._expired_pending = 0
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._closed = False
        self._thread = threading.Thread(target=self._loop,
                                        name=f"gofr-{name}", daemon=True)
        self._thread.start()

    def queue_depth(self) -> int:
        """Items waiting for a dispatch right now."""
        return len(self._queue) + len(self._thr)

    def _report_depth(self) -> None:
        if self.on_queue_depth is not None:
            try:
                self.on_queue_depth(self.queue_depth())
            except Exception:
                pass  # telemetry must never take the batcher down

    # -- producer side -------------------------------------------------------
    def submit(self, payload: Any, timeout: float | None = None,
               deadline=None, slo_class: str | None = None) -> Any:
        """Block until the batched result for ``payload`` is ready.

        ``deadline`` (resilience.Deadline) tightens the wait to the
        caller's remaining budget and rides on the item, so the
        dispatcher drops it unexecuted if it expires while queued.
        ``slo_class`` defaults to the ambient class; with a
        ``class_policy`` it selects the item's wait line."""
        if deadline is not None:
            if deadline.expired():
                self._count_expired(1)
                raise DeadlineExceeded(
                    f"{self.name}: deadline expired before enqueue")
            timeout = deadline.budget(timeout)
        if slo_class is None:
            slo_class = current_slo_class()
        item = BatchItem(payload, deadline=deadline, slo_class=slo_class)
        with self._lock:
            if self._closed:
                raise BatcherClosed(f"{self.name} is closed")
            self._line_for(item).append(item)
            self._nonempty.notify()
        self._report_depth()
        if not item.done.wait(timeout):
            err = self._abandon(item, timeout)
            if err is not None:
                raise err
        if item.error is not None:
            raise item.error
        return item.result

    def _abandon(self, item: BatchItem,
                 timeout: float | None) -> BaseException | None:
        """The waiter's timeout fired. Under the lock: if the dispatcher
        already finished the item, return None and use the result;
        otherwise mark it cancelled and reap it from its line, so the
        runner never executes it. A claimed item cannot be reaped; the
        cancelled flag keeps ``_run_one`` from delivering into it."""
        with self._lock:
            if item.done.is_set():
                return None
            item.cancelled = True
            if not item.claimed:
                try:
                    self._line_for(item).remove(item)
                except ValueError:
                    pass
            if item.deadline is not None and item.deadline.expired():
                # reaped here rather than by the dispatcher: still an
                # expired item dropped without execution
                expired = not item.claimed
                item.error = DeadlineExceeded(
                    f"{self.name}: deadline expired after "
                    f"{time.monotonic() - item.enqueued_at:.3f}s in queue")
            else:
                expired = False
                item.error = TimeoutError(
                    f"{self.name}: no result in {timeout}s")
            item.done.set()
            err = item.error
        if expired:
            self._count_expired(1)
        self._report_depth()
        return err

    def _count_expired(self, n: int) -> None:
        if n <= 0:
            return
        if self._timeline is not None:
            try:
                self._timeline.expired(self.name, count=n)
            except Exception:
                pass  # telemetry must never take the batcher down
        if self.on_expired is not None:
            try:
                self.on_expired(n)
            except Exception:
                pass  # telemetry must never take the batcher down

    # -- dispatcher ----------------------------------------------------------
    def _line_for(self, item: BatchItem) -> list:
        """Class-split only under a policy; without one every class
        shares the FIFO line."""
        if self.class_policy is not None \
                and item.slo_class == SLO_THROUGHPUT:
            return self._thr
        return self._queue

    def _prune_locked(self) -> None:
        """Drop cancelled and expired items from the wait lines (lock
        held). Expired items fail with DeadlineExceeded; their count is
        reported later, outside the lock (``_flush_expired``)."""
        n_expired = 0
        for line in (self._queue, self._thr):
            keep: list[BatchItem] = []
            for it in line:
                if it.cancelled:
                    continue
                if it.deadline is not None and it.deadline.expired():
                    it.error = DeadlineExceeded(
                        f"{self.name}: deadline expired after "
                        f"{time.monotonic() - it.enqueued_at:.3f}s in queue")
                    it.done.set()
                    n_expired += 1
                    continue
                keep.append(it)
            if len(keep) != len(line):
                line[:] = keep
        self._expired_pending += n_expired

    def _flush_expired(self) -> None:
        with self._lock:
            n, self._expired_pending = self._expired_pending, 0
        self._count_expired(n)

    def _take_batch(self) -> list[BatchItem] | None:
        """Wait for a flush condition; pop up to max_batch live items
        (None on close). Expired and cancelled items are pruned BEFORE
        the flush decision, so a dead head of line never triggers a
        dispatch of its own. Under a policy each class's oldest item is
        judged against its own delay bound."""
        with self._lock:
            while True:
                if self._queue or self._thr:
                    self._prune_locked()
                    if not (self._queue or self._thr) \
                            and self._expired_pending:
                        return []   # report the pruned count now
                if self._queue or self._thr:
                    now = time.monotonic()
                    lat_wait = (now - self._queue[0].enqueued_at
                                if self._queue else None)
                    thr_wait = (now - self._thr[0].enqueued_at
                                if self._thr else None)
                    if (len(self._queue) + len(self._thr) >= self.max_batch
                            or (lat_wait is not None
                                and lat_wait >= self.max_delay)
                            or (thr_wait is not None
                                and thr_wait >= self._thr_delay)):
                        return self._compose_locked()
                    waits = []
                    if lat_wait is not None:
                        waits.append(self.max_delay - lat_wait)
                    if thr_wait is not None:
                        waits.append(self._thr_delay - thr_wait)
                    self._nonempty.wait(max(min(waits), 0.0))
                elif self._closed:
                    return None
                else:
                    self._nonempty.wait()

    def _compose_locked(self) -> list[BatchItem]:
        """Pop one dispatch's items (lock held): latency head first, up
        to ``max_batch`` minus the throughput reserve (which binds only
        while throughput items wait), then throughput, then latency
        backfill. Without a policy this is the FIFO take."""
        B = self.max_batch
        reserve = (self.class_policy.reserve(B)
                   if self.class_policy is not None and self._thr else 0)
        n_lat = min(len(self._queue), B - min(reserve, len(self._thr)))
        n_thr = min(len(self._thr), B - n_lat)
        batch = self._queue[:n_lat] + self._thr[:n_thr]
        del self._queue[:n_lat]
        del self._thr[:n_thr]
        for it in batch:
            it.claimed = True
        return batch

    def _run_one(self, batch: list[BatchItem], oldest_wait: float) -> None:
        if self.on_dispatch is not None:
            try:
                self.on_dispatch(len(batch), oldest_wait)
            except Exception:
                pass
        payloads = [it.payload for it in batch]
        try:
            try:
                chaos.fire(chaos.BATCHER_DISPATCH)
                results = self.runner(payloads)
            except BaseException as e:
                if not is_oom_error(e):
                    raise
                # the programs are pure, so the same batch may run again
                _reclaim()
                try:
                    results = self.runner(payloads)
                except BaseException as e2:
                    if not is_oom_error(e2):
                        raise
                    hbm.note_shed("batcher")
                    raise TooManyRequests(
                        f"{self.name}: device memory exhausted after "
                        "reclaim and retry -- shed", retry_after=1.0) from e2
            if len(results) != len(batch):
                raise RuntimeError(
                    f"{self.name}: runner returned {len(results)} results "
                    f"for a batch of {len(batch)}")
            for it, res in zip(batch, results):
                if it.cancelled:
                    continue  # the waiter already raised
                it.result = res
                it.done.set()
        except BaseException as e:  # noqa: BLE001 -- every waiter must wake
            for it in batch:
                if it.cancelled:
                    continue
                it.error = e
                it.done.set()

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            self._flush_expired()
            if batch is None:
                return
            self._report_depth()
            if batch:
                # the true oldest may be a throughput item picked up
                # through the reserve
                oldest = min(it.enqueued_at for it in batch)
                self._run_one(batch, time.monotonic() - oldest)

    def close(self, drain: bool = True) -> None:
        """Stop taking items. ``drain``: the queued items still run;
        otherwise they fail with BatcherClosed."""
        with self._lock:
            self._closed = True
            pending: list[BatchItem] = []
            if not drain:
                pending, self._queue = self._queue, []
                pending += self._thr
                self._thr = []
            self._nonempty.notify_all()
        for it in pending:
            if it.cancelled:
                continue  # the waiter already raised
            it.error = BatcherClosed(f"{self.name} closed")
            it.done.set()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "CoalescingBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def pad_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest configured bucket >= n (clamped to the largest)."""
    for b in sorted(buckets):
        if b >= n:
            return b
    return max(buckets)
