"""The port's coalescing batcher (gofr_tpu_torch.tpu.batcher) held to the
JAX package's (gofr_tpu.tpu.batcher, on its Python condition-variable
line): the JAX package's batcher cases -- coalescing, the delay flush,
runner errors, close, pad_bucket, expired items dropped unexecuted,
abandoned items reaped, the class lines -- run over both packages, and
the BATCHER_DISPATCH chaos seam fires in both. The out-of-memory branch
is the port's own: a runner that raises ``torch.OutOfMemoryError`` once
is retried with the same batch, twice sheds the batch with a 429.
"""

import threading
import time
from types import SimpleNamespace

import pytest
import torch

import gofr_tpu.chaos as jchaos
import gofr_tpu.errors as jerrors
import gofr_tpu.resilience as jres
import gofr_tpu.tpu.batcher as jbatcher
import gofr_tpu_torch.chaos as pchaos
import gofr_tpu_torch.errors as perrors
import gofr_tpu_torch.resilience as pres
import gofr_tpu_torch.tpu.batcher as pbatcher


def _jax_batcher(runner, **kw):
    return jbatcher.CoalescingBatcher(runner, use_native=False, **kw)


SIDES = {
    "jax": SimpleNamespace(mod=jbatcher, res=jres, errors=jerrors,
                           chaos=jchaos, make=_jax_batcher),
    "port": SimpleNamespace(mod=pbatcher, res=pres, errors=perrors,
                            chaos=pchaos, make=pbatcher.CoalescingBatcher),
}


@pytest.fixture(params=sorted(SIDES))
def side(request):
    return SIDES[request.param]


def _wait_for(pred, timeout=2.0):
    end = time.monotonic() + timeout
    while not pred() and time.monotonic() < end:
        time.sleep(0.001)
    return pred()


# -- coalescing, the delay flush, errors, close (tests/test_tpu.py) -----------

def test_batcher_coalesces_concurrent_submits(side):
    seen_batches = []

    def runner(items):
        seen_batches.append(len(items))
        time.sleep(0.01)
        return [x * 2 for x in items]

    with side.make(runner, max_batch=8, max_delay=0.05) as b:
        results = [None] * 16

        def worker(i):
            results[i] = b.submit(i)
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert results == [i * 2 for i in range(16)]
    assert max(seen_batches) > 1  # concurrency actually coalesced
    assert all(s <= 8 for s in seen_batches)


def test_batcher_deadline_flush_and_errors(side):
    def runner(items):
        if any(x < 0 for x in items):
            raise ValueError("bad item")
        return items

    b = side.make(runner, max_batch=64, max_delay=0.005)
    t0 = time.monotonic()
    assert b.submit(7) == 7  # a partial batch flushes on its delay
    assert time.monotonic() - t0 < 1.0
    with pytest.raises(ValueError):
        b.submit(-1)
    b.close()
    with pytest.raises(side.mod.BatcherClosed):
        b.submit(1)


def test_pad_bucket(side):
    pad = side.mod.pad_bucket
    assert pad(1, (1, 2, 4)) == 1
    assert pad(3, (1, 2, 4)) == 4
    assert pad(9, (1, 2, 4)) == 4  # clamps at the largest


def test_many_threads_each_get_their_own_result(side):
    """A stress case: 96 submitting threads (more than the cores) with a
    short switch interval; every item runs exactly once and every
    waiter gets its own result."""
    import sys

    runs, lock = [], threading.Lock()

    def runner(items):
        with lock:
            runs.extend(items)
        return [x * 3 for x in items]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with side.make(runner, max_batch=8, max_delay=0.001) as b:
            results = [None] * 96

            def worker(i):
                results[i] = b.submit(i, timeout=30.0)
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(96)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30.0)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert results == [i * 3 for i in range(96)]
    assert sorted(runs) == list(range(96))


def test_every_waiter_of_a_failed_batch_wakes_with_its_error(side):
    """A runner error reaches every submitting thread of its batch."""
    release = threading.Event()

    def runner(items):
        release.wait(5.0)
        raise RuntimeError(f"device fault in a batch of {len(items)}")

    b = side.make(runner, max_batch=4, max_delay=0.2)
    errors = []

    def one(i):
        try:
            b.submit(i, timeout=10.0)
        except RuntimeError as e:
            errors.append(str(e))
    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    assert _wait_for(lambda: b.queue_depth() == 0)
    release.set()
    for t in threads:
        t.join(5.0)
    b.close()
    assert errors == ["device fault in a batch of 4"] * 4


def test_close_without_drain_fails_the_queued_items(side):
    release = threading.Event()
    executed = []

    def runner(items):
        executed.extend(items)
        release.wait(5.0)
        return items

    b = side.make(runner, max_batch=1, max_delay=0.001)
    box = {}

    def submit(tag):
        try:
            box[tag] = b.submit(tag, timeout=10.0)
        except Exception as e:  # noqa: BLE001
            box[tag] = e
    held = threading.Thread(target=submit, args=("A",))
    held.start()
    assert _wait_for(lambda: executed == ["A"])
    queued = threading.Thread(target=submit, args=("B",))
    queued.start()
    assert _wait_for(lambda: b.queue_depth() == 1)
    threading.Timer(0.05, release.set).start()
    b.close(drain=False)
    held.join(5.0)
    queued.join(5.0)
    assert box["A"] == "A"
    assert isinstance(box["B"], side.mod.BatcherClosed)
    assert executed == ["A"]


# -- expiry and abandonment (tests/test_resilience.py) ------------------------

def test_batcher_drops_expired_item_without_executing(side):
    """An item whose deadline expires while queued fails with
    DeadlineExceeded and NEVER reaches the runner."""
    executed = []
    release = threading.Event()

    def runner(items):
        executed.extend(items)
        release.wait(5.0)
        return items

    expired_counts = []
    b = side.make(runner, max_batch=4, max_delay=0.001,
                  on_expired=expired_counts.append)
    try:
        occupier = threading.Thread(
            target=lambda: b.submit("A", timeout=10.0), daemon=True)
        occupier.start()
        assert _wait_for(lambda: "A" in executed)
        assert executed == ["A"]
        t0 = time.monotonic()
        with pytest.raises(side.errors.DeadlineExceeded):
            b.submit("B", timeout=10.0,
                     deadline=side.res.Deadline.after(0.03))
        assert time.monotonic() - t0 < 1.0  # failed at its deadline, fast
        release.set()
        occupier.join(timeout=5.0)
        assert b.submit("C", timeout=5.0) == "C"  # still serving
        assert "B" not in executed
        assert sum(expired_counts) == 1
        assert b.queue_depth() == 0  # nothing leaked
    finally:
        release.set()
        b.close(drain=False)


def test_batcher_prune_path_counts_outside_waiter(side):
    """The dispatcher's own prune drops an expired item, fails it with
    DeadlineExceeded and reports the count, with no waiter around."""
    counts = []
    b = side.make(lambda items: items, max_batch=4, max_delay=0.001,
                  on_expired=counts.append)
    try:
        dead = side.mod.BatchItem(
            "zombie", deadline=side.res.Deadline(time.monotonic() - 1.0))
        with b._lock:
            b._queue.append(dead)
            b._nonempty.notify()
        assert dead.done.wait(2.0)
        assert isinstance(dead.error, side.errors.DeadlineExceeded)
        assert _wait_for(lambda: bool(counts))
        assert sum(counts) == 1
        assert b.submit("live", timeout=5.0) == "live"
    finally:
        b.close(drain=False)


def test_batcher_rejects_already_expired_submit(side):
    b = side.make(lambda items: items, max_batch=2)
    try:
        with pytest.raises(side.errors.DeadlineExceeded):
            b.submit("x", deadline=side.res.Deadline(time.monotonic() - 1.0))
    finally:
        b.close(drain=False)


def test_batcher_timeout_reaps_abandoned_item(side):
    """A timed-out waiter's item leaves the line and is never executed
    by a later dispatch."""
    executed = []
    release = threading.Event()

    def runner(items):
        executed.extend(items)
        release.wait(5.0)
        return items

    b = side.make(runner, max_batch=4, max_delay=0.001)
    try:
        occupier = threading.Thread(
            target=lambda: b.submit("A", timeout=10.0), daemon=True)
        occupier.start()
        assert _wait_for(lambda: "A" in executed)
        with pytest.raises(TimeoutError):
            b.submit("B", timeout=0.05)
        assert b.queue_depth() == 0  # reaped, not leaked
        release.set()
        occupier.join(timeout=5.0)
        assert b.submit("C", timeout=5.0) == "C"
        assert "B" not in executed
    finally:
        release.set()
        b.close(drain=False)


def test_batcher_timeout_of_claimed_item_keeps_waiter_error(side):
    """A waiter that times out while its item is inside a dispatched
    batch keeps its TimeoutError: the runner's later completion does
    not overwrite it."""
    release = threading.Event()

    def runner(items):
        release.wait(5.0)
        return [it.upper() for it in items]

    b = side.make(runner, max_batch=2, max_delay=0.001)
    try:
        with pytest.raises(TimeoutError):
            b.submit("a", timeout=0.05)
        release.set()
        assert b.submit("b", timeout=5.0) == "B"
    finally:
        release.set()
        b.close(drain=False)


# -- the class lines (tests/test_slo_sched.py) --------------------------------

def _run_batcher(side, policy, submissions, max_batch=4, max_delay=0.004,
                 hold_first=0.0):
    """Drive a batcher with ``submissions`` = [(id, class, delay_s)];
    returns the dispatched batches (lists of ids) in order."""
    batches, lock = [], threading.Lock()

    def runner(items):
        with lock:
            batches.append(list(items))
        if hold_first and len(batches) == 1:
            time.sleep(hold_first)
        return items

    b = side.make(runner, max_batch=max_batch, max_delay=max_delay,
                  class_policy=policy)
    threads = []
    for rid, cls, delay in submissions:
        time.sleep(delay)
        t = threading.Thread(
            target=lambda r=rid, c=cls: b.submit(r, timeout=10, slo_class=c))
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=15)
    b.close()
    return batches


def test_latency_dispatches_before_earlier_throughput(side):
    """A throughput item queued FIRST still yields the batch head to
    latency items that arrive within the same flush window."""
    L, T = side.res.SLO_LATENCY, side.res.SLO_THROUGHPUT
    batches = _run_batcher(
        side, side.mod.ClassPolicy(throughput_delay=5.0,
                                   throughput_share=0.25),
        [("T", T, 0.0), ("L1", L, 0.001), ("L2", L, 0.0)],
        max_batch=2, max_delay=0.05)
    first = batches[0]
    assert first[0] in ("L1", "L2") and len(first) == 2
    assert "T" in first  # the reserve hands throughput its slot


def test_throughput_reserve_survives_latency_saturation(side):
    """With latency traffic saturating every batch, the reserve share
    still drains the throughput line. The first dispatch holds the
    runner while both lines fill, so the next batch is 3 latency items
    and the reserved throughput slot."""
    L, T = side.res.SLO_LATENCY, side.res.SLO_THROUGHPUT
    subs = [("L0", L, 0.0), ("T", T, 0.01)]
    subs += [(f"L{i}", L, 0.0) for i in range(1, 12)]
    batches = _run_batcher(
        side, side.mod.ClassPolicy(throughput_delay=30.0,
                                   throughput_share=0.25),
        subs, max_batch=4, max_delay=0.004, hold_first=0.05)
    assert any("T" in b for b in batches)
    picked = next(b for b in batches if "T" in b)
    assert sum(1 for x in picked if x != "T") == 3


def test_throughput_solo_flushes_on_its_own_delay(side):
    t0 = time.monotonic()
    batches = _run_batcher(
        side, side.mod.ClassPolicy(throughput_delay=0.05,
                                   throughput_share=0.25),
        [("T", side.res.SLO_THROUGHPUT, 0.0)], max_batch=8, max_delay=0.002)
    assert batches == [["T"]]
    assert time.monotonic() - t0 >= 0.04  # the throughput window


def test_classless_batcher_ignores_slo_tags(side):
    batches = _run_batcher(
        side, None,
        [("T", side.res.SLO_THROUGHPUT, 0.0),
         ("L", side.res.SLO_LATENCY, 0.002)],
        max_batch=2, max_delay=0.05)
    assert batches[0] == ["T", "L"]


def test_the_ambient_class_picks_the_line(side):
    """Without ``slo_class=`` a submit takes the ambient class: under a
    throughput scope the item waits the throughput delay."""
    batches = []
    b = side.make(lambda items: batches.append(list(items)) or items,
                  max_batch=8, max_delay=0.002,
                  class_policy=side.mod.ClassPolicy(throughput_delay=0.08))
    try:
        t0 = time.monotonic()
        with side.res.slo_scope(side.res.SLO_THROUGHPUT):
            assert b.submit("T", timeout=5.0) == "T"
        assert time.monotonic() - t0 >= 0.07
        t0 = time.monotonic()
        assert b.submit("L", timeout=5.0) == "L"
        assert time.monotonic() - t0 < 0.07
    finally:
        b.close()
    assert batches == [["T"], ["L"]]


# -- the dispatch seam and the out-of-memory branch ---------------------------

def test_the_dispatch_seam_fails_one_batch(side):
    """An error injected at BATCHER_DISPATCH fails that batch's waiter
    and the batcher serves the next one; a latency rule slows each
    dispatch."""
    seams = side.chaos
    executed = []
    sched = seams.ChaosSchedule(seed=5).on(
        seams.BATCHER_DISPATCH, error=RuntimeError, every=1, limit=1)
    b = side.make(lambda items: executed.extend(items) or items,
                  max_batch=2, max_delay=0.001)
    try:
        with seams.scope(sched):
            with pytest.raises(RuntimeError):
                b.submit("a", timeout=5.0)
            assert b.submit("b", timeout=5.0) == "b"
        assert executed == ["b"]
        assert sched.stats()["errors_fired"] == {seams.BATCHER_DISPATCH: 1}
        slow = seams.ChaosSchedule(seed=5).on(seams.BATCHER_DISPATCH,
                                              latency=0.05)
        with seams.scope(slow):
            t0 = time.monotonic()
            assert b.submit("c", timeout=5.0) == "c"
            assert time.monotonic() - t0 >= 0.05
    finally:
        b.close()


def _oom_runner(failures: int, calls: list):
    def runner(items):
        calls.append(list(items))
        if len(calls) <= failures:
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return [x + 1 for x in items]
    return runner


def test_an_out_of_memory_dispatch_is_retried_once():
    calls = []
    b = pbatcher.CoalescingBatcher(_oom_runner(1, calls), max_batch=2,
                                   max_delay=0.001)
    try:
        assert b.submit(1, timeout=5.0) == 2
    finally:
        b.close()
    assert calls == [[1], [1]]  # the same batch, twice


def test_a_second_out_of_memory_sheds_the_batch_with_429():
    calls = []
    b = pbatcher.CoalescingBatcher(_oom_runner(2, calls), max_batch=2,
                                   max_delay=0.001)
    try:
        with pytest.raises(perrors.TooManyRequests) as ei:
            b.submit(1, timeout=5.0)
        assert ei.value.status_code == 429
        assert ei.value.headers["Retry-After"] == "1"
        assert isinstance(ei.value.__cause__, torch.OutOfMemoryError)
        assert b.submit(5, timeout=5.0) == 6  # still serving
    finally:
        b.close()
    assert calls == [[1], [1], [5]]
    assert pbatcher.is_oom_error(torch.cuda.OutOfMemoryError("x"))
    # the memory arbiter's classifier, JAX's: a RuntimeError counts by an
    # out-of-memory marker in its message, nothing else does
    assert not pbatcher.is_oom_error(RuntimeError("device lost"))
    assert not pbatcher.is_oom_error(ValueError("out of memory"))
