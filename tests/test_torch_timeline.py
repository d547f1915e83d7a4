"""The serving timeline (gofr_tpu_torch/observe/timeline.py) against the
JAX package's, on the CPU.

- ``chrome_trace()`` is equal on both packages for the same typed emits
  (epochs pinned), so a port trace loads in ``tools/timeline_dump.py``
  and merges with a JAX peer's; ``timeline_from_config`` reads the rows
  alike;
- tests/test_timeline.py's cases run on the port's copy: the ring, the
  rows, the exporter, a serving window on the port's engine (``tiny``
  on the CPU), the timeline off, the wide events;
- the arbiter's counter samples and instants (``hbm.set_timeline``),
  the batcher's expiry instant and the predict engine's dispatch slices
  and shed markers.
"""

from __future__ import annotations

import threading
import time
import types
from functools import partial

import jax
import numpy as np
import pytest

from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.models import LLAMA_CONFIGS as JLLAMA
from gofr_tpu.models import llama as jllama
from gofr_tpu.observe import timeline as jtimeline
from gofr_tpu_torch import resilience as pres
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.errors import DeadlineExceeded, TooManyRequests
from gofr_tpu_torch.observe import Observe, Timeline
from gofr_tpu_torch.observe import timeline as ptimeline
from gofr_tpu_torch.tpu import GenerationEngine, TorchEngine, from_jax_params
from gofr_tpu_torch.tpu import hbm
from gofr_tpu_torch.tpu.batcher import CoalescingBatcher
from _torch_port_copy import port_copy


# -- tests/test_timeline.py's cases on the port ------------------------------

P = port_copy("test_timeline.py",
              GenerationEngine=partial(GenerationEngine, device="cpu"))


@pytest.fixture(scope="module")
def tiny():
    """test_timeline.py's ``tiny``: the JAX seed-0 weights, carried."""
    cfg = JLLAMA["tiny"]
    params = jllama.init(cfg, jax.random.PRNGKey(0))
    from gofr_tpu_torch.models import LLAMA_CONFIGS

    return LLAMA_CONFIGS["tiny"], from_jax_params(
        jax.tree.map(np.asarray, params), device="cpu")


test_ring_bounded_ordered_and_drop_accounting = \
    P.test_ring_bounded_ordered_and_drop_accounting
test_ring_capacity_rounds_up_to_power_of_two = \
    P.test_ring_capacity_rounds_up_to_power_of_two
test_disabled_timeline_records_nothing = \
    P.test_disabled_timeline_records_nothing
test_disabled_timeline_does_not_preallocate_the_ring = \
    P.test_disabled_timeline_does_not_preallocate_the_ring
test_last_ms_window_filter = P.test_last_ms_window_filter
test_concurrent_append_stays_consistent = \
    P.test_concurrent_append_stays_consistent
test_timeline_from_config_knobs = P.test_timeline_from_config_knobs
test_chrome_trace_shape_and_ordering_from_known_schedule = \
    P.test_chrome_trace_shape_and_ordering_from_known_schedule
test_serving_window_exports_known_schedule = \
    P.test_serving_window_exports_known_schedule
test_timeline_off_emits_nothing_from_the_hot_path = \
    P.test_timeline_off_emits_nothing_from_the_hot_path
test_wide_event_on_finish_carries_canonical_fields = \
    P.test_wide_event_on_finish_carries_canonical_fields
test_wide_event_on_shed_and_expiry = P.test_wide_event_on_shed_and_expiry
test_wide_log_line_survives_a_raised_log_level = \
    P.test_wide_log_line_survives_a_raised_log_level
test_append_cost_is_sub_microsecond_scale = \
    P.test_append_cost_is_sub_microsecond_scale


# -- the exporter against JAX's ----------------------------------------------

def _emit_script(tl, mod, rng) -> None:
    """One seeded schedule through every typed emitter, at fixed
    monotonic stamps (the instants' own ``time.monotonic()`` reads are
    pinned through the module's ``time``)."""
    base = 1000.0
    for i in range(12):
        t0 = base + i * 0.01
        slots = tuple(int(s) for s in np.flatnonzero(rng.random(8) < 0.6))
        tl.decode_block(t0, t0 + 0.004, slots, 4)
        if i % 3 == 0:
            tl.verify_block(t0 + 0.005, t0 + 0.007, slots, 5)
        if i % 4 == 0:
            tl.prefill(t0, t0 + 0.02, i % 8, int(rng.integers(8, 512)), i,
                       "ab" * 16)
            tl.chunk(t0, t0 + 0.001, i % 8, i // 4, 512, i)
        tl.predict(t0, t0 + 0.002, "score" if i % 2 else "embed",
                   int(rng.integers(1, 9)))
        tl.dispatch_gap(t0 + 0.004, t0 + 0.0045)
    tl.pipeline_depth(2)
    tl.admit(3, "throughput", 0.0123456789, 7, "cd" * 16)
    tl.shed("generate", "latency", "ef" * 16)
    tl.expired("queue", 9)
    tl.expired("tpu-embed", count=3)
    tl.kvcache("t1", 128, 2)
    tl.hbm("engine", 1 << 30)
    tl.hbm_event("kvcache-t0", "reclaim", 4096.0)
    tl.append("custom", base, None, 1, 2, 3, 4)


def test_chrome_trace_equals_jax_for_the_same_emits(monkeypatch):
    """The same typed emits on both packages' timelines give the same
    Chrome-trace JSON (epochs pinned): the track ids, the 8-slot tuple
    and the payload conventions are JAX's."""
    traces = []
    for mod in (jtimeline, ptimeline):
        clock = iter(np.arange(2000.0, 2100.0, 0.5).tolist())
        tl = mod.Timeline(capacity=1024)
        tl._epoch_mono, tl._epoch_wall = 50.0, 1.7e9
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=lambda c=clock: next(c), time=time.time))
        _emit_script(tl, mod, np.random.default_rng(5))
        monkeypatch.undo()
        traces.append((tl.chrome_trace(), tl.stats(), tl.events()))
    assert traces[1] == traces[0]
    events = traces[1][0]["traceEvents"]
    assert {e.get("cat") for e in events} >= {
        "decode", "verify", "prefill", "chunk", "predict", "gap", "sched",
        "kvcache", "hbm", "other"}


@pytest.mark.parametrize("rows", [
    {}, {"TPU_TIMELINE": "0"}, {"TPU_TIMELINE": "on"},
    {"TPU_TIMELINE_EVENTS": "1000"}, {"TPU_TIMELINE_EVENTS": "junk"},
    {"TPU_TIMELINE": "off", "TPU_TIMELINE_EVENTS": "4"}],
    ids=["default", "off", "on", "events", "junk", "off-small"])
def test_timeline_from_config_reads_the_rows_as_jax(rows, monkeypatch):
    monkeypatch.delenv("TPU_TIMELINE", raising=False)
    j = jtimeline.timeline_from_config(JMapConfig(rows))
    p = ptimeline.timeline_from_config(MapConfig(rows))
    assert (p.enabled, p.capacity, len(p._buf)) == (
        j.enabled, j.capacity, len(j._buf))


def test_the_observe_bundle_honours_the_environment(monkeypatch):
    """Observe() outside a Container: the timeline follows the process's
    TPU_TIMELINE, as JAX's does."""
    from gofr_tpu.observe import Observe as JObserve

    for value, on in (("", True), ("0", False), ("yes", True)):
        monkeypatch.setenv("TPU_TIMELINE", value)
        assert Observe().timeline.enabled is on
        assert JObserve().timeline.enabled is on
    obs = Observe(max_events=16)
    assert obs.recorder.capacity == 16 and obs.tracer is None
    assert obs.clock.window == 64 and len(obs.requests) == 0


# -- the arbiter, the batcher and the predict engine -------------------------

@pytest.fixture
def arbiter():
    hbm.reset()
    hbm.set_timeline(None)
    yield hbm
    hbm.set_timeline(None)
    hbm.reset()


def test_the_arbiter_lands_counter_samples_and_instants(arbiter):
    """``set_timeline``: the live subsystems at attach, every accounting
    change after it, and the reclaim and shed instants; weakly held."""
    import gc

    owner = type("Owner", (), {})()
    hbm.lease("engine", 4096, owner=owner, tag="cache")
    tl = Timeline(capacity=256)
    hbm.set_timeline(tl)
    hbm.lease("kvcache-t0", 1024, owner=owner, tag="pool",
              priority=hbm.PRI_CACHE, reclaim=lambda need: 1024)
    hbm.reclaim(512)
    hbm.note_shed("engine")
    hbm.release("kvcache-t0", owner=owner, tag="pool")
    kinds = [(e[3], e[4], e[5]) for e in tl.events()]
    assert ("hbm", "engine", 4096.0) == kinds[0]
    assert ("hbm", "kvcache-t0", 1024.0) in kinds
    assert ("hbm", "kvcache-t0", 0.0) in kinds
    assert ("hbm_event", "kvcache-t0", "reclaim") in kinds
    assert ("hbm_event", "engine", "shed") in kinds
    trace = tl.chrome_trace()
    assert {e["name"] for e in trace["traceEvents"] if e.get("ph") == "C"} \
        == {"hbm:engine", "hbm:kvcache-t0"}
    hbm.release(owner=owner)
    del tl
    gc.collect()
    assert len(hbm._registry._timelines) == 0


def test_a_batcher_expiry_lands_on_the_scheduler_track():
    tl = Timeline(capacity=64)
    release = threading.Event()
    b = CoalescingBatcher(lambda items: release.wait(5.0) and items,
                          max_batch=1, max_delay=0.001, name="tpu-echo",
                          timeline=tl)
    try:
        first = threading.Thread(target=lambda: b.submit(1, timeout=10.0))
        first.start()
        time.sleep(0.05)
        with pytest.raises(DeadlineExceeded):
            b.submit(2, timeout=10.0,
                     deadline=pres.Deadline(time.monotonic() + 0.05))
        release.set()
        first.join(5.0)
    finally:
        release.set()
        b.close()
    expired = [e for e in tl.events() if e[3] == "expired"]
    assert [(e[4], e[6]) for e in expired] == [("tpu-echo", 1)]


def test_the_predict_engine_emits_dispatches_and_sheds():
    obs = Observe(timeline=Timeline(capacity=64))
    eng = TorchEngine(device="cpu", max_delay=0.001, observe=obs,
                      gate=pres.AdmissionGate(max_queue_depth=1))
    eng.register("echo", lambda p, t, lens: t, None, kind="tokens",
                 batch_buckets=(1, 2), seq_buckets=(8,))
    try:
        eng.predict("echo", np.ones(3, np.int32), timeout=10.0)
        eng._batchers["echo"].queue_depth = lambda: 5
        with pytest.raises(TooManyRequests):
            eng.predict("echo", np.ones(3, np.int32), timeout=10.0)
    finally:
        eng.close()
    kinds = [(e[3], e[4], e[5]) for e in obs.timeline.events()]
    assert kinds == [("predict", "echo", 1), ("shed", "echo", "latency")]
    off = TorchEngine(device="cpu", observe=Observe(
        timeline=Timeline(capacity=4, enabled=False)))
    try:
        assert off._tl is None
    finally:
        off.close()
