"""Deadlines, SLO classes and the admission gate on the port's engine
(gofr_tpu_torch.tpu.generator with gofr_tpu_torch.resilience) against
the JAX package's GenerationEngine on `tiny` with the same weights, on
the CPU: tests/test_slo_sched.py's engine cases, each run on both
engines with explicit ``deadline=``/``slo_class=`` arguments. The two
must agree on the outcome: which requests are served and their tokens,
the error each failed stream ends with, and where each deadline ran out
(in the queue, between lattice chunks, at a reap).

The requests a case orders are queued while the case holds the engine's
device lock, so the loop sees them all at its next pass on either
engine, whatever the machine's speed. A deadline that must run out at a
chosen moment is moved into the past there (``Deadline.at``).
"""

import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gofr_tpu.resilience as jres
import gofr_tpu_torch.resilience as pres
from gofr_tpu import chaos as jchaos
from gofr_tpu.errors import DeadlineExceeded as JDeadlineExceeded
from gofr_tpu.errors import TooManyRequests as JTooManyRequests
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.tpu import GenerationError as JGenerationError
from gofr_tpu.tpu.generator import GenerationEngine as JaxEngine
from gofr_tpu_torch import chaos
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.errors import DeadlineExceeded, TooManyRequests
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.tpu import (UNPORTED_ROWS, GenerationEngine,
                                GenerationError, from_jax_params,
                                new_engine_from_config)

JCFG = JAX_CONFIGS["tiny"]
CFG = LLAMA_CONFIGS["tiny"]
BUCKETS = (8, 16, 32)
MAX_SEQ = 256
PAGED = {"paged_blocks": 72, "paged_block_size": 8}
LAT, THR = pres.SLO_LATENCY, pres.SLO_THROUGHPUT


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JCFG, jax.random.PRNGKey(1))
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _sides(weights, gate=None, **kw):
    """The JAX engine and the port's on the same weights and rows, each
    with its own package's names; ``gate(res)``, if given, builds each
    engine's admission gate from that side's resilience module."""
    args = dict(slots=4, max_seq=MAX_SEQ, prompt_buckets=BUCKETS,
                decode_block=2)
    args.update(kw)

    def gated(res):
        return {} if gate is None else {"gate": gate(res)}

    return [
        SimpleNamespace(
            name="jax", res=jres, chaos=jchaos, Error=JGenerationError,
            Shed=JTooManyRequests, Expired=JDeadlineExceeded,
            make=lambda: JaxEngine(JCFG, weights[0], kv_dtype=jnp.int8,
                                   **args, **gated(jres))),
        SimpleNamespace(
            name="port", res=pres, chaos=chaos, Error=GenerationError,
            Shed=TooManyRequests, Expired=DeadlineExceeded,
            make=lambda: GenerationEngine(CFG, weights[1],
                                          kv_dtype=torch.int8, device="cpu",
                                          **args, **gated(pres))),
    ]


def _both(weights, case, **kw):
    """Run ``case(engine, side)`` on both engines; their outcomes, JAX's
    first. Each engine is closed after its case."""
    outs = []
    for side in _sides(weights, **kw):
        eng = side.make()
        try:
            outs.append(case(eng, side))
        finally:
            eng.close()
    return outs


def _prompt(n, seed=7):
    return np.random.default_rng(seed).integers(
        1, CFG.vocab_size, n).tolist()


def _outcome(stream):
    """A stream's tokens and how it ended: ("ok", tokens) or (the
    error's class name, tokens delivered before it)."""
    got = []
    try:
        for t in stream:
            got.append(int(t))
    except Exception as e:  # noqa: BLE001 — the class name is compared
        return type(e).__name__, got
    return "ok", got


def _wait_for(pred, timeout=20.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.005)
    return False


def _pool_whole(eng):
    st = eng.stats()
    return "paged" not in st or st["paged"]["free"] == st["paged"]["blocks"]


# -- class order, the reserve, unknown classes --------------------------------

def test_latency_request_admitted_before_earlier_throughput(weights):
    """One slot, held by a blocker: a latency request queued after a
    throughput request takes the slot first."""
    def case(eng, side):
        with eng._device_lock:
            blocker = eng.generate(_prompt(6, 1), max_new_tokens=12)
            thr = eng.generate(_prompt(6, 2), max_new_tokens=2,
                               slo_class=THR)
            lat = eng.generate(_prompt(6, 3), max_new_tokens=2,
                               slo_class=LAT)
        outs = [_outcome(s) for s in (blocker, thr, lat)]
        return outs, lat.trace["first_put"] < thr.trace["first_put"]

    jax_out, port_out = _both(weights, case, slots=1)
    assert port_out == jax_out
    outs, lat_first = port_out
    assert lat_first
    assert [o[0] for o in outs] == ["ok"] * 3
    assert [len(o[1]) for o in outs] == [12, 2, 2]


@pytest.mark.parametrize("paged", [False, True])
def test_latency_reserved_slot_blocks_throughput(weights, paged):
    """With the default one-slot reserve, throughput admissions stop at
    slots - 1: the reserved slot stays free for a latency arrival while
    throughput queues, and the queued throughput request runs only once
    a slot frees."""
    def case(eng, side):
        with eng._device_lock:
            t1 = eng.generate(_prompt(6, 1), max_new_tokens=200,
                              slo_class=THR)
            t2 = eng.generate(_prompt(6, 2), max_new_tokens=2,
                              slo_class=THR)
        assert _wait_for(lambda: eng.stats()["active"] == 1 and eng.stats()[
            "scheduler"]["queued_throughput"] == 1), eng.stats()
        lat = eng.generate(_prompt(6, 3), max_new_tokens=2)
        lat_out = _outcome(lat)
        t2_waited = t2.trace.get("first_put") is None
        t1.cancel()
        t1_out = _outcome(t1)
        return (lat_out, t2_waited, _outcome(t2), t1_out[0],
                len(t1_out[1]) < 200, _wait_for(lambda: _pool_whole(eng)))

    jax_out, port_out = _both(weights, case, slots=2,
                              **(PAGED if paged else {}))
    assert port_out == jax_out
    assert port_out[0][0] == "ok" and port_out[1] and port_out[-1]


def test_generate_rejects_unknown_slo_class(weights):
    def case(eng, side):
        with pytest.raises(side.Error, match="platinum"):
            eng.generate(_prompt(6), slo_class="platinum")
        return eng.stats()["queued"]

    assert _both(weights, case, slots=1) == [0, 0]


def test_engine_gate_sheds_throughput_first(weights):
    """A gate of depth 4 (throughput held to 2): with a blocker live and
    two latency requests queued, a throughput request sheds with a 429
    and a latency one is admitted; every admitted request is served."""
    def case(eng, side):
        blocker = eng.generate(_prompt(6, 1), max_new_tokens=24)
        assert _wait_for(lambda: eng.stats()["active"] == 1)
        with eng._device_lock:
            queued = [eng.generate(_prompt(6, 10 + i), max_new_tokens=1)
                      for i in range(2)]
            with pytest.raises(side.Shed) as ei:
                eng.generate(_prompt(6, 20), max_new_tokens=1,
                             slo_class=THR)
            ok = eng.generate(_prompt(6, 21), max_new_tokens=1,
                              slo_class=LAT)
        outs = [_outcome(s) for s in queued + [ok, blocker]]
        e = ei.value
        return (outs, e.status_code, int(e.headers["Retry-After"]) >= 1,
                dict(eng.gate.sheds_by_class),
                sorted(eng.stats()["admission"]))

    jax_out, port_out = _both(
        weights, case, slots=1,
        gate=lambda res: res.AdmissionGate(
            max_queue_depth=4, throughput_factor=0.5, name="generate"))
    assert port_out == jax_out
    assert port_out[3] == {LAT: 0, THR: 1}
    assert port_out[1] == 429
    assert [o[0] for o in port_out[0]] == ["ok"] * 4


def test_brownout_caps_the_token_budget(weights):
    """Past the brownout delay the gate caps max_new_tokens (throughput
    a band earlier); the capped streams end at the cap."""
    def case(eng, side):
        for _ in range(30):
            eng.gate.note_wait(0.15)   # between the two classes' bands
        lat = _outcome(eng.generate(_prompt(6, 1), max_new_tokens=12))
        thr = _outcome(eng.generate(_prompt(6, 2), max_new_tokens=12,
                                    slo_class=THR))
        return lat, thr, eng.gate.brownout_capped

    jax_out, port_out = _both(
        weights, case,
        gate=lambda res: res.AdmissionGate(
            max_queue_depth=100, brownout_delay=0.2, brownout_max_new=5,
            throughput_factor=0.5))
    assert port_out == jax_out
    lat, thr, capped = port_out
    assert (len(lat[1]), len(thr[1]), capped) == (12, 5, 1)


def test_ambient_scopes_reach_generate(weights):
    """Without arguments generate reads the calling thread's scopes: an
    expired ambient deadline raises before queueing, and the ambient
    class tags the stream."""
    def case(eng, side):
        res = side.res
        with res.deadline_scope(res.Deadline(time.monotonic() - 1.0)):
            with pytest.raises(side.Expired, match="before generate"):
                eng.generate(_prompt(6), max_new_tokens=2)
        with res.slo_scope(THR):
            s = eng.generate(_prompt(6), max_new_tokens=2)
        return s.slo_class, _outcome(s), eng.stats()["queued"]

    jax_out, port_out = _both(weights, case, slots=1)
    assert port_out == jax_out
    assert port_out[0] == THR and port_out[1][0] == "ok"


# -- expiry: in the queue, between lattice chunks, at a reap ------------------

def _error(stream):
    try:
        for _ in stream:
            pass
    except Exception as e:  # noqa: BLE001 — the class and text are compared
        return type(e).__name__, str(e)
    return "ok", ""


@pytest.mark.parametrize("paged", [False, True])
def test_expiry_in_the_queue_dispatches_no_prefill(weights, paged):
    """A request whose deadline runs out while it waits behind a busy
    slot fails with DeadlineExceeded naming the wait, and is never
    prefilled; the blocker ahead of it is served whole."""
    def case(eng, side):
        with eng._device_lock:
            blocker = eng.generate(_prompt(6, 1), max_new_tokens=10)
            victim = eng.generate(_prompt(6, 2), max_new_tokens=4,
                                  deadline=side.res.Deadline.after(0.05))
            time.sleep(0.1)
        kind, msg = _error(victim)
        return (_outcome(blocker), kind, "admission queue" in msg,
                victim.where, victim.trace.get("admit"),
                eng.stats()["total_requests"],
                _wait_for(lambda: _pool_whole(eng)))

    jax_out, port_out = _both(weights, case, slots=1,
                              **(PAGED if paged else {}))
    assert port_out == jax_out
    assert port_out[1:] == ("DeadlineExceeded", True, "queue", None, 1, True)


@pytest.mark.parametrize("paged", [False, True])
def test_expiry_drops_half_prefilled_request(weights, paged):
    """A deadline that runs out mid-lattice stops the remaining chunks:
    the stream fails with DeadlineExceeded naming the prefilled length,
    the slot (paged: its blocks) comes back, and the engine keeps
    serving. A latency rule on the chunk seam pins the lattice far past
    the deadline, so expiry fires between chunks."""
    def case(eng, side):
        sched = side.chaos.ChaosSchedule(seed=0).on(
            side.chaos.GENERATOR_CHUNK, latency=0.05)
        with side.chaos.scope(sched):
            stream = eng.generate(_prompt(120), max_new_tokens=8,
                                  deadline=side.res.Deadline.after(0.15))
            kind, msg = _error(stream)
        after = _outcome(eng.generate(_prompt(6, 5), max_new_tokens=3))
        free = _wait_for(lambda: all(s.free for s in eng._slots)
                         and _pool_whole(eng))
        return kind, "prefilled" in msg, stream.where, after, free

    jax_out, port_out = _both(weights, case, prefill_chunk=8,
                              **(PAGED if paged else {}))
    assert port_out == jax_out
    assert port_out[:3] == ("DeadlineExceeded", True, "mid-prefill")
    assert port_out[3][0] == "ok" and port_out[4]


@pytest.mark.parametrize("mode", ["contiguous", "paged", "paged-spec"])
def test_expiry_mid_decode_with_blocks_in_flight(weights, mode):
    """A decoding stream whose deadline runs out while blocks (depth 2)
    are in flight, or a verify pass is (a spec engine), retires at the
    next reap: DeadlineExceeded naming the tokens it got, those a prefix
    of its stream without a deadline; the tokens of blocks still in
    flight for it are dropped, the stream beside it is served whole and
    the pool comes back."""
    rep = [7, 9, 7, 9, 7, 9, 7, 9, 7, 9]   # prompt-lookup drafts hit

    def case(eng, side):
        prompt = rep if mode == "paged-spec" else _prompt(6, 2)
        full = eng.generate(prompt, max_new_tokens=40).tokens()
        dl = side.res.Deadline.after(3600.0)
        box, depth = {}, []
        admit = eng._admit_inflight

        def tripping(inflight):
            victim = box.get("victim")
            if not depth and any(
                    s.request is not None and s.request.stream is victim
                    and s.generated >= 6 for s in eng._slots):
                depth.append(eng._depth_now)
                dl.at = time.monotonic() - 1.0   # runs out now
            return admit(inflight)

        eng._admit_inflight = tripping
        with eng._device_lock:
            companion = eng.generate(_prompt(6, 3), max_new_tokens=30)
            box["victim"] = eng.generate(prompt, max_new_tokens=40,
                                         deadline=dl)
        victim = box["victim"]
        got = _outcome(victim)
        return (got[0], full[:len(got[1])] == got[1], len(got[1]) >= 6,
                victim.where, _outcome(companion),
                _wait_for(lambda: _pool_whole(eng)), depth)

    kw = dict(slots=2, decode_pipeline=2)
    if mode != "contiguous":
        kw.update(PAGED)
    if mode == "paged-spec":
        kw.update(spec_decode_k=3)
    jax_out, port_out = _both(weights, case, **kw)
    assert port_out[:-1] == jax_out[:-1]
    assert port_out[:4] == ("DeadlineExceeded", True, True, "mid-decode")
    assert port_out[4][0] == "ok" and port_out[5]
    assert port_out[-1] == [1 if mode == "paged-spec" else 2]


def test_expiries_are_counted_by_where(weights):
    """The port counts each expiry where its deadline ran out; the App's
    metrics get one ``app_tpu_expired_dropped_total`` each."""
    from gofr_tpu import metrics as gmetrics

    m = gmetrics.Manager()
    gmetrics.register_framework_metrics(m)
    eng = GenerationEngine(CFG, weights[1], kv_dtype=torch.int8,
                           device="cpu", slots=1, max_seq=MAX_SEQ,
                           prompt_buckets=BUCKETS, decode_block=2,
                           metrics=m)
    try:
        with pytest.raises(DeadlineExceeded):
            eng.generate(_prompt(6), deadline=pres.Deadline.after(-1.0))
        with eng._device_lock:
            blocker = eng.generate(_prompt(6, 1), max_new_tokens=4)
            victim = eng.generate(_prompt(6, 2), max_new_tokens=4,
                                  deadline=pres.Deadline.after(0.02))
            time.sleep(0.05)
        assert _outcome(blocker)[0] == "ok"
        assert _error(victim)[0] == "DeadlineExceeded"
        assert eng.stats()["expired"] == {"pre-queue": 1, "queue": 1,
                                          "mid-prefill": 0, "mid-decode": 0,
                                          "post-handoff": 0}
        text = m.render_prometheus()
        assert any(line.startswith("app_tpu_expired_dropped_total")
                   and line.endswith(" 2.0") for line in text.splitlines())
    finally:
        eng.close()


# -- stats, the depth policy, drain, the rows ---------------------------------

def test_stats_surface_scheduler_state(weights):
    def case(eng, side):
        st = eng.stats()
        sched = st["scheduler"]
        return (sched["prefill_chunk"], sched["chunk_interleave"],
                sched["latency_reserved_slots"], sched["queued_latency"],
                sched["queued_throughput"], st["draining"],
                sorted(st["admission"]), st["admission"]["enabled"])

    jax_out, port_out = _both(
        weights, case, prefill_chunk=16, slo_latency_slots=2,
        gate=lambda res: res.AdmissionGate(max_queue_depth=8))
    assert port_out == jax_out
    assert port_out[:6] == (16, True, 2, 0, 0, False)


def test_target_depth_drops_to_one_while_a_latency_request_waits(weights):
    """The pipeline's depth policy gets its latency fact: a queued
    throughput request leaves depth 2, a queued latency request pins 1."""
    def case(eng, side):
        blocker = eng.generate(_prompt(6, 1), max_new_tokens=16)
        assert _wait_for(lambda: eng.stats()["active"] == 1)
        with eng._device_lock:
            idle = eng._target_depth()
            thr = eng.generate(_prompt(6, 2), max_new_tokens=2,
                               slo_class=THR)
            with_thr = eng._target_depth()
            lat = eng.generate(_prompt(6, 3), max_new_tokens=2)
            with_lat = (eng._target_depth(),
                        eng.stats()["scheduler"]["pipeline"]["target_depth"])
        outs = [_outcome(s) for s in (blocker, thr, lat)]
        return idle, with_thr, with_lat, outs, eng._target_depth()

    jax_out, port_out = _both(weights, case, slots=1, decode_pipeline=2)
    assert port_out == jax_out
    assert port_out[:3] == (2, 2, (1, 1)) and port_out[-1] == 2


def test_drain_finishes_accepted_streams_and_refuses_new_ones(weights):
    """drain() refuses new requests (generate raises, stats say so) and
    serves every accepted one, live and queued, before it returns
    True."""
    def case(eng, side):
        with eng._device_lock:
            live = [eng.generate(_prompt(6, i), max_new_tokens=12)
                    for i in range(6)]       # 4 slots: 2 queued
        result = {}
        t = threading.Thread(target=lambda: result.update(
            drained=eng.drain(30.0)))
        t.start()
        assert _wait_for(lambda: eng.stats()["draining"])
        with pytest.raises(side.Error, match="draining"):
            eng.generate(_prompt(6), max_new_tokens=2)
        outs = [_outcome(s) for s in live]
        t.join(30.0)
        assert not t.is_alive()
        return result["drained"], outs, eng.stats()["draining"]

    jax_out, port_out = _both(weights, case)
    assert port_out == jax_out
    drained, outs, draining = port_out
    assert drained and draining
    assert [(o[0], len(o[1])) for o in outs] == [("ok", 12)] * 6


SLO_ROWS = {"TPU_MAX_QUEUE_DEPTH": "16", "TPU_MAX_QUEUE_DELAY": "0.5",
            "TPU_BROWNOUT_DELAY": "0.2", "TPU_BROWNOUT_MAX_NEW": "8",
            "TPU_SLO_THROUGHPUT_FACTOR": "0.25",
            "TPU_SLO_THROUGHPUT_SHARE": "0.5", "TPU_SLO_LATENCY_SLOTS": "2"}


def test_new_engine_from_config_honours_the_slo_rows():
    assert not set(SLO_ROWS) & set(UNPORTED_ROWS)
    eng = new_engine_from_config(MapConfig(
        {"TPU_MODEL": "tiny", "TPU_SLOTS": "4", "TPU_MAX_SEQ": "64",
         **SLO_ROWS}), device="cpu")
    try:
        gen = eng.generator
        gate = gen.gate
        assert (gate.max_queue_depth, gate.max_queue_delay,
                gate.brownout_delay, gate.brownout_max_new,
                gate.throughput_factor, gate.name) == \
            (16, 0.5, 0.2, 8, 0.25, "generate")
        assert gen._lat_reserve == 2 and gen._pending._weight == 1
        assert gen.stats()["admission"]["max_queue_depth"] == 16
    finally:
        eng.close()
    plain = new_engine_from_config(MapConfig(
        {"TPU_MODEL": "tiny", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "64"}),
        device="cpu")
    try:
        assert plain.generator.gate is None
        assert "admission" not in plain.generator.stats()
    finally:
        plain.close()


@pytest.mark.parametrize("row", ["TPU_SLO_BATCH_SHARE", "TPU_SLO_BATCH_DELAY"])
def test_the_batch_class_rows_still_raise(row):
    """The batch class rows are honoured since the predict path was
    ported: they shape the class lines of the score program's batcher
    (TPU_SLO_BATCH_DELAY alone leaves one FIFO line, as in JAX). A row
    of a feature still outside the port, set beside them, still raises
    with its name."""
    eng = new_engine_from_config(MapConfig({"TPU_MODEL": "tiny", row: "0.5",
                                            "TPU_SLOTS": "2",
                                            "TPU_MAX_SEQ": "64"}),
                                 device="cpu")
    try:
        policy = eng._batchers["score"].class_policy
        if row == "TPU_SLO_BATCH_SHARE":
            assert policy.throughput_share == 0.5
        else:
            assert policy is None
    finally:
        eng.close()
    with pytest.raises(ValueError, match="TPU_HBM_DEVICE_BUDGET_MB"):
        new_engine_from_config(MapConfig({"TPU_MODEL": "tiny", row: "0.5",
                                          "TPU_HBM_DEVICE_BUDGET_MB": "16"}),
                               device="cpu")
