"""The port's serving policies (gofr_tpu_torch.resilience, errors) held
to the JAX package's: every case of the JAX package's gate, deadline and
SLO-class tests runs over both modules, and the port's class-aware
pending line picks in the JAX engine's order under one scripted
sequence of puts, pops (with and without the latency-slot reserve) and
push-fronts."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import gofr_tpu.errors as jerrors
import gofr_tpu.resilience as jres
import gofr_tpu_torch.errors as perrors
import gofr_tpu_torch.resilience as pres
from gofr_tpu import metrics as gmetrics
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.tpu.generator import _ClassPending as JClassPending
from gofr_tpu.tpu.generator import _Request as JRequest
from gofr_tpu_torch.config import MapConfig as PMapConfig
from gofr_tpu_torch.tpu.generator import _ClassPending as PClassPending
from gofr_tpu_torch.tpu.generator import _Request as PRequest

SIDES = {
    "jax": SimpleNamespace(res=jres, errors=jerrors, MapConfig=JMapConfig,
                           Pending=JClassPending, Request=JRequest),
    "port": SimpleNamespace(res=pres, errors=perrors, MapConfig=PMapConfig,
                            Pending=PClassPending, Request=PRequest),
}


@pytest.fixture(params=sorted(SIDES))
def side(request):
    return SIDES[request.param]


def _metrics():
    m = gmetrics.Manager()
    gmetrics.register_framework_metrics(m)
    return m


def _counter(m, name: str) -> float:
    total = 0.0
    for line in m.render_prometheus().splitlines():
        if line.startswith(name) and not line.startswith("#"):
            total += float(line.rsplit(" ", 1)[1])
    return total


# -- deadlines ----------------------------------------------------------------

def test_parse_http_timeout_units_and_garbage(side):
    parse = side.res.parse_http_timeout
    assert parse("0.05") == pytest.approx(0.05)
    assert parse("50ms") == pytest.approx(0.05)
    assert parse("250us") == pytest.approx(250e-6)
    assert parse("2s") == pytest.approx(2.0)
    assert parse("1m") == pytest.approx(60.0)
    assert parse("  5S ") == pytest.approx(5.0)
    for bad in (None, "", "soon", "-3", "0", "12q"):
        assert parse(bad) is None


def test_deadline_budget_and_expiry(side):
    dl = side.res.Deadline.after(0.05)
    assert not dl.expired()
    assert 0 < dl.remaining() <= 0.05
    assert dl.budget(10.0) <= 0.05
    assert dl.budget(0.01) == pytest.approx(0.01, abs=1e-3)
    time.sleep(0.06)
    assert dl.expired() and dl.remaining() <= 0


def test_deadline_scope_is_ambient_and_keeps_tighter(side):
    res = side.res
    assert res.current_deadline() is None
    outer = res.Deadline.after(0.05)
    with res.deadline_scope(outer):
        assert res.current_deadline() is outer
        with res.deadline_scope(res.Deadline.after(60.0)) as inner:
            assert inner is outer and res.current_deadline() is outer
        loose = res.Deadline.after(0.001)
        with res.deadline_scope(loose):
            assert res.current_deadline() is loose
        assert res.current_deadline() is outer
    assert res.current_deadline() is None


def test_deadline_scope_is_per_thread(side):
    res = side.res
    seen = []
    with res.deadline_scope(res.Deadline.after(1.0)):
        t = threading.Thread(target=lambda: seen.append(
            res.current_deadline()))
        t.start()
        t.join(10)
    assert not t.is_alive()
    assert seen == [None]


# -- SLO classes --------------------------------------------------------------

def test_parse_slo_class_defaults_to_latency(side):
    res = side.res
    assert res.SLO_CLASSES == (res.SLO_LATENCY, res.SLO_THROUGHPUT)
    for val in (None, "", "interactive", "typo-throughputt"):
        assert res.parse_slo_class(val) == res.SLO_LATENCY
    for alias in ("throughput", "Batch", " BULK ", "offline",
                  "best-effort"):
        assert res.parse_slo_class(alias) == res.SLO_THROUGHPUT


def test_slo_scope_ambient_and_nesting(side):
    res = side.res
    assert res.current_slo_class() == res.SLO_LATENCY
    with res.slo_scope(res.SLO_THROUGHPUT):
        assert res.current_slo_class() == res.SLO_THROUGHPUT
        with res.slo_scope(None):  # None inherits
            assert res.current_slo_class() == res.SLO_THROUGHPUT
        with res.slo_scope(res.SLO_LATENCY):  # explicit nested class wins
            assert res.current_slo_class() == res.SLO_LATENCY
        assert res.current_slo_class() == res.SLO_THROUGHPUT
    assert res.current_slo_class() == res.SLO_LATENCY


# -- the admission gate -------------------------------------------------------

def test_gate_sheds_throughput_first_on_depth(side):
    res = side.res
    gate = res.AdmissionGate(max_queue_depth=8, throughput_factor=0.5)
    gate.admit(4, slo_class=res.SLO_LATENCY)
    with pytest.raises(side.errors.TooManyRequests):
        gate.admit(4, slo_class=res.SLO_THROUGHPUT)
    gate.admit(7, slo_class=res.SLO_LATENCY)
    with pytest.raises(side.errors.TooManyRequests):
        gate.admit(8, slo_class=res.SLO_LATENCY)
    assert gate.sheds_by_class[res.SLO_THROUGHPUT] == 1
    assert gate.sheds_by_class[res.SLO_LATENCY] == 1


def test_gate_sheds_throughput_first_on_delay(side):
    res = side.res
    gate = res.AdmissionGate(max_queue_delay=0.1, throughput_factor=0.5)
    for _ in range(50):
        gate.note_wait(0.08)
    gate.admit(1, slo_class=res.SLO_LATENCY)
    with pytest.raises(side.errors.TooManyRequests):
        gate.admit(1, slo_class=res.SLO_THROUGHPUT)


def test_gate_brownout_caps_throughput_first(side):
    res = side.res
    gate = res.AdmissionGate(max_queue_depth=100, brownout_delay=0.1,
                             brownout_max_new=8, throughput_factor=0.5)
    for _ in range(50):
        gate.note_wait(0.08)
    assert gate.cap_tokens(64, res.SLO_LATENCY) == 64
    assert gate.cap_tokens(64, res.SLO_THROUGHPUT) == 8
    for _ in range(50):
        gate.note_wait(0.2)
    assert gate.cap_tokens(64, res.SLO_LATENCY) == 8
    assert gate.stats()["brownout_active"] is True


def test_gate_brownout_clears_for_silent_class(side):
    res = side.res
    gate = res.AdmissionGate(max_queue_depth=100, brownout_delay=0.1,
                             brownout_max_new=4, throughput_factor=0.5)
    for _ in range(50):
        gate.note_wait(0.08)
    assert gate.cap_tokens(64, res.SLO_THROUGHPUT) == 4
    assert gate.stats()["brownout_active"] is True
    for _ in range(80):
        gate.note_wait(0.0)
    assert gate.cap_tokens(64, res.SLO_LATENCY) == 64
    assert gate._brownout_on[res.SLO_THROUGHPUT] is False
    assert gate.stats()["brownout_active"] is False


def test_gate_factor_one_is_class_blind(side):
    res = side.res
    gate = res.AdmissionGate(max_queue_depth=4, throughput_factor=1.0)
    gate.admit(3, slo_class=res.SLO_THROUGHPUT)
    for cls in (res.SLO_THROUGHPUT, res.SLO_LATENCY):
        with pytest.raises(side.errors.TooManyRequests):
            gate.admit(4, slo_class=cls)


def test_gate_depth_shed_carries_retry_after(side):
    m = _metrics()
    gate = side.res.AdmissionGate(max_queue_depth=4, name="g", metrics=m)
    gate.admit(3)
    with pytest.raises(side.errors.TooManyRequests) as ei:
        gate.admit(4)
    e = ei.value
    assert e.status_code == 429
    assert e.retry_after is not None and e.retry_after > 0
    assert int(e.headers["Retry-After"]) >= 1
    assert "X-Shed-Reason" not in e.headers
    assert gate.sheds == 1
    assert _counter(m, "app_tpu_shed_total") == 1.0


def test_gate_delay_shed_uses_wait_ewma(side):
    gate = side.res.AdmissionGate(max_queue_delay=0.05, name="g")
    gate.admit(100)  # no wait signal yet
    for _ in range(20):
        gate.note_wait(0.5)
    with pytest.raises(side.errors.TooManyRequests):
        gate.admit(1)
    gate.admit(0)  # an empty queue always admits
    assert gate.estimated_wait > 0.05


def test_gate_disabled_admits_everything(side):
    gate = side.res.AdmissionGate()
    assert not gate.enabled
    gate.admit(10**6)


def test_gate_brownout_caps_token_budget(side):
    m = _metrics()
    gate = side.res.AdmissionGate(max_queue_depth=1000, brownout_delay=0.05,
                                  brownout_max_new=16, name="g", metrics=m)
    assert gate.cap_tokens(128) == 128
    for _ in range(20):
        gate.note_wait(0.2)
    assert gate.cap_tokens(128) == 16
    assert gate.cap_tokens(8) == 8
    assert gate.stats()["brownout_active"] is True
    assert _counter(m, "app_tpu_brownout_capped_total") == 1.0
    for _ in range(40):
        gate.note_wait(0.0)
    assert gate.cap_tokens(128) == 128
    assert gate.stats()["brownout_active"] is False


def test_gate_shed_memory_is_a_typed_429(side):
    res = side.res
    gate = res.AdmissionGate(max_queue_depth=4, name="g")
    err = gate.shed_memory(program="generate", slo_class=res.SLO_THROUGHPUT,
                           retry_after=2.5, trace_id="ab" * 16)
    assert isinstance(err, side.errors.TooManyRequests)
    assert err.status_code == 429 and err.reason == "hbm"
    assert err.headers == {"Retry-After": "3", "X-Shed-Reason": "hbm"}
    assert gate.sheds_by_class == {res.SLO_LATENCY: 0,
                                   res.SLO_THROUGHPUT: 1}


def test_deadline_exceeded_is_a_504(side):
    e = side.errors.DeadlineExceeded()
    assert e.status_code == 504 and str(e) == "deadline exceeded"
    assert side.errors.format_retry_after(90.4) == "91"
    assert side.errors.format_retry_after(0.0) == "1"


def _gate_script(res, errors):
    """One scripted sequence through a gate: admits and sheds of both
    classes at rising depths, waits fed in, brownout caps; what it
    returned at each step, and the gate's stats."""
    gate = res.AdmissionGate(max_queue_depth=6, max_queue_delay=0.2,
                             brownout_delay=0.1, brownout_max_new=10,
                             throughput_factor=0.5, name="generate")
    seen = []
    rng = np.random.default_rng(5)
    for step in range(60):
        gate.note_wait(float(rng.uniform(0.0, 0.3)))
        cls = res.SLO_THROUGHPUT if step % 3 else res.SLO_LATENCY
        depth = int(rng.integers(0, 8))
        try:
            gate.admit(depth, program="generate", slo_class=cls)
            seen.append(("admit", gate.cap_tokens(40, slo_class=cls)))
        except errors.TooManyRequests as e:
            seen.append(("shed", e.headers["Retry-After"]))
    return seen, gate.stats()


def test_gates_agree_under_one_script():
    assert _gate_script(pres, perrors) == _gate_script(jres, jerrors)


@pytest.mark.parametrize("rows,want", [
    ({}, None),
    ({"TPU_MAX_QUEUE_DEPTH": "16"}, (16, 0.0, 0.0, 32, 0.5)),
    ({"TPU_MAX_QUEUE_DELAY": "0.25", "TPU_SLO_THROUGHPUT_FACTOR": "0.3"},
     (0, 0.25, 0.0, 32, 0.3)),
    ({"TPU_BROWNOUT_DELAY": "0.1", "TPU_BROWNOUT_MAX_NEW": "8"},
     (0, 0.0, 0.1, 8, 0.5)),
])
def test_gate_from_config_reads_the_rows(side, rows, want):
    gate = side.res.gate_from_config(side.MapConfig(rows), "generate")
    if want is None:
        assert gate is None
        return
    assert (gate.max_queue_depth, gate.max_queue_delay, gate.brownout_delay,
            gate.brownout_max_new, gate.throughput_factor) == want
    assert gate.name == "generate"


# -- the class-aware pending line ---------------------------------------------

def _req(side, cls, tag=None):
    r = object.__new__(side.Request)
    r.slo_class = cls
    r.lattice_peek = tag
    return r


def test_class_pending_prefers_latency_with_antistarvation(side):
    res = side.res
    q = side.Pending(throughput_share=0.25)
    for _ in range(6):
        q.put(_req(side, res.SLO_THROUGHPUT))
    for _ in range(20):
        q.put(_req(side, res.SLO_LATENCY))
    order = [q.get_nowait().slo_class for _ in range(12)]
    assert order == ([res.SLO_LATENCY] * 3 + [res.SLO_THROUGHPUT]) * 3


@pytest.mark.parametrize("share,want", [(0.75, "TTTLLL"), (0.0, "LLLLLT")])
def test_class_pending_share_extremes(side, share, want):
    """Shares past 1/2 floor toward throughput-first; 0 drains
    throughput only when no latency request waits."""
    res = side.res
    q = side.Pending(throughput_share=share)
    n_thr = want.count("T")
    for _ in range(n_thr):
        q.put(_req(side, res.SLO_THROUGHPUT))
    for _ in range(len(want) - n_thr):
        q.put(_req(side, res.SLO_LATENCY))
    order = "".join("T" if q.get_nowait().slo_class == res.SLO_THROUGHPUT
                    else "L" for _ in range(len(want)))
    assert order == want


def test_class_pending_put_front_restores_head_and_streak(side):
    res = side.res
    q = side.Pending(throughput_share=0.25)   # weight 3
    t = _req(side, res.SLO_THROUGHPUT)
    q.put(t)
    for _ in range(6):
        q.put(_req(side, res.SLO_LATENCY))
    for _ in range(3):
        assert q.get_nowait().slo_class == res.SLO_LATENCY
    got = q.get_nowait()
    assert got is t
    q.put_front(got)
    assert q.get_nowait() is t
    assert [q.get_nowait().slo_class for _ in range(3)] == \
        [res.SLO_LATENCY] * 3
    assert q.empty() and q.qsize() == 0


def _pending_script(side):
    """One scripted sequence of puts of both classes, pops with and
    without the reserve's ``allow_throughput``, push-fronts of the latest
    pop and requeues at the back; returns the tags in pick order (None
    for an empty pick) and the line's sizes along the way."""
    res = side.res
    rng = np.random.default_rng(11)
    q = side.Pending(throughput_share=0.25)
    out, n, last = [], 0, None
    for _ in range(400):
        op = rng.integers(0, 10)
        if op < 4:
            cls = res.SLO_THROUGHPUT if rng.integers(0, 3) else res.SLO_LATENCY
            q.put(_req(side, cls, n))
            n += 1
        elif op < 8:
            try:
                last = q.get_nowait(allow_throughput=bool(rng.integers(0, 4)))
                out.append(last.lattice_peek)
            except Exception as e:  # noqa: BLE001 — queue.Empty on both
                out.append(type(e).__name__)
                last = None
        elif op == 8 and last is not None:
            q.put_front(last)
            last = None
        elif last is not None:
            q.put(last)
            last = None
        out.append((q.qsize(), q.qsize_class(res.SLO_LATENCY),
                    q.qsize_class(res.SLO_THROUGHPUT), q.empty()))
    return out


def test_class_pending_picks_in_the_jax_order():
    got = _pending_script(SIDES["port"])
    assert got == _pending_script(SIDES["jax"])
    assert "Empty" in got and sum(isinstance(x, int) for x in got) > 100
