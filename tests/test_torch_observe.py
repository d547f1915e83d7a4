"""The flight recorder, the clock, the profiler, the /debug pages and the
engine's emission on the port (gofr_tpu_torch/observe, tpu/generator.py)
against the JAX package, on the CPU.

- the recorder, the clock and ``render_collapsed`` on the same seeded
  script in both packages;
- tests/test_observe.py's cases on the port's copy (its App built with
  ``device="cpu"``): the registry, the recorder, the profiler, the
  /debug pages and a whole generation through the App;
- the JAX engine and the port's on ``tiny`` (f32, the same weights),
  each with an ``Observe``, over a bucket prompt, a lattice prompt, a
  shed and an expiry in the queue: the recorder's events and fields
  (times aside), the timeline's kinds and payloads and the wide events'
  keys in order are equal, and so are the greedy tokens, which the
  timeline does not change;
- fault 13: without an ``Observe`` the port's engine feeds
  ``app_tpu_dispatch_gap_duration``, ``app_tpu_pipeline_depth`` and
  ``app_tpu_request_segment_duration`` and logs JAX's wide ``request``
  line, field for field;
- ``/debug/vars``' keys against JAX's, the profiler's limits and its
  samples of a live engine's serving loop.
"""

from __future__ import annotations

import io
import json
import threading
import time
import urllib.error
import urllib.request
from collections import Counter
from functools import partial
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import gofr_tpu
import gofr_tpu.resilience as jres
import gofr_tpu_torch
import gofr_tpu_torch.resilience as pres
from gofr_tpu import glog as jglog
from gofr_tpu import metrics as jmetrics
from gofr_tpu import observe as jobserve
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.errors import TooManyRequests as JTooManyRequests
from gofr_tpu.models import LLAMA_CONFIGS as JLLAMA
from gofr_tpu.models import llama as jllama
from gofr_tpu.observe import clock as jclock
from gofr_tpu.observe import profiler as jprofiler
from gofr_tpu.tpu.generator import GenerationEngine as JaxEngine
from gofr_tpu_torch import glog as pglog
from gofr_tpu_torch import metrics as pmetrics
from gofr_tpu_torch import observe as pobserve
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.errors import TooManyRequests
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.observe import clock as pclock
from gofr_tpu_torch.observe import profiler as pprofiler
from gofr_tpu_torch.serving import install_generate
from gofr_tpu_torch.tpu import GenerationEngine, from_jax_params
from _torch_port_copy import port_copy


# -- tests/test_observe.py's cases on the port -------------------------------

P = port_copy("test_observe.py",
              App=partial(gofr_tpu_torch.App, device="cpu"))
app = P.app
test_registry_add_update_remove = P.test_registry_add_update_remove
test_recorder_ring_buffer_and_filters = \
    P.test_recorder_ring_buffer_and_filters
test_recorder_rejects_bad_capacity = P.test_recorder_rejects_bad_capacity
test_profiler_collapsed_stacks_capture_a_named_thread = \
    P.test_profiler_collapsed_stacks_capture_a_named_thread
test_debug_requests_shows_inflight_http_request = \
    P.test_debug_requests_shows_inflight_http_request
test_debug_index_and_pprof_profile = P.test_debug_index_and_pprof_profile
test_debug_events_bad_request_id_is_400 = \
    P.test_debug_events_bad_request_id_is_400
test_debug_cache_without_engine_reports_disabled = \
    P.test_debug_cache_without_engine_reports_disabled
test_metrics_endpoint_content_negotiation = \
    P.test_metrics_endpoint_content_negotiation
test_debug_events_html_renders_seq_and_trace_id = \
    P.test_debug_events_html_renders_seq_and_trace_id
test_debug_timeline_page_serves_chrome_trace = \
    P.test_debug_timeline_page_serves_chrome_trace
test_full_app_generation_flight_recorder_and_telemetry = \
    P.test_full_app_generation_flight_recorder_and_telemetry
_get = P._get


# -- the recorder, the clock and the profiler's text against JAX's ----------

def _recorder_script(mod, rng) -> list:
    rec = mod.FlightRecorder(capacity=16)
    for i in range(40):
        kind = ("submitted", "admitted", "first_token", "finished",
                "request")[int(rng.integers(0, 5))]
        rid = int(rng.integers(0, 6))
        rec.record(kind, request_id=rid if kind != "request" or i % 2
                   else None, trace_id=("ab" * 16) if i % 3 else "",
                   tokens=int(rng.integers(0, 64)), slot=i % 4)
    out = [rec.stats()]
    for kw in ({}, {"limit": 0}, {"limit": 5}, {"event": "request"},
               {"request_id": 3}, {"since_seq": 30},
               {"event": "finished", "request_id": 2, "limit": 2}):
        out.append([{k: v for k, v in e.items() if k != "ts"}
                    for e in rec.events(**kw)])
    return out


def test_the_recorder_matches_jax_on_one_script():
    outs = [_recorder_script(mod, np.random.default_rng(9))
            for mod in (jobserve, pobserve)]
    assert outs[1] == outs[0]


def test_the_clock_matches_jax_on_one_script(monkeypatch):
    """The same NTP samples on both packages' registries (the monotonic
    clock pinned): offsets, round trips, uncertainty, ages, peers."""
    outs = []
    for mod in (jclock, pclock):
        now = [100.0]
        monkeypatch.setattr(mod, "time", SimpleNamespace(
            monotonic=lambda: now[0], time=time.time))
        reg = mod.ClockRegistry(window=4)
        rng = np.random.default_rng(13)
        for i in range(12):
            t0 = 1.7e9 + i
            send, recv = rng.uniform(0.0005, 0.02, 2)
            t1 = t0 + send + 0.25
            reg.observe("replica:a" if i % 2 else "decode:b", t0, t1,
                        t1 + 0.001, t0 + send + recv + 0.001,
                        debug_url=f"http://127.0.0.1:{9000 + i % 2}")
            now[0] += 0.5
        reg.observe("decode:b", 5.0, 4.0, 4.0, 4.5)   # negative rtt: dropped
        reg.note_peer("gw", debug_url="http://127.0.0.1:1")
        now[0] += 30.0
        out = {"stats": reg.stats(),
               "to_local": reg.peer("replica:a").to_local(1.8e9),
               "aligned": {n: p.aligned for n, p in reg.peers().items()}}
        monkeypatch.undo()
        outs.append(out)
    assert outs[1] == outs[0]
    assert outs[1]["stats"]["replica:a"]["samples"] == 4
    assert outs[1]["aligned"]["gw"] is False


def test_render_collapsed_and_sample_once_match_jax():
    rng = np.random.default_rng(17)
    frames = ["loop (a.py:1)", "reap (b.py:2)", "wait (c.py:3)",
              "serve (d.py:4)"]
    counts = Counter()
    for _ in range(200):
        depth = int(rng.integers(1, 5))
        stack = ";".join(frames[int(i)] for i in rng.integers(0, 4, depth))
        counts["gofr-torch-gen;" + stack] += int(rng.integers(1, 4))
    assert pprofiler.render_collapsed(counts) \
        == jprofiler.render_collapsed(counts)
    assert pprofiler.render_collapsed(Counter()) == ""
    me = threading.get_ident()
    names = {me: "the-test"}
    for mod in (jprofiler, pprofiler):
        stacks = [s for s in mod.sample_once(thread_names=names)
                  if s.startswith("the-test;")]
        assert len(stacks) == 1 and "test_render_collapsed" in stacks[0]


# -- the engines' emission, side by side -------------------------------------

BUCKETS = (8, 16, 32)
TRACEPARENTS = [f"00-{'%032x' % (0x1234 + i)}-{'%016x' % (0x99 + i)}-01"
                for i in range(4)]
TIME_KEYS = {"ts", "wait_s", "ttft_s", "duration_s", "tokens_per_s",
             "queue_wait_s", "submit_wall_s"}


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JLLAMA["tiny"], jax.random.PRNGKey(1))
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _sides(weights):
    args = dict(slots=2, max_seq=256, prompt_buckets=BUCKETS,
                decode_block=2, decode_pipeline=1)
    return [
        SimpleNamespace(
            name="jax", res=jres, obs=jobserve, glog=jglog,
            metrics=jmetrics, Shed=JTooManyRequests,
            make=lambda **kw: JaxEngine(JLLAMA["tiny"], weights[0],
                                        **args, **kw)),
        SimpleNamespace(
            name="port", res=pres, obs=pobserve, glog=pglog,
            metrics=pmetrics, Shed=TooManyRequests,
            make=lambda **kw: GenerationEngine(LLAMA_CONFIGS["tiny"],
                                               weights[1], device="cpu",
                                               **args, **kw)),
    ]


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        1, LLAMA_CONFIGS["tiny"].vocab_size, n).tolist()


def _wide_lines(buf) -> list:
    out = []
    for line in buf.getvalue().splitlines():
        try:
            msg = json.loads(line).get("message")
        except ValueError:
            continue
        if isinstance(msg, dict) and msg.get("event") == "request":
            out.append(msg)
    return out


def _timeless(d: dict, ids: dict) -> list:
    """An event's (key, value) pairs in order, times blanked, request
    ids as submission indices and the breakdown as its segment names."""
    out = []
    for k, v in d.items():
        if k in TIME_KEYS and v is not None:
            v = "t"
        elif k == "request_id":
            v = ids.get(v, v)
        elif k == "breakdown":
            v = list(v)
        out.append((k, v))
    return out


def _payloads(events, ids: dict) -> list:
    """The timeline's kinds and payloads in order, times and the
    arbiter's, depth and gap samples aside (they follow allocations and
    the host's clock, not the schedule)."""
    out = []
    for _, _, _, kind, a, b, c, d in events:
        if kind in ("hbm", "hbm_event", "depth", "gap"):
            continue
        if kind == "admit":
            c = ids[c[0]]
        elif kind in ("prefill", "chunk"):
            if kind == "prefill":
                c = ids[c]
            else:
                d = ids[d]
        elif kind == "expired":
            b = ids.get(b, b)
        out.append((kind, a, b, c, d))
    return out


def _serve_scenario(side):
    """A bucket prompt (A), a lattice prompt (B), a request whose
    deadline runs out while it waits for a slot (C) and one the gate
    sheds (D), queued while the device lock is held so the loop sees
    them at one pass."""
    buf = io.StringIO()
    log = side.glog.Logger(level=side.glog.LogLevel.INFO, out=buf, err=buf,
                           pretty=False)
    obs = side.obs.Observe(timeline=side.obs.Timeline(capacity=4096))
    eng = side.make(observe=obs, logger=log,
                    gate=side.res.AdmissionGate(max_queue_depth=3,
                                                name="generate"))
    try:
        with eng._device_lock:
            streams = [eng.generate(_prompt(12, 1), max_new_tokens=6,
                                    traceparent=TRACEPARENTS[0]),
                       eng.generate(_prompt(70, 2), max_new_tokens=6,
                                    traceparent=TRACEPARENTS[1])]
            dl = side.res.Deadline.after(60.0)
            streams.append(eng.generate(_prompt(9, 3), max_new_tokens=6,
                                        deadline=dl,
                                        traceparent=TRACEPARENTS[2]))
            dl.at = time.monotonic() - 1.0
            with pytest.raises(side.Shed):
                eng.generate(_prompt(5, 4), max_new_tokens=6,
                             traceparent=TRACEPARENTS[3])
        outs = []
        for s in streams:
            got = []
            try:
                for t in s:
                    got.append(int(t))
                outs.append(("ok", got))
            except Exception as e:  # noqa: BLE001 — compared by name
                outs.append((type(e).__name__, got))
        end = time.monotonic() + 20.0
        while len(obs.recorder.events(event="request")) < 4 \
                and time.monotonic() < end:
            time.sleep(0.01)
        events = obs.recorder.events()
        timeline = obs.timeline.events()
    finally:
        eng.close()
    ids = {e["request_id"]: i for i, e in enumerate(
        e for e in events if e["event"] == "submitted")}
    return {"tokens": outs,
            "events": [_timeless(e, ids) for e in events],
            "timeline": _payloads(timeline, ids),
            "wide": [_timeless(w, ids) for w in _wide_lines(buf)],
            "chunks": [s.chunks for s in streams]}


def test_the_engines_record_alike(weights):
    """The recorder's event sequence and fields, the timeline's kinds
    and payloads and the wide events' keys in order are the JAX
    engine's, and so are the streams."""
    jax_run, port_run = (_serve_scenario(side) for side in _sides(weights))
    assert port_run["tokens"] == jax_run["tokens"]
    assert port_run["tokens"][0][0] == port_run["tokens"][1][0] == "ok"
    assert port_run["tokens"][2] == ("DeadlineExceeded", [])
    assert port_run["chunks"] == [0, 2, 0]
    assert port_run["events"] == jax_run["events"]
    assert port_run["timeline"] == jax_run["timeline"]
    assert port_run["wide"] == jax_run["wide"]
    kinds = [dict(e)["event"] for e in port_run["events"]]
    assert kinds.count("request") == 4 and "failed" in kinds
    assert {k for k, *_ in port_run["timeline"]} == {
        "admit", "prefill", "chunk", "decode", "shed", "expired"}
    assert [dict(w)["outcome"] for w in port_run["wide"]] == [
        "shed", "finished", "failed", "finished"]


@pytest.mark.parametrize("timeline", ["on", "off", "none"])
def test_greedy_tokens_do_not_change_with_the_timeline(weights, timeline):
    """A bucket prompt and a lattice prompt at depth 2: the same tokens
    with the timeline on, off and with no Observe at all (and JAX's)."""
    port = _sides(weights)[1]
    obs = {"on": pobserve.Observe(),
           "off": pobserve.Observe(timeline=pobserve.Timeline(
               capacity=16, enabled=False)),
           "none": None}[timeline]
    eng = port.make(observe=obs) if obs is not None else port.make()
    eng._pipeline = type(eng._pipeline)(2)
    try:
        assert (eng._tl is not None) == (timeline == "on")
        got = [eng.generate(_prompt(n, n), max_new_tokens=10).tokens()
               for n in (12, 70)]
    finally:
        eng.close()
    jeng = _sides(weights)[0].make()
    try:
        want = [jeng.generate(_prompt(n, n), max_new_tokens=10).tokens()
                for n in (12, 70)]
    finally:
        jeng.close()
    assert got == want


def test_fault_13_the_generate_path_feeds_its_series_and_jax_s_wide_line(
        weights):
    """Without an Observe bundle the port's engine records
    app_tpu_dispatch_gap_duration, app_tpu_pipeline_depth and
    app_tpu_request_segment_duration for program="generate", and logs
    the wide request line JAX's logs, field for field (times aside)."""
    lines, texts = [], []
    for side in _sides(weights):
        m = side.metrics.Manager()
        side.metrics.register_framework_metrics(m)
        buf = io.StringIO()
        log = side.glog.Logger(level=side.glog.LogLevel.WARN, out=buf,
                               err=buf, pretty=False)
        eng = side.make(metrics=m, logger=log)
        try:
            toks = eng.generate(_prompt(20, 5), max_new_tokens=12,
                                traceparent=TRACEPARENTS[0]).tokens()
            assert len(toks) == 12
            end = time.monotonic() + 10.0
            while not _wide_lines(buf) and time.monotonic() < end:
                time.sleep(0.01)
        finally:
            eng.close()
        (wide,) = _wide_lines(buf)
        lines.append(_timeless(wide, {wide["request_id"]: 0}))
        texts.append(m.render_prometheus())
    assert lines[1] == lines[0]
    assert dict(lines[1])["trace_id"] == "%032x" % 0x1234
    text = texts[1]

    def total(name, *labels):
        return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                   if ln.startswith(name + "{")
                   and all(lab in ln for lab in
                           ('program="generate"',) + labels))

    assert total("app_tpu_dispatch_gap_duration_count") > 0
    assert any(ln.startswith('app_tpu_pipeline_depth{program="generate"}')
               for ln in text.splitlines())
    for seg in ("queue_wait", "prefill", "handoff", "decode"):
        assert total("app_tpu_request_segment_duration_count",
                     f'segment="{seg}"') == 1, seg


# -- the /debug pages against JAX's ------------------------------------------

def _keys(tree, depth=2):
    if not isinstance(tree, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in tree.items()}


def test_debug_vars_carries_jax_s_keys():
    """/debug/vars on an App of each package with the same rows (a
    tracer exporting through the tail sampler, a clock sample): the same
    sections and keys, the device topology included (the CPU here)."""
    rows = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR",
            "APP_NAME": "vars", "API_SECRET_TOKEN": "hush",
            "TRACER_HOST": "127.0.0.1", "TRACER_PORT": "9"}
    apps = [gofr_tpu.App(JMapConfig(rows)),
            gofr_tpu_torch.App(MapConfig(rows), device="cpu")]
    payloads = []
    try:
        for a in apps:
            a.container.observe.clock.observe("replica:x", 1.0, 1.5, 1.5,
                                              1.1)
            a.run(block=False)
            status, body, _ = _get(a.metrics_port, "/debug/vars")
            assert status == 200
            payloads.append(json.loads(body))
    finally:
        for a in apps:
            a.stop()
    jv, pv = payloads
    assert set(pv) == set(jv) >= {"app", "config", "devices", "inflight",
                                  "recorder", "timeline", "trace_sampler",
                                  "fleet_clock", "device_memory"}
    for section in ("app", "recorder", "timeline", "trace_sampler",
                    "fleet_clock"):
        assert _keys(pv[section]) == _keys(jv[section]), section
    assert set(pv["devices"]) == set(jv["devices"]) == {
        "platform", "device_kind", "devices", "process_count"}
    assert pv["devices"]["platform"] == "cpu"
    assert pv["config"] == jv["config"]
    assert pv["config"]["API_SECRET_TOKEN"] == "<redacted>"


def test_a_profile_of_a_live_app_samples_its_serving_loop_and_is_single():
    """/debug/pprof/profile while a stream decodes: the serving loop's
    thread (gofr-torch-gen) is in the samples, and a second profile
    while one runs is a 409."""
    a = gofr_tpu_torch.App(MapConfig({
        "HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR",
        "TPU_MODEL": "tiny", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "256",
        "TPU_SEQ_BUCKETS": "16,32"}), device="cpu")
    install_generate(a)
    a.run(block=False)
    try:
        gen = a.container.tpu.generator
        stream = gen.generate([1, 2, 3, 4], max_new_tokens=200)
        out = {}

        def profile():
            out["first"] = _get(a.metrics_port,
                                "/debug/pprof/profile?seconds=1&hz=200")

        t = threading.Thread(target=profile)
        t.start()
        time.sleep(0.2)
        second = _get(a.metrics_port, "/debug/pprof/profile?seconds=0.1")
        t.join(10.0)
        stream.cancel()
    finally:
        a.stop()
    assert second[0] == 409
    status, body, headers = out["first"]
    assert status == 200 and int(headers["X-Profile-Samples"]) > 0
    assert any(ln.startswith("gofr-torch-gen;")
               for ln in body.decode().splitlines())


def test_no_observe_object_reaches_a_tensor_parallel_worker():
    """The bundle and the timeline live in rank 0's process: ``observe``
    is not among the engine keys a worker rank's pickled spec carries,
    so a TP block's event is rank 0's dispatch to reap."""
    from gofr_tpu_torch.tpu import generator

    assert "observe" not in generator._TP_KWARGS
    assert {"slots", "max_seq", "decode_block"} <= set(generator._TP_KWARGS)
