"""The fleet plane on the port (gofr_tpu_torch/observe/fleet.py and
clock.py) against the JAX package's, on the CPU.

- tests/test_fleet_obs.py's cases on the port's copy: the clock's
  estimator, ``parse_obs_peers``, the merge on a known two-process
  schedule, ``assemble_request`` with a peer down, ``/debug/request``
  over HTTP, and the breakdown of a wide event from the port's engine;
- ``parse_obs_peers``, ``merge_traces`` and ``assemble_request`` equal
  to JAX's on the same seeded inputs;
- a port App whose ``/debug/timeline?fleet=1`` merges a live JAX App's
  timeline and wide events (``TPU_OBS_PEERS``), and a JAX App merging
  the port's: the two packages' traces are one format.
"""

from __future__ import annotations

import json
import time
import urllib.request
from functools import partial

import numpy as np
import pytest

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.observe import fleet as jfleet
from gofr_tpu.observe import recorder as jrecorder
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.observe import fleet as pfleet
from gofr_tpu_torch.observe import recorder as precorder
from _torch_port_copy import port_copy


# -- tests/test_fleet_obs.py's cases on the port -----------------------------

P = port_copy("test_fleet_obs.py",
              App=partial(gofr_tpu_torch.App, device="cpu"))


@pytest.fixture(scope="module")
def engine_obs():
    """test_fleet_obs.py's ``engine_obs`` on the port's engine: tiny on
    the CPU, with an Observe and the framework's metrics."""
    from gofr_tpu_torch.metrics import Manager, register_framework_metrics
    from gofr_tpu_torch.models import LLAMA_CONFIGS, llama
    from gofr_tpu_torch.observe import Observe
    from gofr_tpu_torch.tpu import GenerationEngine

    metrics = Manager()
    register_framework_metrics(metrics)
    obs = Observe(metrics=metrics)
    cfg = LLAMA_CONFIGS["tiny"]
    eng = GenerationEngine(cfg, llama.init(cfg, 0, device="cpu"), slots=2,
                           max_seq=128, prompt_buckets=(16, 32),
                           metrics=metrics, observe=obs, device="cpu")
    yield eng, obs, metrics
    eng.close()


test_offset_converges_under_skew = P.test_offset_converges_under_skew
test_min_rtt_sample_wins = P.test_min_rtt_sample_wins
test_symmetric_exchange_is_exact_and_to_local_inverts = \
    P.test_symmetric_exchange_is_exact_and_to_local_inverts
test_negative_rtt_is_poison_not_data = P.test_negative_rtt_is_poison_not_data
test_uncertainty_grows_with_sample_age = \
    P.test_uncertainty_grows_with_sample_age
test_window_is_bounded = P.test_window_is_bounded
test_registry_observe_note_peer_and_targets = \
    P.test_registry_observe_note_peer_and_targets
test_parse_obs_peers_forms = P.test_parse_obs_peers_forms
test_merge_rebases_peer_events_onto_the_local_axis = \
    P.test_merge_rebases_peer_events_onto_the_local_axis
test_merge_draws_request_slices_and_flow_arrows = \
    P.test_merge_draws_request_slices_and_flow_arrows
test_merge_single_process_trace_gets_no_flow_arrows = \
    P.test_merge_single_process_trace_gets_no_flow_arrows
test_merge_degrades_typed_never_breaks = \
    P.test_merge_degrades_typed_never_breaks
test_merge_orders_metadata_first_then_by_timestamp = \
    P.test_merge_orders_metadata_first_then_by_timestamp
test_assemble_request_with_one_peer_down = \
    P.test_assemble_request_with_one_peer_down
test_debug_request_http_surface_partial_never_500 = \
    P.test_debug_request_http_surface_partial_never_500
test_breakdown_telescopes_to_duration = P.test_breakdown_telescopes_to_duration
test_segment_histograms_record = P.test_segment_histograms_record


# -- the same inputs through both packages -----------------------------------

@pytest.mark.parametrize("spec", [
    None, "", "a=http://h:1", " a = h:1 , ,b=https://x:2/ ",
    "replica:127.0.0.1:8000=http://127.0.0.1:2121", "bare:3,other:4/",
    "x=y=z"])
def test_parse_obs_peers_equals_jax(spec):
    assert pfleet.parse_obs_peers(spec) == jfleet.parse_obs_peers(spec)


def _seeded_fleet(rng):
    """A local trace and three peers (aligned, unaligned, down) with
    seeded slices and wide events, some trace ids shared."""
    def trace(wall, mono, n, cat):
        evs = [{"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
                "args": {"name": "x"}}]
        for i in range(n):
            evs.append({"ph": "X", "pid": 1, "tid": 10 + int(rng.integers(
                0, 4)), "name": f"{cat} {i}", "cat": cat,
                "ts": float(mono * 1e6 + rng.uniform(0, 5e6)),
                "dur": float(rng.uniform(1e3, 1e5)), "args": {"seq": i}})
        return {"traceEvents": evs,
                "otherData": {"epoch_wall_s": wall, "epoch_mono_s": mono}}

    tids = [f"{i:032x}" for i in range(6)]

    def wide(n, wall0):
        return [{"event": "request",
                 "trace_id": tids[int(rng.integers(0, len(tids)))],
                 "outcome": "finished",
                 "submit_wall_s": float(wall0 + rng.uniform(0, 4)),
                 "duration_s": float(rng.uniform(0, 0.5)),
                 "breakdown": {"decode_s": 0.1}} for _ in range(n)]

    local = trace(1.7e9, 100.0, 8, "gw")
    peers = [{"name": "replica:a", "offset_s": 0.25, "uncertainty_s": 0.001,
              "trace": trace(1.7e9 + 0.3, 40.0, 10, "decode"),
              "wide": wide(5, 1.7e9), "error": None},
             {"name": "decode:b", "offset_s": None, "uncertainty_s": None,
              "trace": trace(1.7e9 - 1.0, 7.0, 4, "decode"),
              "wide": wide(3, 1.7e9), "error": None},
             {"name": "dead", "offset_s": None, "uncertainty_s": None,
              "trace": None, "wide": [], "error": "URLError('refused')"}]
    return local, wide(4, 1.7e9), peers


def test_merge_traces_equals_jax_on_a_seeded_fleet():
    local, local_wide, peers = _seeded_fleet(np.random.default_rng(21))
    p = pfleet.merge_traces("gw", local, local_wide, peers)
    j = jfleet.merge_traces("gw", local, local_wide, peers)
    assert p == j
    assert p["otherData"]["fleet"]["traces_joined"] > 0
    assert [d["reason"] for d in p["otherData"]["fleet"]["degraded"]] == [
        "unaligned", "unreachable"]


def test_assemble_request_equals_jax(monkeypatch):
    """One trace id's story from a local recorder and three peers (one
    answering, one down, one with no URL), each package's
    ``fetch_json`` answered by the same fake."""
    peer_events = {"events": [
        {"event": "request", "trace_id": "t-1", "outcome": "finished",
         "duration_s": 0.3},
        {"event": "request", "trace_id": "t-2", "outcome": "shed"}]}

    def fetch(url, path, timeout_s=2.0):
        if "dead" in url:
            raise ConnectionRefusedError(url)
        assert path == "/debug/events?event=request&n=2048"
        return peer_events

    peers = [{"name": "up", "debug_url": "http://up:1", "aligned": True,
              "offset_s": 0.01, "uncertainty_s": 0.002},
             {"name": "dead", "debug_url": "http://dead:1",
              "aligned": True},
             {"name": "nourl", "debug_url": None}]
    outs = []
    for fleet, rec_mod in ((jfleet, jrecorder), (pfleet, precorder)):
        monkeypatch.setattr(fleet, "fetch_json", fetch)
        rec = rec_mod.FlightRecorder()
        rec.record("request", trace_id="t-1", outcome="finished",
                   duration_s=0.5)
        rec.record("request", trace_id="t-3", outcome="failed")
        story = fleet.assemble_request("t-1", "gw", rec, peers)
        for s in story["stories"]:
            for e in s["events"]:
                e.pop("ts", None)
        outs.append(story)
    assert outs[1] == outs[0]
    assert outs[1]["found"] == 2 and outs[1]["partial"] is True


# -- a fleet of both packages ------------------------------------------------

def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=20) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("local_pkg", ["port", "jax"])
def test_an_app_merges_the_other_package_s_timeline(local_pkg):
    """``/debug/timeline?fleet=1`` on an App of one package with the
    other package's App as its ``TPU_OBS_PEERS`` peer: the peer's
    process, its slot tracks and its wide events land in the merge, and
    a trace id both processes served is joined by a flow."""
    base = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR"}
    if local_pkg == "port":
        peer = gofr_tpu.App(JMapConfig(dict(base, APP_NAME="jax-peer")))
    else:
        peer = gofr_tpu_torch.App(MapConfig(dict(base, APP_NAME="port-peer")),
                                  device="cpu")
    peer.run(block=False)
    local = None
    try:
        rows = dict(base, APP_NAME="local",
                    TPU_OBS_PEERS=f"peer=127.0.0.1:{peer.metrics_port}")
        local = (gofr_tpu_torch.App(MapConfig(rows), device="cpu")
                 if local_pkg == "port" else gofr_tpu.App(JMapConfig(rows)))
        local.run(block=False)
        now = time.monotonic()
        tid = "ab" * 16
        for app, slot in ((peer, 3), (local, 0)):
            obs = app.container.observe
            obs.timeline.decode_block(now - 0.02, now - 0.01, (slot,), 4)
            obs.recorder.record("request", request_id=1, trace_id=tid,
                                outcome="finished", duration_s=0.01,
                                submit_wall_s=round(time.time() - 0.02, 6))
        merged = _get_json(local.metrics_port, "/debug/timeline?fleet=1")
    finally:
        if local is not None:
            local.stop()
        peer.stop()
    fleet = merged["otherData"]["fleet"]
    assert [p["name"] for p in fleet["processes"]] == ["local", "peer"]
    assert [d["reason"] for d in fleet["degraded"]] == ["unaligned"]
    pid = fleet["processes"][1]["pid"]
    names = {e["args"]["name"] for e in merged["traceEvents"]
             if e.get("pid") == pid and e.get("name") == "thread_name"}
    assert "slot 3" in names and "requests" in names
    assert any(e.get("pid") == pid and e.get("cat") == "decode"
               for e in merged["traceEvents"])
    assert fleet["traces_joined"] == 1 and fleet["flow_events"] == 2
