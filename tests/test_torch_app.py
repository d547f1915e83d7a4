"""The port's own App over HTTP (gofr_tpu_torch.App) against the JAX
package's (gofr_tpu.App), on the CPU at `tiny`, two Apps on localhost.

Each App is built the way a deployment builds it: from the same config
rows, its Container wires its package's engine as ``ctx.tpu`` (the JAX
engine on one, the port's on ``device="cpu"`` on the other), both on
the JAX weights written once to a ``.npz`` (``TPU_WEIGHTS``, which the
port reads through ``from_jax_params``), and ``install_generate`` of
each package mounts ``POST /generate``. The two Apps must answer alike:
the generate lines, cursors, the typed mid-stream line and the resume
round trip; a shed (429 with ``Retry-After``) through each engine's gate
at the same depth; an expiry under ``X-Request-Timeout`` (a buffered
504 naming the deadline); ``X-SLO-Class`` reaching the engine's class
line; ``traceparent`` reaching the stream's ``trace_id``; health UP,
and 503 with ``Retry-After`` while ``stop(grace_s)`` drains a live
stream that completes; the ``/debug/cache`` keys and the ``/metrics``
framework names.

The requests a case orders are queued while the case holds the engine's
device lock, so either engine's loop sees them at its next pass,
whatever the machine's speed.
"""

import contextlib
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

import gofr_tpu
from gofr_tpu import chaos as jchaos
from gofr_tpu import metrics as jmetrics
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.serving import install_generate as jinstall_generate
from gofr_tpu.serving import resume_chain as jresume_chain
from gofr_tpu.tpu.checkpoint import save_npz
import gofr_tpu_torch
from gofr_tpu_torch import chaos
from gofr_tpu_torch import metrics as pmetrics
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.serving import install_generate, resume_chain

JCFG = JAX_CONFIGS["tiny"]
# tests/test_torch_serving.py's paged engine with prefix sharing, behind
# a gate of depth 4 (throughput requests held to 2)
ROWS = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR",
        "TPU_MODEL": "tiny", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "128",
        "TPU_SEQ_BUCKETS": "16,32", "TPU_PAGED_BLOCKS": "25",
        "TPU_PAGED_BLOCK": "8", "TPU_PREFIX_CACHE": "2",
        "TPU_PREFIX_MIN": "16", "TPU_MAX_QUEUE_DEPTH": "4"}
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
TRACEPARENT = f"00-{TRACE_ID}-00f067aa0ba902b7-01"


@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "tiny.npz"
    save_npz(str(path), jax.tree.map(
        np.asarray, jllama.init(JCFG, jax.random.PRNGKey(1))))
    return str(path)


@contextlib.contextmanager
def _two_apps(weights_npz, **extra):
    """The JAX App and the port's on the same rows, each with its own
    POST /generate, running on localhost: {name: (app, route)}."""
    rows = dict(ROWS, TPU_WEIGHTS=weights_npz, **extra)
    out = {}
    try:
        app = gofr_tpu.App(JMapConfig(dict(rows, APP_NAME="replica-jax")))
        out["jax"] = (app, jinstall_generate(app))
        app.run(block=False)
        app = gofr_tpu_torch.App(
            MapConfig(dict(rows, APP_NAME="replica-port")), device="cpu")
        out["port"] = (app, install_generate(app))
        app.run(block=False)
        yield out
    finally:
        for app, _ in out.values():
            if app._running.is_set():
                app.stop()


@pytest.fixture(scope="module")
def apps(weights_npz):
    with _two_apps(weights_npz) as out:
        yield out


def _gen(app):
    return app.container.tpu.generator


def _prompt(n, seed=7):
    return np.random.default_rng(seed).integers(
        1, JCFG.vocab_size, n).tolist()


def _post(port, body, headers=None, timeout=60):
    """(status, ndjson lines or the error body, response headers)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, [json.loads(line) for line in
                                 resp.read().decode().splitlines()
                                 if line], dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _wait_for(pred, timeout=30.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.002)
    return pred()


def _in_thread(fn):
    box = {}
    t = threading.Thread(target=lambda: box.update(out=fn()))
    t.start()
    return t, box


def _both(apps, case):
    """Run ``case(name, app, route, seams)`` on each App, JAX's first."""
    return [case(name, app, route, seams)
            for (name, (app, route)), seams in
            zip(apps.items(), (jchaos, chaos))]


def _counter(app, name):
    """A counter's total over its series, read from the App's scrape."""
    _, body, _ = _get(app.metrics_port, "/metrics")
    return sum(float(line.rsplit(" ", 1)[1])
               for line in body.decode().splitlines()
               if line.startswith(name + "{") or line.startswith(name + " "))


@contextlib.contextmanager
def _slots_held(app, new=40):
    """Both slots busy with live streams and the engine's device lock
    held, so that what the case queues waits in the pending line."""
    gen = _gen(app)
    blockers = [app.container.tpu.generate(_prompt(18, 100 + i),
                                           max_new_tokens=new)
                for i in range(2)]
    assert _wait_for(lambda: gen.stats()["active"] == 2)
    with gen._device_lock:
        yield gen
    for s in blockers:
        assert len(list(s)) == new


# -- POST /generate: lines, cursors, the typed line, resume ---------------------

@pytest.mark.parametrize("body", [
    {"max_new": 6},
    {"max_new": 5, "temperature": 0.7, "top_k": 15, "seed": 9},
    {"max_new": 4, "eos": [2, 7]},
])
def test_the_route_streams_jax_cursor_lines(apps, body):
    prompt = _prompt(20, seed=17)
    (js, jlines, _), (ps, plines, _) = _both(
        apps, lambda n, app, r, s: _post(app.http_port,
                                         {"tokens": prompt, **body}))
    assert js == ps == 200
    assert plines == jlines
    assert [ln["cursor"] for ln in plines] == list(range(len(plines)))
    assert apps["port"][1].stats()["live"] == 0


def test_the_route_midstream_line_and_resume_round_trip(apps):
    """A kill after 3 tokens (each engine's own MIDKILL seam) gives the
    typed line with a complete resume token; replaying it continues at
    cursor 3, the first line reports the recompute, and the spliced
    stream is the uninterrupted one, on both Apps."""
    prompt = _prompt(20, seed=21)
    rid = "t-resume-app"

    def case(name, app, route, seams):
        ref = _post(app.http_port, {"tokens": prompt, "max_new": 8})
        sched = seams.ChaosSchedule(seed=0).on(
            seams.GENERATOR_MIDKILL, error=RuntimeError, every=3, limit=1)
        with seams.scope(sched):
            killed = _post(app.http_port, {"tokens": prompt, "max_new": 8,
                                           "request_id": rid})
        emitted = [ln["token"] for ln in killed[1] if "token" in ln]
        resumed = _post(app.http_port, {"tokens": prompt, "max_new": 8,
                                        "request_id": rid, "resume_from": 3,
                                        "emitted": emitted})
        return ref[:2], killed[:2], resumed[:2], route.stats()["live"]

    jax_out, port_out = _both(apps, case)
    assert port_out == jax_out
    ref, (status, lines), (status2, lines2), live = port_out
    toks = [ln for ln in lines if "token" in ln]
    err = lines[-1]["error"]
    assert status == status2 == 200 and live == 0
    assert [t["cursor"] for t in toks] == [0, 1, 2]
    assert err["status"] == 503 and err["retry_after"] > 0
    res = err["resume"]
    assert (res["cursor"], res["emitted"], res["request_id"]) == (3, 3, rid)
    emitted = [t["token"] for t in toks]
    assert res["chain"] == resume_chain(prompt, emitted, 16, 0) \
        == jresume_chain(prompt, emitted, 16, 0)
    assert [t["cursor"] for t in lines2] == [3, 4, 5, 6, 7]
    # prompt + 3 emitted = 23 positions, 16 of them the stored prompt's
    # two full blocks of 8: 7 recomputed
    assert lines2[0]["recompute"] == 7
    assert emitted + [t["token"] for t in lines2] == \
        [ln["token"] for ln in ref[1]]


def test_the_route_refuses_a_resume_cursor_mismatch_as_jax(apps):
    (js, jbody, _), (ps, pbody, _) = _both(
        apps, lambda n, app, r, s: _post(
            app.http_port, {"tokens": _prompt(18, seed=23),
                            "resume_from": 2, "emitted": [5]}))
    assert (ps, pbody) == (js, jbody)
    assert ps == 400 and "resume_from" in json.dumps(pbody)


# -- the gate, budgets and classes over HTTP ----------------------------------

def test_a_shed_answers_429_with_retry_after(apps):
    """With both slots busy and two requests waiting, a throughput-class
    request meets the gate's throughput bound (4 x 0.5): both Apps answer
    a buffered 429 with ``Retry-After``, and each engine counts the shed
    where the scrape shows it. (Through a ``gofr_tpu`` App, the port's
    TooManyRequests answered 500: the App did not know the port's
    error class.)"""
    def case(name, app, route, seams):
        before = _counter(app, "app_tpu_shed_total")
        with _slots_held(app) as gen:
            queued = [app.container.tpu.generate(_prompt(6, 10 + i),
                                                 max_new_tokens=2)
                      for i in range(2)]
            status, body, headers = _post(
                app.http_port, {"tokens": _prompt(12, 20), "max_new": 2},
                headers={"X-SLO-Class": "throughput"})
            sheds = dict(gen.stats()["admission"]["sheds_by_class"])
        served = [len(list(s)) for s in queued]
        return (status, int(headers.get("Retry-After", 0)) >= 1,
                "shed (throughput)" in body["error"]["message"], sheds,
                _counter(app, "app_tpu_shed_total") - before, served)

    jax_out, port_out = _both(apps, case)
    assert port_out == jax_out
    assert port_out == (429, True, True, {"latency": 0, "throughput": 1},
                        1.0, [2, 2])


def test_a_header_budget_expires_as_504(apps):
    """``X-Request-Timeout: 50ms`` on a request that waits behind two
    busy slots: its deadline runs out in the queue, and both Apps answer
    a buffered 504 naming the deadline; each engine counts the expiry.
    (Through a ``gofr_tpu`` App the budget never reached the port's
    engine, whose scopes that App's middleware does not open.)"""
    def case(name, app, route, seams):
        before = _counter(app, "app_tpu_expired_dropped_total")
        with _slots_held(app) as gen:
            client, box = _in_thread(lambda: _post(
                app.http_port, {"tokens": _prompt(12, 30), "max_new": 4},
                headers={"X-Request-Timeout": "50ms"}))
            assert _wait_for(lambda: gen.stats()["queued"] == 1)
            time.sleep(0.1)
        client.join(60)
        status, body, headers = box["out"]
        return (status, "deadline" in body["error"]["message"].lower(),
                headers.get("Content-Type"),
                _counter(app, "app_tpu_expired_dropped_total") - before)

    jax_out, port_out = _both(apps, case)
    assert port_out == jax_out
    assert port_out == (504, True, "application/json", 1.0)


def test_the_slo_class_header_reaches_the_engines_class_line(apps):
    """``X-SLO-Class: throughput`` queues the request on the engine's
    throughput line (the scheduler's ``queued_throughput``), and it is
    then served whole."""
    def case(name, app, route, seams):
        with _slots_held(app) as gen:
            client, box = _in_thread(lambda: _post(
                app.http_port, {"tokens": _prompt(12, 40), "max_new": 3},
                headers={"X-SLO-Class": "batch"}))
            assert _wait_for(lambda: gen.stats()["queued"] == 1)
            sched = gen.stats()["scheduler"]
            lines = (sched["queued_latency"], sched["queued_throughput"])
        client.join(60)
        status, got, _ = box["out"]
        return lines, status, got

    jax_out, port_out = _both(apps, case)
    assert port_out == jax_out
    assert port_out[0] == (0, 1) and port_out[1] == 200
    assert len(port_out[2]) == 3


def test_traceparent_reaches_the_streams_trace_id(apps):
    """An inbound ``traceparent`` becomes the request's span, the
    response's ``X-Correlation-ID`` and the generation stream's
    ``trace_id``, on both Apps."""
    def case(name, app, route, seams):
        tpu = app.container.tpu
        streams = []

        def generate(*args, **kw):
            streams.append(type(tpu).generate(tpu, *args, **kw))
            return streams[-1]

        tpu.generate = generate
        try:
            status, lines, headers = _post(
                app.http_port, {"tokens": _prompt(10, 50), "max_new": 2},
                headers={"traceparent": TRACEPARENT})
        finally:
            del tpu.generate
        (stream,) = streams
        return (status, len(lines), headers.get("X-Correlation-ID"),
                stream.trace_id, stream.traceparent.split("-")[1])

    jax_out, port_out = _both(apps, case)
    assert port_out == jax_out
    assert port_out == (200, 2, TRACE_ID, TRACE_ID, TRACE_ID)


def test_generate_takes_a_traceparent_as_the_jax_engine_does(apps):
    """``generate(..., traceparent=)`` joins that trace; without one and
    outside any span a stream gets a fresh trace id and no parent."""
    def case(name, app, route, seams):
        tpu = app.container.tpu
        joined = tpu.generate(_prompt(10, 80), max_new_tokens=2,
                              traceparent=TRACEPARENT)
        fresh = tpu.generate(_prompt(10, 81), max_new_tokens=2)
        out = (joined.trace_id, joined.traceparent, len(fresh.trace_id),
               fresh.trace_id != TRACE_ID, fresh.traceparent,
               len(list(joined)), len(list(fresh)))
        return out

    jax_out, port_out = _both(apps, case)
    assert port_out == jax_out
    assert port_out == (TRACE_ID, TRACEPARENT, 32, True, None, 2, 2)


# -- health, scrapes, the graceful stop -----------------------------------------

def _metric_names(app):
    _, body, _ = _get(app.metrics_port, "/metrics")
    return {line.split()[2] for line in body.decode().splitlines()
            if line.startswith("# TYPE ")}


def test_health_debug_cache_and_metrics_agree_with_the_jax_app(apps):
    """Health UP with the engine's details under ``tpu``; the
    ``/debug/cache`` keys (prefix sharing on: the paged-shared index's
    stats); the framework metric names of the ``/metrics`` scrape."""
    def case(name, app, route, seams):
        _post(app.http_port, {"tokens": _prompt(20, 60), "max_new": 2})
        hs, body, _ = _get(app.http_port, "/.well-known/health")
        health = json.loads(body)["data"]
        cs, cache, _ = _get(app.metrics_port, "/debug/cache?format=json")
        cache = json.loads(cache)
        hcs, page, hdr = _get(app.metrics_port, "/debug/cache")
        return (hs, health["status"], health["tpu"]["status"],
                sorted(health["tpu"]), cs, sorted(cache), cache["enabled"],
                sorted(cache["cache"]), cache["cache"]["kind"], hcs,
                hdr["Content-Type"], b"prefix KV cache" in page)

    jax_out, port_out = _both(apps, case)
    assert port_out == jax_out
    assert port_out[:3] == (200, "UP", "UP") and port_out[6] is True
    assert "hits" in port_out[7]

    def registered(mod):
        m = mod.Manager()
        mod.register_framework_metrics(m)
        return {line.split()[2] for line in m.render_prometheus().splitlines()
                if line.startswith("# TYPE ")}

    framework = registered(jmetrics)
    assert registered(pmetrics) == framework
    names = {n: _metric_names(app) & framework
             for n, (app, _) in apps.items()}
    assert names["port"] == names["jax"] == framework
    assert {"app_http_response", "app_tpu_shed_total",
            "app_tpu_expired_dropped_total"} <= framework


def test_a_graceful_stop_answers_503_and_finishes_a_live_stream(
        weights_npz):
    """``stop(grace_s)`` with a stream accepted on ``POST /generate``
    (queued behind the case's hold on the device lock): while it drains,
    health and a new request answer 503 with ``Retry-After`` (the
    readiness flip comes first), the stream completes over its open
    connection, then the listeners stop; alike on both Apps. A
    second request held open in its handler keeps the drain in progress
    while the case looks, as the stop waits for every in-flight
    handler."""
    with _two_apps(weights_npz) as pair:
        def case(name, app, route, seams):
            gen = _gen(app)
            release, entered = threading.Event(), threading.Event()

            def hold(ctx):
                entered.set()
                release.wait(60)
                return "released"

            app.get("/hold", hold)
            holder, held = _in_thread(lambda: _get(app.http_port, "/hold"))
            assert entered.wait(30)
            with gen._device_lock:
                client, box = _in_thread(lambda: _post(
                    app.http_port, {"tokens": _prompt(20, 70),
                                    "max_new": 40}))
                assert _wait_for(lambda: gen.stats()["queued"] == 1)
                stopper, _ = _in_thread(lambda: app.stop(grace_s=30.0))
                assert _wait_for(lambda: app._draining)
                st = gen.stats()
                live = st["active"] + st["queued"]
            assert _wait_for(lambda: gen.stats()["draining"])
            hs, _, hh = _get(app.http_port, "/.well-known/health")
            ns, nbody, nh = _post(app.http_port,
                                  {"tokens": _prompt(8), "max_new": 2})
            alive, _, _ = _get(app.http_port, "/.well-known/alive")
            client.join(60)
            release.set()
            holder.join(60)
            stopper.join(60)
            assert not stopper.is_alive()
            with pytest.raises(urllib.error.URLError):
                urllib.request.urlopen(
                    f"http://127.0.0.1:{app.http_port}/.well-known/alive",
                    timeout=5)
            status, lines, _ = box["out"]
            return (live, hs, hh.get("Retry-After"), ns,
                    nh.get("Retry-After"), nbody, alive, held["out"][0],
                    status, [ln["cursor"] for ln in lines])

        jax_out, port_out = _both(pair, case)
    assert port_out == jax_out
    assert port_out[:8] == (1, 503, "30", 503, "30",
                            {"error": {"message": "server draining"}}, 200,
                            200)
    assert port_out[8:] == (200, list(range(40)))
