"""Durable streams on the port (gofr_tpu_torch.tpu.generator
``continue_from``, the ``GENERATOR_MIDKILL`` seam, the sink protocol of
gofr_tpu_torch.wire) against the JAX package on `tiny`, with the same
seeded weights carried across through ``from_jax_params``, on the CPU.

A stream killed mid-way resumes with ``continue_from`` token for token,
greedy and seeded, paged (where the continuation's prompt hits the
prompt's own stored blocks once prefix sharing is on) and contiguous.
The port's engine mounted on a ``gofr_tpu`` App through
``install_generate`` (tests/test_resume.py's route) gives the same
``/generate`` lines, cursors, typed mid-stream line and resume round
trip as a JAX-engine App on the same rows.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import App
from gofr_tpu import chaos as jchaos
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.serving import install_generate, resume_chain
from gofr_tpu.tpu import GenerationError as JaxError
from gofr_tpu.tpu.generator import GenerationEngine as JaxEngine
from gofr_tpu.wire import WAKE as JWAKE
from gofr_tpu.wire import PushStream as JPushStream
from gofr_tpu_torch import chaos
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.tpu import (GenerationEngine, GenerationError,
                                TorchEngine, from_jax_params)
from gofr_tpu_torch.wire import WAKE, PushStream

JCFG = JAX_CONFIGS["tiny"]
CFG = LLAMA_CONFIGS["tiny"]
# tests/test_resume.py's paged engine, with prefix sharing on
PAGED = dict(slots=2, max_seq=128, prompt_buckets=(16, 32), paged_blocks=25,
             paged_block_size=8)
PREFIX = dict(prefix_cache_slots=2, prefix_store_min=16)


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JCFG, jax.random.PRNGKey(1))
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _port(weights, **kw):
    return GenerationEngine(CFG, weights[1], kv_dtype=torch.int8,
                            device="cpu", **kw)


def _jax(weights, **kw):
    return JaxEngine(JCFG, weights[0], kv_dtype=jnp.int8, **kw)


def _prompt(n, seed=7):
    return np.random.default_rng(seed).integers(1, CFG.vocab_size,
                                                n).tolist()


def _kill_at(eng, seams, error, prompt, max_new, k, **kw):
    """A stream under a seeded GENERATOR_MIDKILL that fires after exactly
    ``k`` delivered tokens: the tokens delivered before its typed
    death."""
    sched = seams.ChaosSchedule(seed=0).on(
        seams.GENERATOR_MIDKILL, error=RuntimeError, every=k, limit=1)
    got = []
    with seams.scope(sched):
        st = eng.generate(prompt, max_new_tokens=max_new, **kw)
        with pytest.raises(error, match="mid-stream kill"):
            for t in st:
                got.append(int(t))
    assert len(got) == k
    assert st.failed is not None
    return got


SAMPLED = {"temperature": 0.8, "top_k": 20, "seed": 123}


@pytest.mark.parametrize("sampling", ["greedy", "seeded"])
@pytest.mark.parametrize("prefix", [False, True])
def test_paged_kill_and_resume_is_token_exact(weights, prefix, sampling):
    """tests/test_resume.py's paged case: kill after 4 tokens, resume
    with continue_from; the spliced stream equals the uninterrupted one
    and the JAX engine's. With prefix sharing on, the continuation's
    prompt (prompt + emitted) hits the prompt's own stored blocks."""
    kw = SAMPLED if sampling == "seeded" else {}
    prompt = _prompt(20, seed=43)
    rows = dict(PAGED, **(PREFIX if prefix else {}))
    jeng = _jax(weights, **rows)
    try:
        want = jeng.generate(prompt, max_new_tokens=8, **kw).tokens()
    finally:
        jeng.close()
    eng = _port(weights, **rows)
    try:
        ref = eng.generate(prompt, max_new_tokens=8, **kw).tokens()
        got = _kill_at(eng, chaos, GenerationError, prompt, 8, 4, **kw)
        cont = eng.generate(prompt, max_new_tokens=8,
                            continue_from=(prompt, got), **kw)
        rest = cont.tokens()
        assert eng.down is None
    finally:
        eng.close()
    assert ref == want
    assert got + rest == ref
    assert cont.prompt_len == len(prompt) + 4
    assert cont.cache_tokens == (16 if prefix else 0)
    assert cont.cache_tier == ("paged" if prefix else None)


def test_contiguous_kill_and_resume_recomputes_and_splices(weights):
    """A contiguous engine resumes by a full recompute of prompt +
    emitted; the spliced greedy and seeded streams equal the JAX
    engine's uninterrupted ones, and a kill in one stream leaves the
    stream beside it whole."""
    prompt = _prompt(24, seed=1)
    rows = dict(slots=2, max_seq=128, prompt_buckets=(16, 32))
    jeng = _jax(weights, **rows)
    try:
        want = [jeng.generate(prompt, max_new_tokens=12, **kw).tokens()
                for kw in ({}, SAMPLED)]
    finally:
        jeng.close()
    eng = _port(weights, **rows)
    try:
        for kw, ref in zip(({}, SAMPLED), want):
            got = _kill_at(eng, chaos, GenerationError, prompt, 12, 5, **kw)
            rest = eng.generate(prompt, max_new_tokens=12,
                                continue_from=(prompt, got), **kw).tokens()
            assert got + rest == ref
        sched = chaos.ChaosSchedule(seed=0).on(
            chaos.GENERATOR_MIDKILL, error=RuntimeError, every=3, limit=1)
        with chaos.scope(sched):
            with eng._device_lock:
                a = eng.generate(prompt, max_new_tokens=12)
                b = eng.generate(prompt, max_new_tokens=12)
            outs = []
            for s in (a, b):
                try:
                    outs.append(s.tokens())
                except GenerationError:
                    outs.append(None)
        assert sorted(o is None for o in outs) == [False, True]
        assert [o for o in outs if o is not None] == [want[0]]
        assert eng.down is None
    finally:
        eng.close()


def test_a_spent_budget_is_a_typed_error(weights):
    """max_new counts from the original request: a continuation whose
    emitted list spends the whole budget raises, as on the JAX engine."""
    prompt = _prompt(16, seed=13)
    eng = _port(weights, **PAGED)
    jeng = _jax(weights, **PAGED)
    try:
        ref = eng.generate(prompt, max_new_tokens=4).tokens()
        for e, error in ((eng, GenerationError), (jeng, JaxError)):
            with pytest.raises(error, match="nothing to resume"):
                e.generate(prompt, max_new_tokens=4,
                           continue_from=(prompt, ref))
        # an adapter the engine has no slot for: JAX's range check
        for e, error in ((eng, GenerationError), (jeng, JaxError)):
            with pytest.raises(error, match="adapter 1 out of range"):
                e.generate(prompt, max_new_tokens=4, adapter=1)
    finally:
        eng.close()
        jeng.close()


# -- the sink protocol --------------------------------------------------------

def _sink_script(stream_cls, wake):
    """One sequence over a PushStream: items queued before the sink,
    a terminal queued behind them, a sink that takes three items and
    then declines, items after the decline. Returns what the sink took and
    what the iterator saw."""
    took = []

    def sink(item):
        if len(took) >= 3:
            return False
        took.append(item)
        return True

    s = stream_cls()
    s._push(1)
    s._push(2)
    s.set_sink(sink)          # drains 1 and 2 through the sink, in order
    s._push(3)                # straight to the sink
    s._push(4)                # declined: the fallback is permanent
    took.clear()              # the sink would take 5 now: it must not
    s._push(5)
    s.wake()
    s._push(ValueError("boom"))
    seen = []
    with pytest.raises(ValueError, match="boom"):
        for item in s:
            seen.append("wake" if item is wake else item)
    t = stream_cls()
    t._push(7)
    t._push(None)             # a terminal stays queued for the iterator
    t.set_sink(lambda item: took.append(("t", item)) or True)
    t._push(8)                # after the terminal: no consumer reads it
    t.clear_sink()
    return took, seen, list(t)


def test_the_sink_protocol_orders_as_the_jax_streams_do():
    port = _sink_script(PushStream, WAKE)
    ref = _sink_script(JPushStream, JWAKE)
    assert port == ref
    took, seen, tail = port
    assert seen == [4, 5, "wake"]
    assert took == [("t", 7), ("t", 8)] and tail == []


# -- the App's POST /generate -------------------------------------------------

@pytest.fixture(scope="module")
def apps(weights):
    """Two Apps on localhost: one serving the JAX engine, one the port's
    (through TorchEngine, as ``ctx.tpu``), on the same rows."""
    engines = {"jax": _jax(weights, **PAGED, **PREFIX),
               "port": TorchEngine(_port(weights, **PAGED, **PREFIX),
                                   "tiny", torch.device("cpu"))}
    out = {}
    for name, eng in engines.items():
        app = App(JMapConfig({"HTTP_PORT": "0", "METRICS_PORT": "0",
                              "APP_NAME": f"replica-{name}",
                              "LOG_LEVEL": "ERROR"}))
        app.container.tpu = eng
        route = install_generate(app)
        app.run(block=False)
        out[name] = (app, route, eng)
    yield out
    for app, _, eng in out.values():
        app.container.tpu = None
        app.stop()
        eng.close()


def _post(port, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, [json.loads(line) for line in
                                 resp.read().decode().splitlines() if line]
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _both(apps, body, kill_after=None):
    """POST ``body`` to both Apps (under a MIDKILL on each engine's own
    seam when ``kill_after``); their (status, lines), JAX's first."""
    outs = []
    for name, seams in (("jax", jchaos), ("port", chaos)):
        app = apps[name][0]
        if kill_after is None:
            outs.append(_post(app.http_port, body))
            continue
        sched = seams.ChaosSchedule(seed=0).on(
            seams.GENERATOR_MIDKILL, error=RuntimeError, every=kill_after,
            limit=1)
        with seams.scope(sched):
            outs.append(_post(app.http_port, body))
    return outs


@pytest.mark.parametrize("body", [
    {"max_new": 6},
    {"max_new": 5, "temperature": 0.7, "top_k": 15, "seed": 9},
    {"max_new": 4, "eos": [2, 7]},
])
def test_the_route_streams_jax_cursor_lines(apps, body):
    prompt = _prompt(20, seed=17)
    (js, jlines), (ps, plines) = _both(apps, {"tokens": prompt, **body})
    assert js == ps == 200
    assert plines == jlines
    assert [ln["cursor"] for ln in plines] == list(range(len(plines)))
    assert apps["port"][1].stats()["live"] == 0


def test_the_route_midstream_line_and_resume_round_trip(apps):
    """tests/test_resume.py's round trip on both Apps: a kill after 3
    tokens gives the typed line with a complete resume token; replaying
    it (the same request id) continues at cursor 3, the first line
    reports the recompute, and the spliced stream is the reference."""
    prompt = _prompt(20, seed=21)
    rid = "t-resume-port"
    ref = _both(apps, {"tokens": prompt, "max_new": 8})
    killed = _both(apps, {"tokens": prompt, "max_new": 8,
                          "request_id": rid}, kill_after=3)
    assert killed[0] == killed[1]
    status, lines = killed[1]
    assert status == 200
    toks = [ln for ln in lines if "token" in ln]
    emitted = [t["token"] for t in toks]
    err = lines[-1]["error"]
    assert [t["cursor"] for t in toks] == [0, 1, 2]
    assert err["status"] == 503 and err["retry_after"] > 0
    res = err["resume"]
    assert res["cursor"] == 3 and res["emitted"] == 3
    assert res["request_id"] == rid
    assert res["chain"] == resume_chain(prompt, emitted, 16, 0)
    resumed = _both(apps, {"tokens": prompt, "max_new": 8,
                           "request_id": rid, "resume_from": 3,
                           "emitted": emitted})
    assert resumed[0] == resumed[1]
    status2, lines2 = resumed[1]
    assert status2 == 200
    assert [t["cursor"] for t in lines2] == [3, 4, 5, 6, 7]
    # prompt + 3 emitted = 23 positions, 16 of them the stored prompt's
    # two full blocks of 8: 7 recomputed
    assert lines2[0]["recompute"] == 7
    assert emitted + [t["token"] for t in lines2] == \
        [ln["token"] for ln in ref[1][1]]
    assert apps["port"][1].stats()["live"] == 0


def test_the_route_refuses_a_resume_cursor_mismatch_as_jax(apps):
    (js, jbody), (ps, pbody) = _both(apps, {"tokens": _prompt(18, seed=23),
                                           "resume_from": 2, "emitted": [5]})
    assert (ps, pbody) == (js, jbody)
    assert ps == 400 and "resume_from" in json.dumps(pbody)


def test_a_repeated_request_id_cancels_the_ports_zombie_stream(apps):
    """The route's idempotent replay on the port's engine: a repeated
    request id cancels the stream the first attempt may still hold, and
    the engine retires it (its stream ends early, the slot frees)."""
    from gofr_tpu.serving import GenerateRoute

    eng = apps["port"][2]
    route = GenerateRoute(eng)
    zombie = eng.generate(_prompt(20, seed=29), max_new_tokens=100)
    route._live["r-zombie"] = zombie
    route._dedup("r-zombie")
    assert zombie.cancelled.is_set() and "r-zombie" not in route._live
    assert len(zombie.tokens()) < 100
    assert eng.generator.stats()["active"] == 0


def test_the_route_refuses_an_adapter_as_the_jax_route_does(apps):
    """Adapter 1 on engines built without LoRA (neither has adapter
    slots): each engine's range check raises at ``generate`` and both
    Apps answer with the same buffered error."""
    (js, jbody), (ps, pbody) = _both(apps, {"tokens": _prompt(18, seed=23),
                                           "adapter": 1})
    assert (ps, pbody) == (js, jbody)
    assert ps >= 400


# -- the App's drain, health and /debug/cache (both engines mounted) ----------

def _mounted(weights, rows):
    """Two Apps on localhost as a deployment mounts them: the JAX engine
    under a TPUEngine, the port's under TorchEngine, both as
    ``ctx.tpu`` with ``POST /generate``; (name, app, generator) each."""
    from gofr_tpu.tpu.engine import TPUEngine

    jtpu = TPUEngine(model_name="tiny")
    jtpu.generator = _jax(weights, **rows)
    ptpu = TorchEngine(_port(weights, **rows), "tiny", torch.device("cpu"))
    out = []
    for name, tpu in (("jax", jtpu), ("port", ptpu)):
        app = App(JMapConfig({"HTTP_PORT": "0", "METRICS_PORT": "0",
                              "APP_NAME": f"replica-{name}",
                              "LOG_LEVEL": "ERROR"}))
        app.container.tpu = tpu
        install_generate(app)
        app.run(block=False)
        out.append((name, app, tpu.generator))
    return out


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.mark.parametrize("prefix", [False, True])
def test_health_and_debug_cache_agree_with_the_jax_app(weights, prefix):
    """With the port's engine mounted, ``/.well-known/health`` reports
    UP and ``/debug/cache?format=json`` answers with the JAX-engine
    App's keys: ``{"enabled": false}`` without prefix sharing, the
    paged-shared index's stats with it."""
    mounted = _mounted(weights, dict(PAGED, **(PREFIX if prefix else {})))
    try:
        seen = {}
        for name, app, gen in mounted:
            hs, body = _get(app.http_port, "/.well-known/health")
            health = body["data"]
            cs, cache = _get(app.metrics_port, "/debug/cache?format=json")
            seen[name] = (hs, health["status"], health["tpu"]["status"],
                          sorted(health["tpu"]), cs, sorted(cache),
                          cache["enabled"],
                          sorted(cache["cache"] or {}))
    finally:
        for _, app, gen in mounted:
            app.stop()
            gen.close()
    assert seen["port"] == seen["jax"]
    assert seen["port"][:3] == (200, "UP", "UP")
    assert seen["port"][6] is prefix
    if prefix:
        assert "kind" in seen["port"][7] and "hits" in seen["port"][7]


def test_a_graceful_stop_finishes_a_live_stream_then_stops(weights):
    """``app.stop(grace_s > 0)`` with a stream live on ``POST /generate``:
    the engine drains (new requests refused), the client receives the
    whole stream over its live connection, then the listeners stop, on
    the port's App as on the JAX-engine App."""
    mounted = _mounted(weights, PAGED)
    seen = {}
    try:
        for name, app, gen in mounted:
            box = {}
            client = threading.Thread(target=lambda: box.update(
                out=_post(app.http_port, {"tokens": _prompt(20, seed=37),
                                          "max_new": 40})))
            client.start()
            deadline = time.monotonic() + 30
            while gen.stats()["active"] == 0 and time.monotonic() < deadline:
                time.sleep(0.005)
            live = gen.stats()["active"]
            app.stop(grace_s=30.0)
            client.join(30)
            assert not client.is_alive()
            with pytest.raises(urllib.error.URLError):
                urllib.request.urlopen(
                    f"http://127.0.0.1:{app.http_port}/.well-known/alive",
                    timeout=5)
            with pytest.raises(Exception, match="draining|closed"):
                gen.generate(_prompt(8), max_new_tokens=2)
            seen[name] = (live, box["out"], gen.stats().get("draining"))
    finally:
        for _, app, gen in mounted:
            gen.close()
    assert seen["port"] == seen["jax"]
    live, (status, lines), draining = seen["port"]
    assert live == 1 and status == 200 and draining is True
    assert [ln["cursor"] for ln in lines] == list(range(40))
