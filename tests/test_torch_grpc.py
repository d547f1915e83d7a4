"""The port's gRPC transport against the JAX package's, on the CPU.

Across the wire: JAX's client against the port's GRPCServer, the port's
client against JAX's server, and a stock ``grpcio`` client against the
port's server all give the messages, statuses and trailers that JAX's
client gets from JAX's server.

Two Apps: a ``gofr_tpu.App`` and a ``gofr_tpu_torch.App(...,
device="cpu")`` built from the same rows (``TPU_MODEL=tiny``, the JAX
weights written once to a ``.npz``, ``GRPC_PORT=0``), each registering
the ``llm.Generation`` service of examples/tpu-token-streaming/main.py
(``Generate`` returns ``ServerStream(stream, _token_msg)``, ``Chat`` a
turn per request) and its HTTP ``POST /generate`` over
``ctx.stream(stream.map(...))``. Compared over localhost: tokens,
greedy and sampled; the Chat cancel that frees the only slot; a
``grpc-timeout`` that runs out in the queue; a shed; the drain; a
``traceparent``; the ``GRPC_STREAM`` chaos seam. A case orders its
requests by queueing them while it holds the engine's device lock.
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
from gofr_tpu import errors as jerrors
from gofr_tpu import grpcx as jgrpcx
from gofr_tpu import wire as jwire
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.tpu.checkpoint import save_npz
import gofr_tpu_torch
from gofr_tpu_torch import chaos
from gofr_tpu_torch import errors as perrors
from gofr_tpu_torch import grpcx as pgrpcx
from gofr_tpu_torch import wire as pwire
from gofr_tpu_torch.config import MapConfig

JCFG = JAX_CONFIGS["tiny"]
ROWS = {"HTTP_PORT": "0", "METRICS_PORT": "0", "GRPC_PORT": "0",
        "LOG_LEVEL": "ERROR", "TPU_MODEL": "tiny", "TPU_SLOTS": "2",
        "TPU_MAX_SEQ": "128", "TPU_SEQ_BUCKETS": "16,32",
        "TPU_MAX_QUEUE_DEPTH": "4"}
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
TRACEPARENT = f"00-{TRACE_ID}-00f067aa0ba902b7-01"
PACKAGES = {"jax": (gofr_tpu, jgrpcx, jchaos, jerrors, jwire, JMapConfig),
            "port": (gofr_tpu_torch, pgrpcx, chaos, perrors, pwire,
                     MapConfig)}


# -- the service of examples/tpu-token-streaming/main.py, for either package --

def _token_msg(item):
    if isinstance(item, tuple):
        return {"token": item[0], "logprob": item[1]}
    return {"token": item}


def llm_service(g):
    llm = g.GRPCService("llm.Generation")

    @llm.server_stream("Generate")
    def generate_grpc(ctx, req):
        stream = ctx.tpu.generate(req["tokens"],
                                  max_new_tokens=req.get("max_new_tokens", 64),
                                  temperature=req.get("temperature", 0.0),
                                  top_k=req.get("top_k", 0),
                                  eos_id=req.get("eos_id"),
                                  logprobs=req.get("logprobs", False))
        return g.ServerStream(stream, _token_msg)

    @llm.bidi_stream("Chat")
    def chat_grpc(ctx, requests):
        for req in requests:
            stream = ctx.tpu.generate(
                req["tokens"], max_new_tokens=req.get("max_new_tokens", 64),
                temperature=req.get("temperature", 0.0),
                top_k=req.get("top_k", 0), eos_id=req.get("eos_id"))
            try:
                for tok in stream:
                    yield {"token": tok}
            finally:
                stream.cancel()
            yield {"turn_done": True}

    return llm


def install_example(app, g):
    app.register_grpc_service(llm_service(g))

    @app.post("/generate")
    def generate_http(ctx):
        body = ctx.bind()
        stream = ctx.tpu.generate(body["tokens"],
                                  max_new_tokens=body.get("max_new_tokens", 64),
                                  temperature=body.get("temperature", 0.0),
                                  top_k=body.get("top_k", 0))
        ctx.stream(stream.map(
            lambda t: (json.dumps({"token": t}) + "\n").encode()))
        return None


@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "tiny.npz"
    save_npz(str(path), jax.tree.map(
        np.asarray, jllama.init(JCFG, jax.random.PRNGKey(1))))
    return str(path)


@contextlib.contextmanager
def _two_apps(weights_npz, **extra):
    """{name: (app, grpcx module, chaos module)}, JAX's first, both
    running on localhost with the example's service and route."""
    rows = dict(ROWS, TPU_WEIGHTS=weights_npz, **extra)
    out = {}
    try:
        for name, (pkg, g, seams, _, _, cfg) in PACKAGES.items():
            kw = {"device": "cpu"} if name == "port" else {}
            app = pkg.App(cfg(dict(rows, APP_NAME=f"grpc-{name}")), **kw)
            install_example(app, g)
            out[name] = (app, g, seams)
            app.run(block=False)
        yield out
    finally:
        for app, _, _ in out.values():
            if app._running.is_set():
                app.stop()


@pytest.fixture(scope="module")
def apps(weights_npz):
    with _two_apps(weights_npz) as out:
        yield out


def _both(apps, case):
    return [case(name, app, g, seams)
            for name, (app, g, seams) in apps.items()]


def _gen(app):
    return app.container.tpu.generator


def _prompt(n, seed=7):
    return np.random.default_rng(seed).integers(
        1, JCFG.vocab_size, n).tolist()


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


def _channel(g, port):
    """A channel whose finished calls' trailers are kept in order on
    ``ch.trailers`` (the client raises the status, not the trailers)."""
    ch = g.dial(f"127.0.0.1:{port}")
    ch.trailers = []
    finish = ch._finish_call

    def keep(call):
        ch.trailers.append(dict(call.trailers))
        finish(call)

    ch._finish_call = keep
    return ch


def _generate(g, port, body, metadata=None, timeout=60.0):
    """(messages or None, status code, message, trailers) of one
    Generate."""
    ch = _channel(g, port)
    try:
        try:
            msgs = list(ch.server_stream("/llm.Generation/Generate", body,
                                         timeout=timeout, metadata=metadata))
            out = (msgs, g.OK, "")
        except g.GRPCError as e:
            out = (None, e.code, e.message)
        _wait_for(lambda: ch.trailers, 5.0)
        return (*out, ch.trailers[-1] if ch.trailers else {})
    finally:
        ch.close()


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


def _counter(app, name):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{app.metrics_port}/metrics", timeout=30) as r:
        body = r.read().decode()
    return sum(float(line.rsplit(" ", 1)[1]) for line in body.splitlines()
               if line.startswith(name + "{") or line.startswith(name + " "))


# -- GenStream.map under ctx.stream: the example's HTTP route ------------------

def test_the_example_http_route_streams_through_genstream_map(apps):
    """The HTTP half of the example, ``ctx.stream(stream.map(...))``,
    streams the JAX App's lines on the port's App. (The port's GenStream
    had no ``map``: the route answered 500.)"""
    prompt = _prompt(20, seed=17)

    def case(name, app, g, seams):
        req = urllib.request.Request(
            f"http://127.0.0.1:{app.http_port}/generate",
            data=json.dumps({"tokens": prompt,
                             "max_new_tokens": 6}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, [json.loads(line) for line in
                                 resp.read().decode().splitlines() if line]

    jax_out, port_out = _both(apps, case)
    assert port_out == jax_out
    assert port_out[0] == 200 and len(port_out[1]) == 6
    from gofr_tpu_torch.tpu.generator import GenStream

    assert hasattr(GenStream, "map")


# -- Generate, Chat ---------------------------------------------------------------

@pytest.mark.parametrize("body", [
    {"max_new_tokens": 6},
    {"max_new_tokens": 5, "temperature": 0.7, "top_k": 15},
    {"max_new_tokens": 4, "logprobs": True},
    {"max_new_tokens": 8, "eos_id": [2, 7]},
])
def test_generate_streams_the_jax_tokens(apps, body):
    """Token-exact on the float32 ``tiny``, greedy and sampled (the
    engines' auto-seeds advance alike), each equal to the same request
    sent to the engine directly with the stream's seed."""
    prompt = _prompt(20, seed=19)

    def case(name, app, g, seams):
        tpu = app.container.tpu
        streams = []

        def generate(*args, **kw):
            streams.append(type(tpu).generate(tpu, *args, **kw))
            return streams[-1]

        tpu.generate = generate
        try:
            msgs, code, msg, trailers = _generate(
                g, app.grpc_port, {"tokens": prompt, **body})
        finally:
            del tpu.generate
        (s,) = streams
        again = tpu.generate(
            prompt, max_new_tokens=body["max_new_tokens"],
            temperature=body.get("temperature", 0.0),
            top_k=body.get("top_k", 0), eos_id=body.get("eos_id"),
            seed=s.seed)
        return ([m["token"] for m in msgs], list(again), code,
                trailers.get("grpc-status"),
                [m.get("logprob") for m in msgs])

    jax_out, port_out = _both(apps, case)
    toks, direct, code, status, logprobs = port_out
    assert (code, status) == (0, "0") and toks == direct
    assert port_out[:4] == jax_out[:4]
    if body.get("logprobs"):
        # the first token's log-probability comes from the prefill and
        # agrees to 1e-6; the decode steps read the int8 cache (the
        # rows' default), where the two packages' attention parts by up
        # to 2e-3 in a log-probability while every token agrees
        assert abs(logprobs[0] - jax_out[4][0]) < 1e-5
        np.testing.assert_allclose(logprobs, jax_out[4], atol=5e-3)
    else:
        assert logprobs == [None] * len(toks)


def test_chat_turns_and_a_cancel_free_the_only_slot(weights_npz):
    """tests/test_grpc.py's bidi case on both Apps: turn 1 streams its
    tokens and the turn marker; turn 2 is cancelled after its first
    token and, with one slot, a fresh Chat is served only because the
    cancel released it."""
    with _two_apps(weights_npz, TPU_SLOTS="1") as pair:
        def case(name, app, g, seams):
            gen = _gen(app)
            ch = g.dial(f"127.0.0.1:{app.grpc_port}")
            try:
                call = ch.bidi_stream("/llm.Generation/Chat", timeout=120.0)
                it = iter(call)
                call.send({"tokens": _prompt(12, 31), "max_new_tokens": 4})
                turn1 = [next(it) for _ in range(5)]
                call.send({"tokens": _prompt(9, 32),
                           "max_new_tokens": 1000})
                first = next(it)
                call.cancel()
                freed = _wait_for(lambda: gen.stats()["active"] == 0
                                  and gen.stats()["queued"] == 0, 60.0)
                call2 = ch.bidi_stream("/llm.Generation/Chat", timeout=120.0)
                call2.send({"tokens": _prompt(7, 33), "max_new_tokens": 3})
                call2.close_send()
                turn3 = list(call2)
            finally:
                ch.close()
            return turn1, "token" in first, freed, turn3

        jax_out, port_out = _both(pair, case)
    assert port_out == jax_out
    turn1, first, freed, turn3 = port_out
    assert [m for m in turn1 if "token" in m] and turn1[-1] == \
        {"turn_done": True}
    assert first and freed
    assert len([m for m in turn3 if "token" in m]) == 3
    assert turn3[-1] == {"turn_done": True}


# -- deadlines, sheds, traces, chaos ----------------------------------------------

def test_grpc_timeout_expires_in_the_queue_as_deadline_exceeded(apps):
    """``grpc-timeout: 50m`` on a Generate that waits behind two busy
    slots: its deadline runs out in the queue, the RPC ends
    DEADLINE_EXCEEDED and the engine counts one expiry there."""
    def case(name, app, g, seams):
        gen = _gen(app)
        before = _counter(app, "app_tpu_expired_dropped_total")
        with _slots_held(app):
            client, box = _in_thread(lambda: _generate(
                g, app.grpc_port, {"tokens": _prompt(12, 30),
                                   "max_new_tokens": 4},
                metadata={"grpc-timeout": "50m"}))
            assert _wait_for(lambda: gen.stats()["queued"] == 1)
            time.sleep(0.1)
        client.join(60)
        toks, code, msg, trailers = box["out"]
        return (toks, code, "deadline" in msg.lower(),
                trailers.get("grpc-status"),
                _counter(app, "app_tpu_expired_dropped_total") - before)

    jax_out, port_out = _both(apps, case)
    assert port_out == jax_out
    assert port_out == (None, jgrpcx.DEADLINE_EXCEEDED, True, "4", 1.0)
    assert _gen(apps["port"][0]).stats()["expired"]["queue"] == 1


def test_a_shed_ends_resource_exhausted_with_retry_after(apps):
    """With both slots busy and two requests waiting, a Generate with
    ``slo-class: throughput`` meets the gate's throughput bound: both
    Apps end it RESOURCE_EXHAUSTED with a ``retry-after`` trailer, and
    each engine counts the shed where the scrape shows it."""
    def case(name, app, g, seams):
        before = _counter(app, "app_tpu_shed_total")
        with _slots_held(app) as gen:
            queued = [app.container.tpu.generate(_prompt(6, 10 + i),
                                                 max_new_tokens=2)
                      for i in range(2)]
            toks, code, msg, trailers = _generate(
                g, app.grpc_port, {"tokens": _prompt(12, 20),
                                   "max_new_tokens": 2},
                metadata={"slo-class": "throughput"})
            sheds = dict(gen.stats()["admission"]["sheds_by_class"])
        served = [len(list(s)) for s in queued]
        return (toks, code, "shed (throughput)" in msg,
                trailers.get("grpc-status"),
                int(trailers.get("retry-after", 0)) >= 1, sheds,
                _counter(app, "app_tpu_shed_total") - before, served)

    jax_out, port_out = _both(apps, case)
    assert port_out == jax_out
    assert port_out == (None, jgrpcx.RESOURCE_EXHAUSTED, True, "8", True,
                        {"latency": 0, "throughput": 1}, 1.0, [2, 2])


def test_traceparent_reaches_the_streams_trace_id(apps):
    def case(name, app, g, seams):
        tpu = app.container.tpu
        streams = []

        def generate(*args, **kw):
            streams.append(type(tpu).generate(tpu, *args, **kw))
            return streams[-1]

        tpu.generate = generate
        try:
            toks, code, _, _ = _generate(
                g, app.grpc_port, {"tokens": _prompt(10, 50),
                                   "max_new_tokens": 2},
                metadata={"traceparent": TRACEPARENT})
        finally:
            del tpu.generate
        (stream,) = streams
        return len(toks), code, stream.trace_id

    jax_out, port_out = _both(apps, case)
    assert port_out == jax_out
    assert port_out == (2, 0, TRACE_ID)


def test_the_grpc_stream_seam_ends_the_rpc_unavailable(apps):
    """An error injected at each package's GRPC_STREAM seam ends that
    RPC UNAVAILABLE before dispatch; the next one is served."""
    def case(name, app, g, seams):
        sched = seams.ChaosSchedule(seed=0).on(
            seams.GRPC_STREAM, error=ConnectionResetError, every=1, limit=1)
        with seams.scope(sched):
            failed = _generate(g, app.grpc_port,
                               {"tokens": _prompt(8, 60),
                                "max_new_tokens": 2})
            served = _generate(g, app.grpc_port,
                               {"tokens": _prompt(8, 60),
                                "max_new_tokens": 2})
        return (failed[0], failed[1], failed[3].get("grpc-status"),
                len(served[0]), served[1])

    jax_out, port_out = _both(apps, case)
    assert port_out == jax_out
    assert port_out == (None, jgrpcx.UNAVAILABLE, "14", 2, 0)
    assert chaos.GRPC_STREAM in chaos.SEAMS


def test_a_drain_flips_health_and_finishes_the_live_stream(weights_npz):
    """``stop(grace_s)`` with a Generate accepted and queued: gRPC
    health answers NOT_SERVING and a new RPC UNAVAILABLE with a
    ``retry-after`` trailer while the engine drains, the live stream
    completes over its connection, and no server thread outlives the
    stop; alike on both Apps."""
    with _two_apps(weights_npz) as pair:
        def case(name, app, g, seams):
            gen = _gen(app)
            ch = g.dial(f"127.0.0.1:{app.grpc_port}")
            up = ch.unary("/grpc.health.v1.Health/Check", {}, timeout=10.0)
            with gen._device_lock:
                client, box = _in_thread(lambda: _generate(
                    g, app.grpc_port, {"tokens": _prompt(20, 70),
                                       "max_new_tokens": 40}))
                assert _wait_for(lambda: gen.stats()["queued"] == 1)
                stopper, _ = _in_thread(lambda: app.stop(grace_s=30.0))
                assert _wait_for(lambda: gen.stats()["draining"])
                down = ch.unary("/grpc.health.v1.Health/Check", {},
                                timeout=10.0)
                refused = _generate(g, app.grpc_port,
                                    {"tokens": _prompt(8), "max_new_tokens": 2})
            client.join(60)
            stopper.join(60)
            ch.close()
            assert not stopper.is_alive()
            toks, code, _, trailers = box["out"]
            srv = app._grpc_server
            gone = _wait_for(lambda: not srv._conns, 10.0) \
                and not srv._accept_thread.is_alive()
            return (up, down, refused[1], refused[3].get("retry-after"),
                    len(toks), code, trailers.get("grpc-status"), gone)

        jax_out, port_out = _both(pair, case)
    assert port_out == jax_out
    assert port_out == ({"status": "SERVING"}, {"status": "NOT_SERVING"},
                        jgrpcx.UNAVAILABLE, "30", 40, 0, "0", True)


def test_a_drain_ends_a_chat_idle_between_turns(weights_npz):
    """``stop(grace_s=30)`` with a Chat open and idle after its first
    turn: the stop returns well inside the grace and the Chat ends
    UNAVAILABLE on both Apps. The port's server ends it with the drain's
    ``retry-after`` trailer; JAX's App does not wait for its RPCs, and
    its Chat ends when the connection closes."""
    with _two_apps(weights_npz) as pair:
        def case(name, app, g, seams):
            ch = _channel(g, app.grpc_port)
            call = ch.bidi_stream("/llm.Generation/Chat", timeout=120.0)
            it = iter(call)
            call.send({"tokens": _prompt(12, 41), "max_new_tokens": 3})
            turn1 = [next(it) for _ in range(4)]
            t0 = time.monotonic()
            app.stop(grace_s=30.0)
            took = time.monotonic() - t0
            try:
                next(it)
                code = None
            except g.GRPCError as e:
                code = e.code
            ch.close()
            trailers = ch.trailers[-1] if ch.trailers else {}
            return (turn1[-1], code, took < 10.0), trailers

        (jax_out, _), (port_out, trailers) = _both(pair, case)
    assert port_out == jax_out
    assert port_out == ({"turn_done": True}, jgrpcx.UNAVAILABLE, True)
    assert trailers.get("grpc-status") == "14"
    assert trailers.get("retry-after") == "30"


def _stalled_generate(g, port, body):
    """A raw HTTP/2 client that opens one Generate with a stream window
    of 8 bytes, smaller than any message, and then never reads nor
    grants more: the server's first send finds no credit."""
    import socket

    h2, hpack = g.http2, g.hpack
    sock = socket.create_connection(("127.0.0.1", port))
    io = h2.FrameIO(sock)
    io.send_raw(h2.CLIENT_PREFACE)
    io.send_frame(h2.SETTINGS, 0, 0, h2.encode_settings(
        {h2.SETTINGS_INITIAL_WINDOW_SIZE: 8}))
    block = hpack.Encoder().encode([
        (":method", "POST"), (":scheme", "http"),
        (":path", "/llm.Generation/Generate"), (":authority", "test"),
        ("content-type", "application/grpc"), ("te", "trailers")])
    io.send_frame(h2.HEADERS, h2.FLAG_END_HEADERS, 1, block)
    io.send_frame(h2.DATA, h2.FLAG_END_STREAM, 1, g.service.grpc_frame(
        json.dumps(body).encode()))
    return sock


def test_a_stalled_client_does_not_stall_decoding(apps):
    """A client that stops reading: its stream's first message finds no
    flow-control credit, the push sender downgrades to the RPC's worker
    (which waits for credit), and the serving loop never blocks on it:
    the engine decodes the stalled stream to its end while another
    client's Generate is served whole; closing the stalled connection
    releases the RPC. Alike on both Apps."""
    def case(name, app, g, seams):
        gen = _gen(app)
        srv = app._grpc_server
        sock = _stalled_generate(g, app.grpc_port, {
            "tokens": _prompt(12, 80), "max_new_tokens": 30})
        try:
            assert _wait_for(lambda: gen.stats()["active"] == 1)
            msgs, code, _, _ = _generate(g, app.grpc_port, {
                "tokens": _prompt(10, 81), "max_new_tokens": 6})
            drained = _wait_for(lambda: gen.stats()["active"] == 0)
        finally:
            sock.close()
        released = _wait_for(lambda: not srv._conns)
        return len(msgs), code, drained, released

    jax_out, port_out = _both(apps, case)
    assert port_out == jax_out == (6, 0, True, True)


# -- across the wire: each package's client against the other's server ---------

def echo_service(g, errors, wire):
    svc = g.GRPCService("test.Echo")

    @svc.unary("Say")
    def say(ctx, req):
        return {"msg": req["msg"], "deadline": ctx.deadline is not None}

    @svc.server_stream("Count")
    def count(ctx, req):
        src = wire.PushStream()
        for i in range(req["n"]):
            src._push(i)
        src._push(None)
        return g.ServerStream(src, lambda i: {"i": i})

    @svc.unary("Shed")
    def shed(ctx, req):
        raise errors.TooManyRequests("shed (throughput)", retry_after=2.5)

    @svc.unary("Late")
    def late(ctx, req):
        raise errors.DeadlineExceeded()

    @svc.unary("Fail")
    def fail(ctx, req):
        raise g.GRPCError(g.INVALID_ARGUMENT, "bad thing: 100%")

    return svc


def _exchange(client_g, port):
    """What one client sees of the echo service: messages, statuses and
    the trailers, per RPC."""
    ch = _channel(client_g, port)
    out = []
    try:
        out.append(ch.unary("/test.Echo/Say", {"msg": "hé"}, timeout=10.0))
        out.append(list(ch.server_stream("/test.Echo/Count", {"n": 5})))
        for path in ("/test.Echo/Shed", "/test.Echo/Late", "/test.Echo/Fail",
                     "/test.Echo/Nope", "/grpc.health.v1.Health/Check"):
            try:
                out.append(ch.unary(path, {}, timeout=10.0))
            except client_g.GRPCError as e:
                out.append((e.code, e.message))
        _wait_for(lambda: len(ch.trailers) == 7, 5.0)
        out.append(ch.trailers)
    finally:
        ch.close()
    return out


@contextlib.contextmanager
def _echo_server(name):
    _, g, _, errors, wire, _ = PACKAGES[name]
    srv = g.GRPCServer([echo_service(g, errors, wire)], port=0)
    srv.start()
    try:
        yield srv
    finally:
        srv.stop()


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_each_client_against_each_server_sees_jax_on_jax(client, server):
    with _echo_server("jax") as srv:
        want = _exchange(jgrpcx, srv.port)
    with _echo_server(server) as srv:
        got = _exchange(PACKAGES[client][1], srv.port)
    assert got == want
    assert want[2] == (jgrpcx.RESOURCE_EXHAUSTED, "shed (throughput)")
    assert want[3][0] == jgrpcx.DEADLINE_EXCEEDED
    assert want[-1][2]["retry-after"] == "3"
    assert want[6] == {"status": "SERVING"}


def test_a_grpcio_client_against_the_port_server():
    """A stock grpcio client with generic JSON calls gets the port's
    messages, statuses and trailers, as it does JAX's."""
    grpc = pytest.importorskip("grpc")

    def run(name):
        with _echo_server(name) as srv:
            ch = grpc.insecure_channel(f"127.0.0.1:{srv.port}")
            try:
                def call(kind, path):
                    return getattr(ch, kind)(
                        path,
                        request_serializer=lambda d: json.dumps(d).encode(),
                        response_deserializer=json.loads)

                out = [call("unary_unary", "/test.Echo/Say")(
                           {"msg": "hi"}, timeout=10),
                       list(call("unary_stream", "/test.Echo/Count")(
                           {"n": 4}, timeout=10))]
                for path in ("/test.Echo/Shed", "/test.Echo/Late",
                             "/test.Echo/Fail"):
                    try:
                        call("unary_unary", path)({}, timeout=10)
                    except grpc.RpcError as e:
                        meta = dict(e.trailing_metadata() or ())
                        out.append((e.code().value[0], e.details(),
                                    meta.get("retry-after")))
                return out
            finally:
                ch.close()

    port, jx = run("port"), run("jax")
    assert port == jx
    assert port[0] == {"msg": "hi", "deadline": True}
    assert port[1] == [{"i": i} for i in range(4)]
    assert port[2] == (8, "shed (throughput)", "3")
    assert port[4] == (3, "bad thing: 100%", None)
