"""The port's App and HTTP transport (gofr_tpu_torch.app, .http, .errors,
.tracing, .metrics) against the JAX package's: the cases of
tests/test_http.py (request, router, responder envelopes, logging
recovery, CORS) and of tests/test_app.py (routes and defaults, the
metrics scrape, a handler exception, the correlation id, and the auth
middlewares: basic, API key, and basic auth on a running App), each one
test body run on both packages, with the same assertions.

Beside them: the block-chain hashes of ``tpu.kvcache`` bit-equal to
JAX's, the tracer's traceparent round trip, the error statuses, the
ambient deadline and class a handler sees, and the server's chaos seam.
"""

import base64
import dataclasses
import io
import json
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu import chaos as jchaos
from gofr_tpu import errors as jerrors
from gofr_tpu import glog as jglog
from gofr_tpu import resilience as jresilience
from gofr_tpu import tracing as jtracing
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.http import middleware as jmiddleware
from gofr_tpu.http import request as jrequest
from gofr_tpu.http import responder as jresponder
from gofr_tpu.http import router as jrouter
from gofr_tpu.tpu.kvcache import radix as jradix
from gofr_tpu_torch import chaos, errors, glog, resilience, tracing
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.http import middleware, request, responder, router
from gofr_tpu_torch.tpu.kvcache import radix

PACKAGES = {
    "gofr_tpu": SimpleNamespace(
        App=gofr_tpu.App, MapConfig=JMapConfig, chaos=jchaos,
        errors=jerrors, glog=jglog, resilience=jresilience,
        tracing=jtracing, mw=jmiddleware, Request=jrequest.Request,
        Responder=jresponder.Responder,
        ResponseWriter=jresponder.ResponseWriter, Raw=jresponder.Raw,
        FileResponse=jresponder.FileResponse, Router=jrouter.Router,
        compile_template=jrouter.compile_template),
    "gofr_tpu_torch": SimpleNamespace(
        App=gofr_tpu_torch.App, MapConfig=MapConfig, chaos=chaos,
        errors=errors, glog=glog, resilience=resilience, tracing=tracing,
        mw=middleware, Request=request.Request,
        Responder=responder.Responder,
        ResponseWriter=responder.ResponseWriter, Raw=responder.Raw,
        FileResponse=responder.FileResponse, Router=router.Router,
        compile_template=router.compile_template),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture
def app(pkg):
    a = pkg.App(pkg.MapConfig({"HTTP_PORT": "0", "METRICS_PORT": "0",
                               "APP_NAME": "test-app"}))
    yield a
    if a._running.is_set():
        a.stop()


def _get(port, path, **kw):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5, **kw) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


# -- tests/test_http.py's cases ---------------------------------------------

def test_request_params_and_headers(pkg):
    req = pkg.Request("get", "/items?x=1&x=2&y=hello",
                      headers={"Content-Type": "application/json",
                               "Host": "h:80"})
    assert req.method == "GET"
    assert req.path == "/items"
    assert req.param("x") == "1"
    assert req.params("x") == ["1", "2"]
    assert req.param("missing", "d") == "d"
    assert req.header("content-type") == "application/json"
    assert req.host_name() == "http://h:80"


def test_request_bind_json_and_dataclass(pkg):
    @dataclasses.dataclass
    class Body:
        name: str = ""
        count: int = 0

    req = pkg.Request("POST", "/x", body=b'{"name":"a","count":3,"extra":1}')
    assert req.bind() == {"name": "a", "count": 3, "extra": 1}
    b = req.bind(Body)
    assert b.name == "a" and b.count == 3

    with pytest.raises(pkg.errors.BadRequest):
        pkg.Request("POST", "/x", body=b"not-json").bind()
    with pytest.raises(pkg.errors.BadRequest):
        pkg.Request("POST", "/x").bind()


def test_path_template_compilation(pkg):
    pat = pkg.compile_template("/user/{id}/posts/{post_id}")
    m = pat.match("/user/42/posts/abc")
    assert m.groupdict() == {"id": "42", "post_id": "abc"}
    assert pat.match("/user/42") is None


def test_router_dispatch_and_status(pkg):
    r = pkg.Router()
    r.add("GET", "/hello/{name}",
          lambda req, w: w.write(req.path_param("name").encode()))

    w = pkg.ResponseWriter()
    r(pkg.Request("GET", "/hello/world"), w)
    assert w.body == b"world" and w.status == 200

    w = pkg.ResponseWriter()
    r(pkg.Request("POST", "/hello/world"), w)
    assert w.status == 405

    w = pkg.ResponseWriter()
    r(pkg.Request("GET", "/nope"), w)
    assert w.status == 404


def test_responder_envelopes(pkg):
    w = pkg.ResponseWriter()
    pkg.Responder(w).respond({"a": 1}, None)
    assert json.loads(w.body) == {"data": {"a": 1}}

    w = pkg.ResponseWriter()
    pkg.Responder(w).respond(None, pkg.errors.EntityNotFound("user", "9"))
    assert w.status == 404
    assert "user" in json.loads(w.body)["error"]["message"]

    w = pkg.ResponseWriter()
    pkg.Responder(w).respond(pkg.Raw([1, 2]), None)
    assert json.loads(w.body) == [1, 2]

    w = pkg.ResponseWriter()
    pkg.Responder(w).respond(pkg.FileResponse(b"png-bytes", name="x.png"),
                             None)
    assert w.headers["Content-Type"] == "image/png"
    assert w.body == b"png-bytes"


def _mock_logger(pkg):
    out, err = io.StringIO(), io.StringIO()
    return pkg.glog.Logger(level=pkg.glog.LogLevel.DEBUG, out=out, err=err,
                           pretty=False), out, err


def test_logging_middleware_recovers_and_logs(pkg):
    log, out, err = _mock_logger(pkg)

    def boom(req, w):
        raise RuntimeError("kaboom")

    h = pkg.mw.logging_middleware(log)(boom)
    w = pkg.ResponseWriter()
    h(pkg.Request("GET", "/x"), w)
    assert w.status == 500
    assert "panic recovered" in err.getvalue()
    assert '"uri": "/x"' in out.getvalue() or "/x" in out.getvalue()


def test_cors_short_circuits_options(pkg):
    called = []
    h = pkg.mw.cors_middleware()(lambda req, w: called.append(1))
    w = pkg.ResponseWriter()
    h(pkg.Request("OPTIONS", "/x"), w)
    assert not called
    assert w.headers["Access-Control-Allow-Origin"] == "*"
    h(pkg.Request("GET", "/x"), w)
    assert called


def test_basic_auth(pkg):
    ok = []
    h = pkg.mw.basic_auth_middleware({"admin": "secret"})(
        lambda req, w: ok.append(1))
    w = pkg.ResponseWriter()
    h(pkg.Request("GET", "/x"), w)
    assert w.status == 401 and not ok

    creds = base64.b64encode(b"admin:secret").decode()
    w = pkg.ResponseWriter()
    h(pkg.Request("GET", "/x", headers={"Authorization": f"Basic {creds}"}),
      w)
    assert ok

    bad = base64.b64encode(b"admin:wrong").decode()
    w = pkg.ResponseWriter()
    h(pkg.Request("GET", "/x", headers={"Authorization": f"Basic {bad}"}), w)
    assert w.status == 401


def test_apikey_auth(pkg):
    ok = []
    h = pkg.mw.apikey_auth_middleware(["k1"])(lambda req, w: ok.append(1))
    w = pkg.ResponseWriter()
    h(pkg.Request("GET", "/x", headers={"X-API-KEY": "k1"}), w)
    assert ok
    w = pkg.ResponseWriter()
    h(pkg.Request("GET", "/x", headers={"X-API-KEY": "nope"}), w)
    assert w.status == 401


# -- tests/test_app.py's cases ----------------------------------------------

def test_app_serves_routes_and_defaults(app, pkg):
    @app.get("/greet")
    def greet(ctx):
        return {"hello": ctx.param("name", "world")}

    @app.get("/missing")
    def missing(ctx):
        raise pkg.errors.EntityNotFound("thing", "1")

    @app.post("/echo")
    def echo(ctx):
        return ctx.bind()

    app.run(block=False)
    port = app.http_port

    status, body = _get(port, "/greet?name=tpu")
    assert status == 200
    assert json.loads(body) == {"data": {"hello": "tpu"}}

    status, body = _get(port, "/missing")
    assert status == 404

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/echo", data=b'{"a":1}',
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=5) as r:
        assert json.loads(r.read()) == {"data": {"a": 1}}

    status, body = _get(port, "/.well-known/alive")
    assert status == 200 and json.loads(body)["data"]["status"] == "UP"

    status, body = _get(port, "/.well-known/health")
    health = json.loads(body)["data"]
    assert health["name"] == "test-app" and health["status"] == "UP"

    status, _ = _get(port, "/favicon.ico")
    assert status == 200

    status, _ = _get(port, "/no-such-route")
    assert status == 404


def test_metrics_endpoint_scrapes(app):
    @app.get("/ping")
    def ping(ctx):
        return "pong"

    app.run(block=False)
    _get(app.http_port, "/ping")
    status, body = _get(app.metrics_port, "/metrics")
    assert status == 200
    text = body.decode()
    assert "app_http_response_bucket" in text
    assert 'path="/ping"' in text
    assert "app_go_routines" in text


def test_handler_exception_recovered(app):
    @app.get("/boom")
    def boom(ctx):
        raise RuntimeError("unexpected")

    app.run(block=False)
    status, body = _get(app.http_port, "/boom")
    assert status == 500
    assert "error" in json.loads(body)


def test_basic_auth_enabled_app(app):
    @app.get("/secure")
    def secure(ctx):
        return "top-secret"

    app.enable_basic_auth({"u": "p"})
    app.run(block=False)
    status, _ = _get(app.http_port, "/secure")
    assert status == 401
    # health stays open (reference middleware skips well-known routes)
    status, _ = _get(app.http_port, "/.well-known/alive")
    assert status == 200


def test_correlation_id_and_traceparent(app):
    @app.get("/traced")
    def traced(ctx):
        with ctx.trace("inner-work"):
            return "ok"

    app.run(block=False)
    req = urllib.request.Request(
        f"http://127.0.0.1:{app.http_port}/traced",
        headers={"traceparent": "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"})
    with urllib.request.urlopen(req, timeout=5) as r:
        assert r.headers["X-Correlation-ID"] == "ab" * 16


# -- beside them ---------------------------------------------------------------

def test_a_handler_sees_the_ambient_deadline_and_class(app, pkg):
    """The deadline and SLO-class middlewares open the package's own
    scopes: a handler reads them on ``ctx``, and an error of the
    package's own class keeps its status and headers."""
    @app.get("/scope")
    def scope(ctx):
        return {"budget": ctx.deadline is not None
                and 0 < ctx.deadline.remaining() <= 2.0,
                "class": ctx.slo_class}

    @app.get("/shed")
    def shed(ctx):
        raise pkg.errors.TooManyRequests("full", retry_after=2.2)

    app.run(block=False)
    req = urllib.request.Request(
        f"http://127.0.0.1:{app.http_port}/scope",
        headers={"X-Request-Timeout": "2s", "X-SLO-Class": "bulk"})
    with urllib.request.urlopen(req, timeout=5) as r:
        assert json.loads(r.read())["data"] == {"budget": True,
                                                "class": "throughput"}
    status, body = _get(app.http_port, "/scope")
    assert json.loads(body)["data"] == {"budget": False, "class": "latency"}
    try:
        urllib.request.urlopen(f"http://127.0.0.1:{app.http_port}/shed",
                               timeout=5)
        raise AssertionError("the shed answered 2xx")
    except urllib.error.HTTPError as e:
        assert (e.code, e.headers["Retry-After"]) == (429, "3")
        assert json.loads(e.read())["error"]["message"] == "full"


ERRORS = ["BadRequest", "Unauthorized", "Forbidden", "NotFound",
          "InternalServerError", "ServiceUnavailable", "TooManyRequests",
          "DeadlineExceeded"]


@pytest.mark.parametrize("name", ERRORS)
def test_errors_map_to_the_jax_packages_statuses(name):
    port, ref = getattr(errors, name)(), getattr(jerrors, name)()
    assert isinstance(port, errors.HTTPError)
    assert errors.status_from_error(port) == jerrors.status_from_error(ref)
    assert port.to_dict() == ref.to_dict()
    assert errors.status_from_error(None) == 200
    assert errors.status_from_error(ValueError()) == 500
    assert (errors.InvalidParameter("a", "b").message
            == jerrors.InvalidParameter("a", "b").message)
    assert (errors.MissingParameter("a").message
            == jerrors.MissingParameter("a").message)


def test_the_tracer_round_trips_a_traceparent(pkg):
    tr = pkg.tracing
    exporter = tr.InMemoryExporter()
    tracer = tr.Tracer("svc", exporter=exporter)
    inbound = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    with tracer.span("outer", traceparent=inbound) as outer:
        assert tr.current_span() is outer
        assert (outer.trace_id, outer.parent_id) == ("ab" * 16, "cd" * 8)
        with tracer.span("inner") as inner:
            assert inner.parent_id == outer.span_id
        hop = tr.parse_traceparent(outer.traceparent())
        assert hop == (outer.trace_id, outer.span_id)
    assert tr.current_span() is None
    assert [s.name for s in exporter.spans] == ["inner", "outer"]
    # all-zero ids are invalid: a fresh trace starts
    for bad in ("00-" + "0" * 32 + "-" + "cd" * 8 + "-01", "garbage", None):
        assert tr.parse_traceparent(bad) is None
    with tracer.span("fresh", traceparent="00-" + "0" * 32 + "-"
                     + "cd" * 8 + "-01") as fresh:
        assert fresh.trace_id != "0" * 32 and fresh.parent_id is None


def test_the_servers_chaos_seam_fires_once_a_request(app, pkg):
    @app.get("/ok")
    def ok(ctx):
        return "ok"

    app.run(block=False)
    sched = pkg.chaos.ChaosSchedule(seed=0).on(pkg.chaos.HTTP_REQUEST,
                                               latency=0.001)
    with pkg.chaos.scope(sched):
        for _ in range(3):
            assert _get(app.http_port, "/ok")[0] == 200
    assert sched.stats()["calls"] == {pkg.chaos.HTTP_REQUEST: 3}


@pytest.mark.parametrize("n,block,adapter", [
    (0, 16, 0), (15, 16, 0), (16, 16, 0), (100, 16, 0), (100, 16, 3),
    (257, 8, 0), (1024, 128, 1)])
def test_chain_hashes_are_bit_equal_to_jax(n, block, adapter):
    toks = np.random.default_rng(n + block).integers(0, 128256, n)
    got = list(radix.chain_hashes(toks, block, adapter))
    assert got == list(jradix.chain_hashes(toks, block, adapter))
    assert len(got) == n // block
    assert list(radix.chain_hashes(toks, block, adapter, limit=2)) == \
        got[:2]
    assert radix.first_block_hash(toks, block, adapter) == \
        jradix.first_block_hash(toks, block, adapter)
