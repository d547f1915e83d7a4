"""The port's outbound service clients (gofr_tpu_torch.service) against
the JAX package's (gofr_tpu.service): each case of tests/test_service.py
run on both packages, with the same body and assertions, each client
against an in-process backend built from its own package's Router and
HTTPServer. Beside them: RS256 bearer tokens through ``verify_jwt``,
``oauth_middleware`` and ``App.enable_oauth`` on both packages, signed
with ``cryptography`` (the code's own gate), and the client half of the
resume contract, ``stream_generate``, over a ``tiny`` App of each
package on the same ``.npz`` weights, killed mid-stream: token-exact
against the uninterrupted stream and against each other.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu import chaos as jchaos
from gofr_tpu import glog as jglog
from gofr_tpu import metrics as jmetrics
from gofr_tpu import service as jservice
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.http import middleware as jmiddleware
from gofr_tpu.http import request as jrequest
from gofr_tpu.http import responder as jresponder
from gofr_tpu.http.router import Router as JRouter
from gofr_tpu.http.server import HTTPServer as JHTTPServer
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.serving import install_generate as jinstall_generate
from gofr_tpu.tpu.checkpoint import save_npz
from gofr_tpu_torch import chaos, glog, metrics, service
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.http import middleware, request, responder
from gofr_tpu_torch.http.router import Router
from gofr_tpu_torch.http.server import HTTPServer
from gofr_tpu_torch.serving import install_generate

PACKAGES = {
    "gofr_tpu": SimpleNamespace(
        App=gofr_tpu.App, MapConfig=JMapConfig, chaos=jchaos, glog=jglog,
        metrics=jmetrics, service=jservice, mw=jmiddleware,
        Request=jrequest.Request, ResponseWriter=jresponder.ResponseWriter,
        Router=JRouter, HTTPServer=JHTTPServer,
        install_generate=jinstall_generate),
    "gofr_tpu_torch": SimpleNamespace(
        App=gofr_tpu_torch.App, MapConfig=MapConfig, chaos=chaos, glog=glog,
        metrics=metrics, service=service, mw=middleware,
        Request=request.Request, ResponseWriter=responder.ResponseWriter,
        Router=Router, HTTPServer=HTTPServer,
        install_generate=install_generate),
}


@pytest.fixture(params=sorted(PACKAGES))
def pk(request):
    return PACKAGES[request.param]


def _logger(pk):
    """A DEBUG logger writing to buffers (the JAX testutil's MockLogger,
    built from each package's own Logger)."""
    return pk.glog.Logger(level=pk.glog.LogLevel.DEBUG, out=io.StringIO(),
                          err=io.StringIO(), pretty=False)


def _new(pk, url, metrics_=None, *options):
    return pk.service.new_http_service(url, _logger(pk), metrics_, *options)


@pytest.fixture()
def backend(pk):
    """In-process echo server of the package; yields (base_url, state
    dict, router)."""
    state = {"fail": False, "requests": []}
    r = pk.Router()

    def echo(req, w):
        state["requests"].append(req)
        if state["fail"]:
            w.status = 500
            w.write(b'{"error":"boom"}')
            return
        w.set_header("Content-Type", "application/json")
        w.write(json.dumps({
            "method": req.method, "path": req.path,
            "q": {k: v for k, v in req.query.items()},
            "auth": req.header("authorization"),
            "apikey": req.header("x-api-key"),
            "body": req.body.decode() if req.body else "",
        }).encode())

    for method in ("GET", "POST", "PUT", "PATCH", "DELETE"):
        r.add(method, "/echo", echo)
        r.add(method, "/api/items/{id}", echo)

    def alive(req, w):
        if state["fail"]:
            w.status = 500
            return
        w.write(b'{"data":{"status":"UP"}}')

    r.add("GET", "/.well-known/alive", alive)
    r.add("GET", "/custom-health", alive)

    srv = pk.HTTPServer(r, 0, _logger(pk))
    srv.start()
    yield f"http://127.0.0.1:{srv.port}", state, r
    srv.stop()


# -- tests/test_service.py's cases, on both packages ---------------------------

def test_verbs_params_and_body(pk, backend):
    url, state, _ = backend
    svc = _new(pk, url)

    got = svc.get("/echo", {"a": 1, "multi": [1, 2]}).json()
    assert got["method"] == "GET"
    assert got["q"]["a"] == ["1"] and got["q"]["multi"] == ["1", "2"]

    got = svc.post("/echo", body={"x": 1}).json()
    assert got["method"] == "POST" and json.loads(got["body"]) == {"x": 1}

    assert svc.put("/echo", body=b"raw").json()["body"] == "raw"
    assert svc.patch("/echo").json()["method"] == "PATCH"
    assert svc.delete("/echo").json()["method"] == "DELETE"


def test_non_2xx_is_response_not_exception(pk, backend):
    url, state, _ = backend
    svc = _new(pk, url)
    resp = svc.get("/does-not-exist")
    assert resp.status_code == 404 and not resp.ok


def test_metrics_recorded(pk, backend):
    url, _, _ = backend
    m = pk.metrics.Manager()
    pk.metrics.register_framework_metrics(m)
    svc = _new(pk, url, m)
    svc.get("/echo")
    text = m.render_prometheus()
    assert 'app_http_service_response' in text
    assert 'method="GET"' in text


def test_basic_auth_decorator(pk, backend):
    url, _, _ = backend
    svc = _new(pk, url, None, pk.service.BasicAuthOption("user", "pass"))
    got = svc.get("/echo").json()
    expect = base64.b64encode(b"user:pass").decode()
    assert got["auth"] == f"Basic {expect}"


def test_apikey_auth_decorator(pk, backend):
    url, _, _ = backend
    svc = _new(pk, url, None, pk.service.APIKeyAuthOption("sekrit"))
    assert svc.get("/echo").json()["apikey"] == "sekrit"


def test_oauth_decorator_fetches_and_caches_token(pk, backend):
    url, _, _ = backend
    calls = []

    def fake_fetch():
        calls.append(1)
        return {"access_token": "tok123", "expires_in": 3600}

    svc = _new(pk, url, None,
               pk.service.OAuthOption("http://unused/token", "id", "secret",
                                      fetch=fake_fetch))
    assert svc.get("/echo").json()["auth"] == "Bearer tok123"
    assert svc.get("/echo").json()["auth"] == "Bearer tok123"
    assert len(calls) == 1  # cached until expiry


def test_custom_health_endpoint(pk, backend):
    url, _, _ = backend
    svc = _new(pk, url, None, pk.service.HealthOption("/custom-health"))
    assert svc.health_check().status == "UP"


def test_decorators_compose(pk, backend):
    url, _, _ = backend
    svc = _new(
        pk, url, None,
        pk.service.CircuitBreakerOption(threshold=3, interval=60,
                                        start_background_probe=False),
        pk.service.BasicAuthOption("u", "p"),
        pk.service.APIKeyAuthOption("k"),
    )
    got = svc.get("/echo").json()
    assert got["auth"].startswith("Basic ") and got["apikey"] == "k"


def test_user_supplied_header_wins_any_casing(pk, backend):
    url, _, _ = backend
    svc = _new(pk, url, None, pk.service.BasicAuthOption("u", "p"))
    got = svc.get_with_headers(
        "/echo", headers={"authorization": "Bearer mine"}).json()
    assert got["auth"] == "Bearer mine"


def test_breaker_state_visible_through_outer_decorators(pk, backend):
    url, _, _ = backend
    svc = _new(
        pk, url, None,
        pk.service.CircuitBreakerOption(threshold=1, interval=60,
                                        start_background_probe=False),
        pk.service.BasicAuthOption("u", "p"))
    assert svc.is_open is False  # delegated through the auth wrapper


def test_custom_health_repoints_breaker_probe(pk, backend):
    url, state, _ = backend
    svc = _new(
        pk, url, None,
        pk.service.CircuitBreakerOption(threshold=1, interval=60,
                                        start_background_probe=False),
        pk.service.HealthOption("/custom-health"))
    probed = svc.inner.health_probe()  # svc.inner is the breaker
    assert probed.status == "UP"
    state["fail"] = True
    assert svc.inner.health_probe().status == "DOWN"


class TestCircuitBreaker:
    def test_opens_after_threshold_and_recovers(self, pk, backend):
        url, state, _ = backend
        svc = _new(
            pk, url, None,
            pk.service.CircuitBreakerOption(threshold=3, interval=60,
                                            start_background_probe=False))

        state["fail"] = True
        for _ in range(3):
            assert svc.get("/echo").status_code == 500
        assert svc.is_open
        with pytest.raises(pk.service.CircuitOpenError):
            svc.get("/echo")

        # inline recovery probe allowed after `interval` — force it by
        # rewinding the opened-at clock, then a healthy backend closes it
        state["fail"] = False
        svc._opened_at = svc._last_probe = 0.0
        assert svc.get("/echo").ok
        assert not svc.is_open
        # and failure count reset: three more failures needed to re-open
        state["fail"] = True
        assert svc.get("/echo").status_code == 500
        assert not svc.is_open

    def test_background_probe_closes_circuit(self, pk, backend):
        url, state, _ = backend
        svc = _new(pk, url, None,
                   pk.service.CircuitBreakerOption(threshold=1,
                                                   interval=0.05))
        state["fail"] = True
        svc.get("/echo")
        assert svc.is_open
        state["fail"] = False
        deadline = threading.Event()
        for _ in range(100):
            if not svc.is_open:
                break
            deadline.wait(0.05)
        assert not svc.is_open
        svc.close()

    def test_connection_refused_counts_as_failure(self, pk):
        svc = _new(pk, "http://127.0.0.1:1", None,
                   pk.service.CircuitBreakerOption(
                       threshold=2, interval=60,
                       start_background_probe=False))
        svc.inner.timeout = 0.2
        for _ in range(2):
            with pytest.raises(Exception):
                svc.get("/x")
        assert svc.is_open


# -- the port's own surfaces beside them ---------------------------------------

def test_the_port_exports_the_jax_service_surface():
    assert sorted(service.__all__) == sorted(jservice.__all__)
    from gofr_tpu_torch.errors import CircuitOpenError, ServiceUnavailable

    assert service.CircuitOpenError is CircuitOpenError
    assert CircuitOpenError("h:1").status_code == 503
    assert issubclass(CircuitOpenError, ServiceUnavailable)


@pytest.mark.parametrize("value,want", [
    ("3", 3.0), ("0.25", 0.25), ("-4", 0.0), ("", None), (None, None),
    ("Wed, 21 Oct 2015 07:28:00 GMT", None)])
def test_parse_retry_after_reads_as_jax_does(value, want):
    from gofr_tpu.errors import parse_retry_after as jparse
    from gofr_tpu_torch.errors import parse_retry_after

    assert parse_retry_after(value) == jparse(value) == want


def test_the_service_request_seam_fails_the_hop(pk, backend):
    url, state, _ = backend
    svc = _new(pk, url)
    sched = pk.chaos.ChaosSchedule(seed=3).on(
        pk.chaos.SERVICE_REQUEST, error=ConnectionError, every=2)
    with pk.chaos.scope(sched):
        assert svc.get("/echo").ok
        with pytest.raises(ConnectionError):
            svc.get("/echo")
        assert svc.get("/echo").ok
    assert len(state["requests"]) == 2
    assert sched.stats()["errors_fired"][pk.chaos.SERVICE_REQUEST] == 1


def test_an_app_serves_its_registered_service_to_handlers(pk, backend):
    """``add_http_service`` registers the client, ``ctx.get_http_service``
    reaches it from a handler, the health lists it under ``services``
    and ``stop()`` closes it (a breaker's probe thread ends)."""
    url, state, _ = backend
    app = pk.App(pk.MapConfig({"HTTP_PORT": "0", "METRICS_PORT": "0",
                               "LOG_LEVEL": "ERROR"}))
    app.add_http_service(
        "echo", url,
        pk.service.CircuitBreakerOption(threshold=1, interval=0.05),
        pk.service.HealthOption("/custom-health"))

    @app.get("/via")
    def via(ctx):
        return ctx.get_http_service("echo").get("/echo").json()["method"]

    app.run(block=False)
    try:
        with urllib_open(app.http_port, "/via") as r:
            assert json.loads(r.read())["data"] == "GET"
        with urllib_open(app.http_port, "/.well-known/health") as r:
            health = json.loads(r.read())["data"]
        assert health["services"]["echo"]["status"] == "UP"
        state["fail"] = True
        svc = app.container.get_http_service("echo")
        assert svc.get("/echo").status_code == 500
        assert svc.is_open
        probe = svc.inner._probe_thread
        assert probe is not None and probe.is_alive()
    finally:
        app.stop()
    probe.join(timeout=2)
    assert not probe.is_alive()


def urllib_open(port, path):
    import urllib.request

    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=10)


# -- RS256 bearer tokens --------------------------------------------------------

def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


@pytest.fixture(scope="module")
def rsa_key():
    # the code's own gate: RS256 needs the cryptography package
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives.asymmetric import rsa

    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def _jwks(key, kid="k1") -> bytes:
    nums = key.public_key().public_numbers()

    def enc(n: int) -> str:
        return _b64url(n.to_bytes((n.bit_length() + 7) // 8, "big"))

    return json.dumps({"keys": [{"kty": "RSA", "kid": kid, "alg": "RS256",
                                 "n": enc(nums.n), "e": enc(nums.e)}]}
                      ).encode()


def _token(key, claims: dict, kid="k1", alg="RS256") -> str:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    head = _b64url(json.dumps({"alg": alg, "kid": kid,
                               "typ": "JWT"}).encode())
    body = _b64url(json.dumps(claims).encode())
    sig = key.sign(f"{head}.{body}".encode(), padding.PKCS1v15(),
                   hashes.SHA256())
    return f"{head}.{body}.{_b64url(sig)}"


def test_verify_jwt_and_oauth_middleware_rs256(pk, rsa_key):
    jwks = _jwks(rsa_key)
    provider = pk.mw.JWKSKeyProvider("http://jwks.invalid/keys", 60.0,
                                     http_get=lambda url: jwks)
    try:
        claims = {"sub": "svc-a", "exp": time.time() + 60}
        good = _token(rsa_key, claims)
        assert pk.mw.verify_jwt(good, provider) == claims
        errors = []
        for bad in (good[:-4] + "AAAA",                       # signature
                    _token(rsa_key, {"exp": time.time() - 1}),  # expired
                    _token(rsa_key, claims, kid="other"),       # no key
                    _token(rsa_key, claims, alg="HS256"),       # algorithm
                    "not-a-jwt"):
            with pytest.raises(Exception) as ei:
                pk.mw.verify_jwt(bad, provider)
            assert ei.value.status_code == 401
            errors.append(ei.value.message)
        assert errors == ["invalid token signature", "token expired",
                          "unknown signing key",
                          "unsupported signing algorithm", "invalid token"]

        seen = []
        h = pk.mw.oauth_middleware(provider)(
            lambda req, w: seen.append(req.claims))
        w = pk.ResponseWriter()
        h(pk.Request("GET", "/x"), w)
        assert w.status == 401 and not seen
        w = pk.ResponseWriter()
        h(pk.Request("GET", "/x",
                     headers={"Authorization": f"Bearer {good}"}), w)
        assert seen == [claims]
        w = pk.ResponseWriter()
        h(pk.Request("GET", "/x", headers={
            "Authorization": f"Bearer {good[:-4]}AAAA"}), w)
        assert w.status == 401
        assert json.loads(w.body)["error"]["message"] == \
            "invalid token signature"
        # the health routes stay open
        w = pk.ResponseWriter()
        h(pk.Request("GET", "/.well-known/alive"), w)
        assert len(seen) == 2
    finally:
        provider.shutdown()


def test_enable_oauth_guards_routes_and_stop_halts_the_refresh(pk, rsa_key):
    jwks = _jwks(rsa_key)
    app = pk.App(pk.MapConfig({"HTTP_PORT": "0", "METRICS_PORT": "0",
                               "LOG_LEVEL": "ERROR"}))

    @app.get("/secure")
    def secure(ctx):
        return ctx.request.claims["sub"]

    app.enable_oauth("http://jwks.invalid/keys", refresh_interval=0.05,
                     http_get=lambda url: jwks)
    refresher = app._jwks_provider._thread
    app.run(block=False)
    try:
        import urllib.error
        import urllib.request

        url = f"http://127.0.0.1:{app.http_port}/secure"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url, timeout=10)
        assert ei.value.code == 401
        token = _token(rsa_key, {"sub": "svc-b"})
        req = urllib.request.Request(
            url, headers={"Authorization": f"Bearer {token}"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.loads(r.read())["data"] == "svc-b"
        assert refresher.is_alive()
    finally:
        app.stop()
    refresher.join(timeout=2)
    assert not refresher.is_alive()


# -- the client half of the resume contract ------------------------------------

JCFG = JAX_CONFIGS["tiny"]
ROWS = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR",
        "TPU_MODEL": "tiny", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "128",
        "TPU_SEQ_BUCKETS": "16,32"}


@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "tiny.npz"
    save_npz(str(path), jax.tree.map(
        np.asarray, jllama.init(JCFG, jax.random.PRNGKey(1))))
    return str(path)


@pytest.fixture(scope="module")
def replicas(weights_npz):
    """A tiny replica of each package on the same weights, each with its
    own POST /generate: {package name: app}."""
    out = {}
    try:
        for name, p in sorted(PACKAGES.items()):
            kw = {"device": "cpu"} if name == "gofr_tpu_torch" else {}
            app = p.App(p.MapConfig(dict(ROWS, TPU_WEIGHTS=weights_npz,
                                         APP_NAME=f"replica-{name}")), **kw)
            p.install_generate(app)
            app.run(block=False)
            out[name] = app
        yield out
    finally:
        for app in out.values():
            app.stop()


def test_stream_generate_client_auto_resumes(replicas):
    """tests/test_resume.py's case on both packages: a mid-stream kill
    (the GENERATOR_MIDKILL seam after 4 tokens) is invisible to
    ``stream_generate``, which replays the resume token; the yielded
    stream equals the uninterrupted one, and the port's client over the
    port's App equals JAX's client over JAX's App."""
    prompt = np.random.default_rng(31).integers(
        1, JCFG.vocab_size, 26).tolist()
    got = {}
    for name, app in replicas.items():
        p = PACKAGES[name]
        ref = app.container.tpu.generate(prompt, max_new_tokens=9).tokens()
        sched = p.chaos.ChaosSchedule(seed=0).on(
            p.chaos.GENERATOR_MIDKILL, error=RuntimeError, every=4, limit=1)
        with p.chaos.scope(sched):
            got[name] = list(p.service.stream_generate(
                f"127.0.0.1:{app.http_port}",
                {"tokens": prompt, "max_new": 9}))
        assert sched.stats()["errors_fired"][p.chaos.GENERATOR_MIDKILL] == 1
        assert got[name] == ref
    assert got["gofr_tpu_torch"] == got["gofr_tpu"]
