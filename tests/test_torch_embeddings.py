"""POST /v1/embeddings on the port's own App (gofr_tpu_torch.App with
``install_embeddings``) against the JAX package's, on the CPU at
``bert-tiny``: both Apps are built from the same rows and the same
``.npz`` (JAX's ``save_npz``), each Container wiring its package's
engine, and are compared over localhost: one input and several, the
400s, a 404 for an unknown program, a 429 from the embed program's gate
and a 504 from ``X-Request-Timeout``, both with the engine's
dispatcher held so that the order is the case's, and the health
``programs``. Embeddings agree within 2e-5 (float32, unit norm).

A case holds an App's dispatcher by wrapping its ``embed`` batcher's
runner: the first dispatch waits on an event until the case releases
it.
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
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.models import BERT_CONFIGS as JBERT
from gofr_tpu.models import bert as jbert
from gofr_tpu.serving import install_embeddings as jinstall_embeddings
from gofr_tpu.tpu.checkpoint import save_npz
import gofr_tpu_torch
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.serving import install_embeddings

EMBED_ATOL = 2e-5
ROWS = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR",
        "TPU_MODEL": "bert-tiny", "TPU_SEQ_BUCKETS": "8,16,32",
        "TPU_BATCH_BUCKETS": "1,2,4", "TPU_MAX_QUEUE_DEPTH": "1"}


@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "bert-tiny.npz"
    save_npz(str(path), jax.tree.map(
        np.asarray, jbert.init(JBERT["tiny"], jax.random.PRNGKey(4))))
    return str(path)


def _predict_route(app):
    """A route for any program by name (the 404 case)."""
    def handler(ctx):
        out = ctx.tpu.predict(ctx.path_param("program"),
                              np.arange(1, 4, dtype=np.int32))
        return {"out": np.asarray(out).tolist()}
    app.post("/predict/{program}", handler)


@pytest.fixture(scope="module")
def apps(weights_npz):
    """The JAX App and the port's on the same rows, each with its own
    POST /v1/embeddings, running on localhost."""
    rows = dict(ROWS, TPU_WEIGHTS=weights_npz)
    out = {}
    try:
        app = gofr_tpu.App(JMapConfig(dict(rows, APP_NAME="embed-jax")))
        jinstall_embeddings(app)
        _predict_route(app)
        app.run(block=False)
        out["jax"] = app
        app = gofr_tpu_torch.App(
            MapConfig(dict(rows, APP_NAME="embed-port")), device="cpu")
        install_embeddings(app)
        _predict_route(app)
        app.run(block=False)
        out["port"] = app
        yield out
    finally:
        for app in out.values():
            app.stop()


def _post(port, path, body, headers=None, raw=None):
    """(status, JSON body, response headers)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=raw if raw is not None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _both(apps, case):
    return {name: case(app) for name, app in apps.items()}


def _tokens(n, seed):
    return np.random.default_rng(seed).integers(
        1, JBERT["tiny"].vocab_size, n).tolist()


def _vectors(body):
    return np.asarray([d["embedding"] for d in body["data"]], np.float32)


@pytest.mark.parametrize("inputs", [
    _tokens(10, 1),                                 # one flat id list
    [_tokens(n, 10 + n) for n in (3, 16, 17, 32)],  # several, three buckets
    [_tokens(n, 20 + n) for n in (1, 7, 8, 9, 31)],  # bucket edges
])
def test_embeddings_answer_as_the_jax_app(apps, inputs):
    out = _both(apps, lambda app: _post(app.http_port, "/v1/embeddings",
                                        {"input": inputs}))
    (js, jbody, _), (ps, pbody, _) = out["jax"], out["port"]
    assert js == ps == 200
    jbody, pbody = jbody["data"], pbody["data"]   # the App's envelope
    vj, vp = _vectors(jbody), _vectors(pbody)
    assert vp.shape == vj.shape == (len(vj), JBERT["tiny"].dim)
    np.testing.assert_allclose(vp, vj, rtol=0, atol=EMBED_ATOL)
    np.testing.assert_allclose(np.linalg.norm(vp, axis=-1), 1.0, atol=1e-5)
    for body in (jbody, pbody):
        for d in body["data"]:
            d.pop("embedding")
    assert pbody == jbody   # object, index, model, meta
    assert pbody["model"] == "bert-tiny"
    assert pbody["meta"] == {"tenant": "default", "slo_class": "latency"}


def test_the_meta_carries_the_tenant_header_and_the_class(apps):
    out = _both(apps, lambda app: _post(
        app.http_port, "/v1/embeddings", {"input": [5, 6, 7]},
        headers={"X-Tenant-Id": "acme", "X-SLO-Class": "throughput"}))
    assert out["port"][1]["data"]["meta"] == \
        out["jax"][1]["data"]["meta"] == {
        "tenant": "acme", "slo_class": "throughput"}


@pytest.mark.parametrize("body,raw", [
    (None, b"[1, 2, 3]"),                     # not an object
    ({"inputs": [[1, 2]]}, None),             # no 'input'
    ({"input": []}, None),                    # empty
    ({"input": "hello"}, None),               # not an array
    ({"input": [[1, "x"]]}, None),            # malformed id
    ({"input": [[1, 2], []]}, None),          # an empty row
])
def test_the_400s_answer_as_the_jax_app(apps, body, raw):
    out = _both(apps, lambda app: _post(app.http_port, "/v1/embeddings",
                                        body, raw=raw))
    (js, jbody, _), (ps, pbody, _) = out["jax"], out["port"]
    assert ps == js == 400
    assert pbody == jbody


def test_an_unknown_program_answers_404_as_the_jax_app(apps):
    out = _both(apps, lambda app: _post(app.http_port, "/predict/nope", {}))
    (js, jbody, _), (ps, pbody, _) = out["jax"], out["port"]
    assert ps == js == 404
    assert pbody == jbody
    assert pbody["error"]["message"] == \
        "no TPU program 'nope'; registered: ['embed']"


@contextlib.contextmanager
def _held(app):
    """The embed program's dispatches wait until the case ends; yields
    the batches the runner was given (their token lists)."""
    b = app.container.tpu._batchers["embed"]
    inner, release, executed = b.runner, threading.Event(), []

    def held(items):
        executed.append([list(map(int, it)) for it in items])
        release.wait(10.0)
        return inner(items)

    b.runner = held
    try:
        yield executed
    finally:
        release.set()
        b.runner = inner


def _wait_for(pred, timeout=10.0):
    end = time.monotonic() + timeout
    while not pred() and time.monotonic() < end:
        time.sleep(0.002)
    return pred()


def _scrape(app, name):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{app.metrics_port}/metrics", timeout=10) as r:
        text = r.read().decode()
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith(name + "{") or line.startswith(name + " "))


def test_a_shed_answers_429_with_retry_after(apps):
    """One request inside the held dispatch, one waiting (the gate's
    depth bound of 1): the next answers a buffered 429 with
    ``Retry-After``, counted by the embed program's gate."""
    def case(app):
        tpu = app.container.tpu
        sheds0 = _scrape(app, "app_tpu_shed_total")
        with _held(app) as executed:
            first = threading.Thread(target=_post, args=(
                app.http_port, "/v1/embeddings", {"input": [1, 2, 3]}))
            first.start()
            assert _wait_for(lambda: executed)
            second = threading.Thread(target=_post, args=(
                app.http_port, "/v1/embeddings", {"input": [4, 5, 6]}))
            second.start()
            assert _wait_for(
                lambda: tpu._batchers["embed"].queue_depth() == 1)
            status, body, headers = _post(app.http_port, "/v1/embeddings",
                                          {"input": [7, 8, 9]})
        first.join(10)
        second.join(10)
        gate = tpu._gates["embed"]
        return (status, int(headers["Retry-After"]) >= 1,
                "shed" in body["error"]["message"], gate.sheds,
                _scrape(app, "app_tpu_shed_total") - sheds0)

    out = _both(apps, case)
    assert out["port"] == out["jax"] == (429, True, True, 1, 1.0)


def test_a_budget_that_runs_out_in_the_queue_answers_504(apps):
    """``X-Request-Timeout: 50ms`` behind a held dispatch: a buffered
    504 naming the deadline; the item is never executed and is counted
    in ``app_tpu_expired_dropped_total``."""
    def case(app):
        expired0 = _scrape(app, "app_tpu_expired_dropped_total")
        with _held(app) as executed:
            first = threading.Thread(target=_post, args=(
                app.http_port, "/v1/embeddings", {"input": [1, 2, 3]}))
            first.start()
            assert _wait_for(lambda: executed)
            t0 = time.monotonic()
            status, body, _ = _post(app.http_port, "/v1/embeddings",
                                    {"input": [11, 12, 13]},
                                    headers={"X-Request-Timeout": "50ms"})
            took = time.monotonic() - t0
        first.join(10)
        assert took < 2.0
        return (status, "deadline" in body["error"]["message"].lower(),
                [11, 12, 13] in [it for batch in executed for it in batch],
                _scrape(app, "app_tpu_expired_dropped_total") - expired0)

    out = _both(apps, case)
    assert out["port"] == out["jax"] == (504, True, False, 1.0)


def test_health_lists_the_programs_as_the_jax_app(apps):
    def case(app):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{app.http_port}/.well-known/health",
                timeout=10) as r:
            health = json.loads(r.read())["data"]
        tpu = health["tpu"]
        progs = tpu["details"]["programs"]
        return (health["status"], tpu["status"], sorted(progs),
                progs["embed"]["kind"], progs["embed"]["batch_buckets"],
                tpu["details"]["platform"], tpu["details"]["model"],
                sorted(tpu["details"]["admission"]))

    out = _both(apps, case)
    assert out["port"] == out["jax"] == (
        "UP", "UP", ["embed"], "tokens", [1, 2, 4], "cpu", "bert-tiny",
        ["embed"])
