"""Pub/sub on both packages: every case of tests/test_pubsub.py run on
the JAX package's datasource and on the port's own copy
(gofr_tpu_torch.datasource.pubsub), each over its own process-global
MEM broker: Message as the request surface, the broker's at-least-once
cursor (a commit moves the group's offset to max(committed, offset +
1); a fresh client resumes there), consumer groups, the blocking
subscribe, topic admin and health, the publish counters, the gated
backends and the end-to-end subscriber loop on each package's App.

Beyond the JAX cases: a handler failure leaves its message uncommitted
on both Apps (logged with its topic; a fresh same-group client gets it
again); a handler whose ``predict_batch`` meets a failed device
dispatch is logged and uncommitted the same way; the kafka-vit-classify example's
handler on both Apps at ViT ``tiny`` with JAX's weights carried across
(``TPU_WEIGHTS``): the same labels and the same published message; the
counters, ``health()["pubsub"]`` and the subscriber threads' join at
``stop()``. A ``PUBSUB_BACKEND`` whose client cannot be built raises at
the port's construction naming the backend, where the JAX container
logs it and goes on without pub/sub.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu import errors as jerrors
from gofr_tpu import metrics as jmetrics
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.datasource import pubsub as jpubsub
from gofr_tpu.datasource.pubsub import mem as jmem
from gofr_tpu.models import VIT_CONFIGS as JVIT
from gofr_tpu.models import vit as jvit
from gofr_tpu.testutil import new_mock_logger
from gofr_tpu.tpu.checkpoint import save_npz
from gofr_tpu_torch import errors as perrors
from gofr_tpu_torch import metrics as pmetrics
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.datasource import pubsub as ppubsub
from gofr_tpu_torch.datasource.pubsub import mem as pmem
from gofr_tpu_torch.glog import LogLevel, new_logger

PACKAGES = {
    "jax": SimpleNamespace(name="jax", pkg=gofr_tpu, pubsub=jpubsub,
                           mem=jmem, errors=jerrors, metrics=jmetrics,
                           config=JMapConfig, kw={},
                           logger=lambda: new_mock_logger()),
    "port": SimpleNamespace(name="port", pkg=gofr_tpu_torch, pubsub=ppubsub,
                            mem=pmem, errors=perrors, metrics=pmetrics,
                            config=MapConfig, kw={"device": "cpu"},
                            logger=lambda: new_logger(LogLevel.ERROR)),
}
APP_ROWS = {"PUBSUB_BACKEND": "MEM", "HTTP_PORT": "0", "METRICS_PORT": "0",
            "LOG_LEVEL": "ERROR"}


@pytest.fixture(params=sorted(PACKAGES))
def pk(request):
    return PACKAGES[request.param]


@pytest.fixture(autouse=True)
def clean_brokers():
    jmem.reset()
    pmem.reset()
    yield
    jmem.reset()
    pmem.reset()


def _client(pk, group="gofr", metrics=None):
    cfg = pk.config({"PUBSUB_BACKEND": "MEM", "CONSUMER_ID": group})
    return pk.pubsub.new_pubsub_client("MEM", cfg, pk.logger(), metrics)


def _app(pk, **rows):
    return pk.pkg.App(pk.config(dict(APP_ROWS, **rows)), **pk.kw)


def _counter(m, name: str) -> float:
    return sum(float(line.rsplit(" ", 1)[1])
               for line in m.render_prometheus().splitlines()
               if line.startswith(name) and not line.startswith("#"))


# -- tests/test_pubsub.py, on both packages -----------------------------------

def test_message_request_surface(pk):
    msg = pk.pubsub.Message("orders", b'{"id": 7}', metadata={"k": "v"})
    assert msg.param("k") == "v"
    assert msg.path_param("k") == "v"
    assert msg.header("k") == "v"
    assert msg.host_name() == "pubsub://orders"
    assert msg.bind() == {"id": 7}


def test_message_bind_dataclass_and_errors(pk):
    @dataclasses.dataclass
    class Order:
        id: int = 0

    Message = pk.pubsub.Message
    assert Message("t", b'{"id": 3, "x": 1}').bind(Order).id == 3
    with pytest.raises(pk.errors.BadRequest, match="empty"):
        Message("t", b"").bind()
    with pytest.raises(pk.errors.BadRequest, match="invalid JSON"):
        Message("t", b"nope").bind()
    with pytest.raises(pk.errors.BadRequest, match="object"):
        Message("t", b"[1]").bind(Order)


def test_message_commit_idempotent(pk):
    calls = []
    msg = pk.pubsub.Message("t", b"x", committer=lambda: calls.append(1))
    msg.commit()
    msg.commit()
    assert calls == [1] and msg.committed


def test_publish_subscribe_order(pk):
    c = _client(pk)
    c.publish("t", b"one")
    c.publish("t", {"n": 2})  # dict auto-serializes
    c.publish("t", "three")   # str encodes
    m1, m2, m3 = (c.subscribe("t", timeout=1) for _ in range(3))
    assert m1.value == b"one" and m3.value == b"three"
    assert json.loads(m2.value) == {"n": 2}
    assert m1.metadata == {"offset": "0", "group": "gofr"}


def test_subscribe_timeout(pk):
    c = _client(pk)
    t0 = time.monotonic()
    assert c.subscribe("empty", timeout=0.1) is None
    assert time.monotonic() - t0 < 1.0


def test_uncommitted_redelivery_on_new_client(pk):
    """At-least-once: a new client (same group) resumes from the last
    COMMITTED offset, so uncommitted messages are redelivered."""
    a = _client(pk, "g1")
    a.publish("t", b"m0")
    a.publish("t", b"m1")
    a.subscribe("t", timeout=1).commit()   # m0 committed
    a.subscribe("t", timeout=1)            # m1 delivered, NOT committed
    b = _client(pk, "g1")                  # simulated restart
    assert b.subscribe("t", timeout=1).value == b"m1"


def test_a_late_commit_never_moves_the_offset_back(pk):
    """The group's offset is max(committed, offset + 1): committing m0
    after m1 keeps it past m1."""
    a = _client(pk, "g1")
    for v in (b"m0", b"m1", b"m2"):
        a.publish("t", v)
    m0, m1 = a.subscribe("t", timeout=1), a.subscribe("t", timeout=1)
    m1.commit()
    m0.commit()
    assert _client(pk, "g1").subscribe("t", timeout=1).value == b"m2"


def test_consumer_groups_independent(pk):
    c = _client(pk, "g1")
    c.publish("t", b"x")
    assert c.subscribe("t", timeout=1).value == b"x"
    assert _client(pk, "g2").subscribe("t", timeout=1).value == b"x"


def test_blocking_subscribe_wakes_on_publish(pk):
    c = _client(pk)
    got = []
    th = threading.Thread(target=lambda: got.append(c.subscribe("t", 5)))
    th.start()
    time.sleep(0.05)
    c.publish("t", b"wake")
    th.join(timeout=2)
    assert got and got[0].value == b"wake"


def test_topic_admin_and_health(pk):
    c = _client(pk)
    c.create_topic("a")
    c.publish("a", b"1")
    h = c.health_check()
    assert h.status == "UP" and h.details["topics"] == {"a": 1}
    assert h.to_dict()["details"]["backend"] == "MEM"
    c.delete_topic("a")
    assert "a" not in c.health_check().details["topics"]


def test_publish_counters(pk):
    m = pk.metrics.Manager()
    pk.metrics.register_framework_metrics(m)
    c = _client(pk, metrics=m)
    c.publish("t", b"x")
    c.publish("t", b"y")
    assert _counter(m, "app_pubsub_publish_total_count") == 2
    assert _counter(m, "app_pubsub_publish_success_count") == 2


def test_gated_backends_raise_without_libs(pk):
    cfg = pk.config({})
    for backend in ("KAFKA", "GOOGLE", "MQTT"):
        with pytest.raises((RuntimeError, ValueError)):
            pk.pubsub.new_pubsub_client(backend, cfg)
    with pytest.raises(ValueError, match="NATS"):
        pk.pubsub.new_pubsub_client("NATS", cfg)


def test_the_mem_broker_state_is_one_per_package():
    """Each package's MEM broker is its own process-global log: a test
    on one never sees the other's messages."""
    _client(PACKAGES["jax"]).publish("t", b"j")
    assert _client(PACKAGES["port"]).subscribe("t", timeout=0.05) is None


def test_subscriber_loop_end_to_end(pk):
    """Reference subscriber_test.go:30-38: a handler registered on a
    real App with the in-process broker consumes a published message
    and commits it."""
    app = _app(pk)
    seen = []
    done = threading.Event()

    @app.subscribe("orders")
    def on_order(ctx):
        seen.append((ctx.bind(), ctx.param("group")))
        done.set()

    app.container.get_publisher().publish("orders", {"id": 1})
    with app:
        assert done.wait(timeout=5), "handler never ran"
    assert seen == [({"id": 1}, "gofr")]
    # commit-on-success: a fresh same-group client sees nothing pending
    assert _client(pk).subscribe("orders", timeout=0.2) is None
    m = app.container.metrics
    assert _counter(m, "app_pubsub_subscribe_total_count") == 1
    assert _counter(m, "app_pubsub_subscribe_success_count") == 1


# -- beyond tests/test_pubsub.py ----------------------------------------------

def _run_until(app, done: threading.Event, timeout: float = 5.0):
    with app:
        assert done.wait(timeout=timeout), "handler never ran"
        time.sleep(0.1)   # the loop's commit (or its absence) lands


def _capture_errors(app) -> list:
    seen = []
    app.container.logger.error = lambda *a, **k: seen.append(a[0])
    return seen


def _record_deliveries(app) -> list:
    """Every message the App's subscribers receive, in order."""
    seen = []
    client = app.container.pubsub
    inner = client.subscribe

    def subscribe(topic, timeout=None):
        msg = inner(topic, timeout)
        if msg is not None:
            seen.append(msg)
        return msg

    client.subscribe = subscribe
    return seen


def test_a_handler_failure_leaves_its_message_uncommitted(pk):
    app = _app(pk)
    errors = _capture_errors(app)
    done = threading.Event()

    def fail(ctx):
        done.set()
        raise RuntimeError("handler boom")

    app.subscribe("jobs", fail)   # the call form, beside the decorator
    app.container.get_publisher().publish("jobs", {"id": 9})
    _run_until(app, done)
    assert any(e.get("event") == "subscriber handler error"
               and e.get("topic") == "jobs" and "handler boom" in e["error"]
               for e in errors)
    m = app.container.metrics
    assert _counter(m, "app_pubsub_subscribe_total_count") >= 1
    assert _counter(m, "app_pubsub_subscribe_success_count") == 0
    # at-least-once: a restarted consumer of the group gets it again
    assert _client(pk).subscribe("jobs", timeout=1).bind() == {"id": 9}


def test_an_app_stop_joins_its_subscriber_threads(pk):
    app = _app(pk)
    app.subscribe("a", lambda ctx: None)
    app.subscribe("b", lambda ctx: None)
    app.run(block=False)
    names = {t.name for t in threading.enumerate()}
    assert {"subscriber-a", "subscriber-b"} <= names
    t0 = time.monotonic()
    app.stop(grace_s=0.5)   # the drain stops them first thing
    assert time.monotonic() - t0 < 3.0
    assert not {t.name for t in threading.enumerate()
                if t.is_alive()} & {"subscriber-a", "subscriber-b"}


def test_health_lists_the_broker(pk):
    app = _app(pk)
    app.container.get_publisher().publish("t", b"1")
    h = app.container.health()
    try:
        assert h["status"] == "UP"
        assert h["pubsub"]["details"] == {"backend": "MEM",
                                          "topics": {"t": 1},
                                          "group": "gofr"}
    finally:
        app.stop()


def test_a_broker_whose_client_cannot_be_built_raises_on_the_port():
    """The deliberate difference: JAX logs the failed client and goes on
    with ``pubsub = None``; the port raises naming the backend."""
    rows = dict(APP_ROWS, PUBSUB_BACKEND="KAFKA")
    japp = gofr_tpu.App(JMapConfig(rows))
    try:
        assert japp.container.pubsub is None
    finally:
        japp.stop()
    with pytest.raises(RuntimeError, match="PUBSUB_BACKEND=KAFKA"):
        gofr_tpu_torch.App(MapConfig(rows), device="cpu")


# -- the kafka-vit-classify example's handler on both Apps --------------------

def classify(ctx):
    """examples/kafka-vit-classify/main.py's handler, as written there."""
    job = ctx.bind()
    batch = [np.asarray(img, np.float32) for img in job["images"]]
    probs = ctx.tpu.predict_batch("classify", batch)
    ctx.get_publisher().publish("classifications", {
        "job_id": job.get("job_id"),
        "labels": [int(np.argmax(p)) for p in probs],
    })
    return None  # commit


def test_the_example_handler_is_the_one_in_the_example():
    import inspect
    from pathlib import Path

    src = (Path(__file__).resolve().parent.parent / "examples"
           / "kafka-vit-classify" / "main.py").read_text()
    body = inspect.getsource(classify).split('"""')[-1]
    assert body.strip() in src


@pytest.fixture(scope="module")
def vit_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "vit-tiny.npz"
    save_npz(str(path), jax.tree.map(
        np.asarray, jvit.init(JVIT["tiny"], jax.random.PRNGKey(3))))
    return str(path)


def _jobs(rng, n_jobs: int) -> list[dict]:
    return [{"job_id": f"job-{j}",
             "images": rng.normal(size=(int(rng.integers(1, 5)), 28, 28, 3))
             .astype(np.float32).tolist()} for j in range(n_jobs)]


def _classify_app(pk, vit_npz):
    app = _app(pk, CONSUMER_ID="vit-classifier", TPU_MODEL="vit-tiny",
               TPU_WEIGHTS=vit_npz, TPU_BATCH_BUCKETS="1,2,4")
    app.subscribe("images")(classify)
    return app


def test_the_kafka_vit_handler_publishes_the_same_results_on_both(vit_npz):
    """Five jobs and one malformed message on each App's broker: the
    same five results on ``classifications`` (labels equal, messages
    equal byte for byte), the malformed one logged and its message the
    only one left uncommitted, the counters 6 and 5."""
    rng = np.random.default_rng(17)
    jobs = _jobs(rng, 5)
    out = {}
    for name, pk in PACKAGES.items():
        app = _classify_app(pk, vit_npz)
        errors = _capture_errors(app)
        delivered = _record_deliveries(app)
        pub = app.container.get_publisher()
        for job in jobs[:2]:
            pub.publish("images", job)
        pub.publish("images", b"not json")
        for job in jobs[2:]:
            pub.publish("images", job)
        reader = _client(pk, "reader")
        got = []
        with app:
            deadline = time.monotonic() + 30
            while len(got) < len(jobs) and time.monotonic() < deadline:
                msg = reader.subscribe("classifications", timeout=0.5)
                if msg is not None:
                    got.append(msg.value)
            time.sleep(0.1)
        m = app.container.metrics
        out[name] = (got, _counter(m, "app_pubsub_subscribe_total_count"),
                     _counter(m, "app_pubsub_subscribe_success_count"))
        assert any(e.get("event") == "subscriber handler error"
                   and e.get("topic") == "images" for e in errors), name
        # the malformed job's message is the one left uncommitted
        assert [m.committed for m in delivered] == [
            m.value != b"not json" for m in delivered], name
        assert len(delivered) == 6, name
    assert out["port"] == out["jax"]
    got, total, ok = out["port"]
    assert (total, ok) == (6, 5)
    results = [json.loads(v) for v in got]
    assert [r["job_id"] for r in results] == [j["job_id"] for j in jobs]
    assert [len(r["labels"]) for r in results] == [len(j["images"])
                                                   for j in jobs]


def test_an_engine_error_in_the_handler_is_logged_and_not_committed(
        pk, vit_npz):
    """A batch that fails on the device (the engine's batch dispatch
    raising once, as a lost device would) makes ``predict_batch`` raise
    in the handler: the subscriber thread logs it with the topic and
    leaves the message uncommitted, never counting it a success; the
    next job is served."""
    app = _classify_app(pk, vit_npz)
    errors = _capture_errors(app)
    delivered = _record_deliveries(app)
    pub = app.container.get_publisher()
    for job in _jobs(np.random.default_rng(5), 2):
        pub.publish("images", job)
    engine = app.container.tpu
    run_batch = engine._run_batch
    failed = []

    def lose_the_device_once(*a, **k):
        if not failed:
            failed.append(1)
            raise RuntimeError("device lost")
        return run_batch(*a, **k)

    engine._run_batch = lose_the_device_once
    with app:
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not (
                len(delivered) == 2 and delivered[1].committed):
            time.sleep(0.02)
    assert any(e.get("event") == "subscriber handler error"
               and e.get("topic") == "images" and "device lost" in e["error"]
               for e in errors)
    assert [m.committed for m in delivered] == [False, True]
    m = app.container.metrics
    assert _counter(m, "app_pubsub_subscribe_total_count") == 2
    assert _counter(m, "app_pubsub_subscribe_success_count") == 1
