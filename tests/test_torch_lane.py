"""The async inference lane and the tenant edges of both Apps, on the CPU
(`tiny`, float32): the port's ``gofr_tpu_torch.tenancy.AsyncLane``
against the JAX package's lane on the same weights and jobs
(tests/test_tenancy.py's lane cases), and a ``gofr_tpu.App`` beside a
``gofr_tpu_torch.App(device="cpu")`` built from the same rows.

- the lane: a job killed after its first checkpoints resumes with
  ``continue_from`` and ends token for token JAX's lane and the
  uninterrupted stream; a done job commits without the engine;
  backpressure re-raises after ``Retry-After``; malformed jobs are
  refused; end to end over the MEM broker, through a Container with
  the Redis client, and on an App through ``install_async_lane``;
- the edges: ``X-Tenant-Id`` and ``TPU_TENANT_HEADER`` on HTTP, gRPC's
  ``x-tenant-id``, each reaching the handler canonicalised (an unknown
  id is ``default``), the stream's tenant and adapter, the quota's 429
  with ``Retry-After`` and its reason, and ``RESOURCE_EXHAUSTED`` on
  gRPC;
- ``ctx.redis``: ``REDIS_HOST`` builds the Container's client on both
  Apps, with a ``redis`` health entry; the port refuses a server it
  cannot reach by the row's name.
"""

from __future__ import annotations

import contextlib
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

import gofr_tpu
import gofr_tpu.tenancy as jten
import gofr_tpu_torch
import gofr_tpu_torch.tenancy as pten
from gofr_tpu import grpcx as jgrpcx
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.datasource.pubsub import mem as jmem
from gofr_tpu.errors import BadRequest as JBadRequest
from gofr_tpu.errors import TooManyRequests as JTooMany
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.resilience import SLO_THROUGHPUT as JTHR
from gofr_tpu.resilience import slo_scope as jslo_scope
from gofr_tpu.tpu.checkpoint import save_npz
from gofr_tpu.tpu.generator import GenerationEngine as JaxEngine
from gofr_tpu_torch import grpcx as pgrpcx
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.container import Container
from gofr_tpu_torch.datasource.pubsub import mem as pmem
from gofr_tpu_torch.errors import BadRequest, TooManyRequests
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.resilience import SLO_THROUGHPUT, slo_scope
from gofr_tpu_torch.subscriber import SubscriptionManager
from gofr_tpu_torch.testutil.redisfake import FakeRedisServer
from gofr_tpu_torch.tpu import GenerationEngine, from_jax_params

JCFG = JAX_CONFIGS["tiny"]
CFG = LLAMA_CONFIGS["tiny"]
LANE_DOC = {"tenants": [{"id": "beta", "slo_class": "throughput"},
                        {"id": "gamma", "weight": 2}]}


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init(JCFG, jax.random.PRNGKey(1))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _engine(side, weights, doc=LANE_DOC):
    args = dict(slots=4, max_seq=128, prompt_buckets=(8, 16, 32),
                decode_block=2)
    if side == "jax":
        eng = JaxEngine(JCFG, weights[0], **args)
        ten = jten
    else:
        eng = GenerationEngine(CFG, weights[1], device="cpu", **args)
        ten = pten
    if doc is not None:
        eng.install_tenancy(ten.TenantPlane(ten.TenantRegistry.from_json(doc)))
    return eng


def _prompt(n, seed=7):
    return np.random.default_rng(seed).integers(
        1, CFG.vocab_size, n).tolist()


class _Store:
    """A dict behind the get/set face of the Redis client the lane
    uses."""

    def __init__(self):
        self.kv = {}

    def get(self, key):
        return self.kv.get(key)

    def set(self, key, value, ex=None):
        self.kv[key] = value
        return True


class _Ctx:
    def __init__(self, payload, tpu=None, redis=None):
        self._payload = payload
        self.tpu = tpu
        self.redis = redis

    def bind(self):
        return self._payload


class _KillAfter:
    """An engine whose stream dies after ``n`` tokens (the worker's
    crash); the stream underneath is cancelled, so nothing leaks."""

    def __init__(self, engine, n):
        self.engine = engine
        self.n = n

    def generate(self, *a, **kw):
        stream = self.engine.generate(*a, **kw)

        def die():
            for i, item in enumerate(stream):
                if i >= self.n:
                    stream.cancel()
                    raise RuntimeError("worker died mid-run")
                yield item
        return die()


LANES = {"jax": (jten, jslo_scope, JTHR), "port": (pten, slo_scope,
                                                   SLO_THROUGHPUT)}


@pytest.mark.parametrize("sampled", [False, True])
def test_lane_kill_then_resume_is_token_exact(weights, sampled):
    """A job dies after 5 tokens with checkpoints every 2; the
    redelivery resumes from the stored 4 with ``continue_from`` and ends
    equal to the uninterrupted stream, and to JAX's lane on the same
    job, greedy and seeded."""
    job = {"job_id": "j1", "tokens": _prompt(12, seed=11), "max_new": 12,
           "tenant": "beta"}
    if sampled:
        job.update(temperature=0.8, top_k=20, seed=1234)
    out = {}
    for side, (ten, scope, thr) in LANES.items():
        eng = _engine(side, weights)
        store = _Store()
        try:
            with scope(thr):
                ref = eng.generate(
                    job["tokens"], max_new_tokens=12,
                    temperature=job.get("temperature", 0.0),
                    top_k=job.get("top_k", 0), seed=job.get("seed")).tokens()
            lane = ten.AsyncLane(checkpoint_every=2)
            with pytest.raises(RuntimeError):
                lane.handle(_Ctx(job, tpu=_KillAfter(eng, 5), redis=store))
            mid = json.loads(store.kv["async:j1"])
            lane.handle(_Ctx(job, tpu=eng, redis=store))
            done = json.loads(store.kv["async:j1"])
            lane.handle(_Ctx(job, tpu=None, redis=store))   # done: commits
            active = eng.tenancy.quotas.active("beta")
            out[side] = ([int(t) for t in ref], mid, done, lane.stats(),
                         active)
        finally:
            eng.close()
    ref, mid, done, stats, active = out["port"]
    assert mid == {"status": "running", "tokens": ref[:5], "tenant": "beta"}
    assert done == {"status": "done", "tokens": ref, "tenant": "beta"}
    assert stats == {"done": 1, "resumed": 1, "backpressured": 0}
    assert active == 0
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("side", sorted(LANES))
def test_lane_backpressure_reraises_after_retry_after(side):
    ten = LANES[side][0]
    Shed = JTooMany if side == "jax" else TooManyRequests

    class _Shedding:
        def generate(self, *a, **kw):
            raise Shed("full", retry_after=0.01, reason="tenant_quota")

    store = _Store()
    store.set("async:j2", json.dumps({"status": "running", "tokens": [5],
                                      "tenant": "t"}))
    lane = ten.AsyncLane(engine=_Shedding(), store=store,
                         retry_sleep_cap_s=0.05)
    t0 = time.monotonic()
    with pytest.raises(Shed):
        lane.handle(_Ctx({"job_id": "j2", "tokens": [1, 2, 3],
                          "tenant": "t", "max_new": 4}))
    assert time.monotonic() - t0 >= 0.01
    assert lane.jobs_backpressured == 1 and lane.jobs_resumed == 1
    assert json.loads(store.kv["async:j2"])["tokens"] == [5]


@pytest.mark.parametrize("side", sorted(LANES))
def test_lane_rejects_malformed_jobs(side):
    ten = LANES[side][0]
    Bad = JBadRequest if side == "jax" else BadRequest
    lane = ten.AsyncLane(engine=object(), store=_Store())
    for job in ({"tokens": [1]}, {"job_id": "x", "tokens": "nope"},
                {"job_id": "x", "tokens": [1], "max_new": "many"},
                {"job_id": "x", "tokens": ["a"]}, "not a job"):
        with pytest.raises(Bad):
            lane.handle(_Ctx(job))
    with pytest.raises(Bad):   # no store anywhere
        ten.AsyncLane(engine=object()).handle(
            _Ctx({"job_id": "x", "tokens": [1]}))
    with pytest.raises(Bad):   # no engine anywhere
        ten.AsyncLane(store=_Store()).handle(
            _Ctx({"job_id": "x", "tokens": [1]}))


def _wait_done(get, job_id, timeout=30.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        raw = get(f"async:{job_id}")
        if raw and json.loads(raw).get("status") == "done":
            return json.loads(raw)
        time.sleep(0.02)
    raise AssertionError(f"job {job_id} not done")


def test_lane_end_to_end_over_the_mem_broker(weights):
    """Publish -> MEM broker -> SubscriptionManager -> lane -> engine ->
    the result document in Redis (the Container's client from
    REDIS_HOST): the whole arrival path, committed on success."""
    pmem.reset()
    srv = FakeRedisServer()
    eng = _engine("port", weights)
    c = Container(MapConfig({"PUBSUB_BACKEND": "MEM",
                             "CONSUMER_ID": "lane-test",
                             "REDIS_HOST": srv.host,
                             "REDIS_PORT": str(srv.port)}), device="cpu")
    c.tpu = eng
    mgr = SubscriptionManager(c)
    lane = pten.AsyncLane(checkpoint_every=2)
    mgr.register("inference-jobs", lane.handle)
    prompt = _prompt(8, seed=21)
    try:
        with slo_scope(SLO_THROUGHPUT):
            ref = eng.generate(prompt, max_new_tokens=4).tokens()
        c.pubsub.publish("inference-jobs", {
            "job_id": "e2e", "tokens": prompt, "max_new": 4,
            "tenant": "gamma"})
        c.pubsub.publish("inference-jobs", b"{not json")
        mgr.start()
        doc = _wait_done(c.redis.get, "e2e")
        assert doc == {"status": "done", "tokens": [int(t) for t in ref],
                       "tenant": "gamma"}
        assert lane.stats()["done"] == 1
        assert eng.stats()["tenancy"]["tenants"]["gamma"]["admitted"] == 1
    finally:
        mgr.stop()
        c.close()
        eng.close()
        srv.close()
        pmem.reset()


# -- the Apps --------------------------------------------------------------------

ROWS = {"HTTP_PORT": "0", "METRICS_PORT": "0", "GRPC_PORT": "0",
        "LOG_LEVEL": "ERROR", "TPU_MODEL": "tiny", "TPU_SLOTS": "2",
        "TPU_MAX_SEQ": "128", "TPU_SEQ_BUCKETS": "16,32",
        "TPU_TENANTS_INLINE": json.dumps({"tenants": [
            {"id": "A", "weight": 2},
            {"id": "capped", "max_concurrency": 1,
             "slo_class": "throughput"}]})}
PACKAGES = {"jax": (gofr_tpu, jgrpcx, jten, JMapConfig),
            "port": (gofr_tpu_torch, pgrpcx, pten, MapConfig)}


@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "tiny.npz"
    save_npz(str(path), jax.tree.map(
        np.asarray, jllama.init(JCFG, jax.random.PRNGKey(1))))
    return str(path)


def _install(app, g, ten):
    @app.get("/who")
    def who(ctx):
        return {"tenant": ctx.tenant}

    @app.post("/generate")
    def generate(ctx):
        body = ctx.bind()
        s = ctx.tpu.generate(body["tokens"],
                             max_new_tokens=body.get("max_new_tokens", 4))
        return {"tokens": [int(t) for t in s.tokens()], "tenant": s.tenant,
                "slo_class": s.slo_class}

    @app.post("/hold")
    def hold(ctx):
        s = ctx.tpu.generate(ctx.bind()["tokens"], max_new_tokens=60)
        return {"n": len(s.tokens())}

    @app.get("/kv/{key}")
    def kv_get(ctx):
        key = ctx.path_param("key")
        ctx.redis.set(key, "v-" + key)
        return {"value": ctx.redis.get(key)}

    llm = g.GRPCService("llm.Generation")

    @llm.server_stream("Generate")
    def generate_grpc(ctx, req):
        s = ctx.tpu.generate(req["tokens"],
                             max_new_tokens=req.get("max_new_tokens", 4))
        yield {"tenant": ten.current_tenant(), "stream_tenant": s.tenant}
        for t in s:
            yield {"token": int(t)}

    app.register_grpc_service(llm)


@contextlib.contextmanager
def _two_apps(weights_npz, **extra):
    rows = dict(ROWS, TPU_WEIGHTS=weights_npz, **extra)
    out = {}
    try:
        for name, (pkg, g, ten, cfg) in PACKAGES.items():
            kw = {"device": "cpu"} if name == "port" else {}
            app = pkg.App(cfg(dict(rows, APP_NAME=f"tenants-{name}")), **kw)
            _install(app, g, ten)
            out[name] = (app, g)
            app.run(block=False)
        yield out
    finally:
        for app, _ in out.values():
            if app._running.is_set():
                app.stop()


def _call(port, method, path, body=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _grpc(g, port, body, metadata=None):
    ch = g.dial(f"127.0.0.1:{port}")
    try:
        try:
            return list(ch.server_stream("/llm.Generation/Generate", body,
                                         timeout=60, metadata=metadata)), None
        except g.GRPCError as e:
            return None, e.code
    finally:
        ch.close()


def test_the_tenant_header_and_metadata_reach_the_handler(weights_npz):
    """X-Tenant-Id on HTTP and x-tenant-id on gRPC reach the handler as
    ``ctx.tenant`` / the ambient tenant, canonicalised (an unknown id is
    ``default``); the stream carries the tenant and its class default;
    alike on both Apps."""
    with _two_apps(weights_npz) as apps:
        out = {}
        for name, (app, g) in apps.items():
            p = app.http_port
            got = [_call(p, "GET", "/who", headers=h)[1]["data"]
                   for h in ({"X-Tenant-Id": "A"}, {"X-Tenant-Id": "nope"},
                             {})]
            gen = _call(p, "POST", "/generate",
                        {"tokens": _prompt(12), "max_new_tokens": 4},
                        {"X-Tenant-Id": "capped"})[1]["data"]
            msgs, code = _grpc(g, app.grpc_port,
                               {"tokens": _prompt(12), "max_new_tokens": 4},
                               {"x-tenant-id": "A"})
            unknown, _ = _grpc(g, app.grpc_port,
                               {"tokens": _prompt(9), "max_new_tokens": 2},
                               {"x-tenant-id": "zzz"})
            out[name] = (got, gen, code, msgs, unknown[0])
    assert out["port"] == out["jax"]
    got, gen, code, msgs, unknown = out["port"]
    assert got == [{"tenant": "A"}, {"tenant": "default"},
                   {"tenant": "default"}]
    assert gen["tenant"] == "capped" and gen["slo_class"] == "throughput"
    assert code is None and msgs[0] == {"tenant": "A", "stream_tenant": "A"}
    assert unknown == {"tenant": "default", "stream_tenant": "default"}
    assert [m["token"] for m in msgs[1:]] == gen["tokens"]


def test_tpu_tenant_header_renames_the_header(weights_npz):
    with _two_apps(weights_npz, TPU_TENANT_HEADER="X-Org") as apps:
        out = {n: [_call(app.http_port, "GET", "/who", headers=h)[1]["data"]
                   for h in ({"X-Org": "A"}, {"X-Tenant-Id": "A"})]
               for n, (app, _) in apps.items()}
    assert out["port"] == out["jax"] == [{"tenant": "A"},
                                         {"tenant": "default"}]


def test_a_quota_shed_is_a_typed_429_and_resource_exhausted(weights_npz):
    """``capped`` holds its one concurrency slot with a live stream: its
    next request over HTTP is a 429 with Retry-After and reason
    ``tenant_quota``, over gRPC RESOURCE_EXHAUSTED; A is served."""
    with _two_apps(weights_npz) as apps:
        out = {}
        for name, (app, g) in apps.items():
            p = app.http_port
            tpu = app.container.tpu
            gen = tpu.generator
            holder = threading.Thread(target=_call, args=(
                p, "POST", "/hold", {"tokens": _prompt(10)},
                {"X-Tenant-Id": "capped"}), daemon=True)
            holder.start()
            end = time.monotonic() + 20
            while tpu.tenancy.quotas.active("capped") == 0 and \
                    time.monotonic() < end:
                time.sleep(0.005)
            status, _, headers = _call(p, "POST", "/generate",
                                       {"tokens": _prompt(10)},
                                       {"X-Tenant-Id": "capped"})
            _, code = _grpc(g, app.grpc_port, {"tokens": _prompt(10)},
                            {"x-tenant-id": "capped"})
            ok, _, _ = _call(p, "POST", "/generate", {"tokens": _prompt(10)},
                             {"X-Tenant-Id": "A"})
            holder.join(60)
            end = time.monotonic() + 20
            while tpu.tenancy.quotas.active("capped") and \
                    time.monotonic() < end:
                time.sleep(0.005)
            shed = gen.stats()["tenancy"]["tenants"]
            out[name] = (status, headers.get("X-Shed-Reason"),
                         "Retry-After" in headers, code, ok,
                         shed["capped"]["shed"], shed["A"]["shed"],
                         shed["capped"]["active"])
    assert out["port"] == out["jax"]
    assert out["port"][:3] == (429, "tenant_quota", True)
    assert out["port"][4:] == (200, 2, 0, 0)
    assert out["port"][3] == pgrpcx.RESOURCE_EXHAUSTED


def test_ctx_redis_is_the_containers_client(weights_npz):
    srv = FakeRedisServer()
    try:
        with _two_apps(weights_npz, REDIS_HOST=srv.host,
                       REDIS_PORT=str(srv.port)) as apps:
            out = {}
            for name, (app, _) in apps.items():
                got = _call(app.http_port, "GET", f"/kv/{name}")[1]["data"]
                health = _call(app.http_port, "GET",
                               "/.well-known/health")[1]["data"]
                out[name] = (got, health["redis"]["status"],
                             health["status"])
        assert out["port"] == ({"value": "v-port"}, "UP", "UP")
        assert out["jax"] == ({"value": "v-jax"}, "UP", "UP")
    finally:
        srv.close()


def test_an_unreachable_redis_host_is_refused_by_name():
    with socket.socket() as s:   # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    with pytest.raises(RuntimeError, match="REDIS_HOST=127.0.0.1"):
        gofr_tpu_torch.App(MapConfig({"HTTP_PORT": "0", "METRICS_PORT": "0",
                                      "REDIS_HOST": "127.0.0.1",
                                      "REDIS_PORT": str(dead)}),
                           device="cpu")


def test_the_lane_on_an_app_over_the_mem_broker(weights_npz):
    """``install_async_lane`` on a port App: jobs published on
    ``TPU_TENANT_TOPIC`` run as their tenant's throughput traffic and land
    done in ``ctx.redis``, the checkpoint cadence from
    ``TPU_TENANT_CHECKPOINT_EVERY``; the same jobs on a JAX App give the
    same documents."""
    srv = FakeRedisServer()
    jmem.reset()
    pmem.reset()
    rows = dict(ROWS, TPU_WEIGHTS=weights_npz, PUBSUB_BACKEND="MEM",
                REDIS_HOST=srv.host, REDIS_PORT=str(srv.port),
                TPU_TENANT_TOPIC="jobs", TPU_TENANT_CHECKPOINT_EVERY="3",
                CONSUMER_ID="lane")
    docs = {}
    try:
        for name, (pkg, _, ten, cfg) in PACKAGES.items():
            kw = {"device": "cpu"} if name == "port" else {}
            app = pkg.App(cfg(rows), **kw)
            lane = ten.install_async_lane(app)
            assert lane.checkpoint_every == 3
            app.run(block=False)
            try:
                for i in range(3):
                    app.container.pubsub.publish("jobs", {
                        "job_id": f"{name}-{i}", "tokens": _prompt(10, i),
                        "max_new": 5, "tenant": ["A", "capped", "x"][i]})
                docs[name] = [_wait_done(app.container.redis.get,
                                         f"{name}-{i}") for i in range(3)]
                assert lane.stats()["done"] == 3
            finally:
                app.stop()
    finally:
        srv.close()
        jmem.reset()
        pmem.reset()
    assert docs["port"] == docs["jax"]
    assert [d["tenant"] for d in docs["port"]] == ["A", "capped", "x"]
