"""The port's prefix-affinity gateway (gofr_tpu_torch.gateway, an App with
``TPU_SERVING_ROLE=gateway``) against the JAX package's (gofr_tpu.gateway).

Three layers:

  - every case of tests/test_gateway.py on both packages, with the same
    body and assertions: the gateway App, its ``FakeReplica`` Apps
    (deterministic ndjson tokens, token i = (sum(prompt)+i) % 997) and
    every unit (hash ring, table, router, budget, backoff, relay stream,
    breaker, retry) from the same package;
  - the cross-package pairs: the JAX gateway over the port's replicas
    and the port's gateway over JAX replicas serve affinity, failover
    before the first token and the zero-loss rolling drain, so the two
    packages speak one wire contract (the same-package pairs run the
    same three bodies);
  - tests/test_resume.py's four gateway-resume cases on real ``tiny``
    engines on the CPU (float32, greedy token-exact): a port gateway
    over port replicas (``device="cpu"``) and a JAX gateway over JAX
    replicas, all on the same ``.npz`` weights, each case held line for
    line between the two (less the request ids, addresses and
    retry-after values, which are the run's own).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu import chaos as jchaos
from gofr_tpu import errors as jerrors
from gofr_tpu import gateway as jgateway
from gofr_tpu import resilience as jresilience
from gofr_tpu import service as jservice
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.gateway import relay as jrelay
from gofr_tpu.gateway import router as jrouter
from gofr_tpu.gateway import table as jtable
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.serving import install_generate as jinstall_generate
from gofr_tpu.service import circuit_breaker as jbreaker
from gofr_tpu.service import retry as jretry
from gofr_tpu.tpu import new_engine_from_config as jnew_engine
from gofr_tpu.tpu.checkpoint import save_npz
from gofr_tpu.tpu.kvcache import chain_hashes as jchain_hashes
from gofr_tpu.tpu.kvcache import first_block_hash as jfirst_block_hash
from gofr_tpu_torch import chaos, errors, gateway, resilience, service
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.gateway import relay, router, table
from gofr_tpu_torch.serving import install_generate, resume_chain
from gofr_tpu_torch.service import circuit_breaker, retry
from gofr_tpu_torch.tpu import new_engine_from_config
from gofr_tpu_torch.tpu.kvcache import chain_hashes, first_block_hash

BLOCK = 16
MOD = 997

PACKAGES = {
    "gofr_tpu": SimpleNamespace(
        name="gofr_tpu", App=gofr_tpu.App, MapConfig=JMapConfig,
        chaos=jchaos, errors=jerrors, gateway=jgateway, router=jrouter,
        table=jtable, relay=jrelay, resilience=jresilience,
        service=jservice, breaker=jbreaker, retry=jretry,
        new_engine=jnew_engine, first_block_hash=jfirst_block_hash,
        chain_hashes=jchain_hashes, install_generate=jinstall_generate,
        app_kw={}),
    "gofr_tpu_torch": SimpleNamespace(
        name="gofr_tpu_torch", App=gofr_tpu_torch.App, MapConfig=MapConfig,
        chaos=chaos, errors=errors, gateway=gateway, router=router,
        table=table, relay=relay, resilience=resilience, service=service,
        breaker=circuit_breaker, retry=retry,
        new_engine=new_engine_from_config,
        first_block_hash=first_block_hash, chain_hashes=chain_hashes,
        install_generate=install_generate, app_kw={"device": "cpu"}),
}
# (gateway package, replica package): the same-package pairs and the
# two cross-package ones
PAIRS = [("gofr_tpu", "gofr_tpu"), ("gofr_tpu", "gofr_tpu_torch"),
         ("gofr_tpu_torch", "gofr_tpu"), ("gofr_tpu_torch", "gofr_tpu_torch")]


@pytest.fixture(params=sorted(PACKAGES))
def pk(request):
    return PACKAGES[request.param]


def expected_tokens(prompt, n):
    base = int(sum(prompt))
    return [(base + i) % MOD for i in range(n)]


# -- fixtures: fake replicas + gateway ----------------------------------------

class FakeReplica:
    """A real App of package ``pk`` whose /generate streams deterministic
    tokens. The ``mode`` knob turns it into a shedder or a slow
    streamer."""

    def __init__(self, pk, name: str):
        self.name = name
        self.mode = "ok"
        self.line_delay_s = 0.0
        self.hits = 0
        self.app = pk.App(pk.MapConfig({
            "HTTP_PORT": "0", "METRICS_PORT": "0", "APP_NAME": name,
            "LOG_LEVEL": "ERROR"}))

        @self.app.post("/generate")
        def generate(ctx):
            self.hits += 1
            if self.mode == "shed_hbm":
                raise pk.errors.TooManyRequests(
                    f"{name}: hbm shed", retry_after=0.2, reason="hbm")
            if self.mode == "shed_queue":
                raise pk.errors.TooManyRequests(f"{name}: queue shed",
                                                retry_after=0.2)
            body = ctx.bind()
            toks = body["tokens"]
            n = int(body.get("max_new_tokens", 4))
            # echoed only when present: header pass-through assertions
            extra = {k: v for k, v in
                     (("auth", ctx.header("Authorization")),
                      ("custom", ctx.header("X-Gw-Test")),
                      ("host", ctx.header("Host"))) if v}

            def lines():
                for t in expected_tokens(toks, n):
                    if self.line_delay_s:
                        time.sleep(self.line_delay_s)
                    yield (json.dumps({"token": t, "replica": name,
                                       **extra}) + "\n").encode()

            ctx.stream(lines())
            return None

        self.app.run(block=False)
        self.port = self.app.http_port

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def stop(self, grace_s: float = 0.0):
        if self.app._running.is_set():
            self.app.stop(grace_s)


def make_gateway(pk, replicas, **extra):
    cfg = {"HTTP_PORT": "0", "METRICS_PORT": "0", "APP_NAME": "gw",
           "LOG_LEVEL": "ERROR", "TPU_SERVING_ROLE": "gateway",
           "TPU_GATEWAY_REPLICAS": ",".join(r if isinstance(r, str)
                                            else r.address
                                            for r in replicas),
           "TPU_GATEWAY_BLOCK": str(BLOCK),
           # polls are driven explicitly (poll_once) where a test
           # needs determinism; the background cadence just keeps up
           "TPU_GATEWAY_HEALTH_INTERVAL_S": "0.2",
           "TPU_GATEWAY_CONNECT_TIMEOUT_S": "1.0"}
    cfg.update({k: str(v) for k, v in extra.items()})
    gw = pk.App(pk.MapConfig(cfg))
    gw.run(block=False)
    return gw


def _cluster(gw_pk, rep_pk):
    reps = [FakeReplica(rep_pk, f"r{i}") for i in range(3)]
    try:
        gw = make_gateway(gw_pk, reps)
    except BaseException:
        for r in reps:
            r.stop()
        raise
    return gw, reps


def _teardown(gw, reps):
    gw.stop()
    for r in reps:
        r.stop()


@pytest.fixture
def cluster(pk):
    gw, reps = _cluster(pk, pk)
    yield gw, reps
    _teardown(gw, reps)


@pytest.fixture(params=PAIRS, ids=lambda p: f"{p[0]}-over-{p[1]}")
def pair_cluster(request):
    gw_name, rep_name = request.param
    gw, reps = _cluster(PACKAGES[gw_name], PACKAGES[rep_name])
    yield gw, reps
    _teardown(gw, reps)


def post_generate(port, tokens, max_new=4, headers=None, timeout=10):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"tokens": list(map(int, tokens)),
                         "max_new_tokens": max_new}).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            lines = [json.loads(line) for line in
                     resp.read().decode().splitlines() if line]
            return resp.status, dict(resp.headers), lines
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def gw_stats(gw) -> dict:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{gw.http_port}/gateway/stats",
            timeout=5) as r:
        return json.loads(r.read())["data"]


def prompt_owned_by(gateway_app, idx: int, length: int = 32):
    """A prompt whose affinity owner is replica ``idx`` (search over
    deterministic candidate prompts — the ring is content-addressed,
    so the test picks content instead of rigging the ring)."""
    gw = gateway_app._gateway
    for seed in range(200):
        prompt = [(seed * 131 + j) % 500 + 1 for j in range(length)]
        key = first_block_hash(prompt, BLOCK)
        if gw.router.ring.order(key)[0] == idx:
            return prompt
    raise AssertionError("no candidate prompt landed on replica "
                         f"{idx} in 200 tries")


# -- affinity hashing ---------------------------------------------------------

def test_first_block_hash_is_turn_stable_and_adapter_separated(pk):
    turn1 = np.arange(1, 40)
    turn2 = np.concatenate([turn1, np.arange(100, 140)])  # next turn
    fbh = pk.first_block_hash
    assert fbh(turn1, BLOCK) == fbh(turn2, BLOCK)
    # and it IS the radix chain hash of block 0 — the cache's notion
    # of identity, not a parallel scheme that could drift
    assert fbh(turn1, BLOCK) == next(
        iter(pk.chain_hashes(np.asarray(turn1, np.int32), BLOCK)))
    assert fbh(turn1, BLOCK) != fbh(turn1, BLOCK, adapter=1)
    # sub-block prompts still hash deterministically
    short = [3, 1, 4]
    assert fbh(short, BLOCK) == fbh(short, BLOCK)
    assert fbh(short, BLOCK) != fbh([3, 1], BLOCK)


def test_hash_ring_stable_order_and_coverage(pk):
    addrs = [f"10.0.0.{i}:9{i}00" for i in range(4)]
    ring = pk.router.HashRing(addrs, vnodes=64)
    ring2 = pk.router.HashRing(addrs, vnodes=64)  # rebuilt -> identical
    owners = set()
    for s in range(64):
        key = pk.first_block_hash(np.arange(s, s + BLOCK), BLOCK)
        order = ring.order(key)
        assert order == ring2.order(key)
        assert sorted(order) == [0, 1, 2, 3]  # full, distinct fallback chain
        owners.add(order[0])
    assert owners == {0, 1, 2, 3}  # every replica owns some arc


# -- table + router units -----------------------------------------------------

def _offline_table(pk, n=3):
    # unreachable addresses: nothing here touches the network
    return pk.table.ReplicaTable([f"127.0.0.1:{19000 + i}"
                                  for i in range(n)])


def test_pressure_bias_drains_cache_heavy_first(pk):
    table_ = _offline_table(pk, 3)
    try:
        router_ = pk.router.AffinityRouter(table_, block=BLOCK)
        long_prompt = list(range(1, 80))
        key = pk.first_block_hash(long_prompt, BLOCK)
        owner_idx = router_.ring.order(key)[0]
        owner = table_.replicas[owner_idx]
        r, label = router_.pick(key, len(long_prompt))
        assert r is owner and label == "hit"
        # an hbm shed holds the owner for its Retry-After window:
        # cache-heavy traffic spills, short traffic still lands
        owner.note_shed("hbm", retry_after=30.0)
        r, label = router_.pick(key, len(long_prompt))
        assert r is not owner and label == "spill"
        r, label = router_.pick(key, prompt_len=8)
        assert r is owner and label == "hit"
        # a queue shed raises pressure but holds nothing
        other = table_.replicas[(owner_idx + 1) % 3]
        other.note_shed("", retry_after=None)
        assert 0 < other.pressure() < owner.pressure()
        # hold expiry: cache-heavy traffic returns to the owner
        owner._hold_until = 0.0
        r, label = router_.pick(key, len(long_prompt))
        assert r is owner and label == "hit"
    finally:
        table_.close()


def test_short_prompts_balance_by_pressure(pk):
    table_ = _offline_table(pk, 2)
    try:
        router_ = pk.router.AffinityRouter(table_, block=BLOCK)
        table_.replicas[0].note_shed("", None)
        table_.replicas[0].note_shed("", None)
        r, label = router_.pick(None, prompt_len=4)
        assert label == "short" and r is table_.replicas[1]
    finally:
        table_.close()


def test_pick_unroutable_raises_typed_503(pk):
    table_ = _offline_table(pk, 2)
    try:
        router_ = pk.router.AffinityRouter(table_, block=BLOCK)
        for r in table_.replicas:
            r.mark_drain(retry_after=7.0)
        with pytest.raises(pk.router.GatewayUnavailable) as ei:
            router_.pick(None, 4)
        assert ei.value.status_code == 503
        assert float(ei.value.headers["Retry-After"]) >= 1
    finally:
        table_.close()


def test_retry_budget_bucket(pk):
    b = pk.router.RetryBudget(ratio=0.5, burst=2.0)
    assert b.withdraw() and b.withdraw()
    assert not b.withdraw()  # empty
    b.deposit()  # +0.5
    assert not b.withdraw()
    b.deposit()  # 1.0
    assert b.withdraw()
    assert b.stats()["denied"] == 2 and b.stats()["spent"] == 3


def test_reconnect_backoff_convention(pk):
    t = [0.0]
    b = pk.service.ReconnectBackoff(0.5, 4.0, clock=lambda: t[0])
    assert b.blocked() == 0.0
    assert b.failure() == 0.5          # window armed at base
    assert b.blocked() == pytest.approx(0.5)
    t[0] += 0.6
    assert b.blocked() == 0.0          # window expired
    assert b.failure() == 1.0          # ladder doubled
    assert b.failure() == 2.0
    assert b.failure() == 4.0
    assert b.failure() == 4.0          # capped
    b.success()
    assert b.blocked() == 0.0 and b.failure() == 0.5  # reset to base
    b.hold()                           # config-error class: park at cap
    assert b.blocked() == pytest.approx(4.0)


def test_parse_replicas_forms_and_failures(pk):
    parse = pk.gateway.parse_replicas
    assert parse("a:1, http://b:2/, c:3") == ["a:1", "b:2", "c:3"]
    with pytest.raises(ValueError):
        parse("")
    with pytest.raises(ValueError):
        parse("no-port")


def test_gateway_role_builds_no_engine(pk):
    cfg = pk.MapConfig({"TPU_MODEL": "tiny", "TPU_SERVING_ROLE": "gateway"})
    with pytest.raises(ValueError, match="builds no engine"):
        pk.new_engine(cfg)


# -- satellite: retry deadline cap + context propagation ----------------------

class _FlakyInner:
    address = "test"

    def __init__(self, exc=ConnectionError("down")):
        self.calls = 0
        self.exc = exc

    def get_with_headers(self, path, params, headers):
        self.calls += 1
        raise self.exc


def test_retry_loop_capped_by_ambient_deadline(pk):
    inner = _FlakyInner()
    slept = []
    r = pk.retry.Retry(inner, max_attempts=10, base_delay=0.0,
                       sleep=lambda s: slept.append(s))
    # expired mid-loop: the attempt in flight finishes, no NEW attempt
    # starts — the loop cannot outlive the caller by more than one
    dl = pk.resilience.Deadline.after(0.08)
    with pk.resilience.deadline_scope(dl):
        time.sleep(0.09)
        with pytest.raises(ConnectionError):
            r.get("x")
    assert inner.calls == 1  # first attempt always runs; retries refused
    # without a deadline the same loop burns all attempts
    inner2 = _FlakyInner()
    r2 = pk.retry.Retry(inner2, max_attempts=3, base_delay=0.0,
                        sleep=lambda s: None)
    with pytest.raises(ConnectionError):
        r2.get("x")
    assert inner2.calls == 3


def test_service_client_propagates_slo_and_deadline(pk, cluster):
    """The forwarded-context satellite, observed at a REAL replica:
    ambient SLO class and remaining deadline cross the service-client
    hop as headers."""
    _, reps = cluster
    seen = {}

    @reps[0].app.post("/echo-headers")
    def echo(ctx):
        seen["slo"] = ctx.header("X-SLO-Class")
        seen["timeout"] = ctx.header("X-Request-Timeout")
        return {"ok": True}

    svc = pk.service.new_http_service(f"http://{reps[0].address}", None,
                                      None)
    res = pk.resilience
    with res.slo_scope("throughput"), \
            res.deadline_scope(res.Deadline.after(5.0)):
        resp = svc.post("/echo-headers", body={"x": 1})
    assert resp.ok
    assert seen["slo"] == "throughput"
    assert 0 < float(seen["timeout"].rstrip("s")) <= 5.0


class _Resp:
    def __init__(self, status, headers=None):
        self.status_code = status
        self._h = headers or {}

    def header(self, k, d=""):
        return self._h.get(k, d)


def test_breaker_treats_drain_503_as_alive(pk):
    """An orderly drain answer (503 + Retry-After, the App.stop
    readiness contract) is a LIVE peer asking for patience — a rolling
    restart longer than threshold x poll-interval must not open the
    health breaker and reclassify the replica as down."""
    class Inner:
        address = "t"
        resp = None

        def get_with_headers(self, path, params, headers):
            return self.resp

        def close(self):
            pass

    inner = Inner()
    cb = pk.breaker.CircuitBreaker(inner, threshold=2, interval=60,
                                   start_background_probe=False)
    inner.resp = _Resp(503, {"Retry-After": "5"})
    for _ in range(5):
        cb._do("GET", "/h", None, None, {})
    assert not cb.is_open  # drain answers never trip it
    inner.resp = _Resp(503)  # naked 503: a real failure class
    cb._do("GET", "/h", None, None, {})
    cb._do("GET", "/h", None, None, {})
    assert cb.is_open


def test_replica_stream_close_delimited_and_zero_length(pk):
    """The hand-rolled chunk decoder's two edge contracts: a
    close-delimited body flushes its trailing partial line at EOF
    (never silently dropped), and Content-Length: 0 reads as ended
    immediately instead of blocking in recv()."""
    import socket as socket_mod

    a, b = socket_mod.socketpair()
    b.sendall(b"line1\npartial")
    b.close()
    rs = pk.relay.ReplicaStream(a, b"", chunked=False, length=None)
    assert rs.next_line() == b"line1\n"
    assert rs.next_line() == b"partial"
    assert rs.next_line() is None
    rs.close()

    a2, b2 = socket_mod.socketpair()
    rs2 = pk.relay.ReplicaStream(a2, b"", chunked=False, length=0)
    assert rs2.next_line() is None
    rs2.close()
    b2.close()


def test_caller_deadline_expiry_is_504_not_replica_poison(cluster):
    """An impatient caller's deadline expiring mid-attempt is a 504 on
    THAT request — it must not mark the healthy replica down, spend
    the shared failover budget, or count a transport failover."""
    gw, reps = cluster
    for r in reps:
        r.line_delay_s = 0.5  # first token (coalesced with headers) late
    status, _, _ = post_generate(
        gw.http_port, list(range(1, 33)), max_new=2,
        headers={"X-Request-Timeout": "0.15s"})
    assert status == 504
    assert all(r.routable() for r in gw._gateway.table.replicas)
    assert gw._gateway.budget.spent == 0
    assert gw_stats(gw)["failovers"]["transport"] == 0


def test_non_numeric_tokens_are_typed_400(cluster):
    """Garbage in the 'tokens' array fails typed at the front door —
    the hash never sees it, the gateway never 500s."""
    gw, _ = cluster
    req = urllib.request.Request(
        f"http://127.0.0.1:{gw.http_port}/generate",
        data=json.dumps({"tokens": ["x"] * 32}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=5)
    assert ei.value.code == 400


def test_client_headers_cross_the_gateway_hop(cluster):
    """Authorization and custom client headers pass through the
    gateway to the replica (an authenticated cluster stays usable
    behind the front door), while hop-owned framing is rewritten —
    the replica sees ITS address as Host, not the gateway's."""
    gw, reps = cluster
    prompt = prompt_owned_by(gw, 1)
    status, _, lines = post_generate(
        gw.http_port, prompt, max_new=2,
        headers={"Authorization": "Bearer tok-xyz", "X-Gw-Test": "42"})
    assert status == 200
    assert lines[0]["auth"] == "Bearer tok-xyz"
    assert lines[0]["custom"] == "42"
    assert lines[0]["host"] == reps[1].address


# -- end-to-end: routing, failover, drain, chaos ------------------------------
# (the first three run on every pair of gateway and replica packages)

def test_affinity_routing_end_to_end(pair_cluster):
    gw, reps = pair_cluster
    sessions = [prompt_owned_by(gw, i) for i in range(3)]
    served_by = []
    for prompt in sessions:
        # three "turns": same first block, growing tail
        for turn in range(3):
            full = prompt + list(range(1, 1 + 8 * turn))
            status, _, lines = post_generate(gw.http_port, full, max_new=3)
            assert status == 200
            assert [ln["token"] for ln in lines] == expected_tokens(full, 3)
            served_by.append((prompt[0], lines[0]["replica"]))
    # every turn of a session landed on ONE replica (affinity hits)
    by_session = {}
    for sid, rep in served_by:
        by_session.setdefault(sid, set()).add(rep)
    assert all(len(v) == 1 for v in by_session.values())
    # and sessions spread: 3 owners were chosen by construction
    assert len({next(iter(v)) for v in by_session.values()}) == 3
    stats = gw_stats(gw)
    assert stats["router"]["picks"]["hit"] == 9
    assert stats["outcomes"]["ok"] == 9


def test_failover_pre_first_token_is_token_exact(pair_cluster):
    gw, reps = pair_cluster
    prompt = prompt_owned_by(gw, 0)
    # direct reference BEFORE the owner dies
    direct_status, _, direct = post_generate(reps[1].port, prompt, max_new=5)
    assert direct_status == 200
    # freeze the health poller: the gateway must discover the death
    # from the RELAY ATTEMPT itself (the deterministic failover path,
    # not the poll race)
    table_ = gw._gateway.table
    table_._stop.set()
    table_._thread.join(timeout=2)
    reps[0].stop()  # SIGKILL-equivalent for routing: connects now fail
    status, _, lines = post_generate(gw.http_port, prompt, max_new=5)
    assert status == 200
    # transparent failover: token-exact vs direct serving
    assert [ln["token"] for ln in lines] == [ln["token"] for ln in direct]
    assert lines[0]["replica"] != "r0"
    stats = gw_stats(gw)
    assert stats["failovers"]["transport"] >= 1
    assert stats["outcomes"]["ok"] == 1
    # the dead owner is now marked down: next pick spills straight
    # (no second connect attempt burned on it inside its backoff)
    status2, _, lines2 = post_generate(gw.http_port, prompt, max_new=5)
    assert status2 == 200
    assert [ln["token"] for ln in lines2] == [ln["token"] for ln in direct]


def test_rolling_drain_zero_loss(pair_cluster):
    gw, reps = pair_cluster
    draining = reps[0]
    prompt = prompt_owned_by(gw, 0)
    draining.line_delay_s = 0.05  # ~0.6 s stream: outlives the flip
    results = {}

    def long_stream():
        results["long"] = post_generate(gw.http_port, prompt, max_new=12,
                                        timeout=20)

    t = threading.Thread(target=long_stream)
    t.start()
    time.sleep(0.15)  # stream committed on replica 0
    stopper = threading.Thread(target=lambda: draining.stop(grace_s=5.0))
    stopper.start()
    time.sleep(0.1)  # readiness flipped; drain grace running
    # NEW request for the SAME affinity owner mid-drain: routed away
    # (drain-503 re-pick or health-poll mark), served complete, and
    # the drain failover charges NO retry budget
    status, _, lines = post_generate(gw.http_port, prompt, max_new=3)
    assert status == 200
    assert lines[0]["replica"] != "r0"
    assert [ln["token"] for ln in lines] == expected_tokens(prompt, 3)
    t.join(timeout=20)
    stopper.join(timeout=20)
    # the in-flight stream FINISHED on the draining process: zero loss
    status, _, lines = results["long"]
    assert status == 200
    assert [ln["token"] for ln in lines] == expected_tokens(prompt, 12)
    assert all(ln["replica"] == "r0" for ln in lines)
    stats = gw_stats(gw)
    assert stats["budget"]["spent"] == 0  # drains are budget-free
    assert stats["outcomes"]["ok"] == 2
    assert stats["outcomes"]["midstream"] == 0


def test_hbm_shed_failover_and_passthrough(cluster):
    gw, reps = cluster
    prompt = prompt_owned_by(gw, 1, length=80)  # cache-heavy
    reps[1].mode = "shed_hbm"
    status, _, lines = post_generate(gw.http_port, prompt, max_new=3)
    assert status == 200  # failed over off the shedding owner
    assert lines[0]["replica"] != "r1"
    stats = gw_stats(gw)
    assert stats["failovers"]["shed"] + stats["failovers"]["transport"] >= 1
    rep1 = next(r for r in stats["table"]["replicas"]
                if r["address"].endswith(str(reps[1].port)))
    assert rep1["sheds_hbm"] >= 1 and rep1["pressure"] > 0
    # the hold now steers cache-heavy picks away WITHOUT another 429
    hits_before = reps[1].hits
    status, _, _ = post_generate(gw.http_port, prompt, max_new=3)
    assert status == 200 and reps[1].hits == hits_before
    # fleet-wide memory pressure: the shed passes through typed
    for r in reps:
        r.mode = "shed_hbm"
    status, headers, body = post_generate(gw.http_port, prompt, max_new=3)
    assert status == 429
    assert headers.get("X-Shed-Reason") == "hbm"
    assert float(headers["Retry-After"]) >= 1


def test_retry_budget_exhaustion_goes_typed_503_no_storm(pk):
    reps = [FakeReplica(pk, f"rb{i}") for i in range(3)]
    gw = make_gateway(pk, reps, TPU_GATEWAY_RETRY_BURST="1",
                      TPU_GATEWAY_RETRY_RATIO="0.0")
    try:
        # freeze the poller so the table stays optimistic: every loss
        # is discovered by a relay attempt — the budget's code path
        table_ = gw._gateway.table
        table_._stop.set()
        table_._thread.join(timeout=2)
        for r in reps:
            r.stop()  # the whole fleet is dead
        t0 = time.monotonic()
        status, headers, body = post_generate(gw.http_port,
                                              list(range(32)), max_new=2)
        assert status == 503
        assert "Retry-After" in headers
        assert time.monotonic() - t0 < 5.0  # typed fast, not a storm
        # burst=1, ratio=0 over a 3-dead fleet: attempt 1 free, ONE
        # budgeted failover, then the empty bucket DENIES the second —
        # 2 attempts total, never N*attempts amplification
        stats = gw_stats(gw)
        assert stats["budget"]["spent"] == 1
        assert stats["budget"]["denied"] == 1
        assert stats["outcomes"]["shed"] == 1
        assert sum(stats["failovers"].values()) == 1
        # budget still empty: the next request pays ONE probe then
        # answers typed again (no storm on repeat)
        status, headers, _ = post_generate(gw.http_port,
                                           list(range(32)), max_new=2)
        assert status == 503
        assert gw_stats(gw)["budget"]["spent"] == 1
    finally:
        gw.stop()
        for r in reps:
            r.stop()


def test_chaos_seams_deterministic_and_failover(pk):
    reps = [FakeReplica(pk, f"rc{i}") for i in range(2)]
    gw = make_gateway(pk, reps)
    c = pk.chaos
    try:
        sched = c.ChaosSchedule(seed=7).on(
            c.GATEWAY_RELAY, error=ConnectionError, every=3)
        assert sched.digest() == c.ChaosSchedule(seed=7).on(
            c.GATEWAY_RELAY, error=ConnectionError,
            every=3).digest()  # replayable schedule
        decisions = [f for f, _ in sched.decisions(c.GATEWAY_RELAY, 6)]
        assert decisions == [False, False, True, False, False, True]
        with c.scope(sched):
            prompt = list(range(40))
            for i in range(4):
                status, _, lines = post_generate(gw.http_port, prompt,
                                                 max_new=2)
                # attempt 3 (i=2) takes the injected loss and fails
                # over transparently — every request still serves exact
                assert status == 200
                assert [ln["token"] for ln in lines] \
                    == expected_tokens(prompt, 2)
        assert sched.stats()["errors_fired"][c.GATEWAY_RELAY] == 1
        assert gw_stats(gw)["failovers"]["transport"] == 1
        # GATEWAY_PICK injection surfaces typed, never crashes the app
        with c.scope(c.ChaosSchedule(seed=7).on(
                c.GATEWAY_PICK, error=RuntimeError, every=1)):
            status, headers, _ = post_generate(gw.http_port, prompt,
                                               max_new=2)
            assert status == 503 and "Retry-After" in headers
        status, _, _ = post_generate(gw.http_port, prompt, max_new=2)
        assert status == 200  # gateway healthy after the schedule
    finally:
        gw.stop()
        for r in reps:
            r.stop()


def test_health_poll_tracks_drain_and_recovery(cluster):
    gw, reps = cluster
    table_ = gw._gateway.table
    table_.poll_once()
    assert all(r.state() == "ready" for r in table_.replicas)
    reps[2].app._drain_retry_after = 9.0
    reps[2].app._draining = True  # readiness flips (App.stop's first act)
    table_.poll_once()
    assert table_.replicas[2].state() == "draining"
    reps[2].app._draining = False
    table_.poll_once()
    assert table_.replicas[2].state() == "ready"


class DyingRawReplica:
    """A raw-socket 'replica' that streams ``k`` token chunks to a
    /generate POST then closes the connection WITHOUT the terminal
    chunk — exactly what a SIGKILLed replica process looks like to
    the gateway's relay mid-stream. Health GETs answer 200 so the
    poller keeps it routable."""

    def __init__(self, k: int = 3):
        import socket as s

        self.k = k
        self._srv = s.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._stop = False
        threading.Thread(target=self._serve, daemon=True).start()

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def _serve(self):
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._one, args=(conn,),
                             daemon=True).start()

    def _one(self, conn):
        try:
            data = b""
            while b"\r\n\r\n" not in data:
                chunk = conn.recv(4096)
                if not chunk:
                    return
                data += chunk
            head = data.split(b"\r\n\r\n", 1)[0].decode("latin-1")
            if head.startswith("GET"):
                body = b'{"data":{"status":"UP"}}'
                conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: "
                             + str(len(body)).encode() + b"\r\n\r\n"
                             + body)
                conn.close()
                return
            conn.sendall(b"HTTP/1.1 200 OK\r\n"
                         b"Content-Type: application/x-ndjson\r\n"
                         b"Transfer-Encoding: chunked\r\n\r\n")
            for i in range(self.k):
                line = (json.dumps({"token": i}) + "\n").encode()
                conn.sendall(b"%x\r\n" % len(line) + line + b"\r\n")
                time.sleep(0.02)
        finally:
            conn.close()  # no terminal chunk: the process "died"

    def close(self):
        self._stop = True
        self._srv.close()


def test_midstream_loss_emits_typed_error_line(pk):
    rep = DyingRawReplica(k=3)
    gw = make_gateway(pk, [rep])
    try:
        status, _, lines = post_generate(gw.http_port, list(range(24)),
                                         max_new=200, timeout=20)
        # tokens 1..k delivered, then ONE typed terminal error line —
        # the ndjson mirror of the P/D post-first-token contract
        assert status == 200
        # an abrupt close may clip the last in-flight chunk: the
        # contract is tokens 1..k (a prefix, in order) then ONE
        # terminal typed error line
        toks = [ln["token"] for ln in lines[:-1]]
        assert toks == list(range(len(toks))) and len(toks) >= 1
        tail = lines[-1]
        assert tail["error"]["status"] == 503
        assert tail["error"]["retry_after"] > 0
        assert gw_stats(gw)["outcomes"]["midstream"] == 1
    finally:
        gw.stop()
        rep.close()


# -- beside them: the port's own wire points ------------------------------------

def test_the_ring_orders_alike_on_both_packages():
    """Given the same replica list, both packages' rings order every key
    the same, so a JAX and a port gateway in front of one fleet agree on
    each session's owner."""
    addrs = [f"10.1.0.{i}:8000" for i in range(5)]
    ring, jring = router.HashRing(addrs), jrouter.HashRing(addrs)
    rng = np.random.default_rng(3)
    for _ in range(64):
        toks = rng.integers(0, 32000, 40)
        key = first_block_hash(toks, BLOCK)
        assert key == jfirst_block_hash(toks, BLOCK)
        assert ring.order(key) == jring.order(key)


def test_the_ports_drain_503_reads_as_alive_draining(pk):
    """The port's drain answer (503, Retry-After, the JSON envelope) is
    what each package's breaker and table read as "alive, draining"."""
    rep = FakeReplica(PACKAGES["gofr_tpu_torch"], "drainer")
    t = pk.table.ReplicaTable([rep.address], breaker_threshold=1)
    try:
        rep.app._drain_retry_after = 7.0
        rep.app._draining = True
        for _ in range(3):
            t.poll_once()
        r = t.replicas[0]
        assert r.state() == "draining" and not r.breaker_open
        assert 6.0 < r.retry_after_hint() <= 7.0
        resp = r.client.get("/.well-known/health")
        assert resp.status_code == 503
        assert resp.header("Retry-After") == "7"
        assert resp.json() == {"error": {"message": "server draining"}}
    finally:
        t.close()
        rep.stop()


# -- the gateway-resume cases on real tiny engines ------------------------------

JCFG = JAX_CONFIGS["tiny"]
ENGINE_ROWS = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR",
               "TPU_MODEL": "tiny", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "128",
               "TPU_SEQ_BUCKETS": "16,32", "TPU_KVCACHE_BLOCK": str(BLOCK)}


@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "tiny.npz"
    save_npz(str(path), jax.tree.map(
        np.asarray, jllama.init(JCFG, jax.random.PRNGKey(1))))
    return str(path)


class EngineReplica:
    """A ``tiny`` engine App of one package with POST /generate, counting
    the POSTs that reach it and the resumed ones among them."""

    def __init__(self, p, weights: str, name: str):
        self.hits = 0
        self.resumed = 0
        self.app = p.App(p.MapConfig(dict(ENGINE_ROWS, TPU_WEIGHTS=weights,
                                          APP_NAME=name)), **p.app_kw)
        p.install_generate(self.app)

        def count(next_h):
            def wrapped(req, w):
                if req.method == "POST" and req.path == "/generate":
                    self.hits += 1
                    if json.loads(req.body).get("resume_from"):
                        self.resumed += 1
                next_h(req, w)
            return wrapped

        self.app.router.use(count)
        self.app.run(block=False)

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.app.http_port}"


@pytest.fixture(scope="module")
def engine_replicas(weights_npz):
    """Two tiny replicas of each package on the same weights."""
    out = {}
    try:
        for name, p in sorted(PACKAGES.items()):
            out[name] = [EngineReplica(p, weights_npz, f"{name}-{i}")
                         for i in range(2)]
        yield out
    finally:
        for reps in out.values():
            for r in reps:
                r.app.stop()


def _engine_prompt(n, seed):
    return np.random.default_rng(seed).integers(
        1, JCFG.vocab_size, n).tolist()


def _gen_post(port, tokens, max_new=8, extra=None, timeout=60):
    body = {"tokens": list(map(int, tokens)),
            "max_new_tokens": max_new, **(extra or {})}
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, [json.loads(line) for line in
                             resp.read().decode().splitlines() if line]


def _run_both(engine_replicas, monkeypatch, case):
    """Run ``case(p, reps, gateway_factory)`` for each package: a
    gateway of that package over its own replicas. The gateway's seed
    for a sampled request is pinned, so both packages draw alike.
    Returns {package name: what the case returned}."""
    import random

    monkeypatch.setattr(random, "getrandbits", lambda n: 1234567)
    out = {}
    for name, p in sorted(PACKAGES.items()):
        reps = engine_replicas[name]
        for r in reps:
            r.hits = r.resumed = 0
        gws = []

        def factory(replicas, p=p, gws=gws, **extra):
            gw = make_gateway(p, replicas, **extra)
            gws.append(gw)
            return gw

        try:
            out[name] = case(p, reps, factory)
        finally:
            for gw in gws:
                gw.stop()
    return out


def _wire(lines):
    """Client lines less the run's own values: the request id, the
    replica address in a message, the retry-after."""
    out = []
    for ln in lines:
        ln = json.loads(json.dumps(ln))
        err = ln.get("error")
        if isinstance(err, dict):
            err.pop("message", None)
            err.pop("retry_after", None)
            if isinstance(err.get("resume"), dict):
                err["resume"].pop("request_id", None)
        out.append(ln)
    return out


def test_gateway_resumes_typed_loss_on_same_replica(engine_replicas,
                                                     monkeypatch):
    """An engine-declared death (the GENERATOR_MIDKILL seam after 3
    tokens: a typed line with a resume token) keeps the replica
    eligible -- it is alive and warmest. The gateway replays the
    continuation onto it and the client sees one clean stream, equal to
    the uninterrupted one with the gateway's pinned seed."""
    prompt = _engine_prompt(32, 41)

    def case(p, reps, factory):
        rep = reps[0]
        gw = factory([rep])
        ref = rep.app.container.tpu.generate(
            prompt, max_new_tokens=8, temperature=0.7,
            seed=1234567).tokens()
        sched = p.chaos.ChaosSchedule(seed=0).on(
            p.chaos.GENERATOR_MIDKILL, error=RuntimeError, every=3, limit=1)
        with p.chaos.scope(sched):
            status, lines = _gen_post(gw.http_port, prompt, max_new=8,
                                      extra={"temperature": 0.7})
        assert status == 200
        toks = [ln for ln in lines if "token" in ln]
        assert [t["token"] for t in toks] == ref
        assert [t["cursor"] for t in toks] == list(range(8))
        assert not any("error" in ln for ln in lines)
        # the continuation's first line carried its recompute through
        assert "recompute" in toks[3]
        assert rep.hits == 2 and rep.resumed == 1
        st = gw_stats(gw)
        assert st["resumes"] == 1
        assert st["outcomes"].get("midstream", 0) == 0
        return _wire(lines)

    got = _run_both(engine_replicas, monkeypatch, case)
    assert got["gofr_tpu_torch"] == got["gofr_tpu"]


def test_gateway_transport_loss_resumes_on_other_replica(engine_replicas,
                                                         monkeypatch):
    """A severed relay (the GATEWAY_MIDSTREAM seam after 4 relayed
    tokens, standing in for a replica SIGKILL) excludes the dead
    replica and splices the continuation from the other one: zero
    duplicate, zero missing, greedy token-exact."""
    prompt = _engine_prompt(32, 43)

    def case(p, reps, factory):
        gw = factory(reps)
        ref = reps[0].app.container.tpu.generate(
            prompt, max_new_tokens=8).tokens()
        sched = p.chaos.ChaosSchedule(seed=0).on(
            p.chaos.GATEWAY_MIDSTREAM, error=RuntimeError, every=4,
            limit=1)
        with p.chaos.scope(sched):
            status, lines = _gen_post(gw.http_port, prompt, max_new=8)
        assert status == 200
        toks = [ln for ln in lines if "token" in ln]
        assert [t["token"] for t in toks] == ref
        assert [t["cursor"] for t in toks] == list(range(8))
        assert not any("error" in ln for ln in lines)
        # the splice crossed processes
        assert sorted(r.hits for r in reps) == [1, 1]
        assert sum(r.resumed for r in reps) == 1
        st = gw_stats(gw)
        assert st["resumes"] == 1
        assert sorted(r["relayed"] for r in st["table"]["replicas"]) \
            == [1, 1]
        return _wire(lines)

    got = _run_both(engine_replicas, monkeypatch, case)
    assert got["gofr_tpu_torch"] == got["gofr_tpu"]


def test_gateway_resume_exhausted_typed_line_carries_resume_token(
        engine_replicas, monkeypatch):
    """One replica, transport loss: nobody left to resume on. The
    stream ends with the typed line, now carrying the resume token a
    client can continue from on its own."""
    prompt = _engine_prompt(16, 47)

    def case(p, reps, factory):
        rep = reps[0]
        gw = factory([rep])
        ref = rep.app.container.tpu.generate(
            prompt, max_new_tokens=8).tokens()
        sched = p.chaos.ChaosSchedule(seed=0).on(
            p.chaos.GATEWAY_MIDSTREAM, error=RuntimeError, every=3,
            limit=1)
        with p.chaos.scope(sched):
            status, lines = _gen_post(gw.http_port, prompt, max_new=8)
        assert status == 200
        toks = [ln["token"] for ln in lines[:-1]]
        assert toks == ref[:3]
        err = lines[-1]["error"]
        assert err["status"] == 503
        res = err["resume"]
        assert res["cursor"] == 3
        assert res["request_id"].startswith("gw-")
        assert res["chain"] == resume_chain(prompt, toks, BLOCK, 0)
        st = gw_stats(gw)
        assert st["resumes"] == 0
        assert st["outcomes"]["midstream"] == 1
        return _wire(lines)

    got = _run_both(engine_replicas, monkeypatch, case)
    assert got["gofr_tpu_torch"] == got["gofr_tpu"]


def test_gateway_resume_disabled_restores_legacy_contract(engine_replicas,
                                                          monkeypatch):
    """TPU_RESUME=false: the plain relay -- a post-commit loss is the
    replica's own typed line relayed untouched, no replay."""
    prompt = _engine_prompt(24, 53)

    def case(p, reps, factory):
        rep = reps[0]
        gw = factory([rep], TPU_RESUME="false")
        sched = p.chaos.ChaosSchedule(seed=0).on(
            p.chaos.GENERATOR_MIDKILL, error=RuntimeError, every=2, limit=1)
        with p.chaos.scope(sched):
            status, lines = _gen_post(gw.http_port, prompt, max_new=8)
        assert status == 200
        err = lines[-1]["error"]
        # the replica's own typed line relays through untouched (the
        # legacy relay treats ANY line as opaque bytes)
        assert err["status"] == 503
        assert err["resume"]["cursor"] == 2
        assert [ln["cursor"] for ln in lines[:-1]] == [0, 1]
        assert rep.hits == 1 and rep.resumed == 0
        assert gw_stats(gw)["resumes"] == 0
        return _wire(lines)

    got = _run_both(engine_replicas, monkeypatch, case)
    assert got["gofr_tpu_torch"] == got["gofr_tpu"]
