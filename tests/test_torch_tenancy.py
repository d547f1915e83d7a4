"""The multi-tenant serving plane on both packages, on the CPU: the
port's ``gofr_tpu_torch.tenancy`` (registry, ambient scope, quota book,
plane, ``WeightedFairLine``), the gate's ``admit_tenant``, the
generator's fair class lines and tenant path, the cache manager's tenant
ledger and ``hbm.tenant_lease``, held against the JAX package's
``gofr_tpu.tenancy`` on the same documents and seeded sequences
(tests/test_tenancy.py's cases).

- the registry: resolve, clamps, class and adapter routing, the scope,
  the hot reload with a malformed edit; ``plane_from_config``, which in
  the port refuses an unreadable registry by its row where JAX serves
  with tenancy off;
- the fair line and ``_ClassPending``: the same pop order as JAX's over
  seeded random sequences of append, pop and pop-then-undo, weights 1-4
  and 1-5 tenants;
- ``QuotaBook`` under one patched clock; the plane's and the gate's
  typed 429 and the shed's labels;
- the engine on `tiny` (float32, ``device="cpu"``): tenant-routed greedy
  tokens equal JAX's, the class default, the quota held to the
  terminal, every terminal kind giving the slot back, an engine without
  a plane unchanged, the per-tenant gauges and stats;
- the T0 budgets: the same victims as JAX's ``CacheManager`` over a
  seeded sequence, an engine whose over-share tenant evicts its own
  rows, the ``tenant:{id}`` lease and its reclaim.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import zlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import gofr_tpu.resilience as jres
import gofr_tpu.tenancy as jten
import gofr_tpu.tenancy.registry as jreg
import gofr_tpu_torch.resilience as pres
import gofr_tpu_torch.tenancy as pten
import gofr_tpu_torch.tenancy.registry as preg
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.errors import TooManyRequests as JTooMany
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.tpu import hbm as jhbm
from gofr_tpu.tpu.generator import GenerationEngine as JaxEngine
from gofr_tpu.tpu.generator import _ClassPending as JPending
from gofr_tpu.tpu.kvcache import CacheManager as JManager
from gofr_tpu.tpu.kvcache import KVLayout as JLayout
from gofr_tpu_torch import chaos
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.errors import DeadlineExceeded, TooManyRequests
from gofr_tpu_torch.metrics import Manager, register_framework_metrics
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.tpu import (GenerationEngine, GenerationError,
                                UNPORTED_ROWS, from_jax_params, hbm,
                                new_engine_from_config)
from gofr_tpu_torch.tpu.generator import _ClassPending as PPending
from gofr_tpu_torch.tpu.kvcache import CacheManager, KVLayout

JCFG = dataclasses.replace(JAX_CONFIGS["tiny"], max_seq=256)
CFG = dataclasses.replace(LLAMA_CONFIGS["tiny"], max_seq=256)
BUCKETS = (8, 16, 32)
LAT, THR = pres.SLO_LATENCY, pres.SLO_THROUGHPUT

REGISTRY_DOC = {
    "tenants": [
        {"id": "acme", "weight": 2, "max_concurrency": 1},
        {"id": "beta", "weight": 1, "slo_class": "throughput"},
        {"id": "gamma", "weight": 1, "rps": 1.0, "cache_share": 0.5},
    ],
    "default": {"weight": 1},
}
# the routing registry of the engine cases: one adapter a tenant
ROUTED_DOC = {"tenants": [
    {"id": "A", "weight": 2, "adapter": 1},
    {"id": "B", "weight": 1, "adapter": 2, "slo_class": "throughput"},
    {"id": "C", "weight": 1, "adapter": 3},
    {"id": "capped", "max_concurrency": 1},
]}
SIDES = {"jax": SimpleNamespace(ten=jten, reg=jreg, res=jres,
                                Shed=JTooMany, MapConfig=JMapConfig),
         "port": SimpleNamespace(ten=pten, reg=preg, res=pres,
                                 Shed=TooManyRequests, MapConfig=MapConfig)}


@pytest.fixture(params=sorted(SIDES))
def pk(request):
    return SIDES[request.param]


def _plane(pk, doc=None, metrics=None):
    return pk.ten.TenantPlane(pk.ten.TenantRegistry.from_json(
        doc or REGISTRY_DOC), metrics=metrics)


# -- registry and ambient scope ------------------------------------------------

def test_registry_resolve_known_unknown_default(pk):
    reg = pk.ten.TenantRegistry.from_json(REGISTRY_DOC)
    assert reg.resolve("acme").weight == 2
    assert reg.resolve("beta").slo_class == THR
    assert reg.resolve("who-dis").tenant_id == pk.ten.DEFAULT_TENANT
    assert reg.resolve(None).tenant_id == "default"
    assert reg.resolve("  acme  ").weight == 2
    assert len(reg) == 3
    assert reg.stats() == {"tenants": ["acme", "beta", "gamma"],
                           "path": None, "reloads": 0}


def test_the_specs_read_the_same_on_both():
    docs = [REGISTRY_DOC, ROUTED_DOC,
            {"tenants": [{"name": "n", "adapter": -2, "weight": "3",
                          "rps": "2.5", "slo_class": "bulk",
                          "cache_share": -1}]}]
    for doc in docs:
        out = {}
        for name, pk in SIDES.items():
            reg = pk.ten.TenantRegistry.from_json(json.dumps(doc))
            out[name] = [s.as_dict() for s in reg.tenants()]
        assert out["port"] == out["jax"]


def test_spec_validation_clamps(pk):
    s = pk.ten.TenantSpec("x", weight=0, rps=-3, cache_share=7.0, adapter=-1)
    assert (s.weight, s.rps, s.cache_share, s.adapter) == (1, 0.0, 1.0, 0)
    with pytest.raises(ValueError):
        pk.ten.TenantSpec.from_dict({"weight": 2})   # no id


def test_effective_class_and_adapter(pk):
    plane = _plane(pk)
    beta = plane.resolve("beta")
    assert plane.effective_class(beta, LAT) == THR
    assert plane.effective_class(beta, THR) == THR
    assert plane.effective_class(plane.resolve("acme"), LAT) == LAT
    tuned = pk.ten.TenantSpec("tuned", adapter=2)
    assert plane.effective_adapter(tuned, 0) == 2
    assert plane.effective_adapter(tuned, 5) == 5
    assert plane.cache_shares() == {"gamma": 0.5}


def test_tenant_scope_ambient_and_nesting(pk):
    cur, scope = pk.ten.current_tenant, pk.ten.tenant_scope
    assert cur() == "default"
    with scope("acme"):
        assert cur() == "acme"
        with scope(None):
            assert cur() == "acme"
        with scope("beta"):
            assert cur() == "beta"
        assert cur() == "acme"
    assert cur() == "default"
    seen = []
    with scope("acme"):   # per thread
        t = threading.Thread(target=lambda: seen.append(cur()))
        t.start()
        t.join(5)
    assert seen == ["default"]


def test_registry_hot_reload_and_malformed_keep_last_good(pk, tmp_path):
    path = tmp_path / "tenants.json"
    path.write_text(json.dumps(REGISTRY_DOC))
    reg = pk.ten.TenantRegistry(path=str(path), reload_s=0.05)
    assert reg.resolve("acme").weight == 2
    doc = dict(REGISTRY_DOC, tenants=[{"id": "acme", "weight": 9}])
    path.write_text(json.dumps(doc))
    os.utime(path, (time.time() + 100, time.time() + 100))
    reg._next_check = 0.0
    assert reg.resolve("acme").weight == 9
    assert reg.resolve("beta").tenant_id == "default"
    assert reg.reloads == 1
    for bad in ("{not json", '{"tenants": [{"weight": 2}]}'):
        path.write_text(bad)
        os.utime(path, (time.time() + 200, time.time() + 200))
        reg._next_check = 0.0
        assert reg.resolve("acme").weight == 9
        assert reg.reloads == 1
    # a vanished file keeps the table too
    path.unlink()
    reg._next_check = 0.0
    assert reg.resolve("acme").weight == 9


def test_plane_from_config_inline_path_and_off(pk, tmp_path):
    plane = pk.ten.plane_from_config(pk.MapConfig(
        {"TPU_TENANTS_INLINE": json.dumps(REGISTRY_DOC)}))
    assert plane is not None and plane.resolve("acme").weight == 2
    assert pk.ten.plane_from_config(pk.MapConfig({})) is None
    path = tmp_path / "t.json"
    path.write_text(json.dumps(ROUTED_DOC))
    plane = pk.ten.plane_from_config(pk.MapConfig(
        {"TPU_TENANTS": str(path), "TPU_TENANTS_RELOAD_S": "0.2",
         "TPU_TENANTS_INLINE": json.dumps(REGISTRY_DOC)}))
    assert plane.registry.path == str(path)   # the file wins
    assert plane.registry.reload_s == 0.2
    assert plane.resolve("A").adapter == 1


@pytest.mark.parametrize("row,value", [
    ("TPU_TENANTS", "no/such/registry.json"),
    ("TPU_TENANTS", "MALFORMED_FILE"),
    ("TPU_TENANTS_INLINE", "{bad"),
    ("TPU_TENANTS_INLINE", "4"),
    ("TPU_TENANTS_INLINE", '{"tenants": [{"weight": 1}]}'),
])
def test_an_unreadable_registry_is_refused_by_its_row(row, value, tmp_path):
    """The port raises ValueError naming the row (so does the engine
    builder, before any weights); JAX logs it and serves with tenancy
    off or an empty registry, every request the default tenant (ROADMAP
    queue 3, differences)."""
    if value == "MALFORMED_FILE":
        bad = tmp_path / "bad.json"
        bad.write_text("[1, 2")
        value = str(bad)
    try:
        jplane = jten.plane_from_config(JMapConfig({row: value}))
        assert jplane is None or len(jplane.registry) == 0
    except AttributeError:
        assert value == "4"   # JAX's parser takes any JSON for an object
    with pytest.raises(ValueError, match=row):
        pten.plane_from_config(MapConfig({row: value}))
    with pytest.raises(ValueError, match=row):
        new_engine_from_config(MapConfig({"TPU_MODEL": "tiny", row: value}),
                               device="cpu")


def test_the_tenant_rows_are_honoured():
    rows = ("TPU_TENANTS", "TPU_TENANTS_INLINE", "TPU_TENANTS_RELOAD_S",
            "TPU_TENANT_HEADER", "TPU_TENANT_TOPIC",
            "TPU_TENANT_CHECKPOINT_EVERY")
    assert not set(rows) & set(UNPORTED_ROWS)
    eng = new_engine_from_config(MapConfig({
        "TPU_MODEL": "tiny", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "64",
        "TPU_TENANTS_INLINE": json.dumps(ROUTED_DOC),
        "TPU_TENANT_TOPIC": "jobs", "TPU_TENANT_CHECKPOINT_EVERY": "4",
        "TPU_TENANT_HEADER": "X-Org"}), device="cpu")
    try:
        assert eng.tenancy is not None
        assert eng.generator.tenancy is eng.tenancy
        assert eng.health_check().details["tenancy"]["registry"][
            "tenants"] == ["A", "B", "C", "capped"]
    finally:
        eng.close()


# -- the fair line and the class line ------------------------------------------

class _Req:
    def __init__(self, tenant, weight=1, tag=None, slo_class=LAT):
        self.tenant = tenant
        self.tenant_weight = weight
        self.tag = tag
        self.slo_class = slo_class


def _fill(line, counts):
    seqs = {t: [_Req(t, w) for _ in range(n)] for t, (w, n) in counts.items()}
    while any(seqs.values()):
        for t in counts:
            if seqs[t]:
                line.append(seqs[t].pop(0))


def test_drr_order_is_weight_proportional(pk):
    line = pk.ten.WeightedFairLine()
    _fill(line, {"A": (2, 6), "B": (1, 3), "C": (1, 3)})
    assert [line.popleft().tenant for _ in range(12)] == \
        ["A", "A", "B", "C"] * 3
    assert len(line) == 0 and not line
    with pytest.raises(IndexError):
        line.popleft()


def test_drr_work_conserving_when_tenant_absent(pk):
    line = pk.ten.WeightedFairLine()
    _fill(line, {"A": (2, 4)})
    assert [line.popleft().tenant for _ in range(4)] == ["A"] * 4


def test_drr_appendleft_restores_exact_state(pk):
    ref_line = pk.ten.WeightedFairLine()
    _fill(ref_line, {"A": (2, 6), "B": (1, 3), "C": (1, 3)})
    ref = [ref_line.popleft().tenant for _ in range(12)]
    line = pk.ten.WeightedFairLine()
    _fill(line, {"A": (2, 6), "B": (1, 3), "C": (1, 3)})
    out = []
    for i in range(12):
        req = line.popleft()
        if i in (1, 4, 7):
            line.appendleft(req)
            assert line.popleft() is req
        out.append(req.tenant)
    assert out == ref


def test_untagged_requests_are_plain_fifo(pk):
    line = pk.ten.WeightedFairLine()
    reqs = [SimpleNamespace(slo_class=LAT) for _ in range(5)]
    for r in reqs:
        line.append(r)
    assert [line.popleft() for _ in range(5)] == reqs


def _fair_script(seed: int):
    """A seeded sequence of ("append", tenant, weight) / ("pop",) /
    ("undo",) over 1-5 tenants of weights 1-4."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    weights = {f"t{i}": int(rng.integers(1, 5)) for i in range(n)}
    script = []
    for _ in range(int(rng.integers(40, 120))):
        r = rng.random()
        if r < 0.5:
            t = f"t{int(rng.integers(0, n))}"
            script.append(("append", t, weights[t]))
        elif r < 0.85:
            script.append(("pop",))
        else:
            script.append(("undo",))
    return script


def _run_fair(line, script):
    out, tag = [], 0
    for op in script:
        if op[0] == "append":
            tag += 1
            line.append(_Req(op[1], op[2], tag))
        elif len(line):
            req = line.popleft()
            if op[0] == "undo":
                line.appendleft(req)
                out.append(("undo", req.tag))
            else:
                out.append(("pop", req.tag))
        out.append(tuple(sorted(line.by_tenant().items())))
    while len(line):
        out.append(("drain", line.popleft().tag))
    return out


@pytest.mark.parametrize("seed", range(24))
def test_the_fair_line_pops_as_jax_does(seed):
    script = _fair_script(seed)
    assert _run_fair(pten.WeightedFairLine(), script) == \
        _run_fair(jten.WeightedFairLine(), script)


def _run_pending(q, seed: int):
    """_ClassPending under a seeded sequence: puts of either class and
    tenant, pops with and without throughput allowed, and pops undone by
    put_front (the deferred lattice admission)."""
    import queue as _queue

    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(1, 6))
    weights = {f"t{i}": int(rng.integers(1, 5)) for i in range(n)}
    out, tag = [], 0
    for _ in range(150):
        r = rng.random()
        if r < 0.5:
            tag += 1
            t = f"t{int(rng.integers(0, n))}"
            q.put(_Req(t, weights[t], tag,
                       THR if rng.random() < 0.4 else LAT))
            continue
        allow = bool(rng.random() < 0.8)
        try:
            req = q.get_nowait(allow_throughput=allow)
        except _queue.Empty:
            out.append(("empty", allow))
            continue
        if r > 0.85:
            q.put_front(req)
            out.append(("front", req.tag))
        else:
            out.append(("pop", req.tag))
        out.append((q.qsize(), q.qsize_class(LAT), q.qsize_class(THR),
                    tuple(sorted(q.qsize_by_tenant().items()))))
    return out


@pytest.mark.parametrize("share", [0.25, 0.5, 0.0])
@pytest.mark.parametrize("seed", range(6))
def test_the_class_line_pops_as_jax_does(seed, share):
    assert _run_pending(PPending(share), seed) == \
        _run_pending(JPending(share), seed)


def test_class_pending_reports_queue_by_tenant():
    q = PPending(throughput_share=0.25)
    for tenant, cls in (("acme", LAT), ("acme", LAT), ("beta", THR)):
        q.put(_Req(tenant, 2 if tenant == "acme" else 1, slo_class=cls))
    assert q.qsize_by_tenant() == {"acme": 2, "beta": 1}
    assert q.qsize() == 3


# -- quotas ------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


def test_quota_book_matches_jax_under_one_clock(monkeypatch):
    """A seeded sequence of checks, releases and clock steps over tenants
    with rps and concurrency quotas gives JAX's verdicts and retry
    hints."""
    clock = _Clock()
    monkeypatch.setattr(jreg, "time", clock)
    monkeypatch.setattr(preg, "time", clock)
    rng = np.random.default_rng(5)
    rows = [{"id": f"t{i}", "rps": float(rng.choice([0, 0.5, 2, 5])),
             "max_concurrency": int(rng.integers(0, 4))} for i in range(4)]
    books = {n: (pk.ten.QuotaBook(), {r["id"]: pk.ten.TenantSpec.from_dict(r)
                                      for r in rows})
             for n, pk in SIDES.items()}
    outs = {n: [] for n in books}
    for _ in range(400):
        r, tid = rng.random(), f"t{int(rng.integers(0, 4))}"
        dt = float(rng.exponential(0.2))
        for name, (book, specs) in books.items():
            if r < 0.6:
                outs[name].append(book.check(specs[tid]))
            else:
                book.release(tid)
            outs[name].append(book.active(tid))
        if r > 0.8:
            clock.now += dt
    assert outs["port"] == outs["jax"]
    assert any(o[0] == "rps" for o in outs["port"] if isinstance(o, tuple))
    assert any(o[0] == "concurrency" for o in outs["port"]
               if isinstance(o, tuple))


def test_quota_book_concurrency_and_release(pk):
    book = pk.ten.QuotaBook()
    spec = pk.ten.TenantSpec("t", max_concurrency=1)
    assert book.check(spec) == (None, 0.0)
    why, retry = book.check(spec)
    assert why == "concurrency" and retry > 0
    book.release("t")
    assert book.check(spec) == (None, 0.0)
    assert book.active("t") == 1


def test_plane_admit_raises_typed_429(pk):
    m = Manager()
    register_framework_metrics(m)
    plane = _plane(pk, metrics=m if pk is SIDES["port"] else None)
    spec = plane.resolve("acme")
    plane.admit(spec)
    with pytest.raises(pk.Shed) as ei:
        plane.admit(spec)
    e = ei.value
    assert (e.reason, e.status_code) == ("tenant_quota", 429)
    assert e.retry_after >= 0.05 and "Retry-After" in e.headers
    stats = plane.stats()["tenants"]["acme"]
    assert (stats["admitted"], stats["shed"], stats["active"]) == (1, 1, 1)
    plane.release("acme")
    plane.admit(spec)
    if pk is SIDES["port"]:
        text = m.render_prometheus()
        assert 'app_tpu_tenant_shed{tenant="acme"} 1.0' in text
        assert 'app_tpu_tenant_admitted{tenant="acme"} 2.0' in text


def test_gate_admit_tenant_types_the_shed(pk):
    m = Manager()
    register_framework_metrics(m)
    gate = pk.res.AdmissionGate(max_queue_depth=100, name="generate",
                                metrics=m if pk is SIDES["port"] else None)
    plane = _plane(pk)
    spec = plane.resolve("acme")
    plane.admit(spec, program="generate", gate=gate)
    with pytest.raises(pk.Shed) as ei:
        plane.admit(spec, program="generate", gate=gate)
    assert ei.value.reason == "tenant_quota"
    assert gate.stats()["sheds"] == 1
    assert gate.stats()["sheds_by_class"] == {LAT: 1, THR: 0}
    plane.release("acme")
    if pk is SIDES["port"]:
        # the tenant label only where a tenant was named; a queue shed
        # without a plane keeps the labels it always had
        small = pk.res.AdmissionGate(max_queue_depth=1, name="generate",
                                     metrics=m)
        with pytest.raises(pk.Shed):
            small.admit(5, program="generate")
        text = m.render_prometheus()
        assert ('app_tpu_shed_total{program="generate",slo_class="latency",'
                'tenant="acme"} 1.0') in text
        assert ('app_tpu_shed_total{program="generate",slo_class="latency"}'
                ' 1.0') in text


# -- the engine on tiny ----------------------------------------------------------

def _lora_tree() -> dict:
    """``tiny`` from PRNGKey(1) with 4 adapter slots of rank 4, adapters
    1-3 with distinct nonzero B (a crc32-seeded normal times 0.05, -0.5
    and 0.8)."""
    params = jllama.init(JCFG, jax.random.PRNGKey(1))
    layers = {**params["layers"],
              **jllama.init_lora(JCFG, 4, 4, jax.random.PRNGKey(2))}
    for name in jllama.LORA_TARGETS:
        b = layers[f"lora_b_{name}"]
        fill = jax.random.normal(
            jax.random.PRNGKey(zlib.crc32(name.encode()) % 1000),
            b.shape[:1] + b.shape[2:]) * 0.05
        for idx, k in ((1, 1.0), (2, -0.5), (3, 0.8)):
            b = b.at[:, idx].set((fill * k).astype(b.dtype))
        layers[f"lora_b_{name}"] = b
    return {**params, "layers": layers}


@pytest.fixture(scope="module")
def weights():
    jp = _lora_tree()
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _args(**kw):
    args = dict(slots=4, max_seq=256, prompt_buckets=BUCKETS,
                decode_block=2, lora_adapters=4)
    args.update(kw)
    return args


def _jax_engine(weights, doc=ROUTED_DOC, **kw):
    eng = JaxEngine(JCFG, weights[0], **_args(**kw))
    if doc is not None:
        eng.install_tenancy(jten.TenantPlane(
            jten.TenantRegistry.from_json(doc)))
    return eng


def _port_engine(weights, doc=ROUTED_DOC, metrics=None, **kw):
    eng = GenerationEngine(CFG, weights[1], device="cpu", metrics=metrics,
                           **_args(**kw))
    if doc is not None:
        eng.install_tenancy(pten.TenantPlane(
            pten.TenantRegistry.from_json(doc), metrics=metrics))
    return eng


def _prompt(n, seed=7):
    return np.random.default_rng(seed).integers(
        1, CFG.vocab_size, n).tolist()


def _wait_for(pred, timeout=20.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.005)
    return False


CASES = [("A", 20, 0), ("B", 12, 0), ("C", 60, 0), ("A", 9, 2),
         ("who-dis", 25, 0), (None, 14, 3)]


def _routed(eng, scope):
    """Each case alone on the idle engine: (tenant, adapter, class,
    tokens) of its stream."""
    out = []
    for i, (tenant, n, adapter) in enumerate(CASES):
        with scope(tenant):
            s = eng.generate(_prompt(n, 30 + i), max_new_tokens=6,
                             adapter=adapter)
        toks = [int(t) for t in s.tokens()]
        out.append((s.tenant, s.slo_class, toks))
    return out


def test_tenant_routed_greedy_tokens_equal_jax(weights):
    """A tenant's registry adapter and class default reach its stream;
    an explicit adapter stands; an unknown id is the default tenant; the
    greedy tokens are JAX's, and A's are those of adapter 1 untenanted."""
    jeng = _jax_engine(weights)
    try:
        want = _routed(jeng, jten.tenant_scope)
    finally:
        jeng.close()
    eng = _port_engine(weights)
    try:
        got = _routed(eng, pten.tenant_scope)
        with pten.tenant_scope("A"):
            s = eng.generate(_prompt(20, 30), max_new_tokens=6)
        assert s.adapter == 1 and s.tenant == "A"
        s.tokens()
        plain = eng.generate(_prompt(20, 30), max_new_tokens=6,
                             adapter=1).tokens()
        base = eng.generate(_prompt(20, 30), max_new_tokens=6).tokens()
        stats = eng.stats()
    finally:
        eng.close()
    assert got == want
    assert [g[:2] for g in got] == [
        ("A", LAT), ("B", THR), ("C", LAT), ("A", LAT), ("default", LAT),
        ("default", LAT)]
    assert got[0][2] == plain != base
    assert stats["tenancy"]["tenants"]["A"]["admitted"] == 3
    assert stats["scheduler"]["queued_by_tenant"] == {}
    assert all(t["active"] == 0 for t in stats["tenancy"]["tenants"].values())


def test_an_engine_without_a_plane_is_unchanged(weights):
    jeng = _jax_engine(weights, doc=None)
    try:
        with jten.tenant_scope("A"):
            want = jeng.generate(_prompt(20, 3), max_new_tokens=6).tokens()
    finally:
        jeng.close()
    eng = _port_engine(weights, doc=None)
    try:
        assert eng.tenancy is None
        with pten.tenant_scope("A"):   # the ambient tenant is ignored
            s = eng.generate(_prompt(20, 3), max_new_tokens=6)
        got = s.tokens()
        assert s.tenant == "default" and s.adapter == 0
        stats = eng.stats()
        assert "tenancy" not in stats
        assert "queued_by_tenant" not in stats["scheduler"]
    finally:
        eng.close()
    assert got == [int(t) for t in want]


def test_the_engine_enforces_the_quota_and_releases_at_the_terminal(weights):
    """tests/test_tenancy.py's case: ``capped`` (concurrency 1) holds its
    slot until its stream ends; a second request meanwhile is a typed
    429 counted on the plane."""
    for side, make, scope, Shed in (
            ("jax", _jax_engine, jten.tenant_scope, JTooMany),
            ("port", _port_engine, pten.tenant_scope, TooManyRequests)):
        eng = make(weights)
        try:
            with scope("capped"):
                s1 = eng.generate(_prompt(8), max_new_tokens=4)
                with pytest.raises(Shed) as ei:
                    eng.generate(_prompt(8, seed=8), max_new_tokens=2)
                assert ei.value.reason == "tenant_quota"
                assert len(s1.tokens()) == 4
                assert _wait_for(
                    lambda: eng.tenancy.quotas.active("capped") == 0)
                s2 = eng.generate(_prompt(8, seed=9), max_new_tokens=2)
                assert len(s2.tokens()) == 2
            assert _wait_for(lambda: eng.tenancy.quotas.active("capped") == 0)
            st = eng.stats()
            assert st["tenancy"]["tenants"]["capped"]["shed"] == 1, side
            assert "queued_by_tenant" in st["scheduler"]
        finally:
            eng.close()


def test_the_fair_line_orders_a_saturated_engine_as_jax_does(weights):
    """One slot, the device lock held while 12 requests of A, B and C
    queue (B's class default is throughput: it waits in the throughput
    line, A and C share the latency line 2:1): the admission order is
    JAX's."""
    orders = {}
    for side, make, scope in (("jax", _jax_engine, jten.tenant_scope),
                              ("port", _port_engine, pten.tenant_scope)):
        eng = make(weights, slots=1)
        order = []
        try:
            streams = []
            with eng._device_lock:
                for i in range(12):
                    t = "ABC"[i % 3]
                    with scope(t):
                        s = eng.generate(_prompt(8, 50 + i),
                                         max_new_tokens=2)
                    s.tag = (t, i)
                    streams.append(s)
            for s in streams:
                s.tokens()
            order = [s.tag for s in sorted(
                streams, key=lambda s: s.trace["admit"])]
        finally:
            eng.close()
        orders[side] = order
    assert orders["port"] == orders["jax"]


class _Trip:
    """A deadline that runs out once ``armed`` is set (or after ``after``
    checks), so a case picks the expiry site."""

    def __init__(self, after=None):
        self.armed = False
        self.after = after
        self.calls = 0
        self.at = time.monotonic() + 3600

    def expired(self):
        self.calls += 1
        if self.after is not None and self.calls > self.after:
            return True
        return self.armed

    def remaining(self):
        return -1.0 if self.expired() else 3600.0

    def budget(self, timeout):
        return timeout


def _drain(stream):
    try:
        for _ in stream:
            pass
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return type(e).__name__
    return "ok"


def _terminal(kind, eng, scope):
    """Drive one terminal kind for tenant A; returns how it ended."""
    p = _prompt(12, 77)
    if kind == "finish":
        with scope("A"):
            return _drain(eng.generate(p, max_new_tokens=4))
    if kind == "cancel-live":
        with scope("A"):
            s = eng.generate(p, max_new_tokens=200)
        it = iter(s)
        next(it)
        s.cancel()
        return _drain(s)
    if kind == "cancel-queued":
        with eng._device_lock:
            with scope("A"):
                s = eng.generate(p, max_new_tokens=4)
            s.cancel()
        return _drain(s)
    if kind == "expire-pre-queue":
        d = pres.Deadline(time.monotonic() - 1)
        with scope("A"), pytest.raises(DeadlineExceeded):
            eng.generate(p, max_new_tokens=4, deadline=d)
        return "raised"
    if kind == "expire-queue":
        d = _Trip()
        with eng._device_lock:
            with scope("A"):
                s = eng.generate(p, max_new_tokens=4, deadline=d)
            d.armed = True
        return _drain(s)
    if kind == "expire-mid-prefill":
        # checked before queueing, at admission, then between chunks
        with scope("A"):
            return _drain(eng.generate(_prompt(100, 78), max_new_tokens=4,
                                       deadline=_Trip(after=2)))
    if kind == "expire-mid-decode":
        d = _Trip()
        with scope("A"):
            s = eng.generate(p, max_new_tokens=200, deadline=d)
        it = iter(s)
        next(it)
        d.armed = True
        return _drain(s)
    if kind == "recovery":
        with scope("A"):
            s = eng.generate(p, max_new_tokens=200)
        it = iter(s)
        next(it)
        with chaos.scope(chaos.ChaosSchedule(seed=0).on(
                chaos.GENERATOR_STEP, error=chaos.DeviceLost, every=1,
                limit=1)):
            return _drain(s)
    if kind == "prefill-failed":
        with chaos.scope(chaos.ChaosSchedule(seed=0).on(
                chaos.GENERATOR_PREFILL, error=chaos.DeviceLost, every=1,
                limit=1)):
            with scope("A"):
                return _drain(eng.generate(p, max_new_tokens=4))
    if kind == "midkill":
        with chaos.scope(chaos.ChaosSchedule(seed=0).on(
                chaos.GENERATOR_MIDKILL, error=RuntimeError, every=2,
                limit=1)):
            with scope("A"):
                return _drain(eng.generate(p, max_new_tokens=8))
    if kind == "shed-oom":
        with chaos.scope(chaos.ChaosSchedule(seed=0).on(
                chaos.HBM_ALLOC, error=chaos.ResourceExhausted, every=1,
                limit=1)):
            with scope("A"):
                return _drain(eng.generate(p, max_new_tokens=4))
    if kind == "shed-gate":
        # the quota is taken, then the gate sheds: the slot comes back
        with eng._device_lock:
            with scope("C"):
                first = eng.generate(p, max_new_tokens=2)
            with scope("A"), pytest.raises(TooManyRequests) as ei:
                eng.generate(p, max_new_tokens=2)
        assert ei.value.reason != "tenant_quota"
        _drain(first)
        return "raised"
    if kind == "refused":
        with scope("A"):
            return _drain(eng.generate(_prompt(300, 79), max_new_tokens=4))
    if kind == "adapter-refused":
        with scope("A"), pytest.raises(GenerationError):
            eng.generate(p, max_new_tokens=4, adapter=9)
        return "raised"
    if kind == "drain":
        with scope("A"):
            s = eng.generate(p, max_new_tokens=30)
        assert eng.drain(30.0)
        with scope("A"), pytest.raises(GenerationError):
            eng.generate(p, max_new_tokens=2)
        return _drain(s)
    if kind == "closed":
        # a slowed loop keeps the stream live when the engine closes
        with chaos.scope(chaos.ChaosSchedule(seed=0).on(
                chaos.GENERATOR_STEP, latency=0.05)):
            with scope("A"):
                s = eng.generate(p, max_new_tokens=100)
            it = iter(s)
            next(it)
            eng.close()
        return _drain(s)
    raise AssertionError(kind)


TERMINALS = {
    "finish": "ok", "cancel-live": "ok", "cancel-queued": "ok",
    "expire-pre-queue": "raised", "expire-queue": "DeadlineExceeded",
    "expire-mid-prefill": "DeadlineExceeded",
    "expire-mid-decode": "DeadlineExceeded", "recovery": "GenerationError",
    "prefill-failed": "GenerationError", "midkill": "GenerationError",
    "shed-oom": "HBMExhausted", "shed-gate": "raised",
    "refused": "GenerationError", "adapter-refused": "raised",
    "drain": "ok", "closed": "GenerationError",
}


@pytest.mark.parametrize("kind", sorted(TERMINALS))
def test_no_tenant_slot_leaks_at_any_terminal(weights, kind):
    """Every terminal a stream can reach gives its tenant's concurrency
    slot back exactly once: A's live count is 0 after it, and a second
    release would not have gone below (the book drops a tenant at 0)."""
    m = Manager()
    register_framework_metrics(m)
    gate = pres.AdmissionGate(max_queue_depth=1, name="generate") \
        if kind == "shed-gate" else None
    eng = _port_engine(weights, metrics=m, gate=gate, slots=2,
                       max_seq=128, prefill_chunk=32)
    plane = eng.tenancy
    try:
        if kind == "shed-oom":
            hbm.reset()
        end = _terminal(kind, eng, pten.tenant_scope)
        assert end == TERMINALS[kind] or (
            kind == "shed-oom" and end == "TooManyRequests"), end
        assert _wait_for(lambda: plane.quotas.active("A") == 0), kind
        assert _wait_for(lambda: plane.quotas.active("C") == 0), kind
        assert plane.quotas._active == {}
        if kind in ("finish", "recovery", "drain"):
            # the engine serves on, and A's slot is whole: one more
            with pten.tenant_scope("A"):
                if kind != "drain":
                    assert len(eng.generate(_prompt(9, 5),
                                            max_new_tokens=2).tokens()) == 2
            assert plane.quotas._active == {}
    finally:
        eng.close()
        hbm.reset()


def test_the_per_tenant_gauges_and_the_ttft_labels(weights):
    """The queue-depth gauges by tenant (a tenant that drained reads 0)
    while requests wait, and the TTFT histogram's one label-key set:
    ``tenant`` is "" on an engine without a plane."""
    m = Manager()
    register_framework_metrics(m)
    eng = _port_engine(weights, metrics=m, slots=1)
    try:
        streams = []
        with eng._device_lock:
            for t in "AABC":
                with pten.tenant_scope(t):
                    streams.append(eng.generate(_prompt(8, 9),
                                                max_new_tokens=2))
            text = m.render_prometheus()
            assert eng.stats()["scheduler"]["queued_by_tenant"] == \
                {"A": 2, "B": 1, "C": 1}
        for s in streams:
            s.tokens()
        assert _wait_for(lambda: eng.stats()["active"] == 0)
        after = m.render_prometheus()
    finally:
        eng.close()
    assert 'app_tpu_queue_depth{program="generate",tenant="A"} 2.0' in text
    assert 'app_tpu_queue_depth{program="generate",tenant="B"} 1.0' in text
    assert 'app_tpu_queue_depth{program="generate",tenant="A"} 0.0' in after
    assert ('app_tpu_ttft_duration_count{program="generate",'
            'slo_class="throughput",tenant="B"} 1') in after
    m2 = Manager()
    register_framework_metrics(m2)
    eng = _port_engine(weights, doc=None, metrics=m2)
    try:
        eng.generate(_prompt(8, 9), max_new_tokens=2).tokens()
    finally:
        eng.close()
    text = m2.render_prometheus()
    assert ('app_tpu_ttft_duration_count{program="generate",'
            'slo_class="latency",tenant=""} 1') in text
    assert 'tenant="' not in text.replace('tenant=""', "")


def test_predict_holds_the_tenant_quota_for_the_call():
    """TorchEngine.predict resolves the ambient tenant as generate does:
    the class default, the quota held for the call and given back on
    every exit, the typed 429, ``details["tenancy"]`` in health."""
    doc = {"tenants": [{"id": "one", "max_concurrency": 1},
                       {"id": "bulk", "slo_class": "throughput"}]}
    eng = new_engine_from_config(MapConfig({
        "TPU_MODEL": "bert-tiny", "TPU_TENANTS_INLINE": json.dumps(doc)}),
        device="cpu")
    plane = eng.tenancy
    try:
        seen = {}
        runner = eng._batchers["embed"].runner

        def spy(items):
            seen["active"] = plane.quotas.active("one")
            return runner(items)

        eng._batchers["embed"].runner = spy
        with pten.tenant_scope("one"):
            out = eng.predict("embed", [1, 2, 3])
        assert seen["active"] == 1 and plane.quotas.active("one") == 0
        assert np.asarray(out).ndim == 1
        with pten.tenant_scope("one"):
            with pytest.raises(Exception):
                eng.predict("embed", [])   # refused: the slot comes back
        assert plane.quotas.active("one") == 0
        plane.quotas.check(plane.resolve("one"))   # hold the only slot
        with pten.tenant_scope("one"), \
                pytest.raises(TooManyRequests) as ei:
            eng.predict("embed", [1, 2])
        assert ei.value.reason == "tenant_quota"
        plane.release("one")
        details = eng.health_check().details
        assert details["tenancy"]["tenants"]["one"]["shed"] == 1
        assert details["tenancy"]["tenants"]["one"]["admitted"] == 2
    finally:
        eng.close()


# -- per-tenant cache budgets ----------------------------------------------------

def _key(seed, n=16):
    return np.random.default_rng(seed).integers(1, 100, n).astype(np.int32)


def _managers(shares):
    return {"jax": JManager(4, JLayout(2, 2, 4, False,
                                       np.dtype(np.float32), 64), block=4),
            "port": CacheManager(4, KVLayout(2, 2, 4, False, torch.float32,
                                             64), block=4)}


def test_cache_over_share_tenant_evicts_its_own_rows_first():
    """tests/test_tenancy.py's scripted case on both managers."""
    out = {}
    for name, mgr in _managers(None).items():
        shares = {"a": 0.5, "b": 0.5}
        mgr.set_tenancy(lambda s=shares: s, row_bytes=1024)
        trace = [mgr.tenant_budget("a"), mgr.tenant_budget("c")]
        for i, tenant in enumerate(["a", "a", "b", "b"]):
            row, victim = mgr.store(_key(i), tenant=tenant)
            trace.append((row, victim))
        row, victim = mgr.store(_key(4), tenant="a")
        trace.append((row, victim.key.tolist(),
                      mgr._eid_owner.get(victim.eid)))
        trace.append(mgr.tenant_rows())
        shares["b"] = 0.25
        trace.append([v.key.tolist() for v in mgr.evict_tenant("b")])
        trace.append(mgr.tenant_rows())
        trace.append(mgr.stats()["tenants"])
        out[name] = trace
    assert out["port"] == out["jax"]
    assert out["port"][-2] == {"a": 2, "b": 1}


@pytest.mark.parametrize("seed", range(8))
def test_the_cache_ledger_picks_jax_victims_over_a_seeded_sequence(seed):
    """Stores by tenants a-c (shares 0.5, 0.25, none) and untagged ones,
    hits, targeted evictions, an adapter swap and a recovery's clear:
    every row, victim and ledger equal to JAX's."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(60):
        r = rng.random()
        if r < 0.6:
            ops.append(("store", int(rng.integers(0, 40)),
                        [None, "a", "b", "c"][int(rng.integers(0, 4))],
                        int(rng.integers(0, 2))))
        elif r < 0.8:
            ops.append(("hit", int(rng.integers(0, 40))))
        elif r < 0.9:
            ops.append(("evict", ["a", "b", "c"][int(rng.integers(0, 3))]))
        elif r < 0.95:
            ops.append(("invalidate", int(rng.integers(0, 2))))
        else:
            ops.append(("clear",))
    out = {}
    for name, mgr in _managers(None).items():
        mgr.set_tenancy(lambda: {"a": 0.5, "b": 0.25})
        trace, keys = [], {}
        for op in ops:
            if op[0] == "store":
                k = _key(op[1], 16 + op[1] % 5)
                row, victim = mgr.store(k, adapter=op[3], tenant=op[2])
                trace.append((row, None if victim is None
                              else victim.key.tolist()))
            elif op[0] == "hit":
                mt = mgr.match(_key(op[1], 16 + op[1] % 5))
                if mt is not None:
                    mgr.accept(mt, tenant="a")
                    trace.append(("hit", mt.row, mt.matched_len))
            elif op[0] == "evict":
                trace.append([v.key.tolist()
                              for v in mgr.evict_tenant(op[1])])
            elif op[0] == "invalidate":
                mgr.invalidate_adapter(op[1])
            else:
                mgr.clear_device()
            trace.append(mgr.tenant_rows())
        trace.append(mgr.stats())
        out[name] = trace
    assert out["port"] == out["jax"]


def test_tenant_lease_tags_the_arbiter():
    marker = object()
    for mod in (jhbm, hbm):
        mod.tenant_lease("tenancy-test", 0, tenant="acme", owner=marker)
        try:
            assert any(k[2] == "tenant:acme" for k in mod.snapshot())
        finally:
            mod.release("tenancy-test", owner=marker)
        assert not any(k[2] == "tenant:acme" for k in mod.snapshot())
    calls = []
    try:
        hbm.tenant_lease("kvcache-t0", 0, tenant="b", owner=marker,
                         reclaim=lambda need: calls.append(need) or 0)
        (row,) = [r for r in hbm.arbiter_stats()["leases"]
                  if r["tag"] == "tenant:b"]
        assert (row["priority"], row["reclaimable"], row["bytes"]) == (
            "scratch", True, 0)
        hbm.reclaim(5)
        assert calls == [5]
    finally:
        hbm.reset()


CACHE_DOC = {"tenants": [{"id": "A", "cache_share": 0.5},
                         {"id": "B", "cache_share": 0.5}]}


def _cache_engine(weights):
    m = Manager()
    register_framework_metrics(m)
    return _port_engine(weights, doc=CACHE_DOC, metrics=m, slots=2,
                        lora_adapters=0, prefix_cache_slots=4,
                        prefix_store_min=16), m


def _lease(tenant):
    return [r for r in hbm.arbiter_stats()["leases"]
            if r["tag"] == f"tenant:{tenant}"]


def test_an_over_share_tenant_evicts_its_own_rows_in_the_engine(weights):
    """T0 of 4 rows, A and B a half each: A stores 3 prompts (over its
    share: a ``tenant:A`` lease shows), the lease's reclaim as the
    arbiter holds it evicts only A's oldest row; B stores 2, filling T0;
    A stores 4 more, each evicting one of A's own rows; B's rows stay
    indexed and its re-query is a T0 hit."""
    hbm.reset()
    eng, m = _cache_engine(weights)
    kvc = eng._kvc
    prompts = {t: [_prompt(20, s) for s in range(base, base + 7)]
               for t, base in (("A", 100), ("B", 200))}

    def store(t, i):
        with pten.tenant_scope(t):
            eng.generate(prompts[t][i], max_new_tokens=1).tokens()

    try:
        for i in range(3):
            store("A", i)
        assert kvc.tenant_rows() == {"A": 3}
        assert len(_lease("A")) == 1 and _lease("A")[0]["reclaimable"]
        reg = hbm._registry
        (key,) = [k for k in reg._meta if k[2] == "tenant:A"]
        reg._deref_reclaim(reg._meta[key][1])(1)
        assert kvc.tenant_rows() == {"A": 2} and not _lease("A")
        assert kvc.t0.match(np.asarray(prompts["A"][0], np.int32))[1] == 0
        store("B", 0)
        store("B", 1)
        ev0 = kvc.t0.evictions
        for i in range(3, 7):
            store("A", i)
        assert kvc.t0.evictions - ev0 == 4
        assert kvc.tenant_rows() == {"A": 2, "B": 2}
        with pten.tenant_scope("B"):
            s = eng.generate(prompts["B"][0] + _prompt(5, 9),
                             max_new_tokens=1)
            s.tokens()
        assert s.cache_tier == "t0" and s.cache_tokens == 20
        st = eng.stats()["prefix_cache"]["tenants"]
        assert st == {"A": {"rows": 2, "budget": 2},
                      "B": {"rows": 2, "budget": 2}}
        text = m.render_prometheus()
        assert 'app_tpu_tenant_cache_bytes{tenant="B"}' in text
    finally:
        eng.close()
        hbm.reset()
    assert not _lease("A")
