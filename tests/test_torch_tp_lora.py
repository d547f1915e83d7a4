"""Multi-LoRA serving under tensor parallelism (gofr_tpu_torch,
``TPU_SHARDING=tp=N``) against the JAX package's unsharded engine on
`tiny` (float32), on the same weights and adapters (JAX's stacks carried
across with ``from_jax_params``). Greedy tokens are compared exactly.

Each rank holds its slice of the stacks: B of wq/wk/wv by the rank's
output columns with their A whole, A of wo by the rank's input rows with
its B whole, so the wo delta joins the rank's partial sum before the one
``all_reduce``.

- adapter streams at tp=2 and tp=4, contiguous and paged, equal JAX's;
- ``load_adapter`` while streams are live reaches every rank, leaves the
  live streams JAX's, and drops the adapter's stored prefixes (T0, T1,
  the T2 epoch; the paged index);
- tenancy's adapter routing at tp=2 is JAX's.
"""

import signal
import zlib

import jax
import numpy as np
import pytest
import torch

import gofr_tpu.tenancy as jten
import gofr_tpu_torch.tenancy as pten
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.tpu.generator import GenerationEngine as JaxEngine
from gofr_tpu.tpu.kvcache import KVCacheOptions as JOptions
from gofr_tpu_torch.datasource.redisclient import RedisClient
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.parallel import MeshPlan, shard_params
from gofr_tpu_torch.testutil.redisfake import FakeRedisServer
from gofr_tpu_torch.tpu import GenerationEngine, from_jax_params
from gofr_tpu_torch.tpu.kvcache import KVCacheOptions

JCFG = JAX_CONFIGS["tiny"]
CFG = LLAMA_CONFIGS["tiny"]
_LIMIT_S = 120
N_NEW = 8
PAGED = dict(paged_blocks=25, paged_block_size=8)
ROUTED_DOC = {"tenants": [
    {"id": "A", "weight": 2, "adapter": 1},
    {"id": "B", "weight": 1, "adapter": 2, "slo_class": "throughput"},
]}


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(*_):
        raise TimeoutError(f"tensor-parallel test ran past {_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, _LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _lora_tree() -> dict:
    """``tiny`` from PRNGKey(1) with 3 adapter slots of rank 4, adapters
    1 and 2 with distinct nonzero B (a crc32-seeded normal times 0.05
    and -0.5 times it), as tests/test_lora.py builds them."""
    params = jllama.init(JCFG, jax.random.PRNGKey(1))
    layers = {**params["layers"],
              **jllama.init_lora(JCFG, 3, 4, jax.random.PRNGKey(2))}
    for name in jllama.LORA_TARGETS:
        b = layers[f"lora_b_{name}"]
        fill = jax.random.normal(
            jax.random.PRNGKey(zlib.crc32(name.encode()) % 1000),
            b.shape[:1] + b.shape[2:]) * 0.05
        for idx, k in ((1, 1.0), (2, -0.5)):
            b = b.at[:, idx].set((fill * k).astype(b.dtype))
        layers[f"lora_b_{name}"] = b
    return {**params, "layers": layers}


@pytest.fixture(scope="module")
def weights():
    jp = _lora_tree()
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _base(tree: dict) -> dict:
    return {**tree, "layers": {k: v for k, v in tree["layers"].items()
                               if not k.startswith("lora_")}}


def _slot(tree: dict, idx: int) -> dict:
    """load_adapter's tree for adapter ``idx`` of ``tree``'s stacks."""
    return {name: (np.asarray(tree["layers"][f"lora_a_{name}"][:, idx]),
                   np.asarray(tree["layers"][f"lora_b_{name}"][:, idx]))
            for name in llama.LORA_TARGETS}


def _args(**kw):
    args = dict(slots=4, max_seq=64, prompt_buckets=(8, 16),
                lora_adapters=3, lora_rank=4)
    args.update(kw)
    return args


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        1, CFG.vocab_size, n).tolist()


def _agree(eng) -> None:
    probe = eng.tp_probe()
    B = eng.n_slots
    assert (probe[:, :5 * B + 1] == probe[0, :5 * B + 1]).all(), probe


# (prompt length, adapter): bucket admissions and a lattice one
STREAMS = [(6, 1), (12, 2), (9, 0), (40, 1)]


def _streams(eng):
    """Each stream alone on the idle engine (single-stream probes)."""
    return [eng.generate(_prompt(n, 40 + i), max_new_tokens=N_NEW,
                         adapter=a).tokens()
            for i, (n, a) in enumerate(STREAMS)]


def test_the_stacks_slice_and_put_back_together(weights):
    """shard_params slices the stacks: B of wq/wk/wv on its output
    columns (wk/wv on the rank's KV head where heads replicate), A of wo
    on its input rows, the rest whole; tp=2's slices concatenated are
    the whole stacks."""
    full = weights[1]["layers"]
    s0, s1 = (shard_params(weights[1], CFG, r, 2)["layers"] for r in (0, 1))
    for name in ("lora_b_wq", "lora_b_wk", "lora_b_wv"):
        assert torch.equal(torch.cat([s0[name], s1[name]], -1), full[name])
    assert torch.equal(torch.cat([s0["lora_a_wo"], s1["lora_a_wo"]], -2),
                       full["lora_a_wo"])
    for name in ("lora_a_wq", "lora_a_wk", "lora_a_wv", "lora_b_wo"):
        assert torch.equal(s0[name], full[name])
    hd = CFG.head_dim
    for r in range(4):
        b = shard_params(weights[1], CFG, r, 4)["layers"]["lora_b_wk"]
        head = r // 2
        assert torch.equal(b, full["lora_b_wk"][..., head * hd:
                                                (head + 1) * hd])


@pytest.mark.parametrize("tp,kind", [(2, "contiguous"), (2, "paged"),
                                     (4, "contiguous")])
def test_tp_adapter_streams_equal_jax_s_unsharded_engine(weights, tp, kind):
    """Adapter streams (0, 1, 2; bucket and lattice admissions) at tp
    ranks, each rank on its slices of the carried stacks, equal JAX's
    unsharded engine; every rank's carry agrees."""
    kw = _args(**(PAGED if kind == "paged" else {}))
    jeng = JaxEngine(JCFG, weights[0], **kw)
    try:
        want = _streams(jeng)
    finally:
        jeng.close()
    eng = GenerationEngine(CFG, weights[1], mesh=MeshPlan(tp=tp),
                           device="cpu", **kw)
    try:
        got = _streams(eng)
        _agree(eng)
        assert eng.stats()["lora"] == {"adapters": 3, "rank": 4}
    finally:
        eng.close()
    assert got == want
    assert len({tuple(g) for g in got[:2]}) == 2   # the adapters differ


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_load_adapter_while_streams_are_live_reaches_every_rank(
        weights, kind):
    """A tp=2 engine built without stacks (each rank draws its slice of
    A from the engine's seed, B zero) serves adapter 1's prompt and
    stores it; ``load_adapter(1, ...)`` while two adapter-0 streams
    decode installs the adapter on both ranks (its next stream is JAX's
    after the same load), leaves the live streams JAX's, and drops the
    adapter's stored prefixes: T0 and T1 rows and a T2 epoch bump, or
    the paged index's entries."""
    stored = _prompt(20, 5)
    paged = kind == "paged"
    kw = _args(prefix_cache_slots=2, prefix_store_min=16,
               **(PAGED if paged else {}))
    live = [_prompt(10, 8), _prompt(14, 9)]

    def run(eng):
        before = eng.generate(stored, max_new_tokens=N_NEW,
                              adapter=1).tokens()
        streams = [eng.generate(p, max_new_tokens=40) for p in live]
        next(iter(streams[0]))   # live: its first token is out
        eng.load_adapter(1, _slot(weights[0], 1))
        after = eng.generate(stored, max_new_tokens=N_NEW, adapter=1)
        return before, [s.tokens() for s in streams], after

    jopts = None if paged else JOptions(block=8, host_mb=64,
                                        epoch_refresh_s=0.0)
    jeng = JaxEngine(JCFG, _base(weights[0]), kvcache=jopts, **kw)
    try:
        jbefore, jlive, jafter = run(jeng)
        jafter = jafter.tokens()
    finally:
        jeng.close()
    srv = FakeRedisServer()
    opts = None if paged else KVCacheOptions(
        block=8, host_mb=64, epoch_refresh_s=0.0,
        redis=RedisClient(srv.host, srv.port))
    eng = GenerationEngine(CFG, _base(weights[1]), mesh=MeshPlan(tp=2),
                           kvcache=opts, device="cpu", **kw)
    try:
        before, got_live, after = run(eng)
        tier = after.cache_tier
        after = after.tokens()
        _agree(eng)
        st = eng.stats()["prefix_cache"]
        epochs = {k: v for k, v in srv.store.data.items() if ":ep:" in k}
    finally:
        eng.close()
        srv.close()
    assert got_live == jlive
    assert after == jafter != before
    assert before == jbefore   # adapter 1 as drawn: B zero, the base
    assert tier is None        # the stored prefix went with the swap
    if paged:
        assert st["entries"] >= 1 and st["hits"] == 0
    else:
        assert st["tiers"]["t1"]["entries"] == 0
        assert list(epochs.values()) == [b"1"]


def test_tenant_routing_at_tp2_equals_jax(weights):
    """A tenancy plane on a tp=2 engine: each tenant's registry adapter
    and class default reach its stream on rank 0, and the routed greedy
    tokens are JAX's unsharded engine's with the same plane."""
    cases = [("A", 12, 0), ("B", 9, 0), ("A", 30, 2), (None, 14, 1)]

    def routed(eng, scope):
        out = []
        for i, (tenant, n, adapter) in enumerate(cases):
            with scope(tenant):
                s = eng.generate(_prompt(n, 60 + i), max_new_tokens=N_NEW,
                                 adapter=adapter)
            out.append((s.tenant, s.slo_class, s.tokens()))
            adapters.append(getattr(s, "adapter", None))
        return out

    adapters: list = []

    jeng = JaxEngine(JCFG, weights[0], **_args())
    jeng.install_tenancy(jten.TenantPlane(
        jten.TenantRegistry.from_json(ROUTED_DOC)))
    try:
        want = routed(jeng, jten.tenant_scope)
    finally:
        jeng.close()
    eng = GenerationEngine(CFG, weights[1], mesh=MeshPlan(tp=2),
                           device="cpu", **_args())
    eng.install_tenancy(pten.TenantPlane(
        pten.TenantRegistry.from_json(ROUTED_DOC)))
    try:
        got = routed(eng, pten.tenant_scope)
        _agree(eng)
    finally:
        eng.close()
    assert got == want
    # the port's streams (the second four) carry the adapter they ran
    assert adapters[len(cases):] == [1, 2, 2, 1]
