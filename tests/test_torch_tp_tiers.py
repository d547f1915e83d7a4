"""The prefix tiers and the paged prefix index under tensor parallelism
(gofr_tpu_torch, ``TPU_SHARDING=tp=N``) against the JAX package on
`tiny`, on the CPU.

A tp=N port engine is rank 0 of N processes: each rank holds its
KV-head shard of the T0 pool; rank 0 keeps the CacheManager, T1 and T2,
gathers a row's shards for a spill or a write-through (a
``ShardedHostKV``) and sends each rank its heads of a promoted row. The
JAX references, from the same weights (``from_jax_params``): its
unsharded engine for the tokens, and its tp=2 mesh engine on two of the
eight virtual CPU devices (tests/test_multichip_serving.py's way) for
the tiers, the T2 frames and the fingerprint.

- ``ShardedHostKV`` and the sharded T2 frames are JAX's byte for byte,
  each package reads the other's, and a one-shard reader misses them;
- a tp=2 engine through a miss, a T0 hit, an eviction to T1 and a T1
  hit, then a second engine's T2 hit: JAX's unsharded tokens, JAX's mesh
  engine's tiers;
- JAX's tp=2 mesh engine and the port's tp=2 engine read each other's
  T2 blocks under one fingerprint, from the whole tree and from a
  weight source each rank slices;
- tp=4 over tiny's 2 KV heads (replicated) frames dense rows, in the
  unsharded namespace;
- a paged tp=2 prefix index: JAX's hits, ``blocks_held`` and tokens;
- an arbiter reclaim shrinks every rank's pool and the next hit
  promotes from T1.

Every test checks that the workers' carries, cursors and pool rows are
rank 0's (``tp_probe``) and runs under its own time limit.
"""

import contextlib
import signal
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gofr_tpu.datasource.redisclient import RedisClient as JClient
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.parallel import make_mesh
from gofr_tpu.parallel import shard_params as jshard_params
from gofr_tpu.tpu import kvcache as jkv
from gofr_tpu.tpu.checkpoint import save_npz
from gofr_tpu.tpu.generator import GenerationEngine as JaxEngine
from gofr_tpu_torch.datasource.redisclient import RedisClient
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.parallel import (MeshPlan, kv_frame_shards,
                                     kv_head_owners, kv_head_range)
from gofr_tpu_torch.testutil.redisfake import FakeRedisServer
from gofr_tpu_torch.tpu import GenerationEngine, from_jax_params, hbm
from gofr_tpu_torch.tpu import kvcache as pkv
from gofr_tpu_torch.tpu.checkpoint import WeightSource

TINY = LLAMA_CONFIGS["tiny"]
JTINY = JAX_CONFIGS["tiny"]
# a test's own limit: well past its time on a loaded host
_LIMIT_S = 120
N_NEW = 6


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


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JTINY, jax.random.PRNGKey(1))
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


@pytest.fixture
def redis_server():
    srv = FakeRedisServer()
    yield srv
    srv.close()


def _jmesh():
    return make_mesh(tp=2, devices=jax.devices()[:2])


def _jax(weights, server=None, mesh=None, host_mb=64, cfg=JTINY, **kw):
    """The JAX engine of the tiers' cases: 2 slots, 128 positions,
    buckets 8/16/32, int8 KV, a 1-row T0 storing prompts of 16+ tokens,
    radix blocks of 8, T1 of ``host_mb`` MiB, T2 on ``server``."""
    kw.setdefault("prefix_cache_slots", 1)
    opts = jkv.KVCacheOptions(
        block=8, host_mb=host_mb, epoch_refresh_s=0.0,
        redis=JClient(server.host, server.port) if server else None)
    params = weights[0] if mesh is None else jshard_params(weights[0], mesh)
    return JaxEngine(cfg, params, mesh=mesh, kv_dtype=jnp.int8,
                     kvcache=opts, slots=2, max_seq=128,
                     prompt_buckets=(8, 16, 32), prefix_store_min=16, **kw)


def _port(params, server=None, tp=2, host_mb=64, cfg=TINY, **kw):
    """The port's engine of the same rows, as ``tp`` ranks."""
    kw.setdefault("prefix_cache_slots", 1)
    opts = pkv.KVCacheOptions(
        block=8, host_mb=host_mb, epoch_refresh_s=0.0,
        redis=RedisClient(server.host, server.port) if server else None)
    return GenerationEngine(cfg, params, kv_dtype=torch.int8,
                            mesh=MeshPlan(tp=tp) if tp > 1 else None,
                            kvcache=opts, slots=2, max_seq=128,
                            prompt_buckets=(8, 16, 32), prefix_store_min=16,
                            device="cpu", **kw)


@contextlib.contextmanager
def _closing(eng):
    try:
        yield eng
    finally:
        eng.close()


def _serve(eng, prompt, n=N_NEW):
    s = eng.generate(prompt, max_new_tokens=n)
    return s.tokens(), s.cache_tier, s.cache_tokens


def _agree(eng) -> np.ndarray:
    """Every rank's carry, cursors and pool rows equal rank 0's; the
    probe."""
    probe = eng.tp_probe()
    B = eng.n_slots
    assert (probe[:, :5 * B + 1] == probe[0, :5 * B + 1]).all(), probe
    return probe


def _prompts(seed: int = 3):
    rng = np.random.default_rng(seed)
    a = rng.integers(1, TINY.vocab_size, 40).tolist()
    b = rng.integers(1, TINY.vocab_size, 40).tolist()

    def tail(n=5):
        return rng.integers(1, TINY.vocab_size, n).tolist()

    # miss (stores A), T0 hit, miss (stores B: A spills to T1), T1 hit
    return a, [a + tail(), a + tail(), b + tail(), a + tail()], a + tail()


# -- the host snapshot and the sharded frames ---------------------------------

L, KV, HD = 2, 4, 8


def _to_torch(a):
    if a is None:
        return None
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _sharded(rng, plen: int, kind: str, shards: int):
    """(JAX ShardedHostKV, port ShardedHostKV) of the same seeded parts,
    each part KV/shards heads."""
    n = KV // shards
    parts = []
    for _ in range(shards):
        if kind == "int8":
            k = rng.integers(-127, 128, (L, plen, n, HD)).astype(np.int8)
            v = rng.integers(-127, 128, (L, plen, n, HD)).astype(np.int8)
            ks = rng.random((L, plen, n), np.float32) + 0.01
            vs = rng.random((L, plen, n), np.float32) + 0.01
        else:
            dt = np.float32 if kind == "float32" else ml_dtypes.bfloat16
            k = (rng.standard_normal((L, plen, n, HD)) * 3).astype(dt)
            v = (rng.standard_normal((L, plen, n, HD)) * 3).astype(dt)
            ks = vs = None
        parts.append(jkv.HostKV(k, v, ks, vs))
    j = jkv.quant.ShardedHostKV(tuple(parts))
    p = pkv.ShardedHostKV(tuple(pkv.HostKV(*(_to_torch(a) for a in part))
                                for part in parts))
    return j, p


def _layouts(kind: str):
    jdt = {"int8": np.int8, "float32": np.float32,
           "bfloat16": ml_dtypes.bfloat16}[kind]
    tdt = {"int8": torch.int8, "float32": torch.float32,
           "bfloat16": torch.bfloat16}[kind]
    quant = kind == "int8"
    return (jkv.KVLayout(L, KV, HD, quant, np.dtype(jdt), 64),
            pkv.KVLayout(L, KV, HD, quant, tdt, 64))


def _bits(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return t.view(np.uint16) if t.dtype == ml_dtypes.bfloat16 else t


@pytest.mark.parametrize("kind", ["int8", "float32", "bfloat16"])
def test_sharded_snapshots_and_frames_are_jax_s_and_cross_read(kind):
    """A two-shard snapshot: ``assemble`` and ``slice_tokens`` equal
    JAX's; a two-shard tier's frames are JAX's byte for byte under the
    same ``:s{i}`` keys; each package's tier reads what the other's
    wrote; a one-shard reader of the same fingerprint misses them."""
    rng = np.random.default_rng(21)
    j, p = _sharded(rng, 24, kind, 2)
    for a, b in zip(j.assemble(), p.assemble()):
        if a is not None:
            np.testing.assert_array_equal(_bits(a), _bits(b))
    for ja, pa in zip(j.slice_tokens(8, 16).parts,
                      p.slice_tokens(8, 16).parts):
        np.testing.assert_array_equal(_bits(ja.k), _bits(pa.k))
    assert (p.shards, p.plen, p.nbytes) == (j.shards, j.plen, j.nbytes)
    assert pkv.dense_hostkv(p).k.shape == (L, 24, KV, HD)
    key = rng.integers(1, 200, 24).astype(np.int32)
    jl, pl = _layouts(kind)
    stores = {}
    for side in ("jax", "port"):
        srv = FakeRedisServer()
        try:
            if side == "jax":
                tier = jkv.RedisTier(JClient(srv.host, srv.port), "beef", jl,
                                     block=8, epoch_refresh_s=0.0, shards=2)
                assert tier.put(key, 0, j) == 3
            else:
                tier = pkv.RedisTier(RedisClient(srv.host, srv.port), "beef",
                                     pl, block=8, epoch_refresh_s=0.0,
                                     shards=2)
                assert tier.put(key, 0, p) == 3
                assert tier.stats()["shards"] == 2
            stores[side] = dict(srv.store.data)
            tier.client.close()
        finally:
            srv.close()
    assert stores["port"] == stores["jax"]
    assert sum(k.endswith(":s1") for k in stores["port"]) == 3
    srv = FakeRedisServer()
    try:
        jc, pc = JClient(srv.host, srv.port), RedisClient(srv.host, srv.port)
        jt = jkv.RedisTier(jc, "beef", jl, block=8, epoch_refresh_s=0.0,
                           shards=2)
        pt = pkv.RedisTier(pc, "beef", pl, block=8, epoch_refresh_s=0.0,
                           shards=2)
        one = pkv.RedisTier(pc, "beef", pl, block=8, epoch_refresh_s=0.0)
        # JAX writes, the port reads; then the reverse
        assert jt.put(key, 0, j) == 3
        m, got = pt.match(np.concatenate([key, [1, 2]]))
        assert m == 24 and isinstance(got, pkv.ShardedHostKV)
        for jp, pp in zip(j.parts, got.parts):
            for a, b in zip(jp, pp):
                if a is not None and kind == "int8":
                    np.testing.assert_array_equal(a, b.numpy())
        assert one.match(key) == (0, None)
        srv.store.data.clear()
        assert pt.put(key, 7, p) == 3
        m, got = jt.match(key, 7)
        assert m == 24 and got.shards == 2
        # half a block (one shard's frame gone) is no block
        drop = next(k for k in srv.store.data if k.endswith(":s1"))
        del srv.store.data[drop]
        assert pt.match(key, 7)[0] < 24
        jc.close()
        pc.close()
    finally:
        srv.close()


def test_the_frame_shards_and_head_ranges_follow_jax():
    """The frame count is JAX's ``kv_head_shards`` (tp when it divides
    the KV heads, else 1), while each rank's heads and the distinct
    owners follow the port's slicing."""
    from gofr_tpu.parallel import kv_head_shards as jshards

    for tp in (1, 2, 4, 8):
        for kvh in (1, 2, 4, 8):
            mesh = make_mesh(tp=tp, devices=jax.devices()[:tp])
            assert kv_frame_shards(tp, kvh) == jshards(mesh, kvh)
    cfg8 = LLAMA_CONFIGS["llama3-8b"]
    assert [kv_head_range(cfg8, 8, r) for r in (0, 7)] == [(0, 1), (7, 8)]
    assert kv_head_owners(cfg8, 2) == [0, 1]
    # tiny at tp=4: heads replicated on two ranks each
    assert [kv_head_range(TINY, 4, r) for r in range(4)] == \
        [(0, 1), (0, 1), (1, 2), (1, 2)]
    assert kv_head_owners(TINY, 4) == [0, 2]


# -- the contiguous tiers through the engine ----------------------------------

def test_tp2_tiers_miss_t0_t1_then_a_second_engine_s_t2_equal_jax(
        weights, redis_server):
    """A tp=2 engine through a miss, a T0 hit, an eviction to T1 and a
    T1 hit, then a second tp=2 engine on the same Redis hitting T2: the
    greedy tokens are JAX's unsharded engine's through the same script,
    the tiers and restored positions JAX's tp=2 mesh engine's, every
    rank's carry and pool agree, and the T2 stores hold the same keys."""
    _, script, t2_prompt = _prompts()
    runs, stores = {}, {}
    for side in ("jax", "mesh", "port"):
        redis_server.store.data.clear()
        if side == "port":
            first, second = (_port(weights[1], redis_server)
                             for _ in range(2))
        else:
            mesh = _jmesh() if side == "mesh" else None
            first, second = (_jax(weights, redis_server, mesh=mesh)
                             for _ in range(2))
        with _closing(first), _closing(second):
            runs[side] = [_serve(first, p) for p in script]
            runs[side].append(_serve(second, t2_prompt))
            if side == "port":
                _agree(first)
                _agree(second)
                st = first.stats()["prefix_cache"]
                assert st["tiers"]["t2"]["shards"] == 2
        stores[side] = sorted(redis_server.store.data)
    assert [r[0] for r in runs["port"]] == [r[0] for r in runs["jax"]]
    assert [r[1:] for r in runs["port"]] == [r[1:] for r in runs["mesh"]]
    assert [r[1] for r in runs["port"]] == [None, "t0", None, "t1", "t2"]
    assert stores["port"] == stores["mesh"]
    assert any(k.endswith(":s1") for k in stores["port"])


def test_one_layer_tp2_t1_and_t2_hits_equal_jax_and_tp1(redis_server,
                                                         monkeypatch):
    """A one-layer ``tiny`` (registered as ``tiny-1l`` in both packages'
    configs): a tp=2 engine's miss, T0 hit, T1 hit and a second tp=2
    engine's T2 hit stream the greedy tokens of JAX's unsharded engine
    and of the port's tp=1 engine through the same script."""
    jcfg = JTINY.with_(name="tiny-1l", n_layers=1)
    cfg = TINY.with_(name="tiny-1l", n_layers=1)
    monkeypatch.setitem(JAX_CONFIGS, "tiny-1l", jcfg)
    monkeypatch.setitem(LLAMA_CONFIGS, "tiny-1l", cfg)
    jparams = jllama.init(jcfg, jax.random.PRNGKey(1))
    pparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    _, script, t2_prompt = _prompts()
    runs = {}
    for side, tp in (("jax", 1), ("port", 1), ("port", 2)):
        redis_server.store.data.clear()
        if side == "jax":
            first, second = (_jax((jparams, None), redis_server, cfg=jcfg)
                             for _ in range(2))
        else:
            first, second = (_port(pparams, redis_server, tp=tp, cfg=cfg)
                             for _ in range(2))
        with _closing(first), _closing(second):
            got = [_serve(first, p) for p in script]
            got.append(_serve(second, t2_prompt))
            if tp > 1:
                _agree(first)
                _agree(second)
        runs[side, tp] = got
    assert [r[1] for r in runs["port", 2]] == [None, "t0", None, "t1", "t2"]
    assert [r[1:] for r in runs["port", 2]] == [r[1:] for r in runs["jax", 1]]
    assert [r[0] for r in runs["port", 2]] == [r[0] for r in runs["jax", 1]]
    assert runs["port", 2] == runs["port", 1]


def test_jax_s_mesh_engine_and_the_port_s_tp2_engine_share_t2(
        weights, redis_server, tmp_path):
    """JAX's tp=2 mesh engine writes T2 and the port's tp=2 engine
    restores it, and the reverse, under equal fingerprints: the port's
    from rank 0's shard of a whole tree, and of a JAX .npz each rank
    slices as it reads."""
    a, script, _ = _prompts(5)
    store_p, hit_p = script[0], script[1]
    mesh = _jmesh()
    for writer_side in ("jax", "port"):
        redis_server.store.data.clear()
        w = (_jax(weights, redis_server, mesh=mesh, host_mb=0)
             if writer_side == "jax" else _port(weights[1], redis_server,
                                                host_mb=0))
        with _closing(w):
            _serve(w, store_p)
            w_fp = w._kvc.redis.fingerprint
        r = (_port(weights[1], redis_server, host_mb=0)
             if writer_side == "jax" else _jax(weights, redis_server,
                                               mesh=mesh, host_mb=0))
        with _closing(r):
            tokens, tier, m = _serve(r, hit_p)
            r_fp = r._kvc.redis.fingerprint
        assert w_fp == r_fp
        assert (tier, m) == ("t2", 40), writer_side
    # the fingerprint from a weight source each rank slices: a JAX .npz
    path = str(tmp_path / "tiny.npz")
    save_npz(path, jax.tree.map(np.asarray, weights[0]))
    with _closing(_port(WeightSource("npz", path=path), redis_server,
                        host_mb=0)) as eng:
        assert eng._kvc.redis.fingerprint == r_fp
        _agree(eng)


def test_tp4_with_replicated_kv_heads_frames_dense_rows(weights,
                                                        redis_server):
    """tp=4 over tiny's 2 KV heads: the row's two distinct heads are
    gathered from one rank each and framed dense in the unsharded
    namespace, so a tp=1 port engine and JAX's unsharded engine read
    them; the tp=4 tokens and tiers equal tp=1's."""
    _, script, t2_prompt = _prompts(7)
    eng = _port(weights[1], redis_server, tp=4)
    with _closing(eng):
        got = [_serve(eng, p) for p in script]
        probe = _agree(eng)
        assert eng.stats()["mesh"]["kv_shards"] == 2
        assert eng._kvc.redis.shards == 1
        fp = eng._kvc.redis.fingerprint
    assert not any(":s" in k.rsplit(":", 1)[-1]
                   for k in redis_server.store.data)
    blocks = dict(redis_server.store.data)
    assert probe[0, 5 * eng.n_slots] == 1   # every rank's pool: one row
    redis_server.store.data.clear()
    with _closing(_port(weights[1], redis_server, tp=1)) as ref:
        assert ref._kvc.redis.fingerprint == fp
        want = [_serve(ref, p) for p in script]
    assert got == want
    for side in ("port", "jax"):
        redis_server.store.data.clear()
        redis_server.store.data.update(blocks)
        eng = (_port(weights[1], redis_server, tp=1, host_mb=0)
               if side == "port" else _jax(weights, redis_server, host_mb=0))
        with _closing(eng):
            assert _serve(eng, t2_prompt)[1:] == ("t2", 40), side


def test_an_arbiter_reclaim_shrinks_every_rank_s_pool_then_t1_rewarms(
        weights):
    """A tp=2 engine with a 2-row T0 over T1: ``hbm.reclaim`` spills
    both rows, shrinks the pool to one row on every rank (the probe's
    pool rows, and each rank's lease row re-settled in rank 0's
    arbiter), and the next request of a spilled prefix promotes from
    T1 with the tokens of its first serving."""
    _, script, _ = _prompts(11)
    hbm.reset()
    eng = _port(weights[1], prefix_cache_slots=2)
    try:
        first = _serve(eng, script[0])
        _serve(eng, script[2])
        before = _agree(eng)[:, 5 * eng.n_slots]
        rows = {r["rank"]: r["bytes"] for r in hbm.arbiter_stats()["leases"]
                if r["subsystem"] == "kvcache-t0"}
        freed = hbm.reclaim(1)
        after = _agree(eng)[:, 5 * eng.n_slots]
        shrunk = {r["rank"]: r["bytes"]
                  for r in hbm.arbiter_stats()["leases"]
                  if r["subsystem"] == "kvcache-t0"}
        again = _serve(eng, script[0])
        st = eng.stats()["prefix_cache"]
    finally:
        eng.close()
        hbm.reset()
    assert list(before) == [2, 2] and list(after) == [1, 1]
    assert sorted(rows) == [0, 1] and len(set(rows.values())) == 1
    assert shrunk == {r: b // 2 for r, b in rows.items()}
    assert freed == sum(rows.values()) // 2
    assert st["slots"] == 1
    assert again[0] == first[0] and again[1] == "t1"


# -- the paged prefix index ----------------------------------------------------

def test_paged_tp2_prefix_index_equals_jax(weights):
    """A paged tp=2 engine with the zero-copy prefix index (rank 0's):
    the hits, misses, ``blocks_held`` and tokens of JAX's unsharded paged
    engine through the same script; the shared blocks reach the workers
    through the admission images, and every rank's read-back and
    write-back keep the carries equal."""
    rng = np.random.default_rng(17)
    system = rng.integers(1, TINY.vocab_size, 24).tolist()
    prompts = [system + rng.integers(1, TINY.vocab_size, n).tolist()
               for n in (3, 5, 9)] + [rng.integers(1, 200, 20).tolist()]
    kw = dict(slots=4, max_seq=64, prompt_buckets=(8, 16),
              paged_blocks=25, paged_block_size=8, prefix_cache_slots=4,
              prefix_store_min=16)
    jeng = JaxEngine(JTINY, weights[0], **kw)
    with _closing(jeng):
        want = [_serve(jeng, p)[:2] for p in prompts]
        jst = jeng.stats()["prefix_cache"]
    eng = GenerationEngine(TINY, weights[1], mesh=MeshPlan(tp=2),
                           device="cpu", **kw)
    with _closing(eng):
        got = [_serve(eng, p)[:2] for p in prompts]
        _agree(eng)
        st = eng.stats()["prefix_cache"]
    assert got == want
    assert [t for _, t in got].count("paged") == 2
    assert {k: st[k] for k in ("hits", "misses", "entries", "blocks_held")} \
        == {k: jst[k] for k in ("hits", "misses", "entries", "blocks_held")}


@pytest.mark.parametrize("tp", [2, 4])
def test_uploads_and_pool_copies_land_each_rank_s_heads(weights, tp):
    """A host row uploaded to the pool (each rank gets its KV heads of
    it), copied into a free slot's row on every rank, and read back
    gathered from the ranks that hold distinct heads: the bytes
    uploaded, at tp=2 (one head a rank) and tp=4 (each head on two
    ranks)."""
    g = torch.Generator().manual_seed(tp)
    L, n, kvh, hd = TINY.n_layers, 33, TINY.n_kv_heads, TINY.head_dim
    kv = pkv.HostKV(
        torch.randint(-127, 128, (L, n, kvh, hd), generator=g,
                      dtype=torch.int8),
        torch.randint(-127, 128, (L, n, kvh, hd), generator=g,
                      dtype=torch.int8),
        torch.rand((L, n, kvh), generator=g) + 0.01,
        torch.rand((L, n, kvh), generator=g) + 0.01)
    with _closing(_port(weights[1], tp=tp, host_mb=0)) as eng:
        with eng._device_lock:
            eng._upload_row(kv, 0)
            pooled = eng._kv_row_get(eng._pool, 0, n)
            eng._pool_copy(eng.cache, 1, eng._pool, 0, n)
            copied = pkv.dense_hostkv(eng._kv_row_get(eng.cache, 1, n))
        _agree(eng)
    assert isinstance(pooled, pkv.ShardedHostKV) == (tp == 2)
    for got in (pkv.dense_hostkv(pooled), copied):
        for a, b in zip(kv, got):
            assert torch.equal(a, b)


def test_a_failed_step_reallocates_every_rank_s_pool_and_t1_rewarms(
        weights):
    """tests/test_multichip_serving.py's device-loss case on the port's
    tp=2 engine: a prefix spilled to T1 restores its tokens; a seeded
    ``GENERATOR_STEP`` failure fails the live stream, clears T0 and
    resets every rank (each reallocates its pool); the repeat then
    rewarms from T1 with the same tokens, the ranks agreeing."""
    from gofr_tpu_torch import chaos
    from gofr_tpu_torch.tpu import GenerationError

    rng = np.random.default_rng(23)
    a = rng.integers(1, TINY.vocab_size, 16).tolist()
    b = rng.integers(1, TINY.vocab_size, 16).tolist()
    with _closing(_port(weights[1])) as eng:
        ref = _serve(eng, a + [1, 2])
        _serve(eng, b + [3, 4])                 # A spills to T1
        assert _serve(eng, a + [1, 2])[:2] == (ref[0], "t1")
        # the loop reaps the last block after the stream's end: let it
        # go idle, so the seam fires in the next request's pass
        with eng._device_lock:
            pass
        time.sleep(0.2)
        sched = chaos.ChaosSchedule(seed=7).on(
            chaos.GENERATOR_STEP, error=chaos.DeviceLost, every=1, limit=1)
        with chaos.scope(sched):
            with pytest.raises(GenerationError):
                eng.generate([9, 8, 7, 6], max_new_tokens=4).tokens()
        again = _serve(eng, a + [1, 2])
        probe = _agree(eng)
        st = eng.stats()
    assert again[:2] == (ref[0], "t1")
    assert st["recoveries"] == 1 and st["prefix_cache"]["entries"] == 1
    assert list(probe[:, 5 * eng.n_slots]) == [1, 1]


@pytest.mark.parametrize("quant", [False, True])
def test_a_rank_built_from_a_seed_holds_the_whole_model_s_slice(quant):
    """``rank_params`` from a seeded source (each rank draws the model
    leaf by leaf, slices its part and, with int8, quantizes the part on
    the whole leaf's scales): every rank's shard at tp=2 and tp=4 equals
    the slice of the whole model quantized whole, and rank 0's shard
    fingerprints, under the whole model's config, as the whole tree
    does."""
    from gofr_tpu_torch.parallel import shard_params
    from gofr_tpu_torch.tpu import maybe_quantize
    from gofr_tpu_torch.tpu.checkpoint import rank_params

    whole = maybe_quantize(tllama.init(TINY, 0, device="cpu"), quant)
    want_fp = pkv.model_fingerprint(TINY, whole, "int8:tp2")

    def leaves(tree):
        return [leaf for k in sorted(tree) for leaf in (
            leaves(tree[k]) if isinstance(tree[k], dict)
            else tuple(tree[k]) if isinstance(tree[k], tuple)
            else (tree[k],))]

    for tp in (2, 4):
        for rank in range(tp):
            got = rank_params(TINY, WeightSource("seed", seed=0, quant=quant),
                              rank, tp, "cpu")
            want = shard_params(whole, TINY, rank, tp)
            assert all(torch.equal(a, b)
                       for a, b in zip(leaves(got), leaves(want)))
            if rank == 0:
                assert pkv.model_fingerprint(TINY, got,
                                             "int8:tp2") == want_fp
