"""The contiguous engine's prefix tiers through the engine: the non-mesh
cases of tests/test_kvcache_engine.py and tests/test_prefix_cache.py run
on the JAX engine and on the port's (gofr_tpu_torch, ``device="cpu"``)
with the same seeded weights (``from_jax_params``), on `tiny`. Each case
holds the two engines to the same tokens, the same serving tier and
``cache_tokens`` per stream, and the same ``stats()["prefix_cache"]``;
tiny's float32 model and the int8 cache are token-exact (no tolerance).

- T1 spill and rewarm, with the full-prompt clamp (an exact repeat
  restores L - 1 positions), on an int8 and a dense float32 cache;
- hits, partial hits, a hit with a chunked remainder, eviction, short
  prompts and the default (no tiers);
- T2 across replicas, surviving a replica's failed step;
- a recovery clears T0, then T1 rewarms the fresh pool;
- a handed-in Redis client is closed by an engine that builds no tiers;
- a JAX engine writes T2 and a port engine hits it, token for token the
  JAX engine's own T2 hit;
- the eight rows build the same tiers through either package's
  ``new_engine_from_config``, and an unreachable Redis leaves T2 off.

The adapter hot-swap case (tests/test_kvcache_engine.py's
``test_adapter_hot_swap_invalidates_all_three_tiers``) waits for LoRA,
ROADMAP queue 1 item 8. The ``tpu.prefix-restore`` span of JAX's T1 case
waits for the timeline (item 13).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import chaos as jchaos
from gofr_tpu.datasource.redisclient import RedisClient as JClient
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.tpu import GenerationEngine as JaxEngine
from gofr_tpu.tpu import GenerationError as JaxError
from gofr_tpu.tpu.kvcache import KVCacheOptions as JOptions
from gofr_tpu_torch import chaos as pchaos
from gofr_tpu_torch.datasource.redisclient import RedisClient
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.testutil.redisfake import FakeRedisServer
from gofr_tpu_torch.tpu import (GenerationEngine, GenerationError,
                                from_jax_params)
from gofr_tpu_torch.tpu.kvcache import KVCacheOptions, KVLayout, decode_block

JCFG = JAX_CONFIGS["tiny"]
CFG = LLAMA_CONFIGS["tiny"]
KV = {"int8": (jnp.int8, torch.int8), "dense": (None, None)}


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JCFG, jax.random.PRNGKey(1))
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


@pytest.fixture
def redis_server():
    srv = FakeRedisServer()
    yield srv
    srv.close()


def _engine(side, weights, server=None, kv="int8", host_mb=64, **kw):
    """tests/test_kvcache_engine.py's engine: 2 slots, 128 positions,
    buckets 8/16/32, a 2-row T0 storing prompts of 16+ tokens, radix
    blocks of 8, T1 of ``host_mb`` MiB, T2 on ``server``."""
    kw.setdefault("prefix_cache_slots", 2)
    kw.setdefault("prefix_store_min", 16)
    common = dict(slots=2, max_seq=128, prompt_buckets=(8, 16, 32), **kw)
    if side == "jax":
        opts = JOptions(block=8, host_mb=host_mb, epoch_refresh_s=0.0,
                        redis=JClient(server.host, server.port)
                        if server is not None else None)
        return JaxEngine(JCFG, weights[0], kv_dtype=KV[kv][0],
                         kvcache=opts, **common)
    opts = KVCacheOptions(block=8, host_mb=host_mb, epoch_refresh_s=0.0,
                          redis=RedisClient(server.host, server.port)
                          if server is not None else None)
    return GenerationEngine(CFG, weights[1], kv_dtype=KV[kv][1],
                            kvcache=opts, device="cpu", **common)


def _serve(eng, prompt, n):
    """(tokens, serving tier, restored positions) of one request."""
    s = eng.generate(prompt, max_new_tokens=n)
    return s.tokens(), s.cache_tier, s.cache_tokens


def _tiers(eng) -> dict:
    """The engine's tier stats, without what is a clock or a socket."""
    st = eng.stats()["prefix_cache"]
    if "t2" in st["tiers"]:
        st["tiers"]["t2"].pop("available")
    return st


def _fill_t0(eng, rng, n=2):
    """Unrelated prompts long enough to store, evicting what T0 held
    into the host tier."""
    for _ in range(n):
        eng.generate(rng.integers(1, CFG.vocab_size, 20).tolist(),
                     max_new_tokens=2).tokens()


def _inject_device_loss(side, eng):
    """One DeviceLost at the prefill seam: that request fails and the
    loop recovers."""
    chaos, error = (jchaos, JaxError) if side == "jax" else \
        (pchaos, GenerationError)
    sched = chaos.ChaosSchedule(seed=0).on(
        chaos.GENERATOR_PREFILL, error=chaos.DeviceLost, every=1, limit=1)
    with chaos.scope(sched):
        with pytest.raises(error):
            eng.generate([1, 2, 3, 4], max_new_tokens=4).tokens()
    # the failed request's stream ends before the loop's recovery runs:
    # wait for the T0 clear
    end = time.monotonic() + 30
    while eng.stats()["prefix_cache"]["entries"] and time.monotonic() < end:
        time.sleep(0.01)
    assert eng.stats()["prefix_cache"]["entries"] == 0


def _both(fn):
    out = {side: fn(side) for side in ("jax", "port")}
    assert out["port"] == out["jax"]
    return out["port"]


@pytest.mark.parametrize("kv", ["int8", "dense"])
def test_t1_spill_and_rewarm_with_the_clamp(weights, kv):
    """An exact repeat matches its whole length and restores L - 1
    positions (the final chunk samples); T0 evicts the prompt into host
    RAM, the next request restores it from there and promotes it back,
    so the one after is a T0 row copy again."""
    def case(side):
        rng = np.random.default_rng(3)
        prefix = rng.integers(1, CFG.vocab_size, 24).tolist()
        eng = _engine(side, weights, kv=kv)
        try:
            out = [_serve(eng, prefix, 4)]
            mt = eng._kvc.match(np.asarray(prefix, np.int32), 0)
            out += [mt.matched_len, _serve(eng, prefix, 4)]
            _fill_t0(eng, rng)
            out += [_tiers(eng), _serve(eng, prefix, 4),
                    _serve(eng, prefix, 4), _tiers(eng)]
        finally:
            eng.close()
        return out

    out = _both(case)
    miss, matched, repeat, spilled, t1_hit, t0_again, st = out
    assert miss[1] is None and matched == 24
    assert repeat == (miss[0], "t0", 23)
    assert spilled["tiers"]["t1"]["entries"] >= 1
    assert t1_hit == (miss[0], "t1", 23) and t0_again == (miss[0], "t0", 23)
    assert st["tiers"]["t0"]["hits"] == 2 and st["tiers"]["t1"]["hits"] == 1


def test_hits_partial_hits_and_a_chunked_remainder(weights):
    """tests/test_prefix_cache.py's engine cases on a dense cache: a
    stored prompt, a partial hit with another tail, an exact repeat, a
    hit whose remainder runs mid chunks, a short prompt that is not
    stored; and an engine without tiers reports none."""
    def case(side):
        rng = np.random.default_rng(3)
        prefix = rng.integers(1, CFG.vocab_size, 24).tolist()
        cont = prefix[:20] + rng.integers(1, CFG.vocab_size, 12).tolist()
        long = prefix + rng.integers(1, CFG.vocab_size, 70).tolist()
        eng = _engine(side, weights, kv="dense", host_mb=0)
        try:
            out = [_serve(eng, prefix, 4), _serve(eng, cont, 6),
                   _serve(eng, prefix, 4), _serve(eng, long, 5),
                   _serve(eng, [1, 2, 3], 2), _tiers(eng)]
        finally:
            eng.close()
        plain = _engine(side, weights, kv="dense", prefix_cache_slots=0)
        try:
            out.append("prefix_cache" in plain.stats())
        finally:
            plain.close()
        return out

    first, partial, repeat, long, short, st, plain = _both(case)
    assert partial[1:] == ("t0", 20) and repeat == (first[0], "t0", 23)
    assert long[1:] == ("t0", 24) and short[1] is None
    assert st["entries"] == 2 and st["hits"] == 3 and not plain


def test_int8_rows_round_trip_and_eviction_keeps_streams(weights):
    """int8 pool rows (values and scale planes) restore bit for bit: a
    hit streams the miss's tokens; with one T0 row, evictions re-store
    and every stream stays the engine's own."""
    def case(side):
        rng = np.random.default_rng(6)
        prompts = [rng.integers(1, CFG.vocab_size, 20).tolist()
                   for _ in range(3)]
        eng = _engine(side, weights, prefix_cache_slots=1, host_mb=0)
        try:
            out = [[_serve(eng, p, 3) for p in prompts] for _ in range(2)]
            out += [_serve(eng, prompts[2], 3), _tiers(eng)]
        finally:
            eng.close()
        return out

    first, second, hit, st = _both(case)
    assert [t for t, _, _ in first] == [t for t, _, _ in second]
    assert hit == (first[2][0], "t0", 19)
    assert st["entries"] == 1 and st["tiers"]["t0"]["evictions"] == 5


def test_t2_shares_a_prefill_across_replicas_and_survives_a_failure(
        weights, redis_server):
    """Replica A's admission writes through; replica B restores the
    prefix from Redis; after a failed step on B (T0 cleared with the
    pool) B restores it from Redis again."""
    def case(side):
        redis_server.store.data.clear()
        rng = np.random.default_rng(5)
        prefix = rng.integers(1, CFG.vocab_size, 32).tolist()
        a = _engine(side, weights, redis_server, host_mb=0)
        b = _engine(side, weights, redis_server, host_mb=0)
        try:
            out = [_serve(a, prefix, 4), _tiers(a)["tiers"]["t2"],
                   _serve(b, prefix, 4), _tiers(b)]
            _inject_device_loss(side, b)
            out += [b.down, _serve(b, prefix, 4), _tiers(b)]
            out.append(sorted(redis_server.store.data))
        finally:
            a.close()
            b.close()
        return out

    miss, a_t2, b_hit, b_st, down, again, st, keys = _both(case)
    assert a_t2["blocks_put"] == 4 and b_hit == (miss[0], "t2", 31)
    assert b_st["tiers"]["t0"]["misses"] >= 1 and down is None
    assert again == (miss[0], "t2", 31) and st["tiers"]["t2"]["hits"] == 2
    assert len(keys) == 4   # the blocks; the epoch key is read, not written


def test_recovery_clears_t0_then_t1_rewarms(weights):
    def case(side):
        rng = np.random.default_rng(7)
        prefix = rng.integers(1, CFG.vocab_size, 24).tolist()
        eng = _engine(side, weights)
        try:
            out = [_serve(eng, prefix, 4)]
            _fill_t0(eng, rng)
            out.append(_tiers(eng))
            _inject_device_loss(side, eng)
            out += [eng.down, _tiers(eng), _serve(eng, prefix, 4),
                    _tiers(eng)]
        finally:
            eng.close()
        return out

    miss, before, down, after, rewarm, st = _both(case)
    assert down is None and after["entries"] == 0
    assert after["tiers"]["t1"]["entries"] == \
        before["tiers"]["t1"]["entries"] >= 1
    assert rewarm == (miss[0], "t1", 23)
    assert st["tiers"]["t1"]["hits"] == before["tiers"]["t1"]["hits"] + 1


def test_an_engine_without_tiers_closes_a_handed_in_redis_client(weights):
    class Client:
        closed = False

        def close(self):
            self.closed = True

    for make in (lambda opts: JaxEngine(
                     JCFG, weights[0], slots=1, max_seq=32,
                     prompt_buckets=(8,), prefix_cache_slots=0,
                     kvcache=JOptions(redis=opts)),
                 lambda opts: GenerationEngine(
                     CFG, weights[1], slots=1, max_seq=32,
                     prompt_buckets=(8,), prefix_cache_slots=0,
                     kvcache=KVCacheOptions(redis=opts), device="cpu"),
                 lambda opts: GenerationEngine(
                     CFG, weights[1], slots=1, max_seq=64,
                     prompt_buckets=(8, 16), paged_blocks=9,
                     paged_block_size=8, prefix_cache_slots=2,
                     kvcache=KVCacheOptions(redis=opts), device="cpu")):
        cli = Client()
        eng = make(cli)
        try:
            assert cli.closed
        finally:
            eng.close()


def test_a_port_replica_hits_what_a_jax_replica_wrote(weights, redis_server):
    """One Redis, three replicas of one model: a JAX engine prefills a
    prompt and writes its blocks through; a second JAX engine and a port
    engine each restore them from T2. The port's stream is the JAX
    replica's, token for token, from the same tier and positions."""
    rng = np.random.default_rng(9)
    prefix = rng.integers(1, CFG.vocab_size, 40).tolist()
    tail = prefix + rng.integers(1, CFG.vocab_size, 5).tolist()
    writer = _engine("jax", weights, redis_server, host_mb=0)
    try:
        writer.generate(prefix, max_new_tokens=2).tokens()
        blocks = dict(redis_server.store.data)
    finally:
        writer.close()
    hits, stores = {}, {}
    for side in ("jax", "port"):
        redis_server.store.data.clear()
        redis_server.store.data.update(blocks)
        eng = _engine(side, weights, redis_server, host_mb=0)
        try:
            hits[side] = _serve(eng, tail, 6) + (
                _tiers(eng)["tiers"]["t2"]["blocks_got"],)
        finally:
            eng.close()
        stores[side] = dict(redis_server.store.data)
    assert hits["port"] == hits["jax"]
    assert hits["port"][1:] == ("t2", 40, 5)
    # each reader stored the longer prompt and wrote its blocks through:
    # the same keys, and the frames the JAX writer left untouched are
    # its bytes. The last restored block's positions 37-39 recompute in
    # the reader's final chunk, so that frame is each package's own
    # quantization of its own float32 projections: the codes equal and
    # the scales within rtol 1e-5 (ROADMAP: the int8 codec is bit-exact,
    # the two packages' float32 products agree to rounding)
    assert sorted(stores["port"]) == sorted(stores["jax"])
    assert len(stores["port"]) == 5
    layout = KVLayout(CFG.n_layers, CFG.n_kv_heads, CFG.head_dim, True,
                      torch.int8, 128)
    for key, frame in stores["jax"].items():
        if frame == blocks.get(key):
            assert stores["port"][key] == frame
            continue
        want = decode_block(frame, layout)
        got = decode_block(stores["port"][key], layout)
        for a, b in zip(want, got):
            if a.dtype == torch.int8:
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(b, a, rtol=1e-5, atol=0)


def test_the_rows_build_the_same_tiers_on_both_packages(redis_server):
    """The eight rows through each package's ``new_engine_from_config``
    (the App's way in): a contiguous engine with T0 of TPU_PREFIX_CACHE
    rows and TPU_KVCACHE_BLOCK blocks, T1 of TPU_KVCACHE_HOST_MB, T2 on
    REDIS_HOST/REDIS_PORT with TPU_KVCACHE_REDIS_TTL_S; the same tier
    stats on both. An unreachable Redis leaves the shared tier off on
    both, and the engine serves."""
    import socket

    from gofr_tpu.config import MapConfig as JMapConfig
    from gofr_tpu.tpu import hbm as jhbm
    from gofr_tpu.tpu import new_engine_from_config as jbuild
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.tpu import hbm as phbm
    from gofr_tpu_torch.tpu import new_engine_from_config as pbuild

    with socket.socket() as s:   # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
    rows = {"TPU_MODEL": "tiny", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "128",
            "TPU_SEQ_BUCKETS": "8,16,32", "TPU_PREFIX_CACHE": "2",
            "TPU_KVCACHE_BLOCK": "8", "TPU_KVCACHE_HOST_MB": "4",
            "TPU_KVCACHE_REDIS": "true", "TPU_KVCACHE_REDIS_TTL_S": "60",
            "TPU_KVCACHE_REDIS_TIMEOUT_S": "1", "TPU_HBM_BUDGET_MB": "64",
            "REDIS_HOST": redis_server.host}
    outs = {}
    try:
        for side, build, config in (("jax", jbuild, JMapConfig),
                                    ("port", pbuild, MapConfig)):
            got = []
            for port in (redis_server.port, dead_port):
                kw = {} if side == "jax" else {"device": "cpu"}
                eng = build(config(dict(rows, REDIS_PORT=str(port))), **kw)
                try:
                    gen = eng.generator
                    st = gen.kvcache_stats()
                    st["tiers"].get("t2", {}).pop("available", None)
                    got.append((st, len(gen.generate(
                        list(range(1, 30)), max_new_tokens=3).tokens())))
                finally:
                    eng.close()
            outs[side] = got
    finally:
        # the budget row is process-wide: leave no budget behind
        jhbm.set_budget(None)
        phbm.set_budget(None)
    assert outs["port"] == outs["jax"]
    (up, n_up), (down, n_down) = outs["port"]
    assert up["kind"] == "hierarchical" and up["slots"] == 2
    assert up["block"] == 8 and up["tiers"]["t1"]["max_bytes"] == 4 << 20
    assert up["tiers"]["t2"]["ttl_s"] == 60.0
    assert "t2" not in down["tiers"] and n_up == n_down == 3
