"""The port's prefix tiers on the host (gofr_tpu_torch.tpu.kvcache) against
the JAX package's (gofr_tpu.tpu.kvcache), on the same seeded numpy
inputs, on the CPU.

- The T2 block codec: ``encode_block`` writes the JAX package's bytes
  for int8, float32 and bfloat16 sources (so a port replica and a JAX
  replica read each other's Redis blocks), and ``decode_block`` returns
  JAX's values (bfloat16 compared by its uint16 bit pattern: both round
  to nearest even). Exact, no tolerance.
- ``RadixIndex``, ``HBMTier``, ``HostTier``, ``RedisTier`` (over the
  port's ``FakeRedisServer``) and ``CacheManager`` under one scripted
  sequence: tiers, matched lengths, rows, victims and ``stats()`` equal,
  and the Redis stores hold the same keys and bytes.
- ``model_fingerprint`` is equal for the same weights, dense and int8.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.tpu import kvcache as jkv
from gofr_tpu.tpu.checkpoint import maybe_quantize as jquantize
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.testutil.redisfake import FakeRedisServer
from gofr_tpu_torch.datasource.redisclient import RedisClient
from gofr_tpu_torch.tpu import from_jax_params, maybe_quantize
from gofr_tpu_torch.tpu import kvcache as pkv

L, KV, HD = 2, 2, 8


def _to_torch(a):
    if a is None:
        return None
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy, bfloat16 by its 16-bit words."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jbits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _hostkv(rng, plen: int, kind: str):
    """(JAX HostKV, port HostKV) of the same seeded values."""
    if kind == "int8":
        k = rng.integers(-127, 128, (L, plen, KV, HD)).astype(np.int8)
        v = rng.integers(-127, 128, (L, plen, KV, HD)).astype(np.int8)
        ks = rng.random((L, plen, KV), np.float32) + 0.01
        vs = rng.random((L, plen, KV), np.float32) + 0.01
    else:
        dt = np.float32 if kind == "float32" else ml_dtypes.bfloat16
        k = (rng.standard_normal((L, plen, KV, HD)) * 3).astype(dt)
        v = (rng.standard_normal((L, plen, KV, HD)) * 3).astype(dt)
        ks = vs = None
    j = jkv.HostKV(k, v, ks, vs)
    return j, pkv.HostKV(*(_to_torch(a) for a in j))


def _layouts(kind: str):
    jdt = {"int8": np.int8, "float32": np.float32,
           "bfloat16": ml_dtypes.bfloat16}[kind]
    tdt = {"int8": torch.int8, "float32": torch.float32,
           "bfloat16": torch.bfloat16}[kind]
    quant = kind == "int8"
    return (jkv.KVLayout(L, KV, HD, quant, np.dtype(jdt), 64),
            pkv.KVLayout(L, KV, HD, quant, tdt, 64))


@pytest.mark.parametrize("kind", ["int8", "float32", "bfloat16"])
def test_a_block_frame_is_the_jax_package_s_byte_for_byte(kind):
    rng = np.random.default_rng(5)
    jhk, phk = _hostkv(rng, 16, kind)
    frame = jkv.encode_block(jhk)
    assert pkv.encode_block(phk) == frame
    # a frame decodes to JAX's values on either package, into the
    # layout's dtype: lossless from an int8 cache, rounded to nearest
    # even into a bfloat16 one
    for src in ("int8", "float32", "bfloat16"):
        jl, pl = _layouts(src)
        want = jkv.decode_block(frame, jl)
        got = pkv.decode_block(frame, pl)
        assert str(got.k.dtype) == f"torch.{src}"
        for a, b in zip(want, got):
            if a is None:
                assert b is None
                continue
            np.testing.assert_array_equal(_jbits(a), _bits(b))
    assert pkv.HostKV(*got).nbytes == jkv.HostKV(*want).nbytes


def test_malformed_frames_are_misses_on_both_packages():
    rng = np.random.default_rng(6)
    jhk, _ = _hostkv(rng, 8, "int8")
    frame = jkv.encode_block(jhk)
    jl, pl = _layouts("int8")
    wrong = (jl._replace(kv_heads=4), pl._replace(kv_heads=4))
    for data, layouts in ((frame[:-1] + bytes([frame[-1] ^ 1]), (jl, pl)),
                          (frame[:20], (jl, pl)), (None, (jl, pl)),
                          (frame, wrong), (b"GKV2" + frame[4:], (jl, pl))):
        assert jkv.decode_block(data, layouts[0]) is None
        assert pkv.decode_block(data, layouts[1]) is None


def test_concat_and_slice_match_jax():
    rng = np.random.default_rng(7)
    pairs = [_hostkv(rng, 4, "int8") for _ in range(3)]
    jcat = jkv.quant.concat_blocks([j for j, _ in pairs]).slice_tokens(2, 9)
    pcat = pkv.quant.concat_blocks([p for _, p in pairs]).slice_tokens(2, 9)
    assert pcat.plen == jcat.plen == 7 and pcat.nbytes == jcat.nbytes
    for a, b in zip(jcat, pcat):
        np.testing.assert_array_equal(a, b.numpy())


def _script(kv, sides, server) -> list:
    """One scripted sequence over a package's tiers; returns everything
    observable. ``sides[i]`` is (HostKV of this package, key) for the
    i-th seeded snapshot. Entry ids differ between packages and are
    not recorded."""
    rng = np.random.default_rng(11)
    out = []

    def note(*what):
        out.append(what)

    # RadixIndex alone: insert, match at block and token granularity,
    # remove with pruning
    idx = kv.RadixIndex(4)
    keys = [rng.integers(1, 50, n).astype(np.int32) for n in (10, 13, 7)]
    keys[1][:8] = keys[0][:8]
    ents = [kv.Entry(k, 0, payload=i) for i, k in enumerate(keys)]
    for e in ents:
        idx.insert(e)
    for probe in (keys[0], keys[1][:11], np.concatenate([keys[0][:5], [99]]),
                  keys[2][:3], np.asarray([77], np.int32)):
        e, m = idx.match(probe)
        note("radix", None if e is None else e.payload, m)
    idx.remove(ents[0])
    note("radix-removed", idx.match(keys[0])[1], len(idx),
         idx.entries_for(0), idx.entries_for(1))
    # the manager: T0 of 2 rows, T1 of ~2 entries, T2 over Redis
    layout = kv.KVLayout(L, KV, HD, True, sides[0][0].k.dtype, 64)
    client = (RedisClient(server.host, server.port) if kv is pkv else
              __import__("gofr_tpu.datasource.redisclient", fromlist=["x"])
              .RedisClient(server.host, server.port))
    mgr = kv.CacheManager(2, layout, block=4, host_bytes=96 * 30,
                          redis=client, epoch_refresh_s=0.0,
                          fingerprint="f00d")
    hk = [h for h, _ in sides]
    k = [key for _, key in sides]
    for i in range(3):
        row, victim = mgr.store(k[i])
        note("store", i, row, None if victim is None else list(victim.key))
        if victim is not None:
            j = next(t for t in range(3) if np.array_equal(k[t], victim.key))
            note("offload", mgr.offload(victim, hk[j]))
        note("shared", mgr.store_shared(k[i], 0, hk[i]))
    for probe in (k[0], np.concatenate([k[1], [5, 6]]), k[2][:9],
                  np.concatenate([k[0][:8], [1, 2, 3, 4, 5]]),
                  np.asarray([1, 2, 3], np.int32)):
        mt = mgr.match(probe)
        if mt is None:
            mgr.reject(prompt=probe)
            note("miss")
            continue
        note("match", mt.tier, mt.matched_len, mt.row, list(mt.key),
             mt.consulted)
        if mt.hostkv is not None:
            note("hostkv", [np.asarray(_bits(t) if isinstance(t, torch.Tensor)
                                       else t).tolist()
                            for t in mt.hostkv])
        if mt.matched_len >= 8:
            mgr.accept(mt)
        else:
            mgr.reject(mt)
    note("covered", mgr.covered(k[2]), mgr.covered(k[0]),
         kv.clamp_restore_len(12, 12), kv.clamp_restore_len(5, 12))
    note("pending", mgr.redis.pending_put_len(k[2]),
         mgr.redis.pending_put_len(np.arange(1, 30, dtype=np.int32)))
    note("shrink", mgr.shrink(1), mgr.slots)
    note("clear", mgr.clear_device(), len(mgr))
    # T0 gone and the prompt never spilled: the shared tier serves it
    mt = mgr.match(np.concatenate([k[2], [7]]))
    note("match", mt.tier, mt.matched_len, mt.row, list(mt.key),
         mt.consulted)
    mgr.accept(mt)
    st = mgr.stats()
    st["tiers"]["t2"]["available"] = bool(st["tiers"]["t2"]["available"])
    note("stats", st)
    client.close()
    return out


def test_the_tiers_and_the_manager_equal_jax_under_one_script():
    rng = np.random.default_rng(9)
    sides = {"jax": [], "port": []}
    for n in (12, 16, 20):
        key = rng.integers(1, 200, n).astype(np.int32)
        j, p = _hostkv(rng, n, "int8")
        sides["jax"].append((j, key))
        sides["port"].append((p, key))
    sides["jax"][1][1][:8] = sides["jax"][0][1][:8]   # keys share a block
    servers = {name: FakeRedisServer() for name in sides}
    try:
        got = {name: _script(jkv if name == "jax" else pkv, sides[name],
                             servers[name]) for name in sides}
        stores = {name: dict(srv.store.data) for name, srv in servers.items()}
    finally:
        for srv in servers.values():
            srv.close()
    assert got["port"] == got["jax"]
    kinds = [r[0] for r in got["port"]]
    assert {"offload", "match", "miss", "hostkv"} <= set(kinds)
    tiers = {r[1] for r in got["port"] if r[0] == "match"}
    assert tiers == {"t0", "t1", "t2"}
    # the shared blocks: the same keys holding the same frames
    assert stores["port"] == stores["jax"] and len(stores["port"]) > 3


def test_a_port_tier_reads_blocks_a_jax_tier_wrote():
    rng = np.random.default_rng(13)
    key = rng.integers(1, 200, 24).astype(np.int32)
    jhk, _ = _hostkv(rng, 24, "int8")
    jl, pl = _layouts("int8")
    srv = FakeRedisServer()
    try:
        from gofr_tpu.datasource.redisclient import RedisClient as JClient

        jc, pc = JClient(srv.host, srv.port), RedisClient(srv.host, srv.port)
        jt = jkv.RedisTier(jc, "beef", jl, block=8, epoch_refresh_s=0.0)
        pt = pkv.RedisTier(pc, "beef", pl, block=8, epoch_refresh_s=0.0)
        assert jt.put(key, 0, jhk) == 3
        m, got = pt.match(np.concatenate([key, [1, 2, 3]]))
        assert m == 24
        for a, b in zip(jhk, got):
            np.testing.assert_array_equal(a, b.numpy())
        # a frame altered in the store is a miss past it, counted
        bad = next(k for k in srv.store.data if k.endswith(
            next(iter(pkv.chain_hashes(key, 8))).hex()))
        srv.store.data[bad] = srv.store.data[bad][:-1] + b"\x00"
        assert pt.match(key) == (0, None)
        assert pt.stats()["checksum_rejects"] == 1
        jc.close()
        pc.close()
    finally:
        srv.close()


@pytest.mark.parametrize("quant", [False, True])
def test_the_model_fingerprint_equals_jax_s(quant):
    cfg = JAX_CONFIGS["tiny"]
    jparams = jllama.init(cfg, jax.random.PRNGKey(3))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    if quant:
        jparams = jquantize(jparams, True)
        tparams = maybe_quantize(tparams, True)
    want = jkv.model_fingerprint(cfg, jparams, extra="int8")
    got = pkv.model_fingerprint(LLAMA_CONFIGS["tiny"], tparams,
                                extra=pkv.dtype_name(torch.int8))
    assert got == want
    # other weights, another fingerprint; no weights, the config's
    other = from_jax_params(jax.tree.map(
        np.asarray, jllama.init(cfg, jax.random.PRNGKey(4))), device="cpu")
    assert pkv.model_fingerprint(LLAMA_CONFIGS["tiny"], other,
                                 extra="int8") != got
    assert pkv.model_fingerprint(LLAMA_CONFIGS["tiny"], None, "bfloat16") \
        == jkv.model_fingerprint(cfg, None, "bfloat16")
