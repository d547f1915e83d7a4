"""The port's paged KV serving (gofr_tpu_torch.ops.paged_attention,
models.paged_llama and the paged paths of tpu.generator) against the JAX
package's (gofr_tpu.ops.paged_attention, models.paged_llama, the paged
GenerationEngine) on the same seeded numpy inputs, on the CPU, mirroring
tests/test_paged.py. The JAX attention runs its Pallas kernel in
interpret mode, as that file runs it; on CPU tensors the port's wrapper
runs its plain version (the CUDA kernel is held against that plain
version on the card by chip_smoke.py and tests/test_torch_cuda.py).

Tolerances: attention outputs atol 2e-5 (float32, another order of
summation); logits atol 1e-4 (float32 through two layers, as
tests/test_torch_llama.py); int8 pool codes bit-equal; greedy tokens
identical. Both engines run at dispatch depth 1.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.models import paged_llama as jpaged
from gofr_tpu.ops.paged_attention import \
    paged_decode_attention as jax_paged_attention
from gofr_tpu.ops.quant import quantize_kv as jax_quantize_kv
from gofr_tpu.tpu.generator import GenerationEngine as JaxEngine
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.models import LLAMA_CONFIGS, llama, paged_llama
from gofr_tpu_torch.ops import paged_attention
from gofr_tpu_torch.tpu import (GenerationEngine, GenerationError,
                                from_jax_params, new_engine_from_config)

JCFG = JAX_CONFIGS["tiny"]
CFG = LLAMA_CONFIGS["tiny"]
ATOL = 2e-5
LOGIT_ATOL = 1e-4

B, H, KV, D = 3, 8, 4, 128
T = 128           # block size
MB = 2            # max blocks per slot
N = B * MB + 1    # pool incl. trash block 0


def _mk(seed, quant: bool, lengths):
    """Pool + clamped table (numpy), as tests/test_paged.py's _mk: each
    slot owns MB distinct blocks, clamped at its live range."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, kp, vp = randn(B, 1, H, D), randn(N, T, KV, D), randn(N, T, KV, D)
    kn, vn = randn(B, 1, KV, D), randn(B, 1, KV, D)
    table = np.zeros((B, MB), np.int32)
    for b in range(B):
        live = max(1, -(-int(lengths[b]) // T))
        for j in range(MB):
            table[b, j] = 1 + b * MB + min(j, live - 1)
    ks = vs = None
    if quant:
        (kp, ks), (vp, vs) = (tuple(np.array(a) for a in jax_quantize_kv(
            jnp.asarray(x))) for x in (kp, vp))
    return q, kp, vp, kn, vn, table, ks, vs


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("lengths", [[256, 100, 1], [37, 128, 255],
                                     [0, 5, 256]])
def test_paged_attention_matches_jax_kernel(quant, lengths):
    q, kp, vp, kn, vn, table, ks, vs = _mk(sum(lengths), quant, lengths)
    lens = np.asarray(lengths, np.int32)
    args = (q, kp, vp, kn, vn, table, lens, ks, vs)
    want = np.asarray(jax_paged_attention(
        *(None if a is None else jnp.asarray(a) for a in args),
        interpret=True))
    t = [None if a is None else torch.from_numpy(a) for a in args]
    paged_attention.reset_counts()
    got = paged_attention.paged_decode_attention(*t)
    assert (paged_attention.launches, paged_attention.plain_calls) == (0, 1)
    assert got.shape == (B, 1, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        paged_attention.paged_attention_reference(*t).numpy(), want,
        atol=ATOL, rtol=0)
    paged_attention.reset_counts()


def test_gather_blocks_is_the_dense_view():
    pool = torch.arange(5 * 4 * 2, dtype=torch.float32).reshape(5, 4, 2)
    table = torch.tensor([[3, 1], [0, 0]], dtype=torch.int32)
    got = paged_attention.gather_blocks(pool, table)
    assert got.shape == (2, 8, 2)
    assert torch.equal(got[0], torch.cat([pool[3], pool[1]]))
    assert torch.equal(got[1], torch.cat([pool[0], pool[0]]))


def _good(quant=True):
    q = torch.zeros((2, 1, 8, 128), dtype=torch.bfloat16)
    dt = torch.int8 if quant else torch.bfloat16
    pool = torch.zeros((5, 16, 2, 128), dtype=dt)
    kn = torch.zeros((2, 1, 2, 128), dtype=torch.bfloat16)
    table = torch.ones((2, 3), dtype=torch.int32)
    sc = torch.ones((5, 16, 2)) if quant else None
    return [q, pool, pool.clone(), kn, kn.clone(), table,
            torch.ones(2, dtype=torch.int32), sc,
            None if sc is None else sc.clone()]


def _with(i, value, quant=True):
    args = _good(quant)
    args[i] = value(args[i]) if callable(value) else value
    return args


@pytest.mark.parametrize("args,error", [
    (_with(0, lambda q: q.float()), TypeError),                 # q dtype
    (_with(1, lambda k: k.to(torch.bfloat16)), TypeError),      # pool type
    (_with(7, None), ValueError),                               # one scale
    (_with(0, lambda q: q[:, :, :6].contiguous()), ValueError),  # H/KV = 3
    (_with(1, lambda k: k[:, :12].contiguous()), ValueError),   # T = 12
    (_with(5, lambda t: t.long()), TypeError),                  # table dtype
    (_with(5, lambda t: t[:1].contiguous()), ValueError),       # table rows
    (_with(6, lambda n: n.long()), TypeError),                  # lengths
    (_with(7, lambda s: s[:, :8].contiguous()), ValueError),    # scale shape
    (_with(1, lambda k: k.transpose(1, 2).contiguous().transpose(1, 2)),
     ValueError),                                                # layout
    (_with(5, lambda t: t.t().contiguous().t()), ValueError),    # table layout
])
def test_kernel_input_checks_reject_what_the_kernel_does_not_take(args,
                                                                  error):
    paged_attention._check(*_good(True))
    paged_attention._check(*_good(False))
    with pytest.raises(error):
        paged_attention._check(*args)


# -- the model: pool writes and the decode step --------------------------------

def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JCFG, jax.random.PRNGKey(1))
    return jparams, from_jax_params(_numpy_tree(jparams), device="cpu")


@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_step_matches_jax(weights, quant):
    """Both sides prefill the same prompts into their own pools through
    write_prompt_blocks, then decode 2*T+8 steps (crossing block
    boundaries) with the tables grown host-side as the engine grows
    them: logits within atol, the same argmax, and the pools equal
    (int8 codes bit for bit)."""
    jparams, tparams = weights
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, CFG.vocab_size, n).tolist() for n in (9, 4, 13)]
    slots, t, mb = 3, 16, 4
    max_seq = t * mb
    jdt, tdt = (jnp.int8, torch.int8) if quant else (None, None)
    jcache = jpaged.init_paged_cache(JCFG, slots, n_blocks=slots * mb + 1,
                                     block_size=t, dtype=jdt)
    tcache = paged_llama.init_paged_cache(CFG, slots, slots * mb + 1, t,
                                          dtype=tdt, device="cpu")
    alloc = paged_llama.BlockAllocator(slots * mb + 1)
    table = np.zeros((slots, mb), np.int32)
    jrope = jllama.get_rope_tables(JCFG, max_seq)
    trope = llama.get_rope_tables(CFG, max_seq, "cpu")

    slot_blocks = []
    for b, prompt in enumerate(prompts):
        L = len(prompt)
        blocks = alloc.alloc(-(-L // t))
        slot_blocks.append(blocks)
        _, jk, jv, _ = jllama.prefill_kv(jparams, JCFG,
                                         jnp.asarray([prompt], jnp.int32),
                                         rope_max=max_seq, rope_tables=jrope)
        jcache = jpaged.write_prompt_blocks(jcache, jk, jv,
                                            jnp.asarray(blocks), L)
        jcache = jcache._replace(lengths=jcache.lengths.at[b].set(L))
        _, tk, tv, _ = llama.prefill_kv(tparams, CFG, torch.tensor([prompt]),
                                        rope_tables=trope)
        paged_llama.write_prompt_blocks(tcache, tk, tv, blocks)
        tcache.lengths[b] = L

    tokens = np.asarray([p[-1] for p in prompts], np.int32)
    for step in range(2 * t + 8):
        for b in range(slots):
            need = int(tcache.lengths[b]) // t + 1
            while len(slot_blocks[b]) < need:
                slot_blocks[b].extend(alloc.alloc(1))
            for j in range(mb):
                table[b, j] = slot_blocks[b][min(j, len(slot_blocks[b]) - 1)]
        jl, jcache = jpaged.paged_decode_step(
            jparams, JCFG, jnp.asarray(tokens), jcache, jnp.asarray(table),
            rope_tables=jrope, flash=False)
        tl, tcache = paged_llama.paged_decode_step(
            tparams, CFG, torch.from_numpy(tokens).long(), tcache,
            torch.from_numpy(table), rope_tables=trope)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {step}")
        want_tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), want_tok)
        np.testing.assert_array_equal(tcache.lengths.numpy(),
                                      np.asarray(jcache.lengths))
        tokens = want_tok
    if quant:
        np.testing.assert_array_equal(tcache.k.numpy(), np.asarray(jcache.k))
        np.testing.assert_array_equal(tcache.v.numpy(), np.asarray(jcache.v))
        np.testing.assert_allclose(tcache.k_scale.numpy(),
                                   np.asarray(jcache.k_scale), rtol=1e-5)
    else:
        np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                                   atol=1e-5, rtol=0)


def test_past_capacity_writes_land_in_the_trash_block():
    table = torch.tensor([[3, 4], [5, 5]], dtype=torch.int32)
    blk, off = paged_llama._pool_coords(table, torch.tensor([17, 40]), 16)
    assert blk.tolist() == [4, 0] and off.tolist() == [1, 8]
    jblk, joff = jpaged._pool_coords(jnp.asarray(table.numpy()),
                                     jnp.asarray([17, 40]), 16)
    assert blk.tolist() == np.asarray(jblk).tolist()
    assert off.tolist() == np.asarray(joff).tolist()


@pytest.mark.parametrize("quant", [False, True])
def test_write_prompt_blocks_partial_final_block(weights, quant):
    """Prompt KV lands at the same pool coordinates as on the JAX side,
    a partial final block included; unallocated blocks stay untouched."""
    jparams, tparams = weights
    t, S = 16, 24  # 1.5 blocks
    prompt = list(range(1, S + 1))
    _, jk, jv, _ = jllama.prefill_kv(jparams, JCFG,
                                     jnp.asarray([prompt], jnp.int32),
                                     rope_max=64)
    jcache = jpaged.init_paged_cache(JCFG, 1, n_blocks=4, block_size=t,
                                     dtype=jnp.int8 if quant else None)
    jcache = jpaged.write_prompt_blocks(jcache, jk, jv, jnp.asarray([2, 3]),
                                        S)
    _, tk, tv, _ = llama.prefill_kv(tparams, CFG, torch.tensor([prompt]))
    tcache = paged_llama.init_paged_cache(
        CFG, 1, 4, t, dtype=torch.int8 if quant else None, device="cpu")
    paged_llama.write_prompt_blocks(tcache, tk, tv, [2, 3])
    got, want = tcache.k.numpy(), np.asarray(jcache.k)
    if quant:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(tcache.v_scale.numpy(),
                                   np.asarray(jcache.v_scale), rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert not tcache.k[:, :2].any()           # trash and block 1 untouched
    assert not tcache.k[:, 3, S - t:].any()    # past the prompt's end
    with pytest.raises(ValueError, match="need 2 blocks"):
        paged_llama.write_prompt_blocks(tcache, tk, tv, [2])


def test_block_allocator_matches_jax():
    ta, ja = paged_llama.BlockAllocator(6), jpaged.BlockAllocator(6)
    for a in (ta, ja):
        assert a.free_blocks == 5
    x, jx = ta.alloc(3), ja.alloc(3)
    assert x == jx and len(set(x)) == 3 and 0 not in x
    assert ta.alloc(3) is None and ja.alloc(3) is None  # all or nothing
    assert ta.free_blocks == ja.free_blocks == 2
    # a second holder keeps a block out of the free list
    ta.ref(x[:1])
    ja.ref(jx[:1])
    ta.free(x)
    ja.free(jx)
    assert ta.free_blocks == ja.free_blocks == 4
    ta.free(x[:1])
    ja.free(jx[:1])
    assert ta.free_blocks == ja.free_blocks == 5
    assert ta.alloc(5) == ja.alloc(5)           # the same reuse order
    with pytest.raises(ValueError, match="double free"):
        ta.free([x[0], x[0]])
    with pytest.raises(ValueError, match="unallocated"):
        paged_llama.BlockAllocator(3).ref([1])
    with pytest.raises(ValueError):
        paged_llama.BlockAllocator(1)


# -- the engine ----------------------------------------------------------------

def _engines(weights, **kw):
    jparams, tparams = weights
    jkw = dict(kw)
    if "kv_dtype" in kw:
        jkw["kv_dtype"] = jnp.int8 if kw["kv_dtype"] is not None else None
    jeng = JaxEngine(JCFG, jparams, slots=2, max_seq=64, decode_pipeline=1,
                     prompt_buckets=(8, 16), **jkw)
    teng = GenerationEngine(CFG, tparams, slots=2, max_seq=64, device="cpu",
                            decode_pipeline=1, prompt_buckets=(8, 16), **kw)
    return jeng, teng


def _held(engines, prompts, n):
    """Submit every prompt while each engine's device lock is held, so
    both admit the whole batch in their first pass."""
    out = []
    for eng in engines:
        with eng._device_lock:
            streams = [eng.generate(p, max_new_tokens=n) for p in prompts]
        out.append([s.tokens() for s in streams])
    return out


@pytest.mark.parametrize("kv_dtype", [None, torch.int8])
def test_paged_engine_streams_match_jax(weights, kv_dtype):
    """Concurrent slots, block-boundary crossings and slot reuse: the
    port's paged engine streams JAX's paged engine's tokens, and its
    contiguous engine's."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, CFG.vocab_size, n).tolist()
               for n in (9, 14, 5, 11)]
    jeng, teng = _engines(weights, kv_dtype=kv_dtype,
                          paged_blocks=2 * 4 + 1, paged_block_size=16)
    dense = GenerationEngine(CFG, weights[1], slots=2, max_seq=64,
                             kv_dtype=kv_dtype, device="cpu")
    try:
        want, got = _held((jeng, teng), prompts, 40)  # crosses 16 twice
        assert [len(t) for t in got] == [40] * 4
        assert got == want
        assert [dense.generate(p, max_new_tokens=40).tokens()
                for p in prompts] == got
        st, jst = teng.stats()["paged"], jeng.stats()["paged"]
        assert st == jst
        assert st["blocks"] == 8 and st["evictions"] == 0
        assert st["free"] == 8  # all retired -> all freed
        assert teng.stats()["kv_dtype"] == str(kv_dtype or torch.float32)
    finally:
        jeng.close()
        teng.close()
        dense.close()


def test_paged_sampled_streams_match_jax(weights):
    jeng, teng = _engines(weights, kv_dtype=torch.int8, paged_blocks=9,
                          paged_block_size=16)
    try:
        kw = dict(max_new_tokens=24, temperature=0.8, top_k=20, seed=11)
        want = jeng.generate(list(range(3, 15)), **kw).tokens()
        assert teng.generate(list(range(3, 15)), **kw).tokens() == want
    finally:
        jeng.close()
        teng.close()


def test_pool_exhaustion_truncates_the_stream_jax_truncates(weights):
    """An undersized pool truncates the stream that cannot grow (counted
    as an eviction) instead of corrupting another: the port truncates
    the same stream as JAX at the same token, and every output is a
    prefix of the contiguous engine's."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, CFG.vocab_size, 8).tolist() for _ in range(2)]
    dense = GenerationEngine(CFG, weights[1], slots=2, max_seq=64,
                             device="cpu")
    try:
        full = [dense.generate(p, max_new_tokens=40).tokens()
                for p in prompts]
    finally:
        dense.close()
    # trash + 3 blocks of 16: two 8-token prompts admit (1 block each),
    # but both cannot grow to 48 tokens (3 blocks each)
    jeng, teng = _engines(weights, paged_blocks=4, paged_block_size=16)
    try:
        want, got = _held((jeng, teng), prompts, 40)
        assert got == want
        for g, f in zip(got, full):
            assert g == f[:len(g)]
        assert sorted(len(g) for g in got)[-1] == 40  # one ran to budget
        assert min(len(g) for g in got) < 40
        st = teng.stats()["paged"]
        assert st == jeng.stats()["paged"]
        assert st["evictions"] >= 1 and st["free"] == 3
    finally:
        jeng.close()
        teng.close()


def test_pool_too_small_and_prompt_over_the_serving_limit(weights):
    _, tparams = weights
    with pytest.raises(ValueError, match="too small"):
        GenerationEngine(CFG, tparams, slots=2, max_seq=64, device="cpu",
                         paged_blocks=1, paged_block_size=16)
    jeng, teng = _engines(weights, paged_blocks=9, paged_block_size=16)
    try:
        for eng in (jeng, teng):
            s = eng.generate(list(range(1, 65)), max_new_tokens=2)
            with pytest.raises(Exception, match="serving limit"):
                s.tokens()
        # the smallest pool still serves: the trash block plus the
        # largest bucket's blocks plus one (JAX's floor)
        small = GenerationEngine(CFG, tparams, slots=2, max_seq=64,
                                 device="cpu", paged_blocks=3,
                                 paged_block_size=16, prompt_buckets=(8, 16))
        try:
            assert len(small.generate([1, 2, 3], max_new_tokens=5).tokens()) \
                == 5
        finally:
            small.close()
    finally:
        jeng.close()
        teng.close()


def test_structurally_oversized_prompt_fails_fast(weights):
    """A prompt needing more blocks than the pool has fails at once, as
    on the JAX side, instead of requeueing forever."""
    jeng, teng = _engines(weights, paged_blocks=4, paged_block_size=16)
    try:
        for eng in (jeng, teng):  # 3 usable blocks; 50 tokens need 4
            s = eng.generate(list(range(1, 51)), max_new_tokens=2)
            with pytest.raises(Exception, match="pool blocks"):
                s.tokens()
        assert teng.stats()["paged"]["free"] == 3
    finally:
        jeng.close()
        teng.close()


def test_cancel_returns_the_streams_blocks(weights):
    _, tparams = weights
    eng = GenerationEngine(CFG, tparams, slots=2, max_seq=64, device="cpu",
                           paged_blocks=9, paged_block_size=16)
    try:
        total = eng.stats()["paged"]["free"]
        for _ in range(3):  # repeated cancels must not drain the pool
            s = eng.generate(list(range(1, 30)), max_new_tokens=30)
            next(iter(s))
            s.cancel()
            assert len(list(s)) < 29
        deadline = time.monotonic() + 10
        while eng.stats()["paged"]["free"] != total \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert eng.stats()["paged"]["free"] == total
        assert eng.stats()["active"] == 0
        assert len(eng.generate([1, 2, 3], max_new_tokens=3).tokens()) == 3
    finally:
        eng.close()


def test_new_engine_from_config_serves_paged_on_the_cpu(monkeypatch):
    rows = {"TPU_MODEL": "tiny", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "64",
            "TPU_KV_DTYPE": "int8", "TPU_DECODE_BLOCK": "2",
            "TPU_PAGED_BLOCKS": "9", "TPU_PAGED_BLOCK": "16"}
    eng = new_engine_from_config(MapConfig(rows), device="cpu")
    try:
        assert len(eng.generate(list(range(1, 20)), max_new_tokens=5)
                   .tokens()) == 5
        stats = eng.health_check().details["generator"]
        assert stats["paged"]["block_size"] == 16
        assert stats["paged"]["blocks"] == 8 and stats["paged"]["free"] == 8
        assert isinstance(eng.generator.cache, paged_llama.PagedKVCache)
    finally:
        eng.close()
    # the card is the default: with none it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        new_engine_from_config(MapConfig(rows))
    with pytest.raises(GenerationError, match="closed"):
        eng.generator.generate([1], max_new_tokens=1)
