"""The chunked prefill's modules in the port (gofr_tpu_torch.ops.attention.
chunk_attention, models.llama.prefill_chunk, models.paged_llama.
read_blocks_to_row / write_row_to_blocks, and the engine's admission
functions) against the JAX package's on the same seeded numpy inputs, on
the CPU. Neither package has a kernel here: chunk_attention and the
chunk's products are plain jnp in JAX and plain PyTorch in the port.

Tolerances: chunk_attention atol 1e-5 in float32 (another order of
summation); in bf16 atol 2e-2 plus 2^-7 of |JAX's| (bf16 inputs and
output, one bf16 rounding step of the probabilities and of the result
apart); prefill_chunk logits atol 1e-4 (float32 through two layers, as
tests/test_torch_llama.py); the chunk's KV: int8 codes bit-equal and
scales rtol 1e-5 (as tests/test_torch_llama.py's codec test), float32
K/V atol 1e-5; block copies bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.models import paged_llama as jpaged
from gofr_tpu.ops.attention import chunk_attention as jax_chunk_attention
from gofr_tpu.ops.quant import quantize_kv as jax_quantize_kv
from gofr_tpu_torch.models import LLAMA_CONFIGS, llama, paged_llama
from gofr_tpu_torch.ops.attention import chunk_attention
from gofr_tpu_torch.tpu import from_jax_params
from gofr_tpu_torch.tpu.generator import (AdmissionInputs, chunk_admission,
                                          prefill_admission,
                                          writeback_admission)

JCFG = JAX_CONFIGS["tiny"]
CFG = LLAMA_CONFIGS["tiny"]
SMAX = 64
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JCFG, jax.random.PRNGKey(3))
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# -- chunk_attention ----------------------------------------------------------

def _attention_inputs(seed: int, quant: bool, b=2, c=16, h=8, kv=4, d=128):
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, kn, vn = randn(b, c, h, d), randn(b, c, kv, d), randn(b, c, kv, d)
    kc, vc = randn(b, SMAX, kv, d), randn(b, SMAX, kv, d)
    ks = vs = None
    if quant:
        (kc, ks), (vc, vs) = (tuple(np.array(a) for a in jax_quantize_kv(
            jnp.asarray(x))) for x in (kc, vc))
    return q, kc, vc, kn, vn, ks, vs


@pytest.mark.parametrize("start", [0, 7, 40])
@pytest.mark.parametrize("quant", [False, True])
def test_chunk_attention_matches_jax(quant, start):
    q, kc, vc, kn, vn, ks, vs = _attention_inputs(start, quant)
    want = jax_chunk_attention(*(None if a is None else jnp.asarray(a)
                                 for a in (q, kc, vc, kn, vn)),
                               jnp.int32(start),
                               *(None if a is None else jnp.asarray(a)
                                 for a in (ks, vs)))
    got = chunk_attention(*(None if a is None else _t(a)
                            for a in (q, kc, vc, kn, vn)),
                          torch.tensor([start]),
                          *(None if a is None else _t(a) for a in (ks, vs)))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("start", [0, 7, 40])
@pytest.mark.parametrize("quant", [False, True])
def test_chunk_attention_in_bf16_matches_jax(quant, start):
    """bf16 q and new k/v (and a bf16 cache when not int8), as on the
    card: the port computes the products in float32 on the bf16 values,
    as JAX's bf16 einsums with float32 accumulation do."""
    q, kc, vc, kn, vn, ks, vs = _attention_inputs(start + 100, quant)
    bf = jnp.bfloat16
    jq, jkn, jvn = (jnp.asarray(a, bf) for a in (q, kn, vn))
    jkc, jvc = ((jnp.asarray(a) if quant else jnp.asarray(a, bf))
                for a in (kc, vc))
    want = jax_chunk_attention(jq, jkc, jvc, jkn, jvn, jnp.int32(start),
                               *(None if a is None else jnp.asarray(a)
                                 for a in (ks, vs)))

    def tb(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)

    tkc, tvc = ((_t(np.asarray(a)) if quant else tb(a)) for a in (jkc, jvc))
    got = chunk_attention(tb(jq), tkc, tvc, tb(jkn), tb(jvn),
                          torch.tensor([start]),
                          *(None if a is None else _t(a) for a in (ks, vs)))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2e-2, rtol=2.0 ** -7)


def test_chunk_attention_sees_only_the_prefix_and_the_chunk():
    """Cache rows at or past ``start`` do not move the output."""
    q, kc, vc, kn, vn, _, _ = _attention_inputs(5, False)
    a = chunk_attention(_t(q), _t(kc), _t(vc), _t(kn), _t(vn),
                        torch.tensor([20]))
    kc[:, 20:], vc[:, 20:] = 1e3, -1e3
    b = chunk_attention(_t(q), _t(kc), _t(vc), _t(kn), _t(vn),
                        torch.tensor([20]))
    assert torch.equal(a, b)


# -- prefill_chunk -------------------------------------------------------------

def _prefilled(weights, quant: bool, start: int, seed: int = 0):
    """Both packages' caches (B=1) holding a prompt prefix of ``start``
    tokens, written from the same (JAX) K/V stacks so the prefix is the
    same on both sides; the prompt's tokens."""
    jparams, _ = weights
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, JCFG.vocab_size, (1, start + 16)).astype(
        np.int32)
    dt = jnp.int8 if quant else None
    jcache = jllama.init_cache(JCFG, 1, SMAX, dtype=dt)
    cache = llama.init_cache(CFG, 1, SMAX, dtype=torch.int8 if quant
                             else None, device="cpu")
    if start:
        _, jk, jv, _ = jllama.prefill_kv(jparams, JCFG,
                                         jnp.asarray(tokens[:, :start]))
        jcache = jllama.write_kv(jcache, jk, jv, (0, 0, 0, 0, 0),
                                 jcache.lengths)
        llama.write_kv(cache, _t(jk), _t(jv))
    return jcache, cache, tokens


@pytest.mark.parametrize("start", [0, 7, 40])
@pytest.mark.parametrize("quant", [False, True])
def test_prefill_chunk_matches_jax(weights, quant, start):
    """A chunk of 16 tokens at ``start``: its logits, and the KV it
    writes at [start, start + 16) (int8: codes bit-equal, scales rtol
    1e-5); the cursor does not move."""
    jparams, tparams = weights
    jcache, cache, tokens = _prefilled(weights, quant, start, seed=start)
    chunk = tokens[:, start:start + 16]
    jlogits, jcache = jllama.prefill_chunk(jparams, JCFG, jnp.asarray(chunk),
                                           jcache, jnp.int32(start))
    logits, cache = llama.prefill_chunk(tparams, CFG,
                                        torch.from_numpy(chunk).long(),
                                        cache, torch.tensor([start]),
                                        torch.tensor([0]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL, rtol=0)
    assert cache.lengths.tolist() == [0]
    rows = slice(start, start + 16)
    for name in (("k", "v", "k_scale", "v_scale") if quant else ("k", "v")):
        got = getattr(cache, name).numpy()[:, 0, rows]
        want = np.asarray(getattr(jcache, name))[:, 0, rows]
        if name in ("k", "v") and quant:
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif quant:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0,
                                       err_msg=name)
        else:   # float32 K/V, as the logits: another order of summation
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                       err_msg=name)
    # nothing past the chunk was written
    assert not cache.k[:, 0, start + 16:].any()


def test_prefill_chunk_logit_pos_and_no_logits(weights):
    jparams, tparams = weights
    jcache, cache, tokens = _prefilled(weights, True, 7, seed=9)
    chunk = tokens[:, 7:23]
    jlogits, _ = jllama.prefill_chunk(jparams, JCFG, jnp.asarray(chunk),
                                      jcache, jnp.int32(7),
                                      logit_pos=jnp.asarray([11]))
    logits, _ = llama.prefill_chunk(tparams, CFG,
                                    torch.from_numpy(chunk).long(), cache,
                                    torch.tensor([7]), torch.tensor([0]),
                                    logit_pos=torch.tensor([11]))
    assert logits.shape == (1, 1, CFG.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL, rtol=0)
    none, _ = llama.prefill_chunk(tparams, CFG,
                                  torch.from_numpy(chunk).long(), cache,
                                  torch.tensor([7]), torch.tensor([0]),
                                  compute_logits=False)
    assert none is None


def test_chunks_equal_one_prefill(weights):
    """Three chunks of 16 into a dense cache give the logits and KV of
    one causal prefill of the 48 tokens (the lattice's premise)."""
    _, tparams = weights
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(1, CFG.vocab_size, (1, 48)))
    cache = llama.init_cache(CFG, 1, SMAX, device="cpu")
    for start in (0, 16, 32):
        logits, _ = llama.prefill_chunk(tparams, CFG,
                                        tokens[:, start:start + 16], cache,
                                        torch.tensor([start]),
                                        torch.tensor([0]))
    whole, k, v, _ = llama.prefill_kv(tparams, CFG, tokens)
    np.testing.assert_allclose(logits.numpy(), whole[:, 32:].numpy(),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(cache.k[:, 0, :48].numpy(), k[:, 0].numpy(),
                               atol=1e-5, rtol=0)


# -- the scratch row and the pool ----------------------------------------------

def _pool_and_row(seed: int, quant: bool, n=12, t=8, smax=40):
    rng = np.random.default_rng(seed)
    shape = (2, n, t, 4, 128)
    row_shape = (2, 1, smax, 4, 128)
    if quant:
        pool = [rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2)]
        pool += [rng.random(shape[:-1]).astype(np.float32) for _ in range(2)]
        row = [rng.integers(-127, 128, row_shape).astype(np.int8)
               for _ in range(2)]
        row += [rng.random(row_shape[:-1]).astype(np.float32)
                for _ in range(2)]
    else:
        pool = [rng.standard_normal(shape).astype(np.float32)
                for _ in range(2)] + [None, None]
        row = [rng.standard_normal(row_shape).astype(np.float32)
               for _ in range(2)] + [None, None]
    lengths = np.zeros((3,), np.int32)
    jp = jpaged.PagedKVCache(*(None if a is None else jnp.asarray(a)
                               for a in pool[:2]), jnp.asarray(lengths),
                             *(None if a is None else jnp.asarray(a)
                               for a in pool[2:]))
    tp = paged_llama.PagedKVCache(*(None if a is None else _t(a)
                                    for a in pool[:2]), _t(lengths),
                                  *(None if a is None else _t(a)
                                    for a in pool[2:]))
    jr = jllama.KVCache(*(None if a is None else jnp.asarray(a)
                          for a in row[:2]), jnp.zeros((1,), jnp.int32),
                        *(None if a is None else jnp.asarray(a)
                          for a in row[2:]))
    tr = llama.KVCache(*(None if a is None else _t(a) for a in row[:2]),
                       torch.zeros((1,), dtype=torch.int32),
                       *(None if a is None else _t(a) for a in row[2:]))
    return jp, tp, jr, tr


def _fields(c, quant):
    return ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_write_row_to_blocks_matches_jax(quant, as_tensor):
    """A 40-position row into 5 blocks of 8, the last two the trash
    block: bit-equal to JAX's pool outside the trash block."""
    jp, tp, _, tr = _pool_and_row(1, quant)
    blocks = [7, 3, 10, 0, 0]
    jp = jpaged.write_row_to_blocks(jp, _pool_and_row(1, quant)[2],
                                    jnp.asarray(blocks, jnp.int32))
    ids = torch.tensor(blocks) if as_tensor else blocks
    paged_llama.write_row_to_blocks(tp, tr, ids)
    for name in _fields(tp, quant):
        np.testing.assert_array_equal(getattr(tp, name).numpy()[:, 1:],
                                      np.asarray(getattr(jp, name))[:, 1:],
                                      err_msg=name)


@pytest.mark.parametrize("quant", [False, True])
def test_read_blocks_to_row_matches_jax(quant):
    jp, tp, jr, tr = _pool_and_row(2, quant)
    blocks = [4, 9, 1, 0, 0]
    jr = jpaged.read_blocks_to_row(jr, jp, jnp.asarray(blocks, jnp.int32))
    paged_llama.read_blocks_to_row(tr, tp, torch.tensor(blocks))
    for name in _fields(tr, quant):
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)),
                                      err_msg=name)
    # a short block list leaves the rest of the row as it was
    _, tp2, _, tr2 = _pool_and_row(2, quant)
    before = tr2.k.clone()
    paged_llama.read_blocks_to_row(tr2, tp2, [4, 9])
    assert torch.equal(tr2.k[:, :, 16:], before[:, :, 16:])
    assert torch.equal(tr2.k[:, 0, 8:16], tp2.k[:, 9])


# -- the admission functions through one input vector --------------------------

def test_one_input_vector_serves_every_slot_and_offset(weights):
    """The engine's chunk and prefill functions read slot, start and
    length from the device input vector, never from Python ints baked
    in: two chunks through the same AdmissionInputs, at other slots and
    offsets, each land where its inputs say (a graph captured once
    serves both)."""
    _, tparams = weights
    rng = np.random.default_rng(6)
    prompt = rng.integers(1, CFG.vocab_size, 40)
    rope = llama.get_rope_tables(CFG, SMAX, "cpu")
    inp = AdmissionInputs(0, 16, "cpu")

    def put(tokens, **kw):
        host = np.empty(tuple(inp.buf.shape), np.int64)
        kw.setdefault("length", 0)
        kw.setdefault("logit_pos", 0)
        kw.setdefault("start", 0)
        inp.pack(host, tokens, temp=0.0, top_k=0, seed=0, blocks=(),
                 **kw)
        inp.buf.copy_(torch.from_numpy(host))

    cache = llama.init_cache(CFG, 3, SMAX, dtype=torch.int8, device="cpu")
    for slot, start in ((2, 0), (0, 16)):
        put(prompt[start:start + 16], slot=slot, start=start)
        with torch.no_grad():
            assert chunk_admission(tparams, CFG, cache, inp, rope, width=16,
                                   final=False) is None
        assert cache.lengths.tolist()[slot] == SMAX   # parked
    assert cache.k[:, 2, :16].any() and not cache.k[:, 2, 16:].any()
    assert cache.k[:, 0, 16:32].any() and not cache.k[:, 0, :16].any()
    assert not cache.k[:, 1].any()
    # the final chunk of slot 2 at [8, 24): cursor to the length, a token
    put(prompt[8:24], slot=2, start=8, length=24, logit_pos=15)
    with torch.no_grad():
        first = chunk_admission(tparams, CFG, cache, inp, rope, width=16,
                                final=True, draw=False)
    assert cache.lengths.tolist() == [SMAX, 0, 24]
    assert first.shape == (2,) and 0 <= int(first[0]) < CFG.vocab_size
    # a bucket prefill into slot 1: padding up to the bucket only
    put(prompt[:11], slot=1, length=11, logit_pos=10)
    with torch.no_grad():
        prefill_admission(tparams, CFG, cache, inp, rope, bucket=16,
                          draw=False)
    assert cache.lengths.tolist() == [SMAX, 11, 24]
    assert cache.k[:, 1, :11].any() and not cache.k[:, 1, 16:].any()


def test_paged_prefill_and_write_back_through_the_input_vector(weights):
    """The paged bucket prefill writes ceil(bucket/T) blocks, the ids
    past the prompt's own the trash block; the write-back lands a
    scratch row in the blocks the vector names and sets the slot's
    cursor."""
    _, tparams = weights
    rope = llama.get_rope_tables(CFG, SMAX, "cpu")
    inp = AdmissionInputs(8, 32, "cpu")
    pool = paged_llama.init_paged_cache(CFG, 2, 12, 8, dtype=torch.int8,
                                        device="cpu")
    host = np.empty(tuple(inp.buf.shape), np.int64)
    # 11 tokens in bucket 32: blocks [5, 6] then the trash block twice
    inp.pack(host, np.arange(1, 12), length=11, slot=1, start=0,
             logit_pos=10, temp=0.0, top_k=0, seed=0, blocks=[5, 6, 0, 0])
    inp.buf.copy_(torch.from_numpy(host))
    with torch.no_grad():
        prefill_admission(tparams, CFG, pool, inp, rope, bucket=32,
                          draw=False)
    assert pool.lengths.tolist() == [0, 11]
    written = [b for b in range(1, 12) if pool.k[:, b].any()]
    assert written == [5, 6]
    row = llama.init_cache(CFG, 1, SMAX, dtype=torch.int8, device="cpu")
    row.k.fill_(3)
    inp.pack(host, (), length=20, slot=0, start=0, logit_pos=0, temp=0.0,
             top_k=0, seed=0, blocks=[9, 2, 4] + [0] * 5)
    inp.buf.copy_(torch.from_numpy(host))
    writeback_admission(pool, row, inp)
    assert pool.lengths.tolist() == [20, 11]
    assert [b for b in range(1, 12) if (pool.k[:, b] == 3).all()] == \
        [2, 4, 9]
