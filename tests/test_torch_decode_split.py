"""The decode kernels' split over the cache, on the CPU.

flash_decode.cu and paged_decode.cu share one body
(gofr_tpu_torch/ops/csrc/decode_attention.cuh): each slot's positions
are cut into chunks of ``SPLIT_CHUNK``, each live chunk's exact softmax
partial (max, sum, accumulator) is written to a workspace, and a second
pass folds a slot's partials in chunk order with the flash rule, then
this step's k/v. Here:

- ``split_geometry``, the one function both wrappers size the grid and
  the workspace with, at the serving shapes and the edges;
- ``split_reference``, a plain PyTorch model of that arithmetic (used by
  these tests only), held against the JAX package's flash decode and
  paged decode, run in interpret mode as tests/test_flash_decode.py and
  tests/test_paged.py run them, at lengths 0, 1, C-1, C, C+1, capacity
  and an all-trash row. Float32, atol 1e-5; a slot of length 0 returns
  v_new exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ops.flash_decode import flash_decode_appended as jax_decode
from gofr_tpu.ops.paged_attention import \
    paged_decode_attention as jax_paged_attention
from gofr_tpu.ops.quant import quantize_kv
from gofr_tpu_torch.ops.flash_decode import (HEAD_DIM, SPLIT_CHUNK,
                                             SplitGeometry, split_geometry)
from gofr_tpu_torch.ops.paged_attention import gather_blocks

ATOL = 1e-5
NEG_INF = -1e30
C = SPLIT_CHUNK


# -- the geometry -------------------------------------------------------------

def _work(b, kv, g, n_chunks):
    return b * kv * n_chunks * g * (HEAD_DIM + 2)


@pytest.mark.parametrize("b,kv,g,cap,want", [
    # phase paged: 32 slots, MB=32 blocks of T=128 (or 256 of T=16)
    (32, 8, 4, 32 * 128, SplitGeometry(C, 16, 66, _work(32, 8, 4, 16))),
    (32, 8, 4, 256 * 16, SplitGeometry(C, 16, 66, _work(32, 8, 4, 16))),
    # phase 5: 8 slots of Smax 2048: 64 items per KV head at most
    (8, 8, 4, 2048, SplitGeometry(C, 8, 64, _work(8, 8, 4, 8))),
    # one slot at TPU_MAX_SEQ, and a capacity just past a chunk edge
    (1, 8, 4, 4096, SplitGeometry(C, 16, 16, _work(1, 8, 4, 16))),
    (2, 2, 8, C + 1, SplitGeometry(C, 2, 4, _work(2, 2, 8, 2))),
    (3, 1, 1, C - 1, SplitGeometry(C, 1, 3, _work(3, 1, 1, 1))),
    # many slots: W is held to BLOCKS_PER_SM blocks of each SM
    (256, 1, 8, 4096, SplitGeometry(C, 16, 528, _work(256, 1, 8, 16))),
])
def test_split_geometry_at_the_serving_shapes_and_edges(b, kv, g, cap, want):
    assert split_geometry(b, kv, g, cap, sms=132) == want


def test_split_geometry_follows_capacity_not_block_size():
    """The pool's block size never enters: a paged pool of MB*T positions
    and a contiguous cache of Smax = MB*T are cut the same way, which is
    what keeps the two kernels bit-equal."""
    for t in (16, 128):
        assert split_geometry(32, 8, 4, (4096 // t) * t) == \
            split_geometry(32, 8, 4, 4096)
    assert split_geometry(4, 8, 4, 0).blocks == 1   # never an empty grid


# -- the split's arithmetic ---------------------------------------------------

def split_reference(q, k_cache, v_cache, k_new, v_new, lengths, k_scale=None,
                    v_scale=None, chunk=SPLIT_CHUNK):
    """The kernels' function the way they compute it, in float32: per
    (slot, KV head) each chunk of positions < length gets an exact
    softmax partial (m, l, acc) -- the k scale on the scores, the v scale
    on the probabilities -- the partials fold in chunk order with the
    flash rule from an empty state (m = -1e30, l = 0), then k_new/v_new
    join. Shapes as decode_attention_appended; returns float32."""
    b, _, h, d = q.shape
    smax, n_kv = k_cache.shape[1], k_cache.shape[2]
    g = h // n_kv
    qf = (q[:, 0].float() * d ** -0.5).reshape(b, n_kv, g, d)
    out = torch.empty((b, n_kv, g, d), dtype=torch.float32)
    for i in range(b):
        n = min(max(int(lengths[i]), 0), smax)
        for kh in range(n_kv):
            qh = qf[i, kh]                                      # [G, D]
            m = torch.full((g,), NEG_INF)
            l_run = torch.zeros(g)
            acc = torch.zeros((g, d))
            for t0 in range(0, n, chunk):
                t1 = min(n, t0 + chunk)
                k = k_cache[i, t0:t1, kh].float()
                v = v_cache[i, t0:t1, kh].float()
                s = qh @ k.T                                    # [G, n]
                p_scale = torch.ones(t1 - t0)
                if k_scale is not None:
                    s = s * k_scale[i, t0:t1, kh]
                    p_scale = v_scale[i, t0:t1, kh]
                mc = s.max(-1).values
                p = torch.exp(s - mc[:, None])
                lc = p.sum(-1)
                ac = (p * p_scale) @ v
                mn = torch.maximum(m, mc)
                a, e = torch.exp(m - mn), torch.exp(mc - mn)
                l_run = l_run * a + lc * e
                acc = acc * a[:, None] + ac * e[:, None]
                m = mn
            sn = qh @ k_new[i, 0, kh].float()
            mt = torch.maximum(m, sn)
            alpha, beta = torch.exp(m - mt), torch.exp(sn - mt)
            out[i, kh] = (acc * alpha[:, None]
                          + beta[:, None] * v_new[i, 0, kh].float()) \
                / (l_run * alpha + beta)[:, None]
    return out.reshape(b, 1, h, d)


B, H, KV, D = 6, 4, 2, 32


def _inputs(seed, smax, quant):
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q = randn(B, 1, H, D)
    kc, vc = randn(B, smax, KV, D), randn(B, smax, KV, D)
    kn, vn = randn(B, 1, KV, D), randn(B, 1, KV, D)
    if not quant:
        return q, kc, vc, kn, vn, None, None
    (kq, ks), (vq, vs) = (tuple(np.array(a) for a in quantize_kv(
        jnp.asarray(x))) for x in (kc, vc))
    return q, kq, vq, kn, vn, ks, vs


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("chunk", [16, SPLIT_CHUNK])
def test_split_matches_jax_flash_decode_at_the_chunk_edges(quant, chunk):
    smax = 2 * chunk if chunk > 64 else 128
    lengths = [0, 1, chunk - 1, chunk, chunk + 1, smax]
    q, kc, vc, kn, vn, ks, vs = _inputs(chunk + quant, smax, quant)
    lens = np.asarray(lengths, np.int32)
    want = np.asarray(jax_decode(
        *(None if a is None else jnp.asarray(a)
          for a in (q, kc, vc, kn, vn, lens, ks, vs)),
        block_s=min(smax, 128), interpret=True))
    got = split_reference(*_torch(q, kc, vc, kn, vn, lens, ks, vs),
                          chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("quant", [True, False])
def test_split_matches_jax_paged_decode_with_an_all_trash_row(quant):
    """The paged kernel is the same split over the gathered view: against
    the JAX paged kernel, one slot's row all trash (block 0, length 0)."""
    t, mb = 64, 5                      # capacity 320 = C + 64
    lengths = [0, 1, C - 1, C, C + 1, mb * t]
    n = 1 + B * mb
    rng = np.random.default_rng(11 + quant)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, kn, vn = randn(B, 1, H, D), randn(B, 1, KV, D), randn(B, 1, KV, D)
    kp, vp = randn(n, t, KV, D), randn(n, t, KV, D)
    ks = vs = None
    if quant:
        (kp, ks), (vp, vs) = (tuple(np.array(a) for a in quantize_kv(
            jnp.asarray(x))) for x in (kp, vp))
    table = np.zeros((B, mb), np.int32)
    for i, x in enumerate(lengths):
        live = -(-x // t)
        for j in range(mb):
            if live:       # rows clamped to the last live block
                table[i, j] = 1 + i * mb + min(j, live - 1)
    lens = np.asarray(lengths, np.int32)
    want = np.asarray(jax_paged_attention(
        *(None if a is None else jnp.asarray(a)
          for a in (q, kp, vp, kn, vn, table, lens, ks, vs)),
        interpret=True))
    tq, tkp, tvp, tkn, tvn, ttab, tlens, tks, tvs = _torch(
        q, kp, vp, kn, vn, table, lens, ks, vs)
    got = split_reference(
        tq, gather_blocks(tkp, ttab), gather_blocks(tvp, ttab), tkn, tvn,
        tlens, None if tks is None else gather_blocks(tks, ttab),
        None if tvs is None else gather_blocks(tvs, ttab))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_split_empty_slot_returns_v_new_exactly():
    q, kc, vc, kn, vn, ks, vs = _inputs(3, 2 * C, True)
    got = split_reference(*_torch(q, kc, vc, kn, vn),
                          torch.zeros(B, dtype=torch.int32),
                          *_torch(ks, vs))
    want = torch.from_numpy(vn[:, 0]).repeat_interleave(H // KV, 1)
    assert torch.equal(got[:, 0], want)
