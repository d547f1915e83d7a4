"""The port's speculative decoding (gofr_tpu_torch.ops.attention.
window_attention_appended, ops.paged_attention.paged_window_attention,
models.llama.verify_step, models.paged_llama.paged_verify_step and the
engine's verify ticks) against the JAX package's on the same seeded numpy
inputs, on the CPU, mirroring tests/test_spec_decode.py and
tests/test_paged.py. The JAX window kernel runs its Pallas kernel in
interpret mode, as that file runs it; on CPU tensors the port's wrapper
runs its plain version (the CUDA kernel is held against that plain
version on the card by chip_smoke.py and tests/test_torch_cuda.py).

A plain model of the CUDA window kernel's own arithmetic (its work items
over chunks carrying all W*G rows in 16-row tiles, the position slices
of a sub-tile, its workspace and its combine with the window fold) is
held against the plain version here in float32 and with the kernel's
bf16 roundings, and against JAX's window kernel on bf16 inputs, so the
kernel's index arithmetic and numerics are checked where no card is.

Tolerances: attention outputs atol 2e-5 (float32, another order of
summation); logits atol 1e-4 (float32 through two layers); int8 codes
bit-equal; greedy tokens identical. Both engines run at dispatch depth 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.models import paged_llama as jpaged
from gofr_tpu.ops.attention import \
    window_attention_appended as jax_window_attention
from gofr_tpu.ops.paged_attention import \
    paged_window_attention as jax_paged_window
from gofr_tpu.ops.quant import quantize_kv as jax_quantize_kv
from gofr_tpu.tpu.generator import GenerationEngine as JaxEngine
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.models import LLAMA_CONFIGS, llama, paged_llama
from gofr_tpu_torch.ops import paged_attention
from gofr_tpu_torch.ops.attention import (NEG_INF, decode_attention_appended,
                                          window_attention_appended)
from gofr_tpu_torch.ops.flash_decode import SPLIT_CHUNK, split_geometry
from gofr_tpu_torch.ops.paged_attention import window_geometry
from gofr_tpu_torch.tpu import (GenerationEngine, from_jax_params,
                                new_engine_from_config)
from gofr_tpu_torch.tpu.generator import verify_epilogue

JCFG = JAX_CONFIGS["tiny"]
CFG = LLAMA_CONFIGS["tiny"]
ATOL = 2e-5
LOGIT_ATOL = 1e-4


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _quant(x):
    return tuple(np.array(a) for a in jax_quantize_kv(jnp.asarray(x)))


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


# -- the attention ------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("w", [1, 3, 5])
def test_window_attention_matches_jax(quant, w):
    rng = np.random.default_rng(10 * w + quant)
    b, smax, h, kv, d = 3, 32, 4, 2, 16
    q, kn, vn = _randn(rng, b, w, h, d), _randn(rng, b, w, kv, d), \
        _randn(rng, b, w, kv, d)
    kc, vc = _randn(rng, b, smax, kv, d), _randn(rng, b, smax, kv, d)
    ks = vs = None
    if quant:
        (kc, ks), (vc, vs) = _quant(kc), _quant(vc)
    lens = np.asarray([0, 7, smax], np.int32)
    args = (q, kc, vc, kn, vn, lens, ks, vs)
    want = np.asarray(jax_window_attention(*_jax(*args)))
    got = window_attention_appended(*_torch(*args))
    assert got.shape == (b, w, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    if w == 1:  # the appended decode step, as JAX's test holds it
        np.testing.assert_allclose(
            got.numpy(), decode_attention_appended(*_torch(*args)).numpy(),
            atol=1e-6, rtol=0)


B, H, KV, D = 3, 8, 4, 128
T, MB = 128, 2
N = B * MB + 1


def _pool_inputs(seed, w, quant, lengths, h=H, kv=KV, d=D, t=T, mb=MB):
    """q/k_new/v_new, a pool of B*MB + 1 blocks and a clamped table, as
    tests/test_paged.py's _mk builds them (numpy)."""
    rng = np.random.default_rng(seed)
    b, n = len(lengths), len(lengths) * mb + 1
    q, kn, vn = (_randn(rng, b, w, h, d), _randn(rng, b, w, kv, d),
                 _randn(rng, b, w, kv, d))
    kp, vp = _randn(rng, n, t, kv, d), _randn(rng, n, t, kv, d)
    table = np.zeros((b, mb), np.int32)
    for i, x in enumerate(lengths):
        live = max(1, -(-int(x) // t))
        for j in range(mb):
            table[i, j] = 1 + i * mb + min(j, live - 1)
    ks = vs = None
    if quant:
        (kp, ks), (vp, vs) = _quant(kp), _quant(vp)
    return (q, kp, vp, kn, vn, table, np.asarray(lengths, np.int32), ks, vs)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("w", [1, 3, 5])
@pytest.mark.parametrize("lengths", [[256, 100, 0], [37, 128, 255]])
def test_paged_window_matches_jax_kernel(quant, w, lengths):
    """The port's window wrapper (its plain version on CPU tensors)
    against JAX's paged_window_attention in interpret mode: ragged
    cursors, an empty slot, block-boundary lengths."""
    args = _pool_inputs(sum(lengths) + w, w, quant, lengths)
    want = np.asarray(jax_paged_window(*_jax(*args), interpret=True))
    paged_attention.reset_counts()
    got = paged_attention.paged_window_attention(*_torch(*args))
    counts = (paged_attention.window_launches,
              paged_attention.window_plain_calls,
              paged_attention.launches, paged_attention.plain_calls)
    assert counts == (0, 1, 0, 0)      # the window caller's own counters
    assert got.shape == (B, w, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    paged_attention.reset_counts()


def test_paged_window_of_one_is_the_paged_decode():
    args = _torch(*_pool_inputs(4, 1, True, [200, 3, 0]))
    np.testing.assert_allclose(
        paged_attention.paged_window_attention(*args).numpy(),
        paged_attention.paged_decode_attention(*args).numpy(),
        atol=1e-6, rtol=0)
    paged_attention.reset_counts()


# -- a plain model of the CUDA kernel's arithmetic ----------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def kernel_model(q, k_pool, v_pool, k_new, v_new, table, lengths,
                 k_scale=None, v_scale=None, chunk=SPLIT_CHUNK, sub=64, nb=3,
                 bf16=True):
    """csrc/paged_window.cu's two passes with its own indexing, in
    float32 on flat buffers: NB blocks per KV head walk the work items
    (slot, chunk), each carrying all R = W*G query rows of the KV head
    (read in place from q [B, W, H, D]) in 16-row tiles, with the
    window_geometry's warps: a tile's position slices (4 or 2 of each
    sub-tile of ``sub`` positions, or 1) keep their own running max, sum
    and accumulator over the sub-tiles (one max and one rescale a step:
    the slice, at most sub/2 positions, sub/4 in a block of eight tiles)
    and each writes its partial, rows of D + 4 floats (acc, m, l), into a
    workspace of NaN; the combine takes each row's largest partial max,
    sums the partials weighted by it in chunk and slice order, then folds
    in the window positions t <= w. With ``bf16`` the kernel's roundings: q x scale,
    the probabilities x v scale before P.V, the window's probabilities
    before P.V, and the output. A partial read that no item wrote shows
    up as NaN."""
    rnd = _bf16 if bf16 else (lambda x: x)
    b_, wn, h, d = q.shape
    n, t_blk, kv, _ = k_pool.shape
    mb = table.shape[1]
    g_ = h // kv
    cap = mb * t_blk
    geo = window_geometry(b_, kv, g_, wn, cap)
    rows, tiles, slices = geo.rows, geo.tiles, geo.slices
    width = sub // slices
    step = min(width, sub // 4 if geo.warps > 7 else sub // 2)
    nc = -(-cap // chunk)
    kw = d + 4
    work = torch.full((b_ * kv * nc * slices * rows * kw,), float("nan"))
    qf = q.reshape(-1).float()
    kf = k_pool.reshape(n * t_blk, kv, d).float()
    vf = v_pool.reshape(n * t_blk, kv, d).float()
    ksf = None if k_scale is None else k_scale.reshape(n * t_blk, kv)
    vsf = None if v_scale is None else v_scale.reshape(n * t_blk, kv)
    scale = d ** -0.5

    def qrow(b, kvh, r):
        w = r // g_
        return ((b * wn + w) * h + kvh * g_ + (r - w * g_)) * d

    def qs(b, kvh, r):   # a query row x scale; a padding row is zero
        if r >= rows:
            return torch.zeros(d)
        return rnd(qf[qrow(b, kvh, r):][:d] * scale)

    def live(b):
        return min(max(int(lengths[b]), 0), cap)

    def n_chunks(x):
        return -(-x // chunk)

    for kvh in range(kv):
        for y in range(nb):
            b, base, item = 0, 0, y
            ln = live(0)
            while True:
                while b < b_ and item >= base + n_chunks(ln):
                    base += n_chunks(ln)
                    b += 1
                    if b < b_:
                        ln = live(b)
                if b >= b_:
                    break
                c = item - base
                t0, t1 = c * chunk, min(ln, c * chunk + chunk)
                for rt in range(tiles):
                    qt = torch.stack([qs(b, kvh, rt * 16 + i)
                                      for i in range(16)])       # [16, D]
                    for ps in range(slices):
                        m = torch.full((16,), NEG_INF)
                        l, acc = torch.zeros(16), torch.zeros(16, d)
                        starts = [s0 + ps * width + h
                                  for s0 in range(t0, t1, sub)
                                  for h in range(0, width, step)]
                        for lo in starts:
                            if lo >= t1:
                                continue
                            pos = torch.arange(lo, min(lo + step, t1))
                            blk = table[b, pos // t_blk].long().clamp(0, n - 1)
                            prow = blk * t_blk + pos % t_blk
                            s = qt @ kf[prow, kvh].T             # [16, n]
                            p_scale = torch.ones(len(pos))
                            if ksf is not None:
                                s = s * ksf[prow, kvh]
                                p_scale = vsf[prow, kvh]
                            mn = torch.maximum(m, s.max(-1).values)
                            corr = torch.exp(m - mn)
                            p = torch.exp(s - mn[:, None])
                            l = l * corr + p.sum(-1)
                            acc = acc * corr[:, None] + \
                                rnd(p * p_scale) @ vf[prow, kvh]
                            m = mn
                        wp = (((b * kv + kvh) * nc + c) * slices + ps) \
                            * rows * kw
                        for i in range(16):
                            r = rt * 16 + i
                            if r < rows:
                                o = wp + r * kw
                                work[o:o + d] = acc[i]
                                work[o + d] = m[i]
                                work[o + d + 1] = l[i]
                item += nb

    out = torch.full((b_ * wn * h * d,), float("nan"))
    knf, vnf = k_new.float(), v_new.float()
    for kvh in range(kv):
        for b in range(b_):
            wp = ((b * kv + kvh) * nc) * slices * rows * kw
            for r in range(rows):
                w = r // g_
                its = [wp + (c * rows + r) * kw
                       for c in range(n_chunks(live(b)) * slices)]
                m_run = torch.tensor(max([work[i + d].item() for i in its],
                                         default=NEG_INF))
                l_run, a_run = 0.0, 0.0
                for it in its:                 # chunk, then slice order
                    e = torch.exp(work[it + d] - m_run)
                    l_run = l_run + work[it + d + 1] * e
                    a_run = a_run + work[it:it + d] * e
                qr = qs(b, kvh, r)
                sw = torch.stack([qr @ knf[b, t, kvh] for t in range(w + 1)])
                mt = torch.maximum(m_run, sw.max())
                alpha = torch.exp(m_run - mt)
                pw = torch.exp(sw - mt)
                pv = (rnd(pw)[:, None] * vnf[b, :w + 1, kvh]).sum(0)
                out[qrow(b, kvh, r):qrow(b, kvh, r) + d] = rnd(
                    (a_run * alpha + pv) / (l_run * alpha + pw.sum()))
    return out.reshape(b_, wn, h, d)


# the kernel against the plain window, as chip_smoke.py holds it: its
# bf16 roundings of q x scale, of the probabilities before P.V and of
# the output move a unit-scale result by about a bf16 step (2^-8
# relative) plus a small absolute term
KERNEL_ATOL, KERNEL_RTOL = 1e-2, 2.0 ** -7


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 2), (8, 1)])
@pytest.mark.parametrize("w", [1, 2, 3, 5])
def test_kernel_model_matches_the_plain_window(h, kv, w):
    """G = 1, 2, 4, 8 by W = 1, 2, 3, 5: one or more 16-row tiles, rows
    padded, 4, 2 or 1 position slices, sub-tiles cut by the chunk's end;
    lengths on and around the chunk edges, an empty slot and one at
    capacity. In float32 the model is the plain window within atol 2e-5
    (another order of summation); with the kernel's bf16 roundings
    within the kernel's tolerance."""
    chunk, t, mb = 16, 8, 5
    lengths = [0, chunk - 1, chunk, chunk + 1, 2 * chunk + 3, t * mb]
    args = _torch(*_pool_inputs(h * w + kv, w, kv % 2 == 0, lengths, h=h,
                                kv=kv, d=16, t=t, mb=mb))
    want = paged_attention.paged_window_reference(*args)
    got = kernel_model(*args, chunk=chunk, sub=8, bf16=False)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    got = kernel_model(*args, chunk=chunk, sub=8)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=KERNEL_ATOL,
                               rtol=KERNEL_RTOL)
    paged_attention.reset_counts()


def _bf16_np(x):
    return None if x is None else np.asarray(
        jnp.asarray(x).astype(jnp.bfloat16))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("w", [2, 5])
def test_kernel_model_matches_the_jax_window_kernel(quant, w):
    """The model in the kernel's bf16-operand numerics against JAX's
    paged_window_attention in interpret mode on the same bf16 inputs
    (an int8 pool is the same codes and scales on both sides): both
    round q x scale, the probabilities before P.V and the output to
    bf16. They round at other values: JAX rounds 1/sqrt(128) to bf16
    before it scales q, so a score moves by about 2^-9 of itself and a
    probability can round to the neighbouring bf16 step (2^-8 of itself,
    times |v| up to 4 here), JAX also rounds the window's P.V to bf16,
    and the two cut the positions differently (the kernel's 256-position
    chunks and 64-position sub-tiles, JAX's 128-position blocks). The
    kernel's tolerance on the card covers a step of either kind:
    KERNEL_ATOL + KERNEL_RTOL |want| (measured here: 0.016 at 2.39)."""
    lengths = [256, 100, 0]
    q, kp, vp, kn, vn, table, lens, ks, vs = _pool_inputs(
        40 + w, w, quant, lengths)
    q, kn, vn = _bf16_np(q), _bf16_np(kn), _bf16_np(vn)
    if not quant:
        kp, vp = _bf16_np(kp), _bf16_np(vp)
    want = np.asarray(jax_paged_window(
        *_jax(q, kp, vp, kn, vn, table, lens, ks, vs), interpret=True)
        .astype(jnp.float32))

    def tb(x):
        if x is None or x.dtype != jnp.bfloat16:
            return None if x is None else torch.from_numpy(x)
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)

    got = kernel_model(*[tb(x) for x in (q, kp, vp, kn, vn, table, lens, ks,
                                         vs)])
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=KERNEL_ATOL,
                               rtol=KERNEL_RTOL)


@pytest.mark.parametrize("w,g,want", [
    (2, 1, (2, 16, 1, 4, 4)), (16, 1, (16, 16, 1, 4, 4)),
    (3, 8, (24, 32, 2, 2, 4)), (5, 4, (20, 32, 2, 2, 4)),
    (4, 8, (32, 32, 2, 2, 4)), (5, 8, (40, 48, 3, 1, 3)),
    (8, 8, (64, 64, 4, 1, 4)), (9, 8, (72, 80, 5, 1, 5)),
    (16, 4, (64, 64, 4, 1, 4)), (16, 8, (128, 128, 8, 1, 8))])
def test_window_geometry(w, g, want):
    """Rows, rows padded to 16-row tiles, tiles, position slices a tile
    and warps, for (W, G) from (2, 1) to (16, 8), at phase paged's 32
    slots x 4096 positions: one item a slot and chunk whatever the rows,
    a partial of R rows a chunk and slice."""
    geo = window_geometry(32, 8, g, w, 4096, sms=132)
    assert (geo.rows, geo.rows_padded, geo.tiles, geo.slices,
            geo.warps) == want
    assert geo.items == 32 * 16 and geo.n_chunks == 16
    assert geo.work == 32 * 8 * 16 * want[3] * w * g * (128 + 4)
    assert geo.blocks == 33


def test_split_geometry_of_the_verify_window():
    """Phase paged's shapes with W = 5: 20 rows a KV head in two 16-row
    tiles (32 rows, 12 of them padding) on 4 warps, two a tile, one item
    a slot and chunk, so each chunk's K/V is read once; 33 blocks a KV
    head, two an SM; and the decodes' split is the decode's own, with no
    window."""
    geo = window_geometry(32, 8, 4, 5, 4096, sms=132)
    assert geo == (20, 32, 2, 2, 4, 16, 512, 33,
                   32 * 8 * 16 * 2 * 20 * 132)
    assert window_geometry(2, 8, 4, 5, 4096).blocks == 32   # = the items
    dec = split_geometry(32, 8, 4, 4096, sms=132)
    assert dec.work == 32 * 8 * 16 * 4 * 130 and dec.blocks == 66


# -- the model -----------------------------------------------------------------

def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JCFG, jax.random.PRNGKey(1))
    return jparams, from_jax_params(_numpy_tree(jparams), device="cpu")


def _prefilled(weights, quant, smax):
    """Three prompts prefilled into a JAX cache and the port's, the
    third one close enough to capacity that a window of 4 writes past
    it (those rows are dropped)."""
    jparams, tparams = weights
    rng = np.random.default_rng(3)
    lens = [8, 5, smax - 2]
    toks = rng.integers(1, CFG.vocab_size, (3, smax - 2))
    jcache = jllama.init_cache(JCFG, 3, smax,
                               dtype=jnp.int8 if quant else None)
    _, jcache = jllama.prefill(jparams, JCFG, jnp.asarray(toks, jnp.int32),
                               jcache, jnp.asarray(lens, jnp.int32))
    tcache = llama.init_cache(CFG, 3, smax,
                              dtype=torch.int8 if quant else None,
                              device="cpu")
    _, k, v, _ = llama.prefill_kv(tparams, CFG, torch.from_numpy(toks),
                                  torch.tensor(lens, dtype=torch.int32))
    llama.write_kv(tcache, k, v, lengths=torch.tensor(lens,
                                                      dtype=torch.int32))
    return jcache, tcache, rng


@pytest.mark.parametrize("quant", [False, True])
def test_verify_step_matches_jax(weights, quant):
    jparams, tparams = weights
    smax = 32
    jcache, tcache, rng = _prefilled(weights, quant, smax)
    window = rng.integers(1, CFG.vocab_size, (3, 4))
    jl, jcache = jllama.verify_step(jparams, JCFG,
                                    jnp.asarray(window, jnp.int32), jcache)
    tl, tcache = llama.verify_step(tparams, CFG, torch.from_numpy(window),
                                   tcache)
    assert tl.shape == (3, 4, CFG.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(tcache.lengths.numpy(),
                                  np.asarray(jcache.lengths))
    assert tcache.lengths.tolist() == [8, 5, smax - 2]   # unchanged
    # the prompts and the windows' rows (the port prefills padding rows
    # as zeros where JAX leaves masked values; neither is read)
    for b, n in enumerate([8, 5, smax - 2]):
        end = min(n + 4, smax)
        if quant:
            np.testing.assert_array_equal(tcache.k[:, b, :end].numpy(),
                                          np.asarray(jcache.k)[:, b, :end])
            np.testing.assert_array_equal(tcache.v[:, b, :end].numpy(),
                                          np.asarray(jcache.v)[:, b, :end])
            np.testing.assert_allclose(
                tcache.k_scale[:, b, :end].numpy(),
                np.asarray(jcache.k_scale)[:, b, :end], rtol=1e-5)
        else:
            np.testing.assert_allclose(tcache.k[:, b, :end].numpy(),
                                       np.asarray(jcache.k)[:, b, :end],
                                       atol=1e-5, rtol=0)


def test_verify_step_reproduces_sequential_decode(weights):
    """With the true greedy continuation as drafts the verify logits are
    the sequential decode's, the whole window is accepted, and a decode
    step after it continues as after the sequential steps."""
    _, tparams = weights
    smax = 32
    _, tcache, _ = _prefilled(weights, False, smax)
    tcache.lengths = torch.tensor([8, 5, 3], dtype=torch.int32)
    seq_cache = llama.KVCache(tcache.k.clone(), tcache.v.clone(),
                              tcache.lengths.clone())
    tok = torch.tensor([11, 12, 13])
    steps, logits = [tok], []
    for _ in range(4):
        lg, seq_cache = llama.decode_step(tparams, CFG, steps[-1], seq_cache)
        logits.append(lg)
        steps.append(lg.argmax(-1))
    window = torch.stack(steps[:4], 1)
    vl, vcache = llama.verify_step(tparams, CFG, window, tcache)
    np.testing.assert_allclose(vl.numpy(), torch.stack(logits, 1).numpy(),
                               atol=LOGIT_ATOL, rtol=0)
    greedy, _, accepted, emit = verify_epilogue(
        vl, window, torch.ones(3, dtype=torch.bool))
    assert accepted.tolist() == [3, 3, 3] and emit.tolist() == [4, 4, 4]
    vcache.lengths = vcache.lengths + emit.int()
    a, _ = llama.decode_step(tparams, CFG, steps[4], seq_cache)
    b, _ = llama.decode_step(tparams, CFG, steps[4], vcache)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=LOGIT_ATOL, rtol=0)


def test_verify_epilogue_accepts_the_agreeing_prefix():
    logits = torch.full((3, 4, 6), -1.0)
    for b, row in enumerate([[1, 2, 3, 4], [1, 5, 3, 4], [2, 2, 2, 2]]):
        for j, t in enumerate(row):
            logits[b, j, t] = 1.0
    window = torch.tensor([[0, 1, 2, 3], [0, 1, 2, 3], [0, 1, 2, 3]])
    greedy, lps, accepted, emit = verify_epilogue(
        logits, window, torch.tensor([True, True, False]))
    assert greedy[0].tolist() == [1, 2, 3, 4]
    assert accepted.tolist() == [3, 1, 0] and emit.tolist() == [4, 2, 0]
    np.testing.assert_allclose(
        lps.numpy(), torch.log_softmax(logits, -1).max(-1).values.numpy())


@pytest.mark.parametrize("quant", [False, True])
def test_paged_verify_step_matches_jax(weights, quant):
    """Both sides prefill the same prompts into their own pools, then
    one verify window of 5 whose rows cross a block boundary, and one
    slot whose window runs past the table's capacity (those rows go to
    the trash block): logits within atol, lengths unchanged, the pools
    equal (int8 codes bit for bit)."""
    jparams, tparams = weights
    slots, t, mb = 3, 16, 4
    cap = t * mb
    lens = [14, 4, cap - 2]
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, CFG.vocab_size, n).tolist() for n in lens]
    jdt, tdt = (jnp.int8, torch.int8) if quant else (None, None)
    jcache = jpaged.init_paged_cache(JCFG, slots, slots * mb + 1, t, jdt)
    tcache = paged_llama.init_paged_cache(CFG, slots, slots * mb + 1, t,
                                          dtype=tdt, device="cpu")
    table = np.zeros((slots, mb), np.int32)
    jrope = jllama.get_rope_tables(JCFG, cap)
    trope = llama.get_rope_tables(CFG, cap, "cpu")
    for b, prompt in enumerate(prompts):
        blocks = [1 + b * mb + j for j in range(mb)]   # every block owned
        table[b] = blocks
        n = len(prompt)
        _, jk, jv, _ = jllama.prefill_kv(jparams, JCFG,
                                         jnp.asarray([prompt], jnp.int32),
                                         rope_max=cap, rope_tables=jrope)
        jcache = jpaged.write_prompt_blocks(
            jcache, jk, jv, jnp.asarray(blocks[:-(-n // t)]), n)
        jcache = jcache._replace(lengths=jcache.lengths.at[b].set(n))
        _, tk, tv, _ = llama.prefill_kv(tparams, CFG, torch.tensor([prompt]),
                                        rope_tables=trope)
        paged_llama.write_prompt_blocks(tcache, tk, tv, blocks)
        tcache.lengths[b] = n
    window = rng.integers(1, CFG.vocab_size, (slots, 5))
    jl, jcache = jpaged.paged_verify_step(
        jparams, JCFG, jnp.asarray(window, jnp.int32), jcache,
        jnp.asarray(table), rope_tables=jrope, flash=False)
    paged_attention.reset_counts()
    tl, tcache = paged_llama.paged_verify_step(
        tparams, CFG, torch.from_numpy(window), tcache,
        torch.from_numpy(table), rope_tables=trope)
    assert paged_attention.window_plain_calls == CFG.n_layers
    assert paged_attention.plain_calls == 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    assert tcache.lengths.tolist() == lens
    if quant:
        np.testing.assert_array_equal(tcache.k[:, 1:].numpy(),
                                      np.asarray(jcache.k)[:, 1:])
        np.testing.assert_array_equal(tcache.v[:, 1:].numpy(),
                                      np.asarray(jcache.v)[:, 1:])
        np.testing.assert_allclose(tcache.v_scale[:, 1:].numpy(),
                                   np.asarray(jcache.v_scale)[:, 1:],
                                   rtol=1e-5)
    else:
        np.testing.assert_allclose(tcache.k[:, 1:].numpy(),
                                   np.asarray(jcache.k)[:, 1:], atol=1e-5,
                                   rtol=0)
    # the rows past capacity landed in the trash block, at the offsets
    # the positions give
    assert tcache.k[:, 0, :3].abs().sum() > 0
    paged_attention.reset_counts()


# -- the engine ----------------------------------------------------------------

REP = [7, 9, 7, 9, 7, 9, 7, 9, 7, 9]           # prompt-lookup hits
RND = np.random.default_rng(2).integers(1, 256, 12).tolist()
PAGED = {"paged_blocks": 9, "paged_block_size": 16}


def _jax_engine(weights, paged, kv_dtype, **kw):
    return JaxEngine(JCFG, weights[0], slots=2, max_seq=64,
                     decode_pipeline=1, prompt_buckets=(8, 16),
                     kv_dtype=jnp.int8 if kv_dtype is not None else None,
                     **(PAGED if paged else {}), **kw)


def _engine(weights, paged, kv_dtype, **kw):
    return GenerationEngine(CFG, weights[1], max_seq=64, device="cpu",
                            kv_dtype=kv_dtype, **{"slots": 2, **kw},
                            **(PAGED if paged else {}))


@pytest.mark.parametrize("kv_dtype", [None, torch.int8])
@pytest.mark.parametrize("paged", [False, True])
def test_spec_engine_streams_jax_and_specless_tokens(weights, paged,
                                                     kv_dtype):
    """Repetitive and random prompts: the port's spec engine streams the
    JAX spec engine's greedy tokens and its own spec-less engine's, with
    the same verify windows and emitted tokens as the JAX engine."""
    for prompt in (REP, RND):
        jeng = _jax_engine(weights, paged, kv_dtype, spec_decode_k=3)
        teng = _engine(weights, paged, kv_dtype, spec_decode_k=3)
        plain = _engine(weights, paged, kv_dtype)
        try:
            want = jeng.generate(prompt, max_new_tokens=24).tokens()
            got = teng.generate(prompt, max_new_tokens=24).tokens()
            assert got == want, f"prompt {prompt[:4]}..."
            assert plain.generate(prompt, max_new_tokens=24).tokens() == got
            st, jst = teng.stats()["spec_decode"], jeng.stats()["spec_decode"]
            assert (st["windows"], st["emitted"]) == \
                (jst["windows"], jst["emitted"])
            assert st["emitted"] >= st["windows"] > 0
            assert teng.verify_passes == st["windows"]  # one slot a pass
            if paged:
                assert teng.stats()["paged"] == jeng.stats()["paged"]
                assert teng.stats()["paged"]["free"] == 8
        finally:
            jeng.close()
            teng.close()
            plain.close()


@pytest.mark.parametrize("paged", [False, True])
def test_spec_concurrent_slots_and_eos(weights, paged):
    """Two slots under spec, one stopping at EOS mid-window: the streams
    are the spec-less engine's, the post-EOS window tokens discarded."""
    p1, p2 = [3, 1, 4, 3, 1, 4, 3, 1, 4], [2, 7, 2, 7, 2, 7]
    plain = _engine(weights, paged, None)
    try:
        want = {tuple(p): plain.generate(p, max_new_tokens=16).tokens()
                for p in (p1, p2)}
    finally:
        plain.close()
    eos = want[tuple(p1)][4]
    eng = _engine(weights, paged, None, spec_decode_k=4)
    try:
        s1 = eng.generate(p1, max_new_tokens=16, eos_id=eos)
        s2 = eng.generate(p2, max_new_tokens=16)
        assert s1.tokens() == want[tuple(p1)][:want[tuple(p1)].index(eos) + 1]
        assert s2.tokens() == want[tuple(p2)]
        assert eng.stats()["spec_decode"]["windows"] > 0
    finally:
        eng.close()


@pytest.mark.parametrize("paged", [False, True])
def test_sampling_slots_take_the_decode_path(weights, paged):
    """A sampled slot alone never verifies (the verify pass is greedy)
    and streams the spec-less engine's sampled tokens; beside it a
    greedy stream stays the spec-less engine's."""
    kw = dict(max_new_tokens=20, temperature=0.9, top_k=20, seed=4)
    plain = _engine(weights, paged, torch.int8)
    try:
        want_hot = plain.generate([1, 2, 3], **kw).tokens()
        want_cold = plain.generate(REP[:6], max_new_tokens=12).tokens()
    finally:
        plain.close()
    eng = _engine(weights, paged, torch.int8, spec_decode_k=3)
    try:
        assert eng.generate([1, 2, 3], **kw).tokens() == want_hot
        assert eng.stats()["spec_decode"]["windows"] == 0
        hot = eng.generate([1, 2, 3], **kw)
        cold = eng.generate(REP[:6], max_new_tokens=12)
        assert cold.tokens() == want_cold
        assert hot.tokens() == want_hot
    finally:
        eng.close()


@pytest.mark.parametrize("paged", [False, True])
def test_near_capacity_slots_take_the_decode_path(weights, paged):
    """A stream run to the cache edge retires as the spec-less engine's
    and the JAX spec engine's: no window is verified once it would write
    past capacity."""
    prompt = [5, 17, 42, 5, 17, 42]
    plain = _engine(weights, paged, None)
    jeng = _jax_engine(weights, paged, None, spec_decode_k=4)
    eng = _engine(weights, paged, None, spec_decode_k=4)
    try:
        want = plain.generate(prompt, max_new_tokens=200).tokens()
        assert len(want) == 64 - 1 - len(prompt)       # capacity-limited
        assert jeng.generate(prompt, max_new_tokens=200).tokens() == want
        assert eng.generate(prompt, max_new_tokens=200).tokens() == want
        st, jst = eng.stats()["spec_decode"], jeng.stats()["spec_decode"]
        assert (st["windows"], st["emitted"]) == \
            (jst["windows"], jst["emitted"])
    finally:
        plain.close()
        jeng.close()
        eng.close()


def test_spec_coverage_gate_mixed_workload(weights):
    """One repetitive stream among non-repetitive ones: every stream is
    the spec-less engine's, with the coverage gate deciding the ticks."""
    prompts = [[7, 9, 7, 9, 7, 9, 7, 9]] + [
        np.random.default_rng(s).integers(1, 256, n).tolist()
        for s, n in ((11, 10), (12, 9), (13, 11))]
    plain = _engine(weights, True, None, slots=4)
    try:
        want = [plain.generate(p, max_new_tokens=12).tokens()
                for p in prompts]
    finally:
        plain.close()
    eng = _engine(weights, True, None, slots=4, spec_decode_k=3)
    try:
        with eng._device_lock:   # admit the whole batch in one pass
            streams = [eng.generate(p, max_new_tokens=12) for p in prompts]
        assert [s.tokens() for s in streams] == want
    finally:
        eng.close()


@pytest.mark.parametrize("paged", [False, True])
def test_new_engine_from_config_honours_spec_decode(paged):
    rows = {"TPU_MODEL": "tiny", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "64",
            "TPU_KV_DTYPE": "int8", "TPU_DECODE_BLOCK": "2",
            "TPU_SPEC_DECODE": "3"}
    if paged:
        rows.update(TPU_PAGED_BLOCKS="9", TPU_PAGED_BLOCK="16")
    eng = new_engine_from_config(MapConfig(rows), device="cpu")
    try:
        toks = eng.generate(REP, max_new_tokens=12).tokens()
        assert len(toks) == 12
        st = eng.health_check().details["generator"]["spec_decode"]
        assert st["k"] == 3 and st["emitted"] >= st["windows"] > 0
    finally:
        eng.close()
