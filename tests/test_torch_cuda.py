"""The port's CUDA kernels on the card: each against its plain version at
odd shapes and every GQA group size the kernels take, the wrappers'
refusals on CUDA tensors they cannot take (an exception, never the plain
version), and the launch counters. The paged kernel also returns the
contiguous kernel's bits on the gathered view of its pool, and a paged
decode step the contiguous step's logits; its verify window (K3w) is
held against its plain version at every group size, at windows of 1,
2 and 5 and at 24 to 128 query rows a KV head, and returns the paged
decode's bits at a window of one. An
engine refuses at construction a model the kernels do not take. The
engine's decode block, captured as a CUDA graph, replays what an eager
call of the same block function computes (contiguous and paged,
sampling on and off, and after a prefill and a verify pass have moved
the cursors between replays); a dispatch returns before its block is
done; replays count their kernels' launches; and a body that cannot be
captured makes construction raise. The admission path is captured too:
K1 replays its eager bits inside a graph, each admission (a bucket
prefill, the chunk lattice, the paged write-back) replays what its
functions compute eagerly, and long prompts stream the same tokens with
interleave on and off and on a contiguous engine. They
need an NVIDIA card and skip without one; on the card run

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets up JAX, which this file
does not use).
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from gofr_tpu_torch.models import LLAMA_CONFIGS, llama, paged_llama
from gofr_tpu_torch.ops import flash, flash_decode, paged_attention
from gofr_tpu_torch.ops.quant import quantize_kv

pytestmark = pytest.mark.cuda

# as chip_smoke.py: bf16 outputs may part by about one bf16 step of the
# plain value plus a small absolute term
ATOL, RTOL = 1e-2, 2.0 ** -7


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16)


def _assert_close(got, want):
    diff = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    assert (diff <= ATOL + RTOL * want.float().abs()).all(), diff.max()


# The kernel's tiles are 128 query rows (two warpgroups of 64) by 128
# keys, in K and V rings of two stages: the cases sit on and around those
# edges, with 1, 2 (the ring's depth), 3 and 8 key tiles in a block's loop,
# a warpgroup whose rows are all padding, and an empty row.
@pytest.mark.parametrize("b,s,h,kv,lengths", [
    (1, 1, 8, 8, [1]), (2, 63, 8, 2, [63, 0]), (2, 65, 16, 2, [65, 64]),
    (3, 129, 32, 8, [1, 128, 129]), (1, 300, 4, 1, [257]),
    (1, 127, 8, 2, [127]), (1, 128, 8, 2, [128]), (1, 129, 8, 2, [129]),
    (1, 255, 8, 1, [255]), (1, 257, 8, 1, [257]), (2, 384, 8, 2, [256, 257]),
    (1, 200, 8, 2, [130]), (2, 1024, 8, 2, [1024, 700]),
    (3, 520, 16, 4, [520, 0, 385]),
])
def test_flash_prefill_kernel_matches_plain(gen, b, s, h, kv, lengths):
    q, k, v = (_randn(gen, b, s, h, 128), _randn(gen, b, s, kv, 128),
               _randn(gen, b, s, kv, 128))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    flash.reset_counts()
    got = flash.flash_prefill(q, k, v, lens)
    assert (flash.launches, flash.plain_calls) == (1, 0)
    # the plain version in float32 on the same bf16 values, as
    # chip_smoke.py holds it: in bf16 it rounds its own partial sums, and
    # at the longer shapes that error alone passes the tolerance
    _assert_close(got, flash.causal_prefill_plain(q.float(), k.float(),
                                                  v.float(), lens))
    for i, n in enumerate(lengths):
        assert not got[i, n:].any()


def test_flash_prefill_backward_matches_plain_autograd(gen):
    q, k, v = (_randn(gen, 2, 96, 8, 128), _randn(gen, 2, 96, 2, 128),
               _randn(gen, 2, 96, 2, 128))
    lens = torch.tensor([96, 50], dtype=torch.int32, device="cuda")
    g = _randn(gen, 2, 96, 8, 128)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (flash.FlashPrefill.apply(*leaves, lens) * g).sum().backward()
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    from gofr_tpu_torch.ops.attention import causal_attention

    mask = torch.arange(96, device="cuda")[None, :] < lens[:, None]
    (causal_attention(*ref, mask=mask) * g).sum().backward()
    for a, r in zip(leaves, ref):
        _assert_close(a.grad, r.grad)


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("h,kv", [(8, 8), (8, 4), (32, 8), (16, 2)])
def test_flash_decode_kernel_matches_plain(gen, quant, h, kv):
    lengths = [0, 1, 31, 32, 33, 100, 255, 256]
    b, smax = len(lengths), 256
    kc, vc = _randn(gen, b, smax, kv, 128), _randn(gen, b, smax, kv, 128)
    ks = vs = None
    if quant:
        (kc, ks), (vc, vs) = quantize_kv(kc), quantize_kv(vc)
    args = (_randn(gen, b, 1, h, 128), kc, vc, _randn(gen, b, 1, kv, 128),
            _randn(gen, b, 1, kv, 128),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"), ks, vs)
    flash_decode.reset_counts()
    got = flash_decode.flash_decode_appended(*args)
    assert (flash_decode.launches, flash_decode.plain_calls) == (1, 0)
    _assert_close(got, flash_decode.decode_plain(*args))
    # the empty slot is this step's value, exactly
    assert torch.equal(got[0, 0], args[4][0, 0].repeat_interleave(h // kv, 0))


def test_wrappers_raise_on_cuda_tensors_the_kernels_do_not_take(gen):
    q, k = _randn(gen, 1, 16, 8, 128), _randn(gen, 1, 16, 2, 128)
    lens = torch.tensor([16], dtype=torch.int32, device="cuda")
    flash.reset_counts()
    with pytest.raises(TypeError):
        flash.flash_prefill(q.float(), k.float(), k.float(), lens)
    with pytest.raises(ValueError):
        flash.flash_prefill(q[..., :64].contiguous(),
                            k[..., :64].contiguous(),
                            k[..., :64].contiguous(), lens)
    with pytest.raises(ValueError):
        flash.flash_prefill(q, k, k, lens.cpu())
    assert (flash.launches, flash.plain_calls) == (0, 0)

    qd = _randn(gen, 1, 1, 8, 128)
    cache = _randn(gen, 1, 16, 2, 128)
    new = _randn(gen, 1, 1, 2, 128)
    flash_decode.reset_counts()
    with pytest.raises(TypeError):     # a bf16 cache with scales
        flash_decode.flash_decode_appended(
            qd, cache, cache, new, new, lens,
            torch.ones(1, 16, 2, device="cuda"),
            torch.ones(1, 16, 2, device="cuda"))
    with pytest.raises(ValueError):    # H/KV = 3
        flash_decode.flash_decode_appended(
            _randn(gen, 1, 1, 6, 128), cache, cache, new, new, lens)
    with pytest.raises(ValueError):    # a cache in another layout
        flash_decode.flash_decode_appended(
            qd, cache.transpose(1, 2).contiguous().transpose(1, 2), cache,
            new, new, lens)
    assert (flash_decode.launches, flash_decode.plain_calls) == (0, 0)


def _shuffled_table(lengths, t, mb):
    """Clamped rows over a pool of B*MB + 1 blocks with interleaved,
    descending ids (no slot's blocks adjacent); length 0 keeps an
    all-trash row."""
    b = len(lengths)
    table = torch.zeros((b, mb), dtype=torch.int32)
    for i, n in enumerate(lengths):
        live = -(-n // t)
        for j in range(mb):
            if live:
                table[i, j] = 1 + (mb - 1 - min(j, live - 1)) * b + i
    return table.cuda(), b * mb + 1


def _paged_args(gen, lengths, t, mb, h, kv, quant):
    table, n = _shuffled_table(lengths, t, mb)
    kp, vp = _randn(gen, n, t, kv, 128), _randn(gen, n, t, kv, 128)
    ks = vs = None
    if quant:
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
    b = len(lengths)
    return (_randn(gen, b, 1, h, 128), kp, vp, _randn(gen, b, 1, kv, 128),
            _randn(gen, b, 1, kv, 128), table,
            torch.tensor(lengths, dtype=torch.int32, device="cuda"), ks, vs)


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("h,kv", [(8, 8), (8, 4), (32, 8), (16, 2)])
@pytest.mark.parametrize("t,mb", [(16, 16), (128, 4)])
def test_paged_decode_kernel_matches_plain(gen, quant, h, kv, t, mb):
    cap = mb * t
    lengths = [0, 1, t - 1, t, t + 1, cap // 2 + 3, cap - 1]
    args = _paged_args(gen, lengths, t, mb, h, kv, quant)
    paged_attention.reset_counts()
    got = paged_attention.paged_decode_attention(*args)
    assert (paged_attention.launches, paged_attention.plain_calls) == (1, 0)
    _assert_close(got, paged_attention.paged_attention_reference(*args))
    # the all-trash row of the empty slot returns this step's value
    assert torch.equal(got[0, 0], args[4][0, 0].repeat_interleave(h // kv, 0))
    # and the contiguous kernel on the gathered view gives the same bits
    q, kp, vp, kn, vn, table, lens, ks, vs = args

    def dense(x):
        return None if x is None else \
            paged_attention.gather_blocks(x, table).contiguous()

    contiguous = flash_decode.flash_decode_appended(
        q, dense(kp), dense(vp), kn, vn, lens, dense(ks), dense(vs))
    assert torch.equal(got, contiguous)


def test_paged_decode_ignores_table_entries_past_the_length(gen):
    """Entries past a slot's live blocks are never read: pointing them at
    other blocks, or past the pool, changes nothing."""
    lengths = [5, 40, 17]
    args = list(_paged_args(gen, lengths, 16, 4, 8, 2, True))
    want = paged_attention.paged_decode_attention(*args)
    table = args[5].clone()
    for i, n in enumerate(lengths):
        table[i, -(-n // 16):] = 10**6 if i % 2 else 1
    args[5] = table
    assert torch.equal(paged_attention.paged_decode_attention(*args), want)


# The decodes split a slot into chunks of SPLIT_CHUNK positions: lengths
# on and around the chunk edges, a slot at capacity and an empty one,
# through both kernels (the paged one at block sizes 16 and 128), against
# the plain version and bit for bit against each other.
@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("t", [16, 128])
def test_decodes_at_the_chunk_edges(gen, quant, t):
    c = flash_decode.SPLIT_CHUNK
    cap = 4 * c
    lengths = [0, c - 1, c, c + 1, 2 * c, cap]
    args = _paged_args(gen, lengths, t, cap // t, 32, 8, quant)
    flash_decode.reset_counts()
    paged_attention.reset_counts()
    got = paged_attention.paged_decode_attention(*args)
    _assert_close(got, paged_attention.paged_attention_reference(*args))
    q, kp, vp, kn, vn, table, lens, ks, vs = args

    def dense(x):
        return None if x is None else \
            paged_attention.gather_blocks(x, table).contiguous()

    rows = (q, dense(kp), dense(vp), kn, vn, lens, dense(ks), dense(vs))
    contiguous = flash_decode.flash_decode_appended(*rows)
    _assert_close(contiguous, flash_decode.decode_plain(*rows))
    assert torch.equal(got, contiguous)
    assert torch.equal(got[0, 0], vn[0, 0].repeat_interleave(4, 0))
    assert flash_decode.launches == paged_attention.launches == 1


def test_decodes_one_slot_of_4096(gen):
    """One slot at phase paged's TPU_MAX_SEQ, where the split spreads a
    single slot over 16 chunks."""
    args = _paged_args(gen, [4096], 128, 32, 32, 8, True)
    got = paged_attention.paged_decode_attention(*args)
    _assert_close(got, paged_attention.paged_attention_reference(*args))
    q, kp, vp, kn, vn, table, lens, ks, vs = args
    dense = [paged_attention.gather_blocks(x, table).contiguous()
             for x in (kp, vp, ks, vs)]
    assert torch.equal(got, flash_decode.flash_decode_appended(
        q, dense[0], dense[1], kn, vn, lens, dense[2], dense[3]))


def _good_paged(gen, quant=True):
    return list(_paged_args(gen, [3, 16], 16, 2, 8, 2, quant))


@pytest.mark.parametrize("case,error", [
    (lambda a: a.__setitem__(0, a[0].float()), TypeError),        # q dtype
    (lambda a: a.__setitem__(1, a[1].to(torch.bfloat16)), TypeError),
    (lambda a: a.__setitem__(7, None), ValueError),                # one scale
    (lambda a: a.__setitem__(0, a[0][:, :, :6].contiguous()), ValueError),
    (lambda a: a.__setitem__(1, a[1][:, :12].contiguous()), ValueError),
    (lambda a: a.__setitem__(5, a[5].long()), TypeError),          # table
    (lambda a: a.__setitem__(5, a[5][:1].contiguous()), ValueError),
    (lambda a: a.__setitem__(6, a[6].long()), TypeError),          # lengths
    (lambda a: a.__setitem__(7, a[7][:, :8].contiguous()), ValueError),
    (lambda a: a.__setitem__(
        1, a[1].transpose(1, 2).contiguous().transpose(1, 2)), ValueError),
    (lambda a: a.__setitem__(5, a[5].t().contiguous().t()), ValueError),
    (lambda a: a.__setitem__(5, a[5].cpu()), ValueError),          # device
    (lambda a: a.__setitem__(0, a[0][..., :64].contiguous()), ValueError),
])
def test_paged_wrapper_raises_on_cuda_tensors_the_kernel_does_not_take(
        gen, case, error):
    args = _good_paged(gen)
    case(args)
    paged_attention.reset_counts()
    with pytest.raises(error):
        paged_attention.paged_decode_attention(*args)
    assert (paged_attention.launches, paged_attention.plain_calls) == (0, 0)


def test_paged_decode_step_equals_decode_step_bit_for_bit(gen):
    """At small width (head_dim 128, G=2), the same prefill in contiguous
    rows and in a shuffled pool, then 8 decode steps through
    llama.decode_step (flash_decode) and paged_llama.paged_decode_step
    (paged_decode): equal logits, since the kernels visit positions in
    one order."""
    cfg = LLAMA_CONFIGS["llama3-8b"].with_(
        vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=1024, max_seq=512)
    params = llama.init(cfg, 0, device="cuda")
    smax, t = 256, 16
    lens = [100, 37, 1]
    b = len(lens)
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (b, 100), generator=g).cuda()
    steps = torch.randint(0, cfg.vocab_size, (8, b), generator=g).cuda()
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    rope = llama.get_rope_tables(cfg, smax, "cuda")
    table, n = _shuffled_table([x + len(steps) for x in lens], t, smax // t)
    flash_decode.reset_counts()
    paged_attention.reset_counts()
    with torch.no_grad():
        _, k, v, _ = llama.prefill_kv(params, cfg, tokens, lengths,
                                      rope_tables=rope, flash=True)
        rows = llama.init_cache(cfg, b, smax, dtype=torch.int8,
                                device="cuda")
        llama.write_kv(rows, k, v, lengths=lengths.clone())
        pool = paged_llama.init_paged_cache(cfg, b, n, t, dtype=torch.int8,
                                            device="cuda")
        host = table.cpu()
        for i, x in enumerate(lens):
            paged_llama.write_prompt_blocks(pool, k[:, i:i + 1, :x],
                                            v[:, i:i + 1, :x],
                                            host[i, :-(-x // t)].tolist())
        pool.lengths = lengths.clone()
        for step in steps:
            want, rows = llama.decode_step(params, cfg, step, rows, rope,
                                           flash=True)
            got, pool = paged_llama.paged_decode_step(params, cfg, step, pool,
                                                      table, rope)
            assert torch.equal(got, want)
    assert torch.equal(pool.lengths, rows.lengths)
    assert flash_decode.launches == paged_attention.launches == 8 * 2
    assert flash_decode.plain_calls == paged_attention.plain_calls == 0


def _window_args(gen, lengths, t, mb, h, kv, w, quant):
    args = list(_paged_args(gen, lengths, t, mb, h, kv, quant))
    b = len(lengths)
    args[0] = _randn(gen, b, w, h, 128)
    args[3] = _randn(gen, b, w, kv, 128)
    args[4] = _randn(gen, b, w, kv, 128)
    return args


def _f32(args):
    """The plain version's inputs: bf16 tensors in float32 (exact), the
    rest as they are, as chip_smoke.py evaluates the plain versions."""
    return [x.float() if x is not None and x.dtype == torch.bfloat16 else x
            for x in args]


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("h,kv", [(8, 8), (8, 4), (32, 8), (16, 2)])
@pytest.mark.parametrize("w", [1, 2, 5])
def test_paged_window_kernel_matches_plain(gen, quant, h, kv, w):
    """G = 1, 2, 4, 8 by W = 1, 2, 5 (row groups of 1 to 8 rows, up to
    five of them): lengths 0, on and around a block and a chunk edge,
    and at capacity less the window."""
    t, mb = 16, 40
    c = flash_decode.SPLIT_CHUNK
    lengths = [0, 1, t + 1, c - 1, c, c + 1, mb * t - w]
    args = _window_args(gen, lengths, t, mb, h, kv, w, quant)
    paged_attention.reset_counts()
    got = paged_attention.paged_window_attention(*args)
    assert (paged_attention.window_launches,
            paged_attention.window_plain_calls) == (1, 0)
    assert (paged_attention.launches, paged_attention.plain_calls) == (0, 0)
    assert got.shape == args[0].shape and got.dtype == torch.bfloat16
    _assert_close(got, paged_attention.paged_window_reference(*_f32(args)))


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("h,kv,w", [(64, 8, 3), (64, 8, 16), (32, 8, 2),
                                    (8, 1, 5)])
def test_paged_window_kernel_at_its_row_tiles(gen, quant, h, kv, w):
    """R = W*G query rows a KV head in 16-row tiles: 24 rows (a padded
    second tile), 128 (all eight tiles, eight warps), W=2 (one padded
    tile, 4 position slices) and 40 rows (three tiles); lengths on and
    around the chunk edges, an empty slot and one at capacity."""
    t, mb = 16, 40
    c = flash_decode.SPLIT_CHUNK
    lengths = [0, c - 1, c, c + 1, 2 * c, 2 * c + 1, mb * t]
    args = _window_args(gen, lengths, t, mb, h, kv, w, quant)
    paged_attention.reset_counts()
    got = paged_attention.paged_window_attention(*args)
    assert (paged_attention.window_launches,
            paged_attention.window_plain_calls) == (1, 0)
    assert got.shape == args[0].shape and got.dtype == torch.bfloat16
    _assert_close(got, paged_attention.paged_window_reference(*_f32(args)))


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("h,kv", [(8, 8), (8, 4), (32, 8), (16, 2)])
def test_paged_window_of_one_returns_the_paged_decode_bits(gen, quant, h,
                                                            kv):
    c = flash_decode.SPLIT_CHUNK
    args = _window_args(gen, [0, 5, c, c + 1, 2 * c + 7], 128, 4, h, kv, 1,
                        quant)
    want = paged_attention.paged_decode_attention(*args)
    assert torch.equal(paged_attention.paged_window_attention(*args), want)
    # and the empty slot attends its window alone: v_new
    assert torch.equal(want[0, 0], args[4][0, 0].repeat_interleave(h // kv,
                                                                    0))


def test_paged_window_refuses_what_it_does_not_take(gen):
    args = _window_args(gen, [3, 16], 16, 2, 8, 2, 17, True)
    paged_attention.reset_counts()
    with pytest.raises(ValueError, match="W=17"):
        paged_attention.paged_window_attention(*args)
    args = _window_args(gen, [3, 16], 16, 2, 8, 2, 4, True)
    args[3] = args[3][:, :3].contiguous()     # k_new of another window
    with pytest.raises(ValueError):
        paged_attention.paged_window_attention(*args)
    with pytest.raises(ValueError):           # the decode caller: W = 1
        paged_attention.paged_decode_attention(
            *_window_args(gen, [3, 16], 16, 2, 8, 2, 2, True))
    assert (paged_attention.window_launches, paged_attention.launches,
            paged_attention.window_plain_calls,
            paged_attention.plain_calls) == (0, 0, 0, 0)


@pytest.mark.parametrize("name,kw", [
    ("tiny", {}), ("llama-1b", {}),
    ("llama3-8b", {"paged_blocks": 9, "spec_decode_k": 16})])
def test_engine_refuses_at_construction_on_the_card(gen, name, kw):
    from gofr_tpu_torch.tpu import GenerationEngine

    before = torch.cuda.memory_allocated()
    with pytest.raises(ValueError, match=f"'{name}'"):
        GenerationEngine(LLAMA_CONFIGS[name], {}, slots=2, max_seq=64,
                         device="cuda", **kw)
    assert torch.cuda.memory_allocated() == before


# -- the decode block as a CUDA graph (tpu.generator) --------------------------

SMALL = LLAMA_CONFIGS["llama3-8b"].with_(
    vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
    ffn_dim=1024, max_seq=512)
# a replay and an eager call of the block run the same kernels on the same
# inputs: tokens, emitted mask, cursors and cache bytes are equal; the
# logprobs may part by float32 rounding if a library kernel picks another
# algorithm under capture
LOGPROB_ATOL = 1e-3


def _engine(paged: bool, **kw):
    from gofr_tpu_torch.tpu import GenerationEngine

    params = llama.init(SMALL, 0, device="cuda")
    args = dict(slots=3, max_seq=256, kv_dtype=torch.int8, decode_block=4,
                device="cuda")
    if paged:
        args.update(paged_blocks=3 * 16 + 1, paged_block_size=16)
    args.update(kw)
    return GenerationEngine(SMALL, params, **args)


def _random_state(eng, gen, lengths, draw):
    """Random cache contents, cursors at ``lengths`` and a dispatch pack
    with every slot live under host_wins (some sampling when ``draw``;
    paged: a shuffled clamped table over the pool), written into the
    engine's own tensors, the ones its graphs read."""
    from gofr_tpu_torch.tpu.generator import EOS_MAX, PACK_EXTRA

    c = eng.cache
    for t in (c.k, c.v):
        t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                              device="cuda", dtype=torch.int8))
    for t in (c.k_scale, c.v_scale):
        t.copy_(torch.rand(t.shape, generator=gen, device="cuda") * 0.02)
    c.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
    b = eng.n_slots
    p = eng._warm_pack()
    p[:, 0] = torch.randint(0, SMALL.vocab_size, (b,)).numpy()
    p[:, 1] = 1
    p[:, 2] = 100
    if draw:
        p[:, 3] = np.array([0.0, 0.8, 1.3][:b], np.float32).view(np.int32)
        p[:, 4] = [0, 20, 0][:b]
    p[:, 7] = np.arange(b) + 5
    p[:, 8] = 3
    if eng._paged:
        table, _ = _shuffled_table([x + 16 for x in lengths], 16, eng._mb)
        p[:, PACK_EXTRA + EOS_MAX:] = table.cpu().numpy()
    eng._pack.copy_(torch.from_numpy(p))


def _snapshot(eng):
    c = eng.cache
    cache = dataclasses.replace(
        c, k=c.k.clone(), v=c.v.clone(), lengths=c.lengths.clone(),
        k_scale=c.k_scale.clone(), v_scale=c.v_scale.clone())
    return cache, eng._pack.clone(), tuple(t.clone() for t in eng._carry)


def _replay_equals_eager(eng, draw):
    """Replay the engine's graph for ``draw``, run fused_decode_block
    eagerly on a copy of the state it started from, and compare."""
    from gofr_tpu_torch.tpu.generator import fused_decode_block

    cache, pack, carry = _snapshot(eng)
    graph, out, _ = eng._graphs[draw]
    graph.replay()
    got = out.clone()
    with torch.no_grad():
        want = fused_decode_block(eng.params, eng.cfg, cache, pack, carry,
                                  eng.rope_tables, steps=eng.decode_block,
                                  capacity=eng.max_seq - 2, draw=draw)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 0], want[:, 0])          # tokens
    assert torch.equal(got[:, 2], want[:, 2])          # emitted
    assert (got[:, 1] - want[:, 1]).abs().max() <= LOGPROB_ATOL
    c = eng.cache
    for a, b in ((c.lengths, cache.lengths), (c.k, cache.k), (c.v, cache.v),
                 (c.k_scale, cache.k_scale), (c.v_scale, cache.v_scale)):
        assert torch.equal(a, b)
    for a, b in zip(eng._carry, carry):
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("draw", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_graph_replay_equals_the_eager_block(gen, paged, draw):
    eng = _engine(paged)
    try:
        with eng._device_lock:
            _random_state(eng, gen, [40, 131, 0], draw)
            got = _replay_equals_eager(eng, draw)
            assert got[:, 2].all()   # every slot live, none stops
            eng._host_wins[:] = True
            eng._touch()
    finally:
        eng.close()


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_and_verify_between_replays_are_seen(gen, paged):
    """A prefill into a free slot and a verify pass write the cursors in
    place between two replays; the second replay must equal an eager
    block on a copy of the state they left (a graph bound to a stale
    cursor tensor would not)."""
    from gofr_tpu_torch.tpu.generator import GenStream, _Request

    eng = _engine(paged, spec_decode_k=2)
    try:
        with eng._device_lock:
            _random_state(eng, gen, [40, 131, 0], False)
            _replay_equals_eager(eng, False)
            prompt = np.arange(1, 30)
            blocks = eng._alloc.alloc(2) if paged else None
            eng._prefill(2, _Request(GenStream(0), prompt, 8, 0.0, 0, None,
                                     0), blocks)
            window = torch.randint(0, SMALL.vocab_size, (3, 3),
                                   device="cuda")
            table = eng._pack[:, -eng._mb:].to(torch.int32) \
                if paged else None
            if paged:
                table[2] = torch.tensor(eng._table[2], device="cuda")
            eng._verify(window, torch.ones(3, dtype=torch.bool,
                                           device="cuda"), table)
            lengths = eng.cache.lengths.tolist()
            assert lengths[2] > 29 and lengths[0] > 44
            if paged:
                eng._pack[:, -eng._mb:] = table.long()
            _replay_equals_eager(eng, False)
            eng._host_wins[:] = True
            eng._touch()
    finally:
        eng.close()


def test_a_dispatch_returns_before_its_block_completes(gen):
    """With the stream busy ahead of it, a decode dispatch (pack upload
    from pinned memory, replay, the copy of its output, its event)
    returns at once with its event not yet reached: nothing in it
    waits for the device."""
    from gofr_tpu_torch.tpu.generator import GenStream, _Request

    eng = _engine(False)
    try:
        with eng._device_lock:
            slot = eng._slots[0]
            slot.request = _Request(GenStream(0), np.arange(1, 4), 50, 0.0,
                                    0, None, 0)
            eng._active[0] = True
            eng._budgets[0] = 50
            eng._touch()
            eng.cache.lengths[0] = 3
            torch.cuda._sleep(2_000_000_000)   # about a second of the stream
            t0 = time.monotonic()
            inflight = eng._decode_tick()
            took = time.monotonic() - t0
            assert not inflight.ready() and took < 0.2
            inflight.done.synchronize()
            assert inflight.ready()
            eng._retire(0, slot)
    finally:
        eng.close()


@pytest.mark.parametrize("paged", [False, True])
def test_replays_count_their_kernel_launches(gen, paged):
    eng = _engine(paged)
    try:
        eng.generate([5, 9, 17], max_new_tokens=4).tokens()
        steps0, replays0 = eng.decode_steps, eng.graph_replays
        flash_decode.reset_counts()
        paged_attention.reset_counts()
        toks = eng.generate(list(range(1, 40)), max_new_tokens=21).tokens()
        steps = eng.decode_steps - steps0
        st = eng.stats()
    finally:
        eng.close()
    assert len(toks) == 21
    assert eng.graph_replays - replays0 == steps // 4 > 0
    decode = paged_attention if paged else flash_decode
    other = flash_decode if paged else paged_attention
    assert decode.launches == SMALL.n_layers * steps
    assert (decode.plain_calls, other.launches) == (0, 0)
    assert st["scheduler"]["pipeline"]["depth"] == 2


def test_construction_raises_when_capture_fails(gen, monkeypatch):
    """A block body that reads the device from the host cannot be
    captured: construction raises, and no eager path takes over."""
    from gofr_tpu_torch.tpu import generator

    body = generator.fused_decode_block

    def reads_the_host(*args, **kw):
        out = body(*args, **kw)
        out.sum().item()
        return out

    monkeypatch.setattr(generator, "fused_decode_block", reads_the_host)
    started = threading.active_count()
    with pytest.raises(RuntimeError, match="capturing the decode block"):
        _engine(False)
    assert threading.active_count() == started


# -- the admission path as CUDA graphs (tpu.generator) -------------------------

def test_flash_prefill_replays_in_a_graph_with_the_eager_bits(gen):
    """K1's shared-memory attribute is set once when its library loads,
    so a launch can sit inside a captured graph: the replay returns the
    eager call's bits."""
    q = _randn(gen, 1, 512, 32, 128)
    k, v = _randn(gen, 1, 512, 8, 128), _randn(gen, 1, 512, 8, 128)
    lens = torch.tensor([500], dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash.flash_prefill(q, k, v, lens)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash.flash_prefill(q, k, v, lens)
    graph.replay()
    want = flash.flash_prefill(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def _lattice_engine(paged: bool, **kw):
    """SMALL with buckets of 16 and 32, so a prompt past 32 runs the
    chunk lattice (mid chunks of 32)."""
    return _engine(paged, prompt_buckets=(16, 32), **kw)


@pytest.mark.parametrize("paged", [False, True])
def test_admission_replays_equal_their_eager_functions(gen, paged):
    """A bucket admission (one replay) and a lattice admission (three mid
    chunks, a final chunk and, paged, the write-back) through the
    engine's graphs, then the same admissions with each dispatch's
    function run eagerly on a copy of the state they started from: the
    same first token, cursors and cache bytes (and scratch row; a pool
    outside its trash block)."""
    from gofr_tpu_torch.tpu.generator import GenStream, _Request

    eng = _lattice_engine(paged)
    names = ["cache"] + (["_scratch"] if paged else [])
    rng = np.random.default_rng(3)

    def eager(key):
        with torch.no_grad():
            out = eng._admission_fn(key)()
        return None if out is None else (int(out[0]), float(out[1]))

    try:
        with eng._device_lock:
            for n, temp in ((30, 0.0), (100, 0.0), (100, 0.8)):
                for name in names:
                    c = getattr(eng, name)
                    for t in (c.k, c.v):
                        t.copy_(torch.randint(-127, 128, t.shape,
                                              generator=gen, device="cuda",
                                              dtype=torch.int8))
                    for t in (c.k_scale, c.v_scale):
                        t.copy_(torch.rand(t.shape, generator=gen,
                                           device="cuda") * 0.02)
                copies = {name: _snapshot_cache(getattr(eng, name))
                          for name in names}
                prompt = rng.integers(0, SMALL.vocab_size, n)
                blocks = (rng.choice(np.arange(1, 49), -(-n // 16),
                                     replace=False).tolist()
                          if paged else None)

                def admit():
                    return eng._prefill(1, _Request(
                        GenStream(0), prompt, 4, temp, 20, None, 9),
                        blocks and list(blocks))

                replays = eng.admission_replays
                got = admit()
                assert eng.admission_replays - replays == (
                    1 if n <= 32 else 3 + 1 + paged)
                real = {name: getattr(eng, name) for name in names}
                for name in names:
                    setattr(eng, name, copies[name])
                eng._run_admission = eager
                try:
                    want = admit()
                finally:
                    del eng._run_admission
                    for name in names:
                        setattr(eng, name, real[name])
                torch.cuda.synchronize()
                assert got[0] == want[0]
                assert abs(got[1] - want[1]) <= LOGPROB_ATOL
                for name in names:
                    a, b = real[name], copies[name]
                    assert torch.equal(a.lengths, b.lengths)
                    # the pool's trash block takes the write-back's rows
                    # routed nowhere, several to a position: whichever
                    # lands last stays, and nothing reads it
                    live = slice(1 if paged and name == "cache" else 0,
                                 None)
                    for x, y in ((a.k, b.k), (a.v, b.v), (a.k_scale,
                                 b.k_scale), (a.v_scale, b.v_scale)):
                        assert torch.equal(x[:, live], y[:, live])
    finally:
        eng.close()


def _snapshot_cache(c):
    return dataclasses.replace(
        c, k=c.k.clone(), v=c.v.clone(), lengths=c.lengths.clone(),
        k_scale=c.k_scale.clone(), v_scale=c.v_scale.clone())


@pytest.mark.parametrize("paged", [False, True])
def test_lattice_streams_through_replays_equal_the_contiguous_ones(gen,
                                                                   paged):
    """Long and short prompts served together: every admission is a
    replay (the counters show K1 only at bucket admissions), and the
    streams equal those of the same engine with interleave off and of a
    contiguous engine."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, SMALL.vocab_size, n).tolist()
               for n in (100, 20, 70, 31, 200)]
    outs = []
    for make in (lambda: _lattice_engine(paged),
                 lambda: _lattice_engine(paged, prefill_chunk=0),
                 lambda: _lattice_engine(False)):
        eng = make()
        try:
            eng.generate([5, 9, 17], max_new_tokens=4).tokens()
            adm0 = eng.admission_replays
            flash.reset_counts()
            streams = [eng.generate(p, max_new_tokens=12) for p in prompts]
            outs.append([s.tokens() for s in streams])
            chunks = [s.chunks for s in streams]
            replays = eng.admission_replays - adm0
        finally:
            eng.close()
        assert chunks == [3, 0, 2, 0, 6]
        assert flash.launches == SMALL.n_layers * 2
        assert flash.plain_calls == 0
        assert replays == 2 + sum(c + 1 + eng._paged for c in chunks if c)
    assert outs[0] == outs[1] == outs[2]


def test_construction_raises_when_an_admission_capture_fails(gen,
                                                              monkeypatch):
    from gofr_tpu_torch.tpu import generator

    body = generator.prefill_admission

    def reads_the_host(*args, **kw):
        out = body(*args, **kw)
        out.sum().item()
        return out

    monkeypatch.setattr(generator, "prefill_admission", reads_the_host)
    started = threading.active_count()
    with pytest.raises(RuntimeError, match="capturing the admission"):
        _engine(False)
    assert threading.active_count() == started
