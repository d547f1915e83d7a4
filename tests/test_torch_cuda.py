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
the cursors between replays), and so does the verify pass's graph; a
dispatch returns before its block is
done, and with the serving timeline on its reap appends one decode
event and nothing synchronises the device; replays count their
kernels' launches; a body that cannot be
captured makes construction raise, and a dead graph that the collector
frees meanwhile does not. The admission path is captured too:
K1 replays its eager bits inside a graph, each admission (a bucket
prefill, the chunk lattice, the paged write-back) replays what its
functions compute eagerly, and long prompts stream the same tokens with
interleave on and off and on a contiguous engine. The score program's
function runs K1 at a ragged batch and equals the plain attention, the
encoders' engines predict on the card, and an App on the card streams a
Generate over its gRPC server and frees the slot of a cancelled Chat.
The prefix tiers restore their stored int8 bytes through the pinned
staging upload and stream the same tokens from T1 and T2, and the memory
arbiter budgets the card and retries a real out-of-memory error. With
multi-LoRA, a replayed decode block, replayed admissions and a replayed
verify pass with mixed adapters equal their eager versions, and after
``load_adapter`` and a stream a replay reads the new weights (the graphs
bind the stacks' storage); repeated swaps and streams keep the replays
equal to the eager block, and no replay writes memory the allocator can
hand to another tensor; under a tenancy plane routing three tenants to
three adapters, a replay after a swap and a tenant's stream equals the
eager block too. A port gateway App over two replica Apps on the card
routes a request to its owner and resumes a cut stream on the other
replica. A P/D pair of Apps on the card (a prefill worker shipping int8
KV to a decode worker) streams what the decode worker's own fused
serving answers, for a bucket prompt and a lattice one. A CLI App
(``new_cmd``) at Llama-3-8B's width runs a ``generate`` sub-command
through K1 and K2 and prints what a direct ``generate`` returns. They
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


def test_score_runs_k1_at_a_batch_and_equals_the_plain_attention(gen):
    """The score program's function at a batch of 8 ragged rows, one of
    length 0: one K1 launch a layer and no plain call, the last-row
    logits within the plain attention's (chip_smoke.py's LOGIT_ATOL)."""
    params = llama.init(SMALL, 0, device="cuda")
    tokens = torch.randint(0, SMALL.vocab_size, (8, 64), generator=gen,
                           device="cuda", dtype=torch.int32)
    lengths = torch.tensor([64, 60, 33, 32, 17, 9, 1, 0], dtype=torch.int32,
                           device="cuda")
    flash.reset_counts()
    with torch.inference_mode():
        got = llama.score(params, SMALL, tokens, lengths, flash=True)
        assert (flash.launches, flash.plain_calls) == (SMALL.n_layers, 0)
        want = llama.score(params, SMALL, tokens, lengths, flash=False)
    assert got.shape == (8, SMALL.vocab_size) and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 0.1


@pytest.mark.parametrize("model", ["tiny", "bert-tiny", "vit-tiny"])
def test_new_engine_from_config_on_the_card(gen, model):
    """A float32 Llama model is refused before anything is allocated
    (its score program would need K1); the encoders' programs run on
    the card through the batcher."""
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.tpu import new_engine_from_config

    rows = MapConfig({"TPU_MODEL": model, "TPU_SEQ_BUCKETS": "8,16"})
    if model == "tiny":
        before = torch.cuda.memory_allocated()
        with pytest.raises(ValueError, match="cannot be scored on cuda"):
            new_engine_from_config(rows, device="cuda")
        assert torch.cuda.memory_allocated() == before
        return
    eng = new_engine_from_config(rows, device="cuda")
    try:
        (name,) = eng._programs
        item = (np.arange(1, 12, dtype=np.int32) if model == "bert-tiny"
                else np.ones((28, 28, 3), np.float32))
        out = eng.predict(name, item)
        assert out.dtype == np.float32 and np.isfinite(out).all()
        assert eng.health_check().details["platform"] == "gpu"
    finally:
        eng.close()


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
    p[:, 0] = torch.randint(0, SMALL.vocab_size, (b,), generator=gen,
                            device="cuda").cpu().numpy()
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
    eagerly on a copy of the state it started from (through the
    adapters of the pack's column 5 on a LoRA engine), and compare."""
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
            blocks = ([], 0, eng._alloc.alloc(2)) if paged else None
            eng._prefill(2, _Request(GenStream(0), prompt, 8, 0.0, 0, None,
                                     0), blocks)
            window = torch.randint(0, SMALL.vocab_size, (3, 3),
                                   device="cuda")
            table = eng._pack[:, -eng._mb:].clone() if paged else None
            if paged:
                table[2] = torch.tensor(eng._table[2], device="cuda")
            _verify_inputs(eng, window, table)
            _, done = eng._run_verify()   # one replay of the verify graph
            done.synchronize()
            lengths = eng.cache.lengths.tolist()
            assert lengths[2] > 29 and lengths[0] > 44
            if paged:
                eng._pack[:, -eng._mb:] = table
            _replay_equals_eager(eng, False)
            eng._host_wins[:] = True
            eng._touch()
    finally:
        eng.close()


def _verify_inputs(eng, window, table=None, adapters=None):
    """Write one verify pass's inputs into the engine's own tensor, the
    one its verify graph reads: the window, every slot active, (paged)
    the table, then each slot's adapter (``adapters``, else 0)."""
    w = window.shape[1]
    buf = eng._verify_in
    buf[:, :w] = window
    buf[:, w] = 1
    if table is not None:
        buf[:, w + 1:-1] = table
    buf[:, -1] = 0 if adapters is None else adapters


@pytest.mark.parametrize("paged", [False, True])
def test_verify_replay_equals_the_eager_pass(gen, paged):
    """The verify pass captured as a CUDA graph (the port of
    ``_verify_jit``) replays what ``verify_pass`` computes eagerly on a
    copy of the state it started from: tokens, emit, the cursors and
    the cache bytes bit for bit, the logprobs within LOGPROB_ATOL (as
    for the decode block); a replay adds its
    capture's window launches (paged) to the counter."""
    from gofr_tpu_torch.tpu.generator import verify_pass

    eng = _engine(paged, spec_decode_k=4)
    try:
        with eng._device_lock:
            _random_state(eng, gen, [40, 131, 0], False)
            window = torch.randint(0, SMALL.vocab_size, (3, 5),
                                   device="cuda", generator=gen)
            table = eng._pack[:, -eng._mb:].clone() if paged else None
            _verify_inputs(eng, window, table)
            cache, _, _ = _snapshot(eng)
            inputs = eng._verify_in.clone()
            before = paged_attention.window_launches
            graph, out, _ = eng._verify_graph
            host, done = eng._run_verify()
            done.synchronize()
            got = torch.from_numpy(host.numpy().copy())
            assert paged_attention.window_launches - before == \
                (SMALL.n_layers if paged else 0)
            with torch.no_grad():
                want = verify_pass(
                    eng.params, eng.cfg, cache, inputs[:, :5],
                    inputs[:, 5].bool(),
                    inputs[:, 6:-1].to(torch.int32) if paged else None,
                    eng.rope_tables).cpu()
            torch.cuda.synchronize()
            assert torch.equal(got[:, :5], want[:, :5])     # tokens
            assert torch.equal(got[:, 10], want[:, 10])     # emit
            assert (got[:, 5:10] - want[:, 5:10]).abs().max() <= \
                LOGPROB_ATOL
            assert (got[:, 10] >= 1).all()   # every slot emits
            c = eng.cache
            for a, b in ((c.lengths, cache.lengths), (c.k, cache.k),
                         (c.v, cache.v), (c.k_scale, cache.k_scale),
                         (c.v_scale, cache.v_scale)):
                assert torch.equal(a, b)
            assert eng.verify_replays == 1
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


def test_a_timeline_on_decode_replay_appends_one_event_without_a_sync(
        gen, monkeypatch):
    """With an Observe bundle's timeline on, a decode block is still one
    graph replay whose dispatch returns before the block completes; its
    reap, waiting on the block's event as it always does, appends one
    ``decode`` event (the slots as dispatched, K steps, dispatch to
    reap), and no ``torch.cuda.synchronize`` runs on the way."""
    from gofr_tpu_torch.observe import Observe
    from gofr_tpu_torch.tpu.generator import GenStream, _Request

    obs = Observe()
    eng = _engine(False, observe=obs)
    syncs = []
    try:
        assert eng._tl is obs.timeline
        with eng._device_lock:
            slot = eng._slots[0]
            slot.request = _Request(GenStream(0), np.arange(1, 4), 50, 0.0,
                                    0, None, 0)
            slot.request.stream.trace["submit"] = time.monotonic()
            slot.generated, slot.remaining = 1, 49
            eng._active[0] = True
            eng._budgets[0] = 49
            eng._touch()
            eng.cache.lengths[0] = 3
            seq0 = obs.timeline.stats()["total_recorded"]
            replays0 = eng.graph_replays
            real = torch.cuda.synchronize
            monkeypatch.setattr(torch.cuda, "synchronize",
                                lambda *a, **k: syncs.append(a)
                                or real(*a, **k))
            torch.cuda._sleep(2_000_000_000)   # about a second of the stream
            inflight = eng._decode_tick()
            assert not inflight.ready()

            def decodes():
                return [e for e in obs.timeline.events()
                        if e[0] >= seq0 and e[3] == "decode"]

            assert decodes() == []             # emitted at the reap
            inflight.reap(False)
            monkeypatch.undo()
            (event,) = decodes()
            assert event[4] == (0,) and event[5] == eng.decode_block
            assert event[2] > 0
            assert eng.graph_replays == replays0 + 1 and syncs == []
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
                        blocks and ([], 0, list(blocks)))

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


def test_a_graph_left_in_a_cycle_does_not_break_a_capture(gen,
                                                         monkeypatch):
    """A CUDA graph destroyed while another is being captured invalidates
    that capture. A closed engine's graphs can sit in a reference cycle
    (a traceback's frame, an engine and its batchers) until Python's
    collector runs. Here a graph becomes such garbage in the middle of
    an admission capture, with the collector set to run at nearly every
    allocation: the engine must still capture every graph."""
    import gc

    from gofr_tpu_torch.tpu import generator

    class Cycle:
        pass

    x = torch.ones(64, device="cuda")
    dead = torch.cuda.CUDAGraph()
    with torch.cuda.graph(dead):
        y = x * 2
    dead.replay()
    pending = [(dead, y)]
    del dead, y
    body = generator.prefill_admission

    def drops_a_graph(*args, **kw):
        if pending and torch.cuda.is_current_stream_capturing():
            holder = Cycle()
            holder.self, holder.graph = holder, pending.pop()
            del holder   # garbage the collector's next pass frees
        return body(*args, **kw)

    monkeypatch.setattr(generator, "prefill_admission", drops_a_graph)
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        eng = _engine(False)
    finally:
        gc.set_threshold(*threshold)
    try:
        assert not pending and eng._graphs and eng._adm_graphs
    finally:
        eng.close()
    gc.collect()


# -- durable streams: the read-back graph, pos_base, recovery ------------------

def test_the_read_back_graph_equals_read_blocks_to_row(gen):
    """A prefix hit's read-back (readback_admission) captured in a graph
    and replayed, at phase durable's shapes (Llama-3-8B's KV: a 257-block
    int8 pool of 128 and a 4096-position scratch row; 12 shared blocks
    spread over the pool), against read_blocks_to_row run eagerly on a
    copy of the row: the same bytes. The ids come through the input
    vector, so a second replay with other ids follows them."""
    from gofr_tpu_torch.tpu.generator import (AdmissionInputs, GenStream,
                                              _Request, readback_admission)

    cfg = LLAMA_CONFIGS["llama3-8b"]
    pool = paged_llama.init_paged_cache(cfg, 32, 257, 128,
                                        dtype=torch.int8, device="cuda")
    for t in (pool.k, pool.v):
        t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                              device="cuda", dtype=torch.int8))
    for t in (pool.k_scale, pool.v_scale):
        t.copy_(torch.rand(t.shape, generator=gen, device="cuda"))
    row = llama.init_cache(cfg, 1, 4096, dtype=torch.int8, device="cuda")
    mb = 4096 // 128
    inp = AdmissionInputs(mb, 512, "cuda")
    req = _Request(GenStream(0), np.zeros(0, np.int64), 1, 0.0, 0, None, 0)
    host = np.empty(tuple(inp.buf.shape), np.int64)

    def upload(blocks):
        inp.pack(host, (), length=0, slot=0, start=0, logit_pos=0,
                 temp=0.0, top_k=0, seed=req.seed,
                 blocks=blocks + [0] * (mb - len(blocks)))
        inp.buf.copy_(torch.from_numpy(host))

    upload([])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        readback_admission(pool, row, inp)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        readback_admission(pool, row, inp)
    rng = np.random.default_rng(4)
    for _ in range(2):
        shared = rng.choice(np.arange(1, 257), 12, replace=False).tolist()
        upload(shared)
        want = _snapshot_cache(row)
        graph.replay()
        paged_llama.read_blocks_to_row(want, pool, shared + [0] * (mb - 12))
        torch.cuda.synchronize()
        for a, b in ((row.k, want.k), (row.v, want.v),
                     (row.k_scale, want.k_scale),
                     (row.v_scale, want.v_scale)):
            assert torch.equal(a, b)
        assert torch.equal(row.k[:, 0, 128:256], pool.k[:, shared[1]])


@pytest.mark.parametrize("paged", [False, True])
def test_replays_with_a_pos_base_equal_their_eager_functions(gen, paged):
    """A continuation's first token is sampled at its absolute position
    pos_base, a device input of the prefill and final-chunk graphs: a
    bucket admission and a lattice admission of a sampled request with
    pos_base 7 replay what their functions compute eagerly, and a
    sampled first token follows pos_base (not a constant of the
    graph)."""
    from gofr_tpu_torch.tpu.generator import GenStream, _Request

    eng = _lattice_engine(paged)
    rng = np.random.default_rng(8)

    def eager(key):
        with torch.no_grad():
            out = eng._admission_fn(key)()
        return None if out is None else (int(out[0]), float(out[1]))

    try:
        with eng._device_lock:
            for n in (30, 70):
                prompt = rng.integers(0, SMALL.vocab_size, n)
                firsts = {}
                for pos_base in (0, 1, 2, 3, 7, 7):
                    blocks = ([], 0, list(range(1, 1 + -(-n // 16)))) \
                        if paged else None
                    req = _Request(GenStream(0), prompt, 4, 1.5, 0, None, 9,
                                   pos_base=pos_base)
                    if pos_base in firsts:
                        eng._run_admission = eager
                        try:
                            want = eng._prefill(1, req, blocks)
                        finally:
                            del eng._run_admission
                        assert want[0] == firsts[pos_base][0]
                        assert abs(want[1] - firsts[pos_base][1]) <= \
                            LOGPROB_ATOL
                    else:
                        firsts[pos_base] = eng._prefill(1, req, blocks)
                # the same logits, other draws: over a 512-token
                # vocabulary at temperature 1.5 five positions do not
                # all draw one token
                assert len({f[0] for f in firsts.values()}) > 1, n
                if paged:
                    eng._slot_blocks[1] = []
    finally:
        eng.close()


@pytest.mark.parametrize("paged", [False, True])
def test_a_recovery_between_replays_keeps_the_graphs(gen, paged):
    """A failed step between two replays of the decode graph: the reset
    zeroes the cache (and pack, carry, scratch row, admission inputs) in
    place, keeps every captured graph, and the next replay still reads
    and writes the engine's tensors (it equals an eager block on a copy
    of the state)."""
    from gofr_tpu_torch import chaos

    eng = _lattice_engine(paged, prefix_cache_slots=2 if paged else 0)
    try:
        with eng._device_lock:
            _random_state(eng, gen, [40, 131, 0], False)
            _replay_equals_eager(eng, False)
            eng._host_wins[:] = True
            eng._touch()
            graphs = (dict(eng._graphs), dict(eng._adm_graphs))
            ptrs = [t.data_ptr() for t in eng._device_tensors()]
        sched = chaos.ChaosSchedule(seed=0).on(
            chaos.GENERATOR_STEP, error=chaos.DeviceLost, every=1, limit=1)
        with chaos.scope(sched):
            with pytest.raises(Exception, match="DeviceLost"):
                eng.generate(list(range(1, 40)), max_new_tokens=8).tokens()
        with eng._device_lock:
            assert eng.down is None and eng.stats()["recoveries"] == 1
            assert (eng._graphs, eng._adm_graphs) == graphs
            tensors = eng._device_tensors()
            assert [t.data_ptr() for t in tensors] == ptrs
            assert not any(bool(t.any()) for t in tensors)
            _random_state(eng, gen, [17, 0, 90], True)
            _replay_equals_eager(eng, True)
            eng._host_wins[:] = True
            eng._touch()
        assert len(eng.generate([5, 9, 17], max_new_tokens=6).tokens()) == 6
    finally:
        eng.close()


# -- the gRPC transport over an App on the card (grpcx) --------------------------

def test_an_app_on_the_card_streams_generate_and_frees_a_cancelled_chat(
        gen, monkeypatch):
    """A ``gofr_tpu_torch.App`` on "cuda" (one slot, a small bf16 Llama
    from its rows) serves the token-streaming example's service over its
    own gRPC server: a Generate streams the tokens a direct ``generate``
    returns, and a Chat turn cancelled after its first token gives the
    only slot back, so a fresh Generate is served."""
    from gofr_tpu_torch import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.grpcx import GRPCService, ServerStream, dial

    monkeypatch.setitem(LLAMA_CONFIGS, "llama-small", SMALL)
    app = App(MapConfig({"GRPC_PORT": "0", "METRICS_PORT": "0",
                         "LOG_LEVEL": "WARN", "TPU_MODEL": "llama-small",
                         "TPU_SLOTS": "1", "TPU_MAX_SEQ": "256",
                         "TPU_SEQ_BUCKETS": "16,32"}))
    llm = GRPCService("llm.Generation")

    @llm.server_stream("Generate")
    def generate(ctx, req):
        return ServerStream(ctx.tpu.generate(
            req["tokens"], max_new_tokens=req["max_new_tokens"]),
            lambda t: {"token": t})

    @llm.bidi_stream("Chat")
    def chat(ctx, requests):
        for req in requests:
            stream = ctx.tpu.generate(req["tokens"],
                                      max_new_tokens=req["max_new_tokens"])
            try:
                for tok in stream:
                    yield {"token": tok}
            finally:
                stream.cancel()
            yield {"turn_done": True}

    app.register_grpc_service(llm)
    app.run(block=False)
    engine = app.container.tpu.generator
    ch = dial(f"127.0.0.1:{app.grpc_port}")
    try:
        assert engine.device.type == "cuda"
        prompt = [int(x) for x in torch.randint(
            1, SMALL.vocab_size, (19,), generator=gen, device="cuda")]
        got = [m["token"] for m in ch.server_stream(
            "/llm.Generation/Generate",
            {"tokens": prompt, "max_new_tokens": 12}, timeout=120.0)]
        want = app.container.tpu.generate(prompt, max_new_tokens=12).tokens()
        assert got == want and len(got) == 12
        call = ch.bidi_stream("/llm.Generation/Chat", timeout=120.0)
        call.send({"tokens": prompt[:7], "max_new_tokens": 200})
        assert "token" in next(iter(call))
        call.cancel()
        end = time.monotonic() + 10
        while engine.stats()["active"] and time.monotonic() < end:
            time.sleep(0.005)
        assert engine.stats()["active"] == 0
        again = [m["token"] for m in ch.server_stream(
            "/llm.Generation/Generate",
            {"tokens": prompt, "max_new_tokens": 12}, timeout=120.0)]
        assert again == want
    finally:
        ch.close()
        app.stop()


def test_a_gateway_over_two_replicas_on_the_card(gen, monkeypatch):
    """A port gateway App (``TPU_SERVING_ROLE=gateway``, no engine) over
    two ``gofr_tpu_torch.App`` replicas on "cuda" (a small bf16 Llama
    from seed 0 each, POST /generate): a greedy request through the
    gateway streams what its owner answers directly, and a relay cut
    after 5 tokens (the GATEWAY_MIDSTREAM seam) is resumed on the other
    replica: one stream, cursors without a gap, equal to the first 5
    tokens plus that replica's own answer to the continuation."""
    import json
    import urllib.request

    from gofr_tpu_torch import App, chaos
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.serving import install_generate
    from gofr_tpu_torch.tpu.kvcache import first_block_hash

    monkeypatch.setitem(LLAMA_CONFIGS, "llama-small", SMALL)
    rows = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "WARN",
            "TPU_MODEL": "llama-small", "TPU_SLOTS": "2",
            "TPU_MAX_SEQ": "256", "TPU_SEQ_BUCKETS": "16,32,64",
            "TPU_KVCACHE_BLOCK": "16"}
    reps, gw = [], None

    def post(port, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps(body).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return [json.loads(x) for x in r.read().splitlines() if x]

    try:
        for i in range(2):
            app = App(MapConfig(dict(rows, APP_NAME=f"replica-{i}")))
            install_generate(app)
            app.run(block=False)
            reps.append(app)
        assert all(a.container.tpu.generator.device.type == "cuda"
                   for a in reps)
        gw = App(MapConfig({
            "HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "WARN",
            "TPU_SERVING_ROLE": "gateway", "TPU_GATEWAY_BLOCK": "16",
            "TPU_GATEWAY_REPLICAS": ",".join(
                f"127.0.0.1:{a.http_port}" for a in reps)}))
        gw.run(block=False)
        assert gw.container.tpu is None
        prompt = [int(x) for x in torch.randint(
            1, SMALL.vocab_size, (40,), generator=gen, device="cuda")]
        body = {"tokens": prompt, "max_new": 16}
        owner = gw._gateway.router.ring.order(first_block_hash(prompt, 16))
        direct = post(reps[owner[0]].http_port, body)
        assert [ln["token"] for ln in post(gw.http_port, body)] == \
            [ln["token"] for ln in direct]
        sched = chaos.ChaosSchedule(seed=0).on(
            chaos.GATEWAY_MIDSTREAM, error=RuntimeError, every=5, limit=1)
        with chaos.scope(sched):
            lines = post(gw.http_port, body)
        assert not any("error" in ln for ln in lines)
        assert [ln["cursor"] for ln in lines] == list(range(16))
        toks = [ln["token"] for ln in lines]
        cont = post(reps[owner[1]].http_port, dict(
            body, resume_from=5, emitted=toks[:5]))
        assert toks == toks[:5] + [ln["token"] for ln in cont]
        assert gw._gateway.resumes == 1
    finally:
        if gw is not None:
            gw.stop()
        for app in reps:
            app.stop()


def test_a_pd_pair_on_the_card_equals_fused_serving(gen, monkeypatch):
    """A decode-role ``gofr_tpu_torch.App`` (``TPU_SERVING_ROLE=decode``,
    ``TPU_PD_LISTEN`` on port 0) and a prefill-role one pointed at it, on
    "cuda" with the small bf16 Llama from seed 0 and an int8 cache: a
    greedy request to the prefill worker's POST /generate (a bucket
    prompt, then one past the largest bucket, shipped mid-lattice)
    streams what the decode worker answers on its own, fused, and a
    seeded sampled one too."""
    import json
    import urllib.request

    from gofr_tpu_torch import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.serving import install_generate

    monkeypatch.setitem(LLAMA_CONFIGS, "llama-small", SMALL)
    rows = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "WARN",
            "TPU_MODEL": "llama-small", "TPU_SLOTS": "2",
            "TPU_MAX_SEQ": "256", "TPU_SEQ_BUCKETS": "16,32,64"}
    apps = []

    def post(port, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps(body).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return [json.loads(x)["token"] for x in r.read().splitlines()
                    if x]

    try:
        dec = App(MapConfig(dict(rows, APP_NAME="decode",
                                 TPU_SERVING_ROLE="decode",
                                 TPU_PD_LISTEN="127.0.0.1:0")))
        install_generate(dec)
        dec.run(block=False)
        apps.append(dec)
        port = dec.container.tpu.pd_ingest.port
        pre = App(MapConfig(dict(rows, APP_NAME="prefill",
                                 TPU_SERVING_ROLE="prefill",
                                 TPU_PD_PEER=f"127.0.0.1:{port}")))
        install_generate(pre)
        pre.run(block=False)
        apps.append(pre)
        for app in apps:
            assert app.container.tpu.generator.device.type == "cuda"
        for n, extra in ((40, {}), (150, {}),
                         (40, {"temperature": 0.8, "top_k": 50, "seed": 7})):
            prompt = [int(x) for x in torch.randint(
                1, SMALL.vocab_size, (n,), generator=gen, device="cuda")]
            body = {"tokens": prompt, "max_new": 16, **extra}
            got = post(pre.http_port, body)
            assert got == post(dec.http_port, body) and len(got) == 16
        assert pre.container.tpu.pd_prefill.stats()["relayed"] == 3
        assert dec.container.tpu.health_check().details["pd"]["ingests"] == 3
    finally:
        for app in reversed(apps):
            app.stop()


# -- the prefix tiers and the memory arbiter on the card ----------------------

def test_the_prefix_tiers_restore_the_stored_bytes_on_the_card(gen):
    """A contiguous engine with one T0 row, a host tier and a shared tier
    on the port's FakeRedisServer: two stored prompts (a 64-token system
    prompt and a first turn) stream an untiered engine's tokens and push
    the first into host RAM; a follow-up of each is a T1 hit whose
    promotion uploads the snapshot through the pinned staging, landing
    its int8 codes and scales in the pool row; a fresh engine's T2 hits
    of the same follow-ups stream the same tokens as those T1 hits."""
    from gofr_tpu_torch.datasource.redisclient import RedisClient
    from gofr_tpu_torch.testutil.redisfake import FakeRedisServer
    from gofr_tpu_torch.tpu.kvcache import KVCacheOptions

    rng = np.random.default_rng(9)
    systems = [rng.integers(1, SMALL.vocab_size, 64).tolist()
               for _ in range(2)]
    first = [s + rng.integers(1, SMALL.vocab_size, 20).tolist()
             for s in systems]
    follow = [s + rng.integers(1, SMALL.vocab_size, 12).tolist()
              for s in systems]
    plain = _lattice_engine(False)
    try:
        want = [plain.generate(p, max_new_tokens=8).tokens() for p in first]
    finally:
        plain.close()
    srv = FakeRedisServer()

    def tiered():
        # follow-ups (76 tokens) stay under the store minimum
        return _lattice_engine(False, prefix_cache_slots=1,
                               prefix_store_min=80,
                               kvcache=KVCacheOptions(
                                   host_mb=64,
                                   redis=RedisClient(srv.host, srv.port)))

    try:
        eng = tiered()
        try:
            assert [eng.generate(p, max_new_tokens=8).tokens()
                    for p in first] == want
            hits, promoted = [], []
            for i in range(2):
                s = eng.generate(follow[i], max_new_tokens=8)
                hits.append((s.tokens(), s.cache_tier, s.cache_tokens))
                entry, _ = eng._kvc.host.match(np.asarray(first[i]))
                row = eng._kvc.t0.match(np.asarray(first[i]))[0].row
                kv = entry.payload
                promoted.append(all(
                    torch.equal(d[:, row, :kv.plen].cpu(), h)
                    for d, h in zip(eng._planes(eng._pool),
                                    eng._planes(kv))))
        finally:
            eng.close()
        assert [h[1:] for h in hits] == [("t1", 64)] * 2 and all(promoted)
        eng = tiered()
        try:
            again = []
            for p in follow:
                s = eng.generate(p, max_new_tokens=8)
                again.append((s.tokens(), s.cache_tier, s.cache_tokens))
        finally:
            eng.close()
        assert [a[1:] for a in again] == [("t2", 64)] * 2
        assert [a[0] for a in again] == [h[0] for h in hits]
    finally:
        srv.close()


def test_the_arbiter_budgets_the_card_and_retries_a_real_oom(gen):
    """The budget resolves from the card's memory less the headroom; an
    allocation that fails with torch.OutOfMemoryError once is retried
    after a reclaim, and one the card can never hold (twice its memory,
    no budget to refuse the lease first) sheds as HBMExhausted."""
    from gofr_tpu_torch.tpu import hbm

    hbm.reset()
    try:
        _, total = torch.cuda.mem_get_info()
        assert hbm.configure(headroom=0.1, device="cuda") == int(total * 0.9)
        tries = []

        def flaky():
            tries.append(1)
            if len(tries) == 1:
                raise torch.OutOfMemoryError("CUDA out of memory (injected)")
            return torch.zeros((1024,), device="cuda")

        owner = object()
        got = hbm.alloc("engine", flaky, nbytes=4096, owner=owner, tag="x")
        assert got.is_cuda and len(tries) == 2
        assert hbm.arbiter_stats()["oom_retries"] == {"engine": 1}
        hbm.set_budget(None)
        with pytest.raises(hbm.HBMExhausted):
            hbm.alloc("engine", lambda: torch.empty(
                (2 * total,), dtype=torch.uint8, device="cuda"),
                owner=owner, tag="huge")
        assert hbm.arbiter_stats()["oom_retries"] == {"engine": 2}
        assert hbm.live_bytes() == {"engine": 4096}
    finally:
        hbm.reset()


# -- multi-LoRA through the captured graphs ------------------------------------

def _lora_engine(gen, paged: bool, **kw):
    """SMALL with 3 adapter slots of rank 8 whose B matrices are filled
    (so every adapter moves the logits), on buckets of 16 and 32."""
    eng = _engine(paged, prompt_buckets=(16, 32), lora_adapters=3,
                  lora_rank=8, **kw)
    for name in llama.LORA_TARGETS:
        b = eng.params["layers"][f"lora_b_{name}"]
        b.copy_(torch.randn(b.shape, generator=gen, device="cuda") * 0.2)
    return eng


@pytest.mark.parametrize("paged", [False, True])
def test_lora_decode_replay_with_mixed_adapters_equals_eager(gen, paged):
    """Three slots on adapters 1, 0 and 2 in one block: the replay reads
    the pack's adapter column and equals the eager block, and the
    adapters matter (the same state on adapter 0 everywhere gives other
    tokens)."""
    eng = _lora_engine(gen, paged)
    try:
        with eng._device_lock:
            _random_state(eng, gen, [40, 131, 0], False)
            state = _snapshot(eng)
            eng._pack[:, 5] = torch.tensor([1, 0, 2], device="cuda")
            mixed = _replay_equals_eager(eng, False)
            for dst, src in zip((eng.cache.k, eng.cache.v, eng.cache.k_scale,
                                 eng.cache.v_scale, eng.cache.lengths),
                                (state[0].k, state[0].v, state[0].k_scale,
                                 state[0].v_scale, state[0].lengths)):
                dst.copy_(src)
            eng._pack.copy_(state[1])
            for dst, src in zip(eng._carry, state[2]):
                dst.copy_(src)
            base = _replay_equals_eager(eng, False)
            assert torch.equal(mixed[:, 0, 1], base[:, 0, 1])   # adapter 0
            assert not torch.equal(mixed[:, 0], base[:, 0])
            eng._host_wins[:] = True
            eng._touch()
    finally:
        eng.close()


@pytest.mark.parametrize("paged", [False, True])
def test_lora_admission_replays_equal_their_eager_functions(gen, paged):
    """A bucket admission and a lattice admission on adapter 2 (and a
    bucket one on adapter 1): the graphs read the adapter from the
    admission inputs and give the eager functions' first token and
    cache bytes."""
    from gofr_tpu_torch.tpu.generator import GenStream, _Request

    eng = _lora_engine(gen, paged)
    names = ["cache"] + (["_scratch"] if paged else [])
    rng = np.random.default_rng(5)

    def eager(key):
        with torch.no_grad():
            out = eng._admission_fn(key)()
        return None if out is None else (int(out[0]), float(out[1]))

    try:
        with eng._device_lock:
            firsts = []
            prompts = {n: rng.integers(0, SMALL.vocab_size, n)
                       for n in (30, 100)}
            for n, adapter in ((30, 2), (30, 1), (100, 2)):
                copies = {name: _snapshot_cache(getattr(eng, name))
                          for name in names}
                prompt = prompts[n]
                blocks = (rng.choice(np.arange(1, 49), -(-n // 16),
                                     replace=False).tolist()
                          if paged else None)

                def admit():
                    return eng._prefill(1, _Request(
                        GenStream(0), prompt, 4, 0.0, 0, None, 9,
                        adapter=adapter), blocks and ([], 0, list(blocks)))

                got = admit()
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
                    live = slice(1 if paged and name == "cache" else 0,
                                 None)
                    for x, y in ((a.k, b.k), (a.v, b.v)):
                        assert torch.equal(x[:, live], y[:, live])
                firsts.append(got)
            # the same prompt through adapters 2 and 1: another prefill
            assert firsts[0] != firsts[1]
    finally:
        eng.close()


@pytest.mark.parametrize("paged", [False, True])
def test_lora_verify_replay_with_mixed_adapters_equals_eager(gen, paged):
    """A LoRA engine's verify graph reads each slot's adapter from the
    last column of its inputs: a replay with slots on adapters 1, 0 and
    2 equals verify_pass run eagerly through those adapters, and the
    adapters matter (the same pass on adapter 0 everywhere gives the
    same tokens for the slot on adapter 0 and others elsewhere)."""
    from gofr_tpu_torch.tpu.generator import verify_pass

    eng = _lora_engine(gen, paged, spec_decode_k=4)
    try:
        with eng._device_lock:
            _random_state(eng, gen, [40, 131, 0], False)
            window = torch.randint(0, SMALL.vocab_size, (3, 5),
                                   device="cuda", generator=gen)
            table = eng._pack[:, -eng._mb:].clone() if paged else None
            start, _, _ = _snapshot(eng)
            results = []
            for adapters in ([1, 0, 2], [0, 0, 0]):
                c = eng.cache
                for dst, src in ((c.k, start.k), (c.v, start.v),
                                 (c.k_scale, start.k_scale),
                                 (c.v_scale, start.v_scale),
                                 (c.lengths, start.lengths)):
                    dst.copy_(src)
                _verify_inputs(eng, window, table,
                               torch.tensor(adapters, device="cuda"))
                cache, _, _ = _snapshot(eng)
                inputs = eng._verify_in.clone()
                host, done = eng._run_verify()
                done.synchronize()
                got = torch.from_numpy(host.numpy().copy())
                with torch.no_grad():
                    want = verify_pass(
                        eng.params, eng.cfg, cache, inputs[:, :5],
                        inputs[:, 5].bool(),
                        inputs[:, 6:-1].to(torch.int32) if paged else None,
                        eng.rope_tables, inputs[:, -1]).cpu()
                torch.cuda.synchronize()
                assert torch.equal(got[:, :5], want[:, :5])     # tokens
                assert torch.equal(got[:, 10], want[:, 10])     # emit
                assert (got[:, 5:10] - want[:, 5:10]).abs().max() <= \
                    LOGPROB_ATOL
                for a, b in ((c.lengths, cache.lengths), (c.k, cache.k),
                             (c.v, cache.v)):
                    assert torch.equal(a, b)
                results.append(got)
            mixed, base = results
            assert torch.equal(mixed[1, :5], base[1, :5])       # adapter 0
            assert not torch.equal(mixed[:, :5], base[:, :5])
            eng._host_wins[:] = True
            eng._touch()
    finally:
        eng.close()


def test_a_replay_after_load_adapter_reads_the_new_weights(gen):
    """load_adapter copies into the stacks every graph binds: a greedy
    stream on adapter 1 changes after the swap and equals the stream of
    the donor adapter 2, and a decode replay after that stream equals
    the eager block on the new weights."""
    eng = _lora_engine(gen, False)
    try:
        prompt = list(range(3, 40))
        donor = eng.generate(prompt, max_new_tokens=12, adapter=2).tokens()
        before = eng.generate(prompt, max_new_tokens=12, adapter=1).tokens()
        assert before != donor
        layers = eng.params["layers"]
        tree = {name: (layers[f"lora_a_{name}"][:, 2].cpu(),
                       layers[f"lora_b_{name}"][:, 2].cpu())
                for name in llama.LORA_TARGETS}
        ptr = layers["lora_b_wq"].data_ptr()
        eng.load_adapter(1, tree)
        assert layers["lora_b_wq"].data_ptr() == ptr
        after = eng.generate(prompt, max_new_tokens=12, adapter=1).tokens()
        assert after == donor
        with eng._device_lock:
            torch.cuda.synchronize()
            _random_state(eng, gen, [40, 131, 0], False)
            eng._pack[:, 5] = 1
            _replay_equals_eager(eng, False)
            eng._host_wins[:] = True
            eng._touch()
    finally:
        eng.close()


@pytest.mark.parametrize("paged", [False, True])
def test_lora_replays_after_swaps_and_streams_equal_eager(gen, paged):
    """The order of the load_adapter test, twelve times over on one
    engine: a swap of adapters 1 and 2 every fourth round, a stream on
    a swapped adapter, then a decode replay with mixed adapters against
    the eager block on a fresh random state."""
    eng = _lora_engine(gen, paged)
    try:
        prompt = list(range(3, 40))
        layers = eng.params["layers"]
        for t in range(12):
            if t % 4 == 0:
                trees = [{name: (layers[f"lora_a_{name}"][:, k].cpu(),
                                 layers[f"lora_b_{name}"][:, k].cpu())
                          for name in llama.LORA_TARGETS} for k in (1, 2)]
                eng.load_adapter(1, trees[1])
                eng.load_adapter(2, trees[0])
            out = eng.generate(prompt, max_new_tokens=8,
                               adapter=1 + t % 2).tokens()
            assert len(out) == 8
            with eng._device_lock:
                torch.cuda.synchronize()
                _random_state(eng, gen, [40, 131, 0], False)
                eng._pack[:, 5] = torch.tensor(
                    [t % 3, (t + 1) % 3, (t + 2) % 3], device="cuda")
                _replay_equals_eager(eng, False)
                eng._host_wins[:] = True
                eng._touch()
    finally:
        eng.close()


@pytest.mark.parametrize("paged", [False, True])
def test_a_mixed_tenant_replay_after_a_swap_and_a_stream_equals_eager(
        gen, paged):
    """The load_adapter scenario under tenant routing: an engine with a
    tenancy plane routing tenants A, B and C to adapters 1, 2 and 3;
    adapter 3 is swapped for adapter 1's weights with load_adapter, one
    greedy stream of C then equals adapter 1's untenanted; a decode
    replay with slots of A, B and C (three adapters in one pack, as the
    plane routed their streams) equals the eager block bit for bit."""
    from gofr_tpu_torch.tenancy import (TenantPlane, TenantRegistry,
                                        tenant_scope)

    eng = _engine(paged, prompt_buckets=(16, 32), lora_adapters=4,
                  lora_rank=8)
    try:
        layers = eng.params["layers"]
        for name in llama.LORA_TARGETS:
            b = layers[f"lora_b_{name}"]
            b.copy_(torch.randn(b.shape, generator=gen, device="cuda") * 0.2)
        eng.install_tenancy(TenantPlane(TenantRegistry.from_json(
            {"tenants": [{"id": "A", "adapter": 1, "weight": 2},
                         {"id": "B", "adapter": 2},
                         {"id": "C", "adapter": 3}]})))
        prompt = list(range(3, 40))
        donor = eng.generate(prompt, max_new_tokens=12, adapter=1).tokens()
        tree = {name: (layers[f"lora_a_{name}"][:, 1].cpu(),
                       layers[f"lora_b_{name}"][:, 1].cpu())
                for name in llama.LORA_TARGETS}
        eng.load_adapter(3, tree)
        with tenant_scope("C"):
            s = eng.generate(prompt, max_new_tokens=12)
            after = s.tokens()
        assert (s.tenant, s.adapter, after) == ("C", 3, donor)
        routed = []
        for t in "ABC":
            with tenant_scope(t):
                s = eng.generate(prompt[:20], max_new_tokens=2)
                s.tokens()
            routed.append(s.adapter)
        assert routed == [1, 2, 3]
        assert eng.tenancy.stats()["tenants"]["C"]["active"] == 0
        with eng._device_lock:
            torch.cuda.synchronize()
            _random_state(eng, gen, [40, 131, 7], False)
            eng._pack[:, 5] = torch.tensor(routed, device="cuda")
            _replay_equals_eager(eng, False)
            eng._host_wins[:] = True
            eng._touch()
    finally:
        eng.close()


def _fill_free_memory(value: int) -> list:
    """Take every free block the caching allocator holds with tensors
    filled with ``value``, largest first: a size stops at the first
    allocation that needs new device memory."""
    out = []
    for size in (256 << 20, 64 << 20, 16 << 20, 4 << 20, 1 << 20,
                 256 << 10, 32 << 10, 4 << 10, 512):
        for _ in range(4096):
            before = torch.cuda.memory_reserved()
            t = torch.full((size,), value, dtype=torch.uint8, device="cuda")
            if torch.cuda.memory_reserved() != before:
                break
            out.append(t)
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_lora_replays_write_nothing_outside_the_engine(gen, paged):
    """After a swap and streams on the swapped adapter, the allocator's
    free memory is handed to canaries; replaying every decode and
    admission graph, and an eager block, leaves each canary whole: no
    graph writes memory that the allocator can give to another tensor
    (the first replay test's eager snapshot lives in such memory)."""
    eng = _lora_engine(gen, paged)
    try:
        prompt = list(range(3, 40))
        layers = eng.params["layers"]
        eng.generate(prompt, max_new_tokens=12, adapter=2).tokens()
        eng.load_adapter(1, {name: (layers[f"lora_a_{name}"][:, 2].cpu(),
                                    layers[f"lora_b_{name}"][:, 2].cpu())
                             for name in llama.LORA_TARGETS})
        eng.generate(prompt, max_new_tokens=12, adapter=1).tokens()
        with eng._device_lock:
            torch.cuda.synchronize()
            canaries = _fill_free_memory(0x5A)
            assert canaries
            for _ in range(3):
                for draw in (False, True):
                    eng._graphs[draw][0].replay()
                for graph, _, _ in eng._adm_graphs.values():
                    graph.replay()
            with torch.no_grad():
                eng._block(False)
            torch.cuda.synchronize()
            bad = [(i, c.numel()) for i, c in enumerate(canaries)
                   if not bool((c == 0x5A).all())]
            assert not bad
            eng._host_wins[:] = True
            eng._touch()
    finally:
        eng.close()


# -- tensor parallelism (gofr_tpu_torch.parallel) ------------------------------

# the per-rank head counts (H, KV) of tensor-parallel serving: Llama-3-8B
# at tp = 2, 4 and 8, and Llama-3-70B at tp = 8 (one KV head a rank)
TP_RANK_SHAPES = [(16, 4), (8, 2), (4, 1), (8, 1)]


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("h,kv", TP_RANK_SHAPES)
def test_the_kernels_at_the_tensor_parallel_rank_shapes(gen, quant, h, kv):
    """K1, K2, K3 and K3w each launched once at a rank's head counts and
    held against their plain versions in float32 (K1 on ragged rows past
    a tile, the decodes on and around a chunk edge with an empty slot,
    K3w at a window of 5)."""
    lens = torch.tensor([300, 129], dtype=torch.int32, device="cuda")
    q, k, v = (_randn(gen, 2, 300, h, 128), _randn(gen, 2, 300, kv, 128),
               _randn(gen, 2, 300, kv, 128))
    flash.reset_counts()
    got = flash.flash_prefill(q, k, v, lens)
    assert (flash.launches, flash.plain_calls) == (1, 0)
    _assert_close(got, flash.causal_prefill_plain(q.float(), k.float(),
                                                  v.float(), lens))
    c = flash_decode.SPLIT_CHUNK
    lengths = [0, 1, c - 1, c, c + 1, 2 * c + 7]
    args = _paged_args(gen, lengths, 16, 40, h, kv, quant)
    qd, kp, vp, kn, vn, table, lens, ks, vs = args

    def dense(x):
        return None if x is None else \
            paged_attention.gather_blocks(x, table).contiguous()

    flash_decode.reset_counts()
    paged_attention.reset_counts()
    contiguous = (qd, dense(kp), dense(vp), kn, vn, lens, dense(ks),
                  dense(vs))
    got = flash_decode.flash_decode_appended(*contiguous)
    assert (flash_decode.launches, flash_decode.plain_calls) == (1, 0)
    _assert_close(got, flash_decode.decode_plain(*_f32(contiguous)))
    paged = paged_attention.paged_decode_attention(*args)
    assert (paged_attention.launches, paged_attention.plain_calls) == (1, 0)
    assert torch.equal(paged, got)
    wargs = _window_args(gen, lengths, 16, 40, h, kv, 5, quant)
    window = paged_attention.paged_window_attention(*wargs)
    assert (paged_attention.window_launches,
            paged_attention.window_plain_calls) == (1, 0)
    _assert_close(window, paged_attention.paged_window_reference(
        *_f32(wargs)))


@pytest.mark.parametrize("paged", [False, True])
def test_a_tp2_engine_on_the_card_serves_tp1_s_first_tokens(gen, paged):
    """SMALL at tp=2 (two ranks on one card, per-rank H=2 over KV=1,
    the activations summed over gloo, eagerly): every rank launches its
    kernels, the carries agree, and each stream's first token equals a
    tp=1 engine's on the same weights; paged with spec decode (K3w)."""
    from gofr_tpu_torch.parallel import MeshPlan
    from gofr_tpu_torch.tpu import GenerationEngine
    from gofr_tpu_torch.tpu.generator import _COUNTERS

    params = llama.init(SMALL, 0, device="cuda")
    args = dict(slots=4, max_seq=256, kv_dtype=torch.int8, decode_block=4,
                prompt_buckets=(32, 64), device="cuda")
    if paged:
        args.update(paged_blocks=40, paged_block_size=16, spec_decode_k=3)
    rng = np.random.default_rng(5)
    xs = [rng.integers(0, SMALL.vocab_size, n).tolist() for n in (9, 20)]
    prompts = [x * 3 for x in xs]
    ref = GenerationEngine(SMALL, params, **args)
    try:
        want = [ref.generate(p, max_new_tokens=24).tokens() for p in prompts]
    finally:
        ref.close()
    eng = GenerationEngine(SMALL, params, mesh=MeshPlan(tp=2), **args)
    try:
        for mod in (flash, flash_decode, paged_attention):
            mod.reset_counts()
        eng.tp_zero_counts()
        got = [eng.generate(p, max_new_tokens=24).tokens() for p in prompts]
        probe = eng.tp_probe()
        stats = eng.stats()
    finally:
        eng.close()
    assert [g[0] for g in got] == [w[0] for w in want]
    assert (probe[:, :20] == probe[0, :20]).all()
    counts = [dict(zip([f"{m.__name__}.{n}" for m, n in _COUNTERS],
                       row[-len(_COUNTERS):].tolist())) for row in probe]
    assert counts[0] == counts[1]
    launched = {k.rsplit(".", 2)[-2] + "." + k.rsplit(".", 1)[-1]: v
                for k, v in counts[0].items() if v}
    assert all(k.endswith("launches") for k in launched), launched
    want_k = ({"flash.launches", "paged_attention.launches"} if paged
              else {"flash.launches", "flash_decode.launches"})
    assert want_k <= set(launched)
    assert stats["mesh"]["backend"] == "gloo" and not stats["mesh"]["graphs"]
    assert all(p.poll() is not None for p in eng._tp.procs)


def test_a_cmd_app_on_the_card_streams_what_engine_generate_does(
        gen, monkeypatch, tmp_path):
    """A ``gofr_tpu_torch.new_cmd`` App on "cuda" (Llama-3-8B's width at
    2 layers, seed-0 weights, int8 KV) with a sqlite file: a migration
    creates a table, and one ``generate`` sub-command streams the tokens
    a direct ``generate`` on the same engine returns, writes its row and
    prints its JSON; K1 launches 2 an admission and K2 2 a decode step,
    and no plain version runs."""
    import contextlib
    import io
    import json

    from gofr_tpu_torch import new_cmd
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.migration import Migrate

    monkeypatch.setitem(LLAMA_CONFIGS, "llama3-8b-2l",
                        LLAMA_CONFIGS["llama3-8b"].with_(n_layers=2))
    app = new_cmd(MapConfig({
        "TPU_MODEL": "llama3-8b-2l", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "512",
        "TPU_KV_DTYPE": "int8", "TPU_SEQ_BUCKETS": "32,64",
        "DB_DIALECT": "sqlite", "DB_NAME": str(tmp_path / "cmd.db"),
        "CMD_LOGS_FILE": str(tmp_path / "cmd.log"), "LOG_LEVEL": "INFO"}))

    @app.sub_command("generate")
    def generate(ctx):
        prompt = [int(t) for t in ctx.param("prompt").split(",")]
        tokens = ctx.tpu.generate(prompt,
                                  max_new_tokens=int(ctx.param("max")),
                                  seed=0).tokens()
        ctx.sql.execute("INSERT INTO runs (tokens) VALUES (?)",
                        json.dumps(tokens))
        return {"tokens": tokens}

    engine = app.container.tpu.generator
    try:
        assert engine.device.type == "cuda"
        app.migrate({1: Migrate(up=lambda ds: ds.sql.execute(
            "CREATE TABLE runs (id INTEGER PRIMARY KEY, tokens TEXT)"))})
        prompt = [int(x) for x in torch.randint(
            1, engine.cfg.vocab_size, (40,), generator=gen, device="cuda")]
        flash.reset_counts()
        flash_decode.reset_counts()
        adm0, steps0 = engine.admissions, engine.decode_steps
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = app.run_command(["generate", "-prompt",
                                  ",".join(map(str, prompt)), "-max", "16"])
        admissions = engine.admissions - adm0
        steps = engine.decode_steps - steps0
        launched = (flash.launches, flash.plain_calls,
                    flash_decode.launches, flash_decode.plain_calls)
        want = app.container.tpu.generate(prompt, max_new_tokens=16,
                                          seed=0).tokens()
        rows = app.container.sql.query("SELECT tokens FROM runs")
    finally:
        app.stop()
    got = json.loads(out.getvalue())["tokens"]
    assert rc == 0 and got == want and len(got) == 16
    assert [json.loads(r["tokens"]) for r in rows] == [got]
    assert admissions == 1 and steps > 0
    assert launched == (2 * admissions, 0, 2 * steps, 0)
    assert '"migration applied"' in (tmp_path / "cmd.log").read_text()
