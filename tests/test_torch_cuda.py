"""The port's CUDA kernels on the card: each against its plain version at
odd shapes and every GQA group size the kernels take, the wrappers'
refusals on CUDA tensors they cannot take (an exception, never the plain
version), and the launch counters. They need an NVIDIA card and skip
without one; on the card run

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets up JAX, which this file
does not use).
"""

import pytest
import torch

from gofr_tpu_torch.ops import flash, flash_decode
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


@pytest.mark.parametrize("b,s,h,kv,lengths", [
    (1, 1, 8, 8, [1]), (2, 63, 8, 2, [63, 0]), (2, 65, 16, 2, [65, 64]),
    (3, 129, 32, 8, [1, 128, 129]), (1, 300, 4, 1, [257]),
])
def test_flash_prefill_kernel_matches_plain(gen, b, s, h, kv, lengths):
    q, k, v = (_randn(gen, b, s, h, 128), _randn(gen, b, s, kv, 128),
               _randn(gen, b, s, kv, 128))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    flash.reset_counts()
    got = flash.flash_prefill(q, k, v, lens)
    assert (flash.launches, flash.plain_calls) == (1, 0)
    _assert_close(got, flash.causal_prefill_plain(q, k, v, lens))
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
