"""The port's flash decode (gofr_tpu_torch.ops.flash_decode) against the
JAX package's Pallas kernel (gofr_tpu.ops.flash_decode.flash_decode_appended,
run in interpret mode as tests/test_flash_decode.py runs it), on the same
seeded numpy inputs, on int8 and dense caches, on the CPU.

On CPU tensors the wrapper runs its plain version; the CUDA kernel is
held against that plain version on the card by chip_smoke.py. Float32,
atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ops.flash_decode import flash_decode_appended as jax_decode
from gofr_tpu.ops.quant import quantize_kv
from gofr_tpu_torch.ops import flash_decode

ATOL = 1e-5
B, SMAX, H, KV, D = 4, 64, 8, 2, 32
BLOCK_S = 16
# empty slot, one position, a tile edge, a full cache
EDGE_LENGTHS = [[0, 1, BLOCK_S, SMAX], [SMAX, 0, BLOCK_S + 1, BLOCK_S - 1]]


def _inputs(seed, quant):
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, kc, vc = randn(B, 1, H, D), randn(B, SMAX, KV, D), \
        randn(B, SMAX, KV, D)
    kn, vn = randn(B, 1, KV, D), randn(B, 1, KV, D)
    if not quant:
        return q, kc, vc, kn, vn, None, None
    (kq, ks), (vq, vs) = (tuple(np.array(a) for a in quantize_kv(
        jnp.asarray(x))) for x in (kc, vc))
    return q, kq, vq, kn, vn, ks, vs


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("lengths", EDGE_LENGTHS)
def test_flash_decode_matches_jax_kernel(quant, lengths):
    q, kc, vc, kn, vn, ks, vs = _inputs(len(lengths) + sum(lengths), quant)
    lens = np.asarray(lengths, np.int32)
    j = [None if a is None else jnp.asarray(a)
         for a in (q, kc, vc, kn, vn, lens, ks, vs)]
    want = np.asarray(jax_decode(*j, block_s=BLOCK_S, interpret=True))
    t = [None if a is None else torch.from_numpy(a)
         for a in (q, kc, vc, kn, vn, lens, ks, vs)]
    got = flash_decode.flash_decode_appended(*t)
    assert got.shape == (B, 1, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_empty_slot_returns_the_new_value():
    q, kc, vc, kn, vn, ks, vs = _inputs(3, True)
    lens = torch.zeros(B, dtype=torch.int32)
    got = flash_decode.flash_decode_appended(
        *(torch.from_numpy(a) for a in (q, kc, vc, kn, vn)), lens,
        torch.from_numpy(ks), torch.from_numpy(vs))
    want = np.repeat(vn[:, 0], H // KV, axis=1)[:, None]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_count_it():
    t = [torch.from_numpy(a) for a in _inputs(4, False)[:5]]
    flash_decode.reset_counts()
    flash_decode.flash_decode_appended(*t, torch.ones(B, dtype=torch.int32))
    assert (flash_decode.launches, flash_decode.plain_calls) == (0, 1)
    flash_decode.reset_counts()


def _good(quant=True):
    q = torch.zeros((2, 1, 8, 128), dtype=torch.bfloat16)
    dt = torch.int8 if quant else torch.bfloat16
    kc = torch.zeros((2, 16, 2, 128), dtype=dt)
    kn = torch.zeros((2, 1, 2, 128), dtype=torch.bfloat16)
    sc = torch.ones((2, 16, 2)) if quant else None
    return [q, kc, kc.clone(), kn, kn.clone(),
            torch.ones(2, dtype=torch.int32), sc,
            None if sc is None else sc.clone()]


def _with(i, value, quant=True):
    args = _good(quant)
    args[i] = value(args[i]) if callable(value) else value
    return args


@pytest.mark.parametrize("args,error", [
    (_with(0, lambda q: q.float()), TypeError),                 # q dtype
    (_with(1, lambda k: k.to(torch.bfloat16)), TypeError),      # cache type
    (_with(6, None), ValueError),                               # one scale
    (_with(0, lambda q: q[:, :, :6].contiguous()), ValueError),  # H/KV = 3
    (_with(5, lambda n: n.long()), TypeError),                  # lengths
    (_with(6, lambda s: s[:, :8].contiguous()), ValueError),    # scale shape
    (_with(1, lambda k: k.transpose(1, 2).contiguous().transpose(1, 2)),
     ValueError),                                                # layout
])
def test_kernel_input_checks_reject_what_the_kernel_does_not_take(args,
                                                                  error):
    flash_decode._check(*_good(True))
    flash_decode._check(*_good(False))
    with pytest.raises(error):
        flash_decode._check(*args)
