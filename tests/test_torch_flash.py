"""The port's flash prefill (gofr_tpu_torch.ops.flash) against the JAX
package's Pallas kernel (gofr_tpu.ops.flash.flash_causal_prefill, run in
interpret mode as tests/test_flash.py runs it), on the same seeded numpy
inputs, on the CPU.

On a CPU tensor the wrapper runs its plain version; the CUDA kernel it
launches on the card is held against that same plain version by
chip_smoke.py. Forward in float32 agrees to atol 1e-5; gradients of the
autograd.Function agree with jax.grad through _flash_diffable.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ops.flash import _flash_diffable, flash_causal_prefill
from gofr_tpu_torch.ops import flash

ATOL = 1e-5
S, D, BLOCK = 64, 32, 16   # four q tiles and four k tiles per sequence


def _inputs(seed, b, h, kv, s=S, d=D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 2)])
@pytest.mark.parametrize("lengths", [[S, S], [S - 9, 17], [1, 0]])
def test_flash_prefill_matches_jax_kernel(h, kv, lengths):
    q, k, v = _inputs(sum(lengths) + h, 2, h, kv)
    lens = np.asarray(lengths, np.int32)
    want = np.asarray(flash_causal_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        block_q=BLOCK, block_k=BLOCK, interpret=True))
    got = flash.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(lens))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # rows at or past a sequence's length are exactly zero on both sides
    for b, n in enumerate(lengths):
        assert not got[b, n:].any()


@pytest.mark.parametrize("lengths", [[128, 256], [129, 1]])
def test_plain_version_matches_jax_kernel_at_the_128_tile_edges(lengths):
    """The CUDA kernel's tiles are 128 keys and 128 query rows; on the
    card it is held against causal_prefill_plain, which is held here
    against the JAX kernel (128-wide blocks, interpret mode) with lengths
    on a tile edge and one past it, at H/KV = 4."""
    s = 256
    q, k, v = _inputs(sum(lengths), 2, 4, 1, s=s)
    lens = np.asarray(lengths, np.int32)
    want = np.asarray(flash_causal_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        block_q=128, block_k=128, interpret=True))
    got = flash.causal_prefill_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    for b, n in enumerate(lengths):
        assert got[b, :n].abs().sum() > 0 and not got[b, n:].any()


def test_flash_prefill_ragged_s_on_cpu():
    """S need not divide any tile on the port's side (the kernel masks
    its ragged last tile); the plain version is the same function."""
    q, k, v = _inputs(3, 1, 4, 2, s=37)
    lens = torch.tensor([30], dtype=torch.int32)
    got = flash.flash_prefill(*(torch.from_numpy(a) for a in (q, k, v)),
                              lens)
    mask = torch.arange(37)[None, :] < lens[:, None]
    from gofr_tpu_torch.ops.attention import causal_attention

    want = causal_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            mask=mask)
    np.testing.assert_allclose(got[:, :30].numpy(), want[:, :30].numpy(),
                               atol=ATOL, rtol=0)
    assert not got[:, 30:].any()


@pytest.mark.parametrize("h,kv", [(4, 2), (8, 2)])
def test_flash_prefill_gradients_match_jax(h, kv):
    q, k, v = _inputs(11, 2, h, kv)
    lens = np.asarray([S, 40], np.int32)
    g = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        out = _flash_diffable(q_, k_, v_, jnp.asarray(lens), True, BLOCK,
                              BLOCK)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = flash.FlashPrefill.apply(tq, tk, tv, torch.from_numpy(lens))
    (out * torch.from_numpy(g)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


def test_cpu_tensors_take_the_plain_version_and_count_it():
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 1, 4, 2))
    lens = torch.tensor([S], dtype=torch.int32)
    flash.reset_counts()
    flash.flash_causal_prefill(q, k, v, lens)
    assert (flash.launches, flash.plain_calls) == (0, 1)
    flash.reset_counts()


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty((1, 8, 4, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 8, 2, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash.flash_prefill(q, k, k, torch.ones(1, dtype=torch.int32,
                                                device="meta"))


def _good():
    q = torch.zeros((2, 8, 4, 128), dtype=torch.bfloat16)
    k = torch.zeros((2, 8, 2, 128), dtype=torch.bfloat16)
    return q, k, k.clone(), torch.ones(2, dtype=torch.int32)


@pytest.mark.parametrize("bad,error", [
    (lambda q, k, v, n: (q.float(), k, v, n), TypeError),
    (lambda q, k, v, n: (q[..., :64].contiguous(), k[..., :64].contiguous(),
                         v[..., :64].contiguous(), n), ValueError),
    (lambda q, k, v, n: (q[:, :, :3].contiguous(), k, v, n), ValueError),
    (lambda q, k, v, n: (q, k, v, n.long()), ValueError),
    (lambda q, k, v, n: (q.transpose(1, 2).contiguous().transpose(1, 2),
                         k, v, n), ValueError),
])
def test_kernel_input_checks_reject_what_the_kernel_does_not_take(bad, error):
    flash._check(*_good())  # the shapes the kernel takes pass
    with pytest.raises(error):
        flash._check(*bad(*_good()))
