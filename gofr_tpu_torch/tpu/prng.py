"""JAX's default random numbers in PyTorch, bit for bit (counterpart of
what the JAX engine's sampler draws through ``jax.random``).

The JAX engine keys every sample on ``fold_in(PRNGKey(seed), pos)`` and
draws its Gumbel noise through ``jax.random.categorical``
(gofr_tpu/tpu/generator.py ``_resume_keys`` / ``_sample``). With
``jax_threefry_partitionable`` on (the default since jax 0.5):

  - ``PRNGKey(s)`` is the pair of words ``(0, s)``;
  - ``fold_in(k, p)`` is ``threefry2x32(k, (0, p))``;
  - random word ``i`` of a draw is ``x0 ^ x1`` of
    ``threefry2x32(key, (0, i))``;
  - a float32 uniform is ``f * (1 - tiny) + tiny`` floored at ``tiny``,
    with ``f = bitcast((word >> 9) | 0x3F800000) - 1``, and the Gumbel
    value is ``-log(-log(u))``.

The words and uniforms here equal JAX's exactly; the Gumbel values may
part from XLA's by one ulp of ``log``. Threefry needs only add, rotate
and xor on 32-bit words, carried in int64 tensors masked to 32 bits
(PyTorch has no unsigned 32-bit arithmetic). Keys are ``[B, 2]`` int64,
one per slot, as JAX's ``vmap`` over slots gives.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Random123's, as JAX computes it) on
    int64 tensors holding 32-bit words; the four inputs broadcast.
    Returns the two output words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seeds: torch.Tensor) -> torch.Tensor:
    """``PRNGKey(seed)`` for each of ``seeds`` [B] (non-negative int32
    values): [B, 2] int64 words."""
    s = seeds.long() & _M32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``fold_in(key, data)`` per row: keys [B, 2], data [B] -> [B, 2]."""
    d = data.long() & _M32
    x0, x1 = threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(d), d)
    return torch.stack([x0, x1], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` per row: [B, n] int64 words."""
    idx = torch.arange(n, device=keys.device, dtype=torch.long)[None, :]
    x0, x1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(idx),
                          idx)
    return x0 ^ x1


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` per row (float32, the default
    low-range mode): [B, n]. Value ``i`` depends only on the key and
    ``i``, so the first ``k`` columns are the draw of ``(k,)``."""
    bits = ((random_bits(keys, n) >> 9) | 0x3F800000).to(torch.int32)
    f = bits.view(torch.float32) - 1.0
    u = torch.clamp(f * (1.0 - _TINY) + _TINY, min=_TINY)
    return -torch.log(-torch.log(u))
