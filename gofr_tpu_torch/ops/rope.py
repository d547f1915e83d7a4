"""Rotary position embeddings, Llama-3 style with frequency scaling
(counterpart of gofr_tpu/ops/rope.py)."""

from __future__ import annotations

import math

import torch

from ..device import resolve_device


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 500000.0,
                     scaling: dict | None = None, device="cuda"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [max_seq, head_dim // 2] in float32, on
    ``device`` (the card unless the caller asks for another).

    ``scaling`` is the Llama-3 frequency-scaling dict
    {factor, low_freq_factor, high_freq_factor, original_max_position}.
    """
    device = resolve_device(device)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=device), exps)
    if scaling:
        factor = scaling.get("factor", 8.0)
        low = scaling.get("low_freq_factor", 1.0)
        high = scaling.get("high_freq_factor", 4.0)
        orig = scaling.get("original_max_position", 8192)
        wavelen = 2.0 * math.pi / inv_freq
        ratio = orig / wavelen
        smooth = torch.clamp((ratio - low) / (high - low), 0.0, 1.0)
        inv_freq = torch.where(
            wavelen > orig / low,  # long wavelengths: fully scaled
            inv_freq / factor,
            inv_freq * smooth + (inv_freq / factor) * (1.0 - smooth))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)  # [max_seq, head_dim // 2]
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [B, S, heads, head_dim] by per-token ``positions``
    [B, S] (explicit positions, so every slot keeps its own cursor).
    Returns a new contiguous tensor in x's dtype."""
    c = cos[positions][..., :, None, :]  # [B, S, 1, hd/2]
    s = sin[positions][..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
