"""Int8 weight and KV-cache quantization (counterpart of
gofr_tpu/ops/quant.py).

The codecs round half to even (``torch.round``), as ``jnp.round``
does, so a tensor quantizes to the same bits on both sides. ``qmatmul``
stays a plain upcast plus ``torch.matmul``: on the JAX side it is XLA,
not a kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedLinear(NamedTuple):
    """Per-output-channel symmetric int8 weight. ``w``: [in, out] int8
    (or stacked [L, in, out]), ``scale``: [out] float32 with
    w_true ~= w * scale."""

    w: torch.Tensor
    scale: torch.Tensor


def quantize_int8(w: torch.Tensor, axis: int = 0) -> QuantizedLinear:
    """Quantize a weight per output channel (reduce over ``axis``)."""
    wf = w.float()
    absmax = torch.amax(torch.abs(wf), dim=axis, keepdim=True)
    scale = torch.clamp(absmax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantizedLinear(w=q, scale=scale.squeeze(axis).float())


def qmatmul(x: torch.Tensor, qw: "QuantizedLinear | torch.Tensor"
            ) -> torch.Tensor:
    """x @ w for quantized or plain weights; returns x's dtype. The
    int8 weight is upcast to x's dtype and the per-channel scale
    applied after the contraction, in float32."""
    if isinstance(qw, QuantizedLinear):
        y = torch.matmul(x, qw.w.to(x.dtype))
        return (y.float() * qw.scale).to(x.dtype)
    return torch.matmul(x, qw)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8 over the LAST axis (a K/V head_dim):
    x [..., hd] -> (int8 [..., hd], float32 scale [...])."""
    xf = x.float()
    absmax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp(absmax / 127.0, min=1e-10)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of quantize_kv."""
    return (q.float() * scale[..., None]).to(dtype)


def maybe_quantize_tree(params, quantize: bool, *, min_size: int = 1 << 16):
    """Quantize projection-weight leaves of a nested param dict: plain
    [in, out] and stacked [L, in, out] mats whose key marks them as
    weights, reducing over the ``in`` axis (ndim - 2). Embeddings, norms
    and small leaves stay dense."""
    if not quantize:
        return params

    def is_proj_weight(k: str, v) -> bool:
        if not isinstance(v, torch.Tensor) or v.numel() < min_size:
            return False
        named_weight = k.startswith("w") or k in ("lm_head", "head",
                                                  "patch_proj", "pooler_w")
        return named_weight and v.ndim in (2, 3, 4)

    def visit(d):
        if isinstance(d, dict):
            return {k: (quantize_int8(v, axis=v.ndim - 2)
                        if is_proj_weight(k, v) else visit(v))
                    for k, v in d.items()}
        return d

    return visit(params)
