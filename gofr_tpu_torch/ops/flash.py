"""Flash prefill attention (counterpart of gofr_tpu/ops/flash.py).

``flash_prefill`` launches the hand-written CUDA kernel
(``csrc/flash_prefill.cu``) on a CUDA tensor and runs the plain version,
``causal_prefill_plain``, only on a CPU tensor. There is no fallback: a
CUDA tensor the kernel does not take raises. ``FlashPrefill`` is the
``autograd.Function`` around it; its backward recomputes through the
plain ``causal_attention``, as the JAX package's ``_flash_bwd`` does.

``launches`` counts kernel launches and ``plain_calls`` calls of the
plain version, so a run can show which one its main path took.
"""

from __future__ import annotations

import torch

from . import kernels
from .attention import causal_attention

launches = 0
plain_calls = 0


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


def _prefix_mask(lengths: torch.Tensor, s: int) -> torch.Tensor:
    return torch.arange(s, device=lengths.device)[None, :] < lengths[:, None]


def causal_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: causal attention with keys
    at or past ``lengths[b]`` masked and query rows at or past it zero."""
    global plain_calls
    plain_calls += 1
    mask = _prefix_mask(lengths, q.shape[1])
    out = causal_attention(q, k, v, mask=mask)
    return out.masked_fill(~mask[:, :, None, None], 0.0)


def _check(q, k, v, lengths) -> None:
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_prefill shapes: q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    b, _, h, d = q.shape
    kernels.check_attention_shape("flash_prefill", head_dim=d, n_heads=h,
                                  n_kv_heads=k.shape[2], dtype=q.dtype)
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"flash_prefill takes bf16 q/k/v on CUDA, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError(f"lengths must be int32 [{b}], got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_prefill needs contiguous {name}")


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Causal GQA prefill attention without S x S materialization.

    q: [B, S, H, D]; k, v: [B, S, KV, D]; lengths: [B] int32 true
    prompt lengths. Returns [B, S, H, D] in q's dtype, zero in rows at or
    past a sequence's length.
    """
    global launches
    if q.device.type == "cpu":
        return causal_prefill_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill runs on cuda or cpu, not {q.device}")
    _check(q, k, v, lengths)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    fn = kernels.function("gofr_flash_prefill_bf16")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), b, s, h, k.shape[2], d ** -0.5, stream)
    kernels.check(err, "gofr_flash_prefill_bf16")
    launches += 1
    return out


class FlashPrefill(torch.autograd.Function):
    """Differentiable flash prefill: the forward is ``flash_prefill``;
    the backward recomputes attention through the plain
    ``causal_attention`` with the prefix mask and differentiates that."""

    @staticmethod
    def forward(ctx, q, k, v, lengths):
        ctx.save_for_backward(q, k, v, lengths)
        return flash_prefill(q, k, v, lengths)

    @staticmethod
    def backward(ctx, g):
        q, k, v, lengths = ctx.saved_tensors
        with torch.enable_grad():
            qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = causal_attention(qr, kr, vr,
                                   mask=_prefix_mask(lengths, q.shape[1]))
            dq, dk, dv = torch.autograd.grad(out, (qr, kr, vr), g)
        return dq, dk, dv, None


def flash_causal_prefill(q, k, v, lengths):
    """The model's entry: ``FlashPrefill.apply``."""
    return FlashPrefill.apply(q, k, v, lengths)
