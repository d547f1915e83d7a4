"""Shared model configuration and initializer (counterpart of
gofr_tpu/models/common.py)."""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str = "custom"
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    rope_scaling: dict | None = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # mixture-of-experts (0 experts = dense FFN); the port serves dense
    # models only so far
    n_experts: int = 0
    experts_per_token: int = 2
    moe_capacity_factor: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


LLAMA_CONFIGS = {
    # Llama-3-8B / 70B (architecture dims are public knowledge)
    "llama3-8b": ModelConfig(name="llama3-8b", vocab_size=128256, dim=4096,
                             n_layers=32, n_heads=32, n_kv_heads=8,
                             ffn_dim=14336, max_seq=8192),
    "llama3-70b": ModelConfig(name="llama3-70b", vocab_size=128256, dim=8192,
                              n_layers=80, n_heads=64, n_kv_heads=8,
                              ffn_dim=28672, max_seq=8192),
    # small variants for single-chip serving and tests
    "llama-1b": ModelConfig(name="llama-1b", vocab_size=128256, dim=2048,
                            n_layers=16, n_heads=32, n_kv_heads=8,
                            ffn_dim=8192, max_seq=8192, tie_embeddings=True),
    "tiny": ModelConfig(name="tiny", vocab_size=256, dim=64, n_layers=2,
                        n_heads=4, n_kv_heads=2, ffn_dim=128, max_seq=128,
                        rope_theta=10000.0, dtype="float32"),
    "mixtral-8x7b": ModelConfig(name="mixtral-8x7b", vocab_size=32000,
                                dim=4096, n_layers=32, n_heads=32,
                                n_kv_heads=8, ffn_dim=14336, max_seq=8192,
                                rope_theta=1e6, n_experts=8,
                                experts_per_token=2),
    "tiny-moe": ModelConfig(name="tiny-moe", vocab_size=256, dim=64,
                            n_layers=2, n_heads=4, n_kv_heads=2,
                            ffn_dim=128, max_seq=128, rope_theta=10000.0,
                            dtype="float32", n_experts=4,
                            experts_per_token=2),
}


def dense_init(shape, dtype: torch.dtype, generator: torch.Generator,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init on ``generator``'s device: N(0, 1)
    cut at +-2, times ``scale`` or fan_in ** -0.5. Stacked ``[L, ...]``
    weights are drawn one layer at a time in float32, so the float32
    scratch never exceeds one layer."""
    shape = tuple(shape)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    device = generator.device
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = out.view(-1, *shape[-2:]) if len(shape) >= 3 else out[None]
    for row in rows:
        t = torch.empty(row.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        row.copy_(t.mul_(std))
    return out
