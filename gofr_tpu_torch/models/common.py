"""Shared model configuration and initializer (counterpart of
gofr_tpu/models/common.py)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

import torch

from ..ops.quant import QuantizedLinear, quantize_int8


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
    # encoder-model extras (BERT, ViT)
    n_classes: int = 0
    image_size: int = 224
    patch_size: int = 14
    type_vocab_size: int = 2
    # mixture-of-experts (0 experts = dense FFN); > 0 capacity factor =
    # grouped dispatch with per-expert buffers of factor * T * k / E
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


@dataclass(frozen=True)
class RankConfig(ModelConfig):
    """One tensor-parallel rank's view of a model (parallel.sharding.
    rank_config): ``n_heads``, ``n_kv_heads`` and ``ffn_dim`` are the
    rank's own shard, ``head_dim`` stays the model's, and the rank's
    embedding rows and LM-head columns are the vocabulary ids
    [vocab_lo, vocab_hi) (the whole vocabulary when it is replicated).
    ``comm`` (parallel.distributed.TPComm) sums the ranks' partial
    results; the model code calls it where a ``ModelConfig`` has none,
    so a tp = 1 model runs unchanged.

    Serving over the data axes (parallel.sharding.serve_rank_config):
    ``comm`` is the rank's ``parallel.sharding.RankView``, which also
    gathers each layer's weight blocks over ``fsdp`` and computes the
    embedding and LM head on the rank's blocks; ``e_lo``/``e_hi`` are
    the experts [e_lo, e_hi) the rank runs (``n_experts`` stays the
    router's whole set), and ``split_rows`` says the batch is the
    rank's own slots, split over the data axes (a decode block, a split
    score batch), so the embedding, the LM head and an MoE layer gather
    the fsdp or ep group's rows first and keep the rank's own after
    their sums."""

    tp: int = 1
    rank: int = 0
    full_heads: int = 1
    vocab_lo: int = 0
    vocab_hi: int = 0
    comm: Any = field(default=None, compare=False, hash=False, repr=False)
    e_lo: int = 0
    e_hi: int = 0
    split_rows: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.full_heads


class _Enter(torch.autograd.Function):
    """Identity forward, a sum over the ranks backward: the input of a
    column-parallel product (or of a vocab-split head), whose gradient
    each rank holds a part of."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = ctx.group.all_reduce(g.float().contiguous())
        return out.to(g.dtype), None


class _Sum(torch.autograd.Function):
    """A sum over the ranks forward, identity backward: a row-parallel
    product's partial sums (or a vocab-split lookup's), whose sum every
    rank then uses alike."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class TrainRanksComm:
    """A ``RankConfig.comm`` for training: ``all_reduce`` (the model's
    sums, out of place) and ``enter`` (a column-parallel input) as the
    differentiable pair above over ``group`` (anything with an in-place
    ``all_reduce(t)``: parallel.train binds its tensor-parallel
    group). Serving's comm has no ``enter`` and sums in place."""

    def __init__(self, group):
        self.group = group

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return _Sum.apply(t, self.group)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group)


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

BERT_CONFIGS = {
    "bert-base": ModelConfig(name="bert-base", vocab_size=30522, dim=768,
                             n_layers=12, n_heads=12, n_kv_heads=12,
                             ffn_dim=3072, max_seq=512, norm_eps=1e-12),
    "tiny": ModelConfig(name="tiny-bert", vocab_size=128, dim=64, n_layers=2,
                        n_heads=4, n_kv_heads=4, ffn_dim=128, max_seq=64,
                        norm_eps=1e-12, dtype="float32"),
}

VIT_CONFIGS = {
    "vit-l-14": ModelConfig(name="vit-l-14", dim=1024, n_layers=24,
                            n_heads=16, n_kv_heads=16, ffn_dim=4096,
                            image_size=224, patch_size=14, n_classes=1000),
    "tiny": ModelConfig(name="tiny-vit", dim=64, n_layers=2, n_heads=4,
                        n_kv_heads=4, ffn_dim=128, image_size=28,
                        patch_size=14, n_classes=10, dtype="float32"),
}


def dense_init(shape, dtype: torch.dtype, generator: torch.Generator,
               scale: float | None = None, quant: bool = False):
    """Truncated-normal fan-in init on ``generator``'s device: N(0, 1)
    cut at +-2, times ``scale`` or fan_in ** -0.5. Stacked ``[L, ...]``
    weights (``[L, E, in, out]`` expert stacks too) are drawn one
    ``[in, out]`` matrix at a time in float32, so the float32 scratch
    never exceeds one matrix.

    ``quant``: each matrix, rounded to ``dtype``, is int8-quantized per
    output channel as it is drawn, straight into a ``QuantizedLinear``
    of codes ``shape`` and scales ``shape[:-2] + shape[-1:]``: the
    codes and scales of ``quantize_int8(dense_init(...), ndim - 2)``,
    without the whole weight in ``dtype``."""
    shape = tuple(shape)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    device = generator.device

    def matrices(t, tail):
        return t.view(-1, *tail) if len(shape) >= 3 else t[None]

    if quant:
        codes = torch.empty(shape, dtype=torch.int8, device=device)
        scales = torch.empty(shape[:-2] + shape[-1:], dtype=torch.float32,
                             device=device)
        rows = zip(matrices(codes, shape[-2:]), matrices(scales, shape[-1:]))
    else:
        out = torch.empty(shape, dtype=dtype, device=device)
        rows = ((row, None) for row in matrices(out, shape[-2:]))
    for row, row_scale in rows:
        t = torch.empty(row.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        if row_scale is None:
            row.copy_(t.mul_(std))
            continue
        q = quantize_int8(t.mul_(std).to(dtype), axis=0)
        row.copy_(q.w)
        row_scale.copy_(q.scale)
    return QuantizedLinear(codes, scales) if quant else out


def layer_weights(layers: dict, i: int) -> dict:
    """Layer ``i`` of a stacked ``[L, ...]`` weight dict (int8
    ``QuantizedLinear`` leaves sliced with their scales)."""
    return {k: (QuantizedLinear(v.w[i], v.scale[i])
                if isinstance(v, QuantizedLinear) else v[i])
            for k, v in layers.items()}
