"""Vision Transformer (ViT-L/14 class) for batched image classification
(counterpart of gofr_tpu/models/vit.py): the engine's ``classify``
program.

Patchify is a reshape and a matmul, not a convolution: the same
function for non-overlapping patches, in JAX's element order, so a
``patch_proj`` carried across from JAX lines up. Attention is the plain
``ops.attention.full_attention``, as it is plain jnp in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.attention import full_attention
from ..ops.norms import layer_norm
from ..ops.quant import qmatmul
from .common import ModelConfig, dense_init, layer_weights


def n_patches(cfg: ModelConfig) -> int:
    return (cfg.image_size // cfg.patch_size) ** 2


def init(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random-init params on ``device`` from a seeded generator."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dt = cfg.tdtype
    L, D, H, hd, Fd = (cfg.n_layers, cfg.dim, cfg.n_heads,
                       cfg.dim // cfg.n_heads, cfg.ffn_dim)
    patch_dim = 3 * cfg.patch_size * cfg.patch_size

    def full(value, *shape):
        return torch.full(shape, value, dtype=dt, device=device)

    return {
        "patch_proj": dense_init((patch_dim, D), dt, gen),
        "cls_token": full(0.0, 1, 1, D),
        "pos_embedding": dense_init((n_patches(cfg) + 1, D), dt, gen,
                                    scale=0.02),
        "layers": {
            "norm1_w": full(1.0, L, D),
            "norm1_b": full(0.0, L, D),
            "wq": dense_init((L, D, H * hd), dt, gen),
            "wk": dense_init((L, D, H * hd), dt, gen),
            "wv": dense_init((L, D, H * hd), dt, gen),
            "wo": dense_init((L, H * hd, D), dt, gen),
            "norm2_w": full(1.0, L, D),
            "norm2_b": full(0.0, L, D),
            "w_in": dense_init((L, D, Fd), dt, gen),
            "b_in": full(0.0, L, Fd),
            "w_out": dense_init((L, Fd, D), dt, gen),
            "b_out": full(0.0, L, D),
        },
        "final_norm_w": full(1.0, D),
        "final_norm_b": full(0.0, D),
        "head": dense_init((D, cfg.n_classes), dt, gen),
    }


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, n_patches, patch * patch * C], each patch's
    elements in (row, column, channel) order as JAX lays them out:
    [B, gh, p, gw, p, C] -> [B, gh, gw, p, p, C]."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)   # B, gh, gw, p, p, C
    return x.reshape(B, gh * gw, patch * patch * C)


def forward(params: dict, cfg: ModelConfig,
            images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] float -> logits [B, n_classes] float32
    (pre-LN ViT)."""
    B = images.shape[0]
    H, hd = cfg.n_heads, cfg.dim // cfg.n_heads
    eps = cfg.norm_eps

    x = qmatmul(patchify(images.to(cfg.tdtype), cfg.patch_size),
                params["patch_proj"])
    cls = params["cls_token"].expand(B, 1, cfg.dim)
    x = torch.cat([cls, x], dim=1) + params["pos_embedding"][None]
    S = x.shape[1]
    for i in range(cfg.n_layers):
        w = layer_weights(params["layers"], i)
        h = layer_norm(x, w["norm1_w"], w["norm1_b"], eps)
        q = qmatmul(h, w["wq"]).reshape(B, S, H, hd)
        k = qmatmul(h, w["wk"]).reshape(B, S, H, hd)
        v = qmatmul(h, w["wv"]).reshape(B, S, H, hd)
        x = x + qmatmul(full_attention(q, k, v).reshape(B, S, H * hd),
                        w["wo"])
        h = layer_norm(x, w["norm2_w"], w["norm2_b"], eps)
        # jax.nn.gelu's default is the tanh approximation
        x = x + qmatmul(F.gelu(qmatmul(h, w["w_in"]) + w["b_in"],
                               approximate="tanh"), w["w_out"]) + w["b_out"]
    x = layer_norm(x, params["final_norm_w"], params["final_norm_b"], eps)
    return qmatmul(x[:, 0], params["head"]).float()
