"""BERT-style bidirectional encoder producing sentence embeddings
(counterpart of gofr_tpu/models/bert.py): the engine's ``embed``
program, behind ``POST /v1/embeddings``.

Parameters are a plain dict of tensors in the JAX package's layout
(layer weights stacked on a leading [L, ...] axis, sliced per layer in
a Python loop; projections [in, out] dense or ``QuantizedLinear``).
Padding is a [B, S] key mask; attention is the plain
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


def init(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random-init params on ``device`` from a seeded generator."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dt = cfg.tdtype
    L, D, H, hd, Fd, V = (cfg.n_layers, cfg.dim, cfg.n_heads,
                          cfg.dim // cfg.n_heads, cfg.ffn_dim,
                          cfg.vocab_size)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dt, device=device)

    return {
        "embedding": dense_init((V, D), dt, gen, scale=0.02),
        "pos_embedding": dense_init((cfg.max_seq, D), dt, gen, scale=0.02),
        "type_embedding": dense_init((cfg.type_vocab_size, D), dt, gen,
                                     scale=0.02),
        "embed_norm_w": full(1.0, D),
        "embed_norm_b": full(0.0, D),
        "layers": {
            "wq": dense_init((L, D, H * hd), dt, gen),
            "bq": full(0.0, L, H * hd),
            "wk": dense_init((L, D, H * hd), dt, gen),
            "bk": full(0.0, L, H * hd),
            "wv": dense_init((L, D, H * hd), dt, gen),
            "bv": full(0.0, L, H * hd),
            "wo": dense_init((L, H * hd, D), dt, gen),
            "bo": full(0.0, L, D),
            "attn_norm_w": full(1.0, L, D),
            "attn_norm_b": full(0.0, L, D),
            "w_in": dense_init((L, D, Fd), dt, gen),
            "b_in": full(0.0, L, Fd),
            "w_out": dense_init((L, Fd, D), dt, gen),
            "b_out": full(0.0, L, D),
            "ffn_norm_w": full(1.0, L, D),
            "ffn_norm_b": full(0.0, L, D),
        },
        "pooler_w": dense_init((D, D), dt, gen),
        "pooler_b": full(0.0, D),
    }


def encode(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
           mask: torch.Tensor | None = None,
           token_types: torch.Tensor | None = None) -> torch.Tensor:
    """tokens [B, S] -> hidden states [B, S, D] in the model dtype.
    ``pos_embedding[:S]`` ties S to at most ``cfg.max_seq``."""
    B, S = tokens.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.bool, device=tokens.device)
    if token_types is None:
        token_types = torch.zeros_like(tokens)
    H, hd = cfg.n_heads, cfg.dim // cfg.n_heads
    eps = cfg.norm_eps

    x = (params["embedding"][tokens] + params["pos_embedding"][None, :S]
         + params["type_embedding"][token_types]).to(cfg.tdtype)
    x = layer_norm(x, params["embed_norm_w"], params["embed_norm_b"], eps)
    for i in range(cfg.n_layers):
        w = layer_weights(params["layers"], i)
        q = (qmatmul(x, w["wq"]) + w["bq"]).reshape(B, S, H, hd)
        k = (qmatmul(x, w["wk"]) + w["bk"]).reshape(B, S, H, hd)
        v = (qmatmul(x, w["wv"]) + w["bv"]).reshape(B, S, H, hd)
        attn = full_attention(q, k, v, mask=mask).reshape(B, S, H * hd)
        x = layer_norm(x + qmatmul(attn, w["wo"]) + w["bo"],
                       w["attn_norm_w"], w["attn_norm_b"], eps)
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(qmatmul(x, w["w_in"]) + w["b_in"], approximate="tanh")
        x = layer_norm(x + qmatmul(h, w["w_out"]) + w["b_out"],
                       w["ffn_norm_w"], w["ffn_norm_b"], eps)
    return x


def embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean-pooled, L2-normalized sentence embeddings [B, D] float32
    over the masked tokens. A row with no token (a padded batch row)
    divides by 1, not 0, and gives zeros."""
    B, S = tokens.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.bool, device=tokens.device)
    x = encode(params, cfg, tokens, mask)
    m = mask[..., None].to(x.dtype)
    pooled = (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    pooled = pooled.float()
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp(norm, min=1e-9)


def pool_cls(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Classic BERT pooler: tanh(W @ h_[CLS])."""
    x = encode(params, cfg, tokens, mask)
    return torch.tanh(qmatmul(x[:, 0], params["pooler_w"])
                      + params["pooler_b"])
