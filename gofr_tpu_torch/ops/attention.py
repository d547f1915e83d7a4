"""Attention in plain PyTorch (counterpart of gofr_tpu/ops/attention.py).

These are the plain versions of the CUDA kernels: ``causal_attention``
of flash prefill (ops.flash), ``decode_attention_appended`` of the
decodes (ops.flash_decode, ops.paged_attention) and
``window_attention_appended`` of the paged verify window
(ops.paged_attention). The CPU runs them; on the card they are the
reference the kernels are held against, and the contiguous verify pass
(models.llama.verify_step) runs ``window_attention_appended`` itself, as
the JAX package runs its jnp version. ``chunk_attention``, the chunked
prefill's attention, has no kernel in either package: it is plain jnp in
JAX and plain PyTorch here, on every device; so has ``full_attention``,
the encoders' bidirectional attention. Layouts follow the JAX package:
q [B, S, H, D], k/v [B, S, KV, D], GQA by grouping query heads
[B, S, KV, G, D]; softmax in float32.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B, S, H, D] -> [B, S, KV, G, D] (a view)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """Causal self-attention for prefill.

    q: [B, S, H, D]; k, v: [B, S, KV, D]; mask: optional [B, S] validity
    (True = real token). Returns [B, S, H, D] in q's dtype.
    """
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    qg = _group(q * d ** -0.5, n_kv)                        # [B,S,KV,G,D]
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=q.device))
    scores = scores.masked_fill(~causal, NEG_INF)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


def decode_attention_appended(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, k_new: torch.Tensor,
                              v_new: torch.Tensor, lengths: torch.Tensor,
                              k_scale: torch.Tensor | None = None,
                              v_scale: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Decode attention over the cache PLUS the current token's k/v,
    before that token is written back.

    q: [B, 1, H, D]; k_cache/v_cache: [B, Smax, KV, D] (int8 with
    ``k_scale``/``v_scale`` [B, Smax, KV] float32, or dense);
    k_new/v_new: [B, 1, KV, D]; lengths: [B] valid cache entries
    EXCLUDING the current token. The k scale multiplies the scores and
    the v scale the probabilities (both constant over the contracted
    head_dim). Returns [B, 1, H, D] in q's dtype.
    """
    b, _, h, d = q.shape
    smax = k_cache.shape[1]
    n_kv = k_cache.shape[2]
    qg = _group(q * d ** -0.5, n_kv)[:, 0].float()          # [B,KV,G,D]
    scores_c = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float())
    if k_scale is not None:
        scores_c = scores_c * k_scale.transpose(1, 2)[:, :, None, :]
    valid = torch.arange(smax, device=q.device)[None, :] < lengths[:, None]
    scores_c = scores_c.masked_fill(~valid[:, None, None, :], NEG_INF)
    scores_s = torch.einsum("bkgd,btkd->bkgt", qg, k_new.float())
    probs = torch.softmax(torch.cat([scores_c, scores_s], dim=-1), dim=-1)
    probs_c = probs[..., :smax]
    if v_scale is not None:
        probs_c = probs_c * v_scale.transpose(1, 2)[:, :, None, :]
    vdt = q.dtype if v_scale is not None else v_cache.dtype
    out = (torch.einsum("bkgt,btkd->bkgd", probs_c.to(vdt),
                        v_cache.to(vdt))
           + torch.einsum("bkgt,btkd->bkgd",
                          probs[..., smax:].to(v_new.dtype), v_new))
    return out.reshape(b, 1, h, d).to(q.dtype)


def window_attention_appended(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, k_new: torch.Tensor,
                              v_new: torch.Tensor, lengths: torch.Tensor,
                              k_scale: torch.Tensor | None = None,
                              v_scale: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """``decode_attention_appended`` over a W-token window, the
    speculative verify pass: window query w attends the cache prefix
    (positions < lengths[b]) plus window positions <= w, before any of
    the window's k/v is written back. W=1 is the appended decode step.

    q: [B, W, H, D]; k_cache/v_cache: [B, Smax, KV, D] (int8 with
    ``k_scale``/``v_scale`` [B, Smax, KV] float32, or dense);
    k_new/v_new: [B, W, KV, D]; lengths: [B] valid cache entries
    EXCLUDING the window. Returns [B, W, H, D] in q's dtype.
    """
    b, w, h, d = q.shape
    smax = k_cache.shape[1]
    n_kv = k_cache.shape[2]
    qg = _group(q * d ** -0.5, n_kv).float()                 # [B,W,KV,G,D]
    scores_c = torch.einsum("bwkgd,btkd->bkgwt", qg, k_cache.float())
    if k_scale is not None:
        scores_c = scores_c * k_scale.transpose(1, 2)[:, :, None, None, :]
    valid = torch.arange(smax, device=q.device)[None, :] < lengths[:, None]
    scores_c = scores_c.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    scores_s = torch.einsum("bwkgd,btkd->bkgwt", qg, k_new.float())
    causal = torch.tril(torch.ones((w, w), dtype=torch.bool,
                                   device=q.device))
    scores_s = scores_s.masked_fill(~causal, NEG_INF)
    probs = torch.softmax(torch.cat([scores_c, scores_s], dim=-1), dim=-1)
    probs_c = probs[..., :smax]
    if v_scale is not None:
        probs_c = probs_c * v_scale.transpose(1, 2)[:, :, None, None, :]
    vdt = q.dtype if v_scale is not None else v_cache.dtype
    out = (torch.einsum("bkgwt,btkd->bwkgd", probs_c.to(vdt),
                        v_cache.to(vdt))
           + torch.einsum("bkgwt,btkd->bwkgd",
                          probs[..., smax:].to(v_new.dtype), v_new))
    return out.reshape(b, w, h, d).to(q.dtype)


def chunk_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor, start: torch.Tensor,
                    k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Chunked-prefill attention: a chunk of C new tokens at positions
    [start, start + C) attends to the cache prefix (positions < start)
    plus causally within the chunk, before the chunk's k/v is written.

    q: [B, C, H, D]; k_cache/v_cache: [B, Smax, KV, D] (int8 with
    ``k_scale``/``v_scale`` [B, Smax, KV] float32, or dense);
    k_new/v_new: [B, C, KV, D]; ``start``: a one-element integer tensor
    on q's device, so one captured graph serves every chunk offset (the
    prefix mask is built on the device). Trailing padding inside the
    chunk is harmless: causality keeps valid positions from attending
    it. Returns [B, C, H, D] in q's dtype.
    """
    b, c, h, d = q.shape
    smax, n_kv = k_cache.shape[1], k_cache.shape[2]
    g = h // n_kv
    # JAX's function, with fewer passes over the [B, KV, G, C, Smax + C]
    # float32 scores: the scales are folded into the keys and values
    # instead of the scores and probabilities, both key sets go through
    # one product, and the mask is applied in place.
    qg = _group(q * d ** -0.5, n_kv).float().permute(0, 2, 3, 1, 4)
    qg = qg.reshape(b, n_kv, g * c, d)                       # [B,KV,G*C,D]
    k_c = k_cache.float()
    if k_scale is not None:
        k_c = k_c * k_scale[..., None]
    keys = torch.cat([k_c, k_new.float()], dim=1)           # [B,Smax+C,KV,D]
    scores = torch.matmul(qg, keys.permute(0, 2, 3, 1))     # [B,KV,G*C,Smax+C]
    pos = torch.arange(smax + c, device=q.device)
    row = torch.arange(c, device=q.device)[:, None]
    visible = torch.where(pos < smax, pos < start.reshape(1),
                          pos - smax <= row)                 # [C, Smax+C]
    scores.view(b, n_kv, g, c, smax + c).masked_fill_(~visible, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    vdt = q.dtype if v_scale is not None else v_cache.dtype
    v_c = v_cache if v_scale is None else v_cache.float() * v_scale[..., None]
    out = (torch.matmul(probs[..., :smax].to(vdt),
                        v_c.to(vdt).transpose(1, 2))
           + torch.matmul(probs[..., smax:].to(v_new.dtype),
                          v_new.transpose(1, 2)))           # [B,KV,G*C,D]
    out = out.reshape(b, n_kv, g, c, d).permute(0, 3, 1, 2, 4)
    return out.reshape(b, c, h, d).to(q.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """Bidirectional attention (BERT/ViT encoders). q [B, S, H, D], k/v
    [B, S, KV, D]; ``mask`` [B, S] marks the real keys. The scaled query
    meets the keys in float32 (JAX's ``preferred_element_type``), masked
    keys score ``NEG_INF``, and the probabilities are cast to v's dtype
    before the second product. Returns [B, S, H, D] in v's dtype."""
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    qg = _group(q * d ** -0.5, n_kv)                        # [B,S,KV,G,D]
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)
