"""Llama-family decoder: GQA + RoPE + SwiGLU with a slot KV cache
(counterpart of gofr_tpu/models/llama.py, dense FFN only).

Parameters are a plain dict of tensors in the JAX package's layout:
layer weights stacked on a leading [L, ...] axis (sliced per layer in a
Python loop), projections [in, out] dense or ``QuantizedLinear``. The KV
cache is a preallocated [L, B, Smax, KV, hd] tensor pair with a per-slot
``lengths`` cursor, int8 with float32 per-vector scales or dense.

Unlike the JAX functions, which return new arrays, the cache is updated
IN PLACE (``write_kv``, ``decode_step``): serving keeps one cache
buffer for the life of the engine, as the JAX engine does by donation.

``flash=True`` runs attention through the CUDA kernels (ops.flash,
ops.flash_decode), which take the plain versions on CPU tensors;
``flash=False`` calls the plain versions directly. ``verify_step``, the
speculative verify pass over the contiguous cache, runs the plain
``window_attention_appended`` on every device, as the JAX package runs
its jnp version there; ``prefill_chunk``, a long prompt's chunk, runs
the plain ``chunk_attention`` for the same reason.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import flash, flash_decode
from ..ops.attention import chunk_attention, window_attention_appended
from ..ops.norms import rms_norm
from ..ops.quant import QuantizedLinear, qmatmul, quantize_kv
from ..ops.rope import apply_rope, rope_frequencies
from .common import ModelConfig, dense_init


def get_rope_tables(cfg: ModelConfig, max_seq: int, device="cuda"):
    """(cos, sin) [max_seq, hd/2] float32 tables on ``device`` (the card
    unless the caller asks for another)."""
    return rope_frequencies(cfg.head_dim, max_seq, cfg.rope_theta,
                            cfg.rope_scaling, device=device)


@dataclass
class KVCache:
    """Preallocated decode cache. ``k``/``v`` [L, B, Smax, KV, hd] are in
    the model dtype, or int8 when ``k_scale``/``v_scale`` [L, B, Smax, KV]
    float32 are present. ``lengths`` [B] int32: valid entries per slot."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_cache(cfg: ModelConfig, batch: int, max_seq: int | None = None,
               dtype: torch.dtype | None = None, device="cuda") -> KVCache:
    """``dtype=torch.int8`` allocates a quantized cache with scale
    planes; anything else a dense cache in that dtype."""
    device = resolve_device(device)
    max_seq = max_seq or cfg.max_seq
    dtype = dtype or cfg.tdtype
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    quant = dtype == torch.int8

    def zeros(s, dt):
        return torch.zeros(s, dtype=dt, device=device)

    return KVCache(
        k=zeros(shape, dtype), v=zeros(shape, dtype),
        lengths=zeros((batch,), torch.int32),
        k_scale=zeros(shape[:-1], torch.float32) if quant else None,
        v_scale=zeros(shape[:-1], torch.float32) if quant else None)


def init(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random-init params on ``device`` from a seeded ``torch.Generator``;
    the same dict layout a checkpoint loader fills."""
    if cfg.n_experts > 0:
        raise NotImplementedError("the port serves dense Llama models; "
                                  "MoE is not ported yet")
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dt = cfg.tdtype
    L, D, H, KV, hd, Fd, V = (cfg.n_layers, cfg.dim, cfg.n_heads,
                              cfg.n_kv_heads, cfg.head_dim, cfg.ffn_dim,
                              cfg.vocab_size)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    params = {
        "embedding": dense_init((V, D), dt, gen, scale=0.02),
        "layers": {
            "attn_norm": ones(L, D),
            "wq": dense_init((L, D, H * hd), dt, gen),
            "wk": dense_init((L, D, KV * hd), dt, gen),
            "wv": dense_init((L, D, KV * hd), dt, gen),
            "wo": dense_init((L, H * hd, D), dt, gen),
            "ffn_norm": ones(L, D),
            "w_gate": dense_init((L, D, Fd), dt, gen),
            "w_up": dense_init((L, D, Fd), dt, gen),
            "w_down": dense_init((L, Fd, D), dt, gen),
        },
        "final_norm": ones(D),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((D, V), dt, gen)
    return params


def _layer_weights(layers: dict, i: int) -> dict:
    return {k: (QuantizedLinear(v.w[i], v.scale[i])
                if isinstance(v, QuantizedLinear) else v[i])
            for k, v in layers.items()}


def _layer(x, w, cfg: ModelConfig, cos, sin, positions, attend):
    """One transformer block; ``attend(q, k, v)`` runs attention.
    Returns (x_out, (k, v)) with this block's new keys and values."""
    B, S = x.shape[0], x.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, w["attn_norm"], cfg.norm_eps)
    q = qmatmul(h, w["wq"]).reshape(B, S, H, hd)
    k = qmatmul(h, w["wk"]).reshape(B, S, KV, hd)
    v = qmatmul(h, w["wv"]).reshape(B, S, KV, hd)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    attn = attend(q, k, v).reshape(B, S, H * hd)
    x = x + qmatmul(attn, w["wo"])
    h = rms_norm(x, w["ffn_norm"], cfg.norm_eps)
    gated = F.silu(qmatmul(h, w["w_gate"])) * qmatmul(h, w["w_up"])
    return x + qmatmul(gated, w["w_down"]), (k, v)


def _logits(params: dict, cfg: ModelConfig, x) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embedding"].t()).float()
    return qmatmul(x, params["lm_head"]).float()


def _causal(params: dict, cfg: ModelConfig, tokens, lengths, rope_max: int,
            rope_tables, flash_attn: bool):
    """Shared causal body of forward/prefill_kv: embed, run the layers.
    Returns (x [B, S, D], k_stack, v_stack [L, B, S, KV, hd], lengths)."""
    B, S = tokens.shape
    device = tokens.device
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=device)
    lengths = lengths.to(torch.int32)
    cos, sin = rope_tables or get_rope_tables(cfg, rope_max, device)
    positions = torch.arange(S, device=device).expand(B, S)
    if flash_attn:
        def attend(q, k, v):
            return flash.flash_causal_prefill(q, k, v, lengths)
    else:
        def attend(q, k, v):
            return flash.causal_prefill_plain(q, k, v, lengths)

    x = params["embedding"][tokens].to(cfg.tdtype)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _layer(x, _layer_weights(params["layers"], i), cfg,
                           cos, sin, positions, attend)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs), lengths


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            lengths: torch.Tensor | None = None, rope_tables=None,
            flash: bool = False) -> torch.Tensor:
    """Cache-free causal forward over [B, S] tokens -> [B, S, V] float32
    logits."""
    x, _, _, _ = _causal(params, cfg, tokens, lengths, tokens.shape[1],
                         rope_tables, flash)
    return _logits(params, cfg, x)


def prefill_kv(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
               lengths: torch.Tensor | None = None,
               rope_max: int | None = None, rope_tables=None,
               flash: bool = False, logit_pos: torch.Tensor | None = None):
    """Causal forward returning the raw KV stacks instead of a filled
    cache, so serving can write one prompt into one slot.

    ``logit_pos`` [B]: gather the hidden state there BEFORE lm_head, so
    only [B, 1, V] logits are computed. Returns (logits [B, S, V] float32
    -- or [B, 1, V] with ``logit_pos`` --, k_stack, v_stack
    [L, B, S, KV, hd], lengths [B])."""
    x, k_stack, v_stack, lengths = _causal(
        params, cfg, tokens, lengths, rope_max or tokens.shape[1],
        rope_tables, flash)
    if logit_pos is not None:
        idx = logit_pos.long()[:, None, None].expand(-1, 1, x.shape[-1])
        x = torch.gather(x, 1, idx)                          # [B, 1, D]
    return _logits(params, cfg, x), k_stack, v_stack, lengths


def _offsets(base, n: int, device) -> torch.Tensor:
    """base + arange(n) as int64 on ``device``: ``base`` an int, or a
    one-element tensor there (read on the device, never by the host)."""
    idx = torch.arange(n, device=device)
    if isinstance(base, torch.Tensor):
        return idx + base.reshape(-1)[:1].long()
    return idx + int(base)


def write_kv(cache: KVCache, k_stack, v_stack, slot=0, start=0,
             lengths: torch.Tensor | None = None) -> KVCache:
    """Write KV stacks [L, B', S', KV, hd] into the cache at batch row
    ``slot`` and position ``start``, quantizing on write for an int8
    cache; IN PLACE. ``lengths`` replaces the cursors when given.

    ``slot`` and ``start`` are ints, or one-element integer tensors on
    the cache's device, read there: the write is an index write, so one
    captured graph serves every slot and chunk offset. An int ``start``
    is checked against the capacity; for a tensor one the caller keeps
    the rows in range (a host check would read the device)."""
    nb, ns = k_stack.shape[1], k_stack.shape[2]
    if not isinstance(start, torch.Tensor) and \
            ns > cache.k.shape[2] - start:
        raise ValueError(f"{ns} positions at {start} exceed the cache "
                         f"capacity {cache.k.shape[2]}")
    device = cache.k.device
    rows = (slice(None), _offsets(slot, nb, device)[:, None],
            _offsets(start, ns, device)[None, :])
    if cache.quantized:
        qk, sk = quantize_kv(k_stack)
        qv, sv = quantize_kv(v_stack)
        cache.k[rows] = qk
        cache.v[rows] = qv
        cache.k_scale[rows] = sk
        cache.v_scale[rows] = sv
    else:
        cache.k[rows] = k_stack.to(cache.k.dtype)
        cache.v[rows] = v_stack.to(cache.v.dtype)
    if lengths is not None:
        cache.lengths = lengths
    return cache


def prefill_chunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: KVCache, start: torch.Tensor, slot: torch.Tensor,
                  rope_tables=None, compute_logits: bool = True,
                  logit_pos: torch.Tensor | None = None):
    """One chunk of C prompt tokens [B, C] at positions [start, start+C)
    against the cache (the long-prompt path: a prompt of any length up
    to the capacity runs as a sequence of fixed-shape chunk calls, so
    one captured graph serves every chunk of a width).

    ``start`` and ``slot``: one-element integer tensors on the device,
    the chunk's offset and the first of the B batch rows of ``cache``
    it belongs to. Positions, the rope rows, the prefix mask
    (ops.attention.chunk_attention, reading an int8 cache through its
    scales) and the KV write's offset are all computed on the device.
    The cache is read-only inside the layer loop and the chunk's KV
    [L, B, C, KV, hd] is written afterwards at [start, start+C).
    ``cache.lengths`` is NOT advanced: the caller sets the cursor once
    after the last chunk. Returns (logits [B, C, V] float32, or
    [B, 1, V] gathered at ``logit_pos``, or None when
    ``compute_logits`` is False, sparing a mid-prompt chunk the lm_head;
    the same cache, written IN PLACE)."""
    B, C = tokens.shape
    device = tokens.device
    cos, sin = rope_tables or get_rope_tables(cfg, cache.k.shape[2], device)
    positions = _offsets(start, C, device).expand(B, C)
    rows = _offsets(slot, B, device)

    def row(t, i):
        return t[i].index_select(0, rows)

    x = params["embedding"][tokens].to(cfg.tdtype)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        k_l, v_l = row(cache.k, i), row(cache.v, i)
        ks_l = row(cache.k_scale, i) if cache.quantized else None
        vs_l = row(cache.v_scale, i) if cache.quantized else None

        def attend(q, k_new, v_new, k_l=k_l, v_l=v_l, ks_l=ks_l, vs_l=vs_l):
            return chunk_attention(q, k_l, v_l, k_new, v_new, start, ks_l,
                                   vs_l)

        x, (k, v) = _layer(x, _layer_weights(params["layers"], i), cfg,
                           cos, sin, positions, attend)
        ks.append(k)
        vs.append(v)
    write_kv(cache, torch.stack(ks), torch.stack(vs), slot=slot,
             start=start)
    if not compute_logits:
        return None, cache
    if logit_pos is not None:
        idx = logit_pos.long()[:, None, None].expand(-1, 1, x.shape[-1])
        x = torch.gather(x, 1, idx)                          # [B, 1, D]
    return _logits(params, cfg, x), cache


EOS_PAD = -1  # unused entries of a per-slot on-device stop set


def decode_stop_mask(tokens: torch.Tensor, lengths: torch.Tensor,
                     budget: torch.Tensor, eos_ids: torch.Tensor,
                     capacity: int) -> torch.Tensor:
    """Per-slot stop verdict for one fused decode step: True where the
    slot emitted its LAST token this step -- its token is in its EOS set
    ``eos_ids`` [B, E] (EOS_PAD-padded), its ``budget`` of further tokens
    is spent, or its post-step cursor reached ``capacity``. The device
    mirror of the engine's host retirement checks."""
    at_eos = torch.any(tokens[:, None] == eos_ids, dim=1)
    return at_eos | (budget <= 0) | (lengths >= capacity)


def multi_request_serving_config(cfg: ModelConfig) -> ModelConfig:
    """Config for programs that batch unrelated requests: grouped MoE
    dispatch would couple batch rows, so it is forced dense."""
    if cfg.n_experts > 0 and cfg.moe_capacity_factor > 0:
        return cfg.with_(moe_capacity_factor=0.0)
    return cfg


def _scatter_drop(buf: torch.Tensor, slots, pos, keep, new) -> None:
    """buf[:, slots, pos] = new where ``keep``, in place; ``slots``,
    ``pos`` and ``keep`` are [B] (one row a slot). Rows whose cursor is
    at or past capacity are dropped, as JAX's ``mode="drop"`` scatter
    drops them (torch indexing would raise): their index is clamped in
    range and the old value written back."""
    old = buf[:, slots, pos]
    shape = (1, -1) + (1,) * (new.ndim - 2)
    buf[:, slots, pos] = torch.where(keep.view(shape), new.to(buf.dtype), old)


def _write_rows(cache: KVCache, slots, positions, k_rows, v_rows) -> None:
    """Write KV rows [L, B, KV, hd] at ``positions`` [B] of each slot,
    quantizing on write for an int8 cache and dropping rows at or past
    capacity; IN PLACE."""
    smax = cache.k.shape[2]
    keep = positions < smax
    pos = positions.clamp(max=smax - 1)
    if cache.quantized:
        qk, sk = quantize_kv(k_rows)
        qv, sv = quantize_kv(v_rows)
        _scatter_drop(cache.k, slots, pos, keep, qk)
        _scatter_drop(cache.v, slots, pos, keep, qv)
        _scatter_drop(cache.k_scale, slots, pos, keep, sk)
        _scatter_drop(cache.v_scale, slots, pos, keep, sv)
    else:
        _scatter_drop(cache.k, slots, pos, keep, k_rows)
        _scatter_drop(cache.v, slots, pos, keep, v_rows)


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: KVCache, rope_tables=None,
                flash: bool = False) -> tuple[torch.Tensor, KVCache]:
    """One decode step for tokens [B] against the cache.

    The cache is read-only inside the layer loop (each layer's attention
    takes this token's k/v beside the cache), and all layers' new k/v
    [L, B, KV, hd] are written by one scatter afterwards, at each slot's
    cursor; a cursor at capacity drops its write. IN PLACE: returns
    (logits [B, V] float32, the same cache with lengths + 1).
    """
    cfg = multi_request_serving_config(cfg)
    B = tokens.shape[0]
    smax = cache.k.shape[2]
    device = tokens.device
    cos, sin = rope_tables or get_rope_tables(cfg, smax, device)
    lengths = cache.lengths
    # a parked cursor (== capacity) would index past the rope table;
    # its write is dropped below, so any in-range position serves
    positions = lengths.clamp(max=smax - 1).long()[:, None]  # [B, 1]
    attn_fn = (flash_decode.flash_decode_appended if flash
               else flash_decode.decode_plain)

    x = params["embedding"][tokens[:, None]].to(cfg.tdtype)   # [B, 1, D]
    k_toks, v_toks = [], []
    for i in range(cfg.n_layers):
        k_l, v_l = cache.k[i], cache.v[i]
        ks_l = cache.k_scale[i] if cache.quantized else None
        vs_l = cache.v_scale[i] if cache.quantized else None

        def attend(q, k_new, v_new, k_l=k_l, v_l=v_l, ks_l=ks_l, vs_l=vs_l):
            return attn_fn(q, k_l, v_l, k_new, v_new, lengths, ks_l, vs_l)

        x, (k, v) = _layer(x, _layer_weights(params["layers"], i), cfg,
                           cos, sin, positions, attend)
        k_toks.append(k[:, 0])
        v_toks.append(v[:, 0])
    _write_rows(cache, torch.arange(B, device=device), lengths.long(),
                torch.stack(k_toks), torch.stack(v_toks))   # [L, B, KV, hd]
    cache.lengths = lengths + 1
    return _logits(params, cfg, x[:, 0]), cache


def verify_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: KVCache, rope_tables=None
                ) -> tuple[torch.Tensor, KVCache]:
    """The speculative verify pass over the contiguous cache.

    ``tokens`` [B, W]: column 0 is each slot's pending last token (the
    one decode_step would consume), columns 1.. drafts. One forward
    computes logits at every window position (logits[:, j] predicts the
    token after tokens[:, :j+1]); attention is the plain
    ``window_attention_appended``. All W KV rows are written at each
    slot's cursor afterwards, rows at or past capacity dropped. IN
    PLACE: returns (logits [B, W, V] float32, the same cache with
    ``lengths`` UNCHANGED: how far a cursor advances is the caller's
    acceptance, and rows past it stay invisible behind the cursor).
    W=1 is decode_step without the cursor advance. The caller honours
    acceptance only where lengths + W <= capacity.
    """
    cfg = multi_request_serving_config(cfg)
    B, W = tokens.shape
    smax = cache.k.shape[2]
    device = tokens.device
    cos, sin = rope_tables or get_rope_tables(cfg, smax, device)
    lengths = cache.lengths
    positions = lengths.long()[:, None] + torch.arange(W, device=device)
    # a row past the rope table is dropped below; any in-range position
    # serves its rotation
    rope_pos = positions.clamp(max=cos.shape[0] - 1)

    x = params["embedding"][tokens].to(cfg.tdtype)            # [B, W, D]
    k_w, v_w = [], []
    for i in range(cfg.n_layers):
        k_l, v_l = cache.k[i], cache.v[i]
        ks_l = cache.k_scale[i] if cache.quantized else None
        vs_l = cache.v_scale[i] if cache.quantized else None

        def attend(q, k_new, v_new, k_l=k_l, v_l=v_l, ks_l=ks_l, vs_l=vs_l):
            return window_attention_appended(q, k_l, v_l, k_new, v_new,
                                             lengths, ks_l, vs_l)

        x, (k, v) = _layer(x, _layer_weights(params["layers"], i), cfg,
                           cos, sin, rope_pos, attend)
        k_w.append(k)
        v_w.append(v)
    k_w = torch.stack(k_w)                                    # [L,B,W,KV,hd]
    v_w = torch.stack(v_w)
    # one window column at a time: a column's dropped rows write back
    # what the earlier columns left, so no two writes of one scatter meet
    slots = torch.arange(B, device=device)
    for j in range(W):
        _write_rows(cache, slots, positions[:, j], k_w[:, :, j], v_w[:, :, j])
    return _logits(params, cfg, x), cache
