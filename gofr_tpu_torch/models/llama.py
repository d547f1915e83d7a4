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

Multi-LoRA: ``init_lora`` draws adapter stacks for the attention
projections (``LORA_TARGETS``), merged into ``params["layers"]``; every
entry point takes ``adapter`` [B] (each batch row's adapter id) and
adds each row's rank-r delta to those projections (``_lora``: a
per-row gather and two thin batched products, plain PyTorch as in the
JAX package, which computes them outside any Pallas kernel). The
attention kernels never see an adapter. ``merge_lora`` folds one
adapter into dense weights: the single-tenant path and the tests'
oracle. Without stacks, or with ``adapter=None``, no LoRA op runs.

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
from ..ops.quant import qmatmul, quantize_kv
from ..ops.rope import apply_rope, rope_frequencies
from .common import ModelConfig, dense_init
from .common import layer_weights as _layer_weights


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


LORA_TARGETS = ("wq", "wk", "wv", "wo")


def _lora_dims(cfg: ModelConfig) -> dict[str, tuple[int, int]]:
    D, H, KV, hd = cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": (D, H * hd), "wk": (D, KV * hd), "wv": (D, KV * hd),
            "wo": (H * hd, D)}


def lora_nbytes(cfg: ModelConfig, n_adapters: int, rank: int) -> int:
    """Bytes of ``init_lora``'s stacks, from their shapes."""
    n = sum(din + dout for din, dout in _lora_dims(cfg).values())
    return cfg.n_layers * n_adapters * rank * n * cfg.tdtype.itemsize


def init_lora(cfg: ModelConfig, n_adapters: int, rank: int,
              generator: torch.Generator) -> dict:
    """Stacked multi-LoRA leaves for the attention projections (the JAX
    package's ``init_lora``): per target, A [L, n_adapters, in, r] drawn
    N(0, 1) * in ** -0.5 from ``generator`` (on its device) and B
    [L, n_adapters, r, out] ZEROS, so every adapter starts as an exact
    no-op and adapter 0 conventionally stays the base model. Merge the
    returned dict into ``params["layers"]``."""
    device = generator.device
    out = {}
    for name in LORA_TARGETS:
        din, dout = _lora_dims(cfg)[name]
        a = torch.randn((cfg.n_layers, n_adapters, din, rank),
                        generator=generator, device=device)
        out[f"lora_a_{name}"] = (a * din ** -0.5).to(cfg.tdtype)
        out[f"lora_b_{name}"] = torch.zeros(
            (cfg.n_layers, n_adapters, rank, dout), dtype=cfg.tdtype,
            device=device)
    return out


def merge_lora(params: dict, cfg: ModelConfig, adapter: int) -> dict:
    """Fold ONE adapter into dense base weights (W + A_i @ B_i, in
    float32, then the weight's dtype) and drop the adapter stacks: the
    single-tenant path, and the oracle the multi-LoRA tests hold the
    gathered path against. Requires unquantized base weights."""
    layers = dict(params["layers"])
    for name in LORA_TARGETS:
        a = layers.pop(f"lora_a_{name}", None)
        b = layers.pop(f"lora_b_{name}", None)
        if a is None:
            continue
        delta = torch.einsum("ldr,lro->ldo", a[:, adapter].float(),
                             b[:, adapter].float())
        layers[name] = (layers[name].float() + delta).to(layers[name].dtype)
    return {**params, "layers": layers}


def _lora(h, w, name: str, adapter):
    """Per-row LoRA delta for projection ``name``: h @ A[adapter[b]] @
    B[adapter[b]] in ``h``'s dtype (the JAX package's ``_lora``), or
    None when ``w`` carries no adapter stacks or ``adapter`` is None.
    ``h`` [B, S, in], ``adapter`` [B] integer ids on ``h``'s device."""
    a = w.get(f"lora_a_{name}")
    if a is None or adapter is None:
        return None
    b = w[f"lora_b_{name}"]
    idx = adapter.reshape(-1).long()
    ha = torch.bmm(h, a.index_select(0, idx).to(h.dtype))
    return torch.bmm(ha, b.index_select(0, idx).to(h.dtype))


def _project(h, w, name: str, adapter):
    """The base projection plus the row's LoRA delta, in that order."""
    out = qmatmul(h, w[name])
    delta = _lora(h, w, name, adapter)
    return out if delta is None else out + delta


def _layer(x, w, cfg: ModelConfig, cos, sin, positions, attend,
           adapter=None):
    """One transformer block; ``attend(q, k, v)`` runs attention;
    ``adapter`` [B] selects each row's LoRA adapter when ``w`` carries
    the stacks. Returns (x_out, (k, v)) with this block's new keys and
    values."""
    B, S = x.shape[0], x.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, w["attn_norm"], cfg.norm_eps)
    q = _project(h, w, "wq", adapter).reshape(B, S, H, hd)
    k = _project(h, w, "wk", adapter).reshape(B, S, KV, hd)
    v = _project(h, w, "wv", adapter).reshape(B, S, KV, hd)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    attn = attend(q, k, v).reshape(B, S, H * hd)
    # (x + base) + delta, the JAX package's order
    x = x + qmatmul(attn, w["wo"])
    delta = _lora(attn, w, "wo", adapter)
    if delta is not None:
        x = x + delta
    h = rms_norm(x, w["ffn_norm"], cfg.norm_eps)
    gated = F.silu(qmatmul(h, w["w_gate"])) * qmatmul(h, w["w_up"])
    return x + qmatmul(gated, w["w_down"]), (k, v)


def _logits(params: dict, cfg: ModelConfig, x) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embedding"].t()).float()
    return qmatmul(x, params["lm_head"]).float()


def _causal(params: dict, cfg: ModelConfig, tokens, lengths, rope_max: int,
            rope_tables, flash_attn: bool, collect_kv: bool = True,
            adapter=None):
    """Shared causal body of forward/prefill_kv/score: embed, run the
    layers. Returns (x [B, S, D], k_stack, v_stack [L, B, S, KV, hd] --
    None without ``collect_kv`` --, lengths)."""
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
                           cos, sin, positions, attend, adapter)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    if not collect_kv:
        return x, None, None, lengths
    return x, torch.stack(ks), torch.stack(vs), lengths


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            lengths: torch.Tensor | None = None, rope_tables=None,
            flash: bool = False, adapter=None) -> torch.Tensor:
    """Cache-free causal forward over [B, S] tokens -> [B, S, V] float32
    logits; ``adapter`` [B]: each row's LoRA adapter."""
    x, _, _, _ = _causal(params, cfg, tokens, lengths, tokens.shape[1],
                         rope_tables, flash, collect_kv=False,
                         adapter=adapter)
    return _logits(params, cfg, x)


def _gather_rows(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] at one position a row, ``pos`` [B] -> [B, 1, D]."""
    idx = pos.long()[:, None, None].expand(-1, 1, x.shape[-1])
    return torch.gather(x, 1, idx)


def score(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
          lengths: torch.Tensor, rope_tables=None,
          flash: bool = False, adapter=None) -> torch.Tensor:
    """Next-token logits at each prompt's end: [B, V] float32, row b at
    position ``max(lengths[b] - 1, 0)`` (the engine's ``score``
    program). The hidden state is gathered there BEFORE the LM head, so
    only B logit rows are computed -- JAX's ``forward`` then one row,
    without the [B, S, V] float32 logits. Causal attention never lets a
    row see past itself, so the keys masked at or past ``lengths[b]``
    change nothing at the row read."""
    x, _, _, _ = _causal(params, cfg, tokens, lengths, tokens.shape[1],
                         rope_tables, flash, collect_kv=False,
                         adapter=adapter)
    pos = torch.clamp(lengths.long() - 1, min=0)
    return _logits(params, cfg, _gather_rows(x, pos))[:, 0]


def prefill_kv(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
               lengths: torch.Tensor | None = None,
               rope_max: int | None = None, rope_tables=None,
               flash: bool = False, logit_pos: torch.Tensor | None = None,
               adapter=None):
    """Causal forward returning the raw KV stacks instead of a filled
    cache, so serving can write one prompt into one slot.

    ``logit_pos`` [B]: gather the hidden state there BEFORE lm_head, so
    only [B, 1, V] logits are computed. Returns (logits [B, S, V] float32
    -- or [B, 1, V] with ``logit_pos`` --, k_stack, v_stack
    [L, B, S, KV, hd], lengths [B])."""
    x, k_stack, v_stack, lengths = _causal(
        params, cfg, tokens, lengths, rope_max or tokens.shape[1],
        rope_tables, flash, adapter=adapter)
    if logit_pos is not None:
        x = _gather_rows(x, logit_pos)                       # [B, 1, D]
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
                  logit_pos: torch.Tensor | None = None, adapter=None):
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
                           cos, sin, positions, attend, adapter)
        ks.append(k)
        vs.append(v)
    write_kv(cache, torch.stack(ks), torch.stack(vs), slot=slot,
             start=start)
    if not compute_logits:
        return None, cache
    if logit_pos is not None:
        x = _gather_rows(x, logit_pos)                       # [B, 1, D]
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
                flash: bool = False, adapter=None
                ) -> tuple[torch.Tensor, KVCache]:
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
                           cos, sin, positions, attend, adapter)
        k_toks.append(k[:, 0])
        v_toks.append(v[:, 0])
    _write_rows(cache, torch.arange(B, device=device), lengths.long(),
                torch.stack(k_toks), torch.stack(v_toks))   # [L, B, KV, hd]
    cache.lengths = lengths + 1
    return _logits(params, cfg, x[:, 0]), cache


def verify_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: KVCache, rope_tables=None, adapter=None
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
                           cos, sin, rope_pos, attend, adapter)
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
