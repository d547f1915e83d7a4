"""Llama-family decoder: GQA + RoPE + SwiGLU with a slot KV cache
(counterpart of gofr_tpu/models/llama.py), with a dense FFN or a
mixture of experts.

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

Mixture of experts (``cfg.n_experts > 0``: tiny-moe, mixtral-8x7b):
each layer's FFN is a router [D, E] and E SwiGLU experts, stacked
``w_gate``/``w_up`` [L, E, D, F] and ``w_down`` [L, E, F, D], dense or
int8. ``_route`` takes the top k of the float32 softmax (the lower
expert on a tie, as ``lax.top_k``) and renormalizes; ``_moe_ffn``
runs every expert on every token and combines them by a [T, E] weight
that is zero off the top k (dense dispatch, what serving runs), or,
with ``cfg.moe_capacity_factor > 0``, ``_moe_ffn_grouped`` scatters the
claims into per-expert buffers of fixed capacity and drops those past
it. Both are plain PyTorch, as the JAX package computes them outside
any Pallas kernel, on fixed shapes with no host read, so a CUDA graph
captures them. Programs that batch unrelated requests force dense
dispatch (``multi_request_serving_config``); ``valid`` (from
``lengths``) keeps padding from claiming capacity.

Over ranks (parallel/): a ``RankConfig``'s ``comm`` sums the
row-parallel products, the vocab-split lookup and the logits over the
tensor-parallel ranks (``_reduce``, ``_embed``, ``_logits``). A mixture
of experts runs each expert's F/tp hidden units and, under ``ep``, only
the rank's experts [e_lo, e_hi): its partial output joins one sum over
the ranks (``_moe_ffn``). Under a serving plan with data axes the comm
is a ``parallel.sharding.RankView``: each layer's weights (``_weights``)
are gathered over ``fsdp`` from the rank's stored blocks at every call,
the embedding and the LM head compute on the rank's own blocks and sum
over fsdp x tp (``embed_rows``, ``head_logits``), and a batch split
over the data axes (``split_rows``: the rank's own slots) gathers the
fsdp or ep group's rows first and keeps the rank's own after the sum.

``flash=True`` runs attention through the CUDA kernels (ops.flash,
ops.flash_decode), which take the plain versions on CPU tensors;
``flash=False`` calls the plain versions directly. ``forward(...,
train=True)``, the training forward (parallel.train), runs the plain
``causal_attention`` under the validity mask on every device, as the
JAX package trains on its jnp attention; autograd differentiates
every op of that path (none writes in place into a tensor it saved).
``verify_step``, the speculative verify pass over the contiguous
cache, runs the plain ``window_attention_appended`` on every device, as
the JAX package runs its jnp version there; ``prefill_chunk``, a long
prompt's chunk, runs the plain ``chunk_attention`` for the same reason.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops import flash, flash_decode
from ..ops.attention import (causal_attention, chunk_attention,
                             window_attention_appended)
from ..ops.norms import rms_norm
from ..ops.quant import QUANT_LEAVES, QuantizedLinear, qmatmul, quantize_kv
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


def init(cfg: ModelConfig, seed: int = 0, *, device="cuda",
         leaf=None, quant: bool = False) -> dict:
    """Random-init params on ``device`` from a seeded ``torch.Generator``;
    the same dict layout a checkpoint loader fills (an MoE model's
    ``router`` [L, D, E] and expert stacks [L, E, D, F] / [L, E, F, D]
    in place of the dense FFN). ``leaf(name, tensor)``, if given, maps
    each leaf as soon as it is drawn (a tensor-parallel rank's slice:
    tpu.checkpoint.rank_params), so the whole model never exists at
    once; the draws are the same. ``quant``: the projection leaves
    (ops.quant.QUANT_LEAVES) are int8-quantized one [in, out] matrix at
    a time as they are drawn (common.dense_init): the weights of
    ``maybe_quantize(init(...), True)``, bit for bit, at a peak of the
    int8 model plus one float32 matrix."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dt = cfg.tdtype
    L, D, H, KV, hd, Fd, V = (cfg.n_layers, cfg.dim, cfg.n_heads,
                              cfg.n_kv_heads, cfg.head_dim, cfg.ffn_dim,
                              cfg.vocab_size)

    leaf = leaf or (lambda name, t: t)

    def ones(name, *shape):
        return leaf(name, torch.ones(shape, dtype=dt, device=device))

    def draw(name, shape, scale=None):
        return leaf(name, dense_init(shape, dt, gen, scale=scale,
                                     quant=quant and name in QUANT_LEAVES))

    # drawn in this order (the JAX tree's), whatever ``leaf`` does
    params = {"embedding": draw("embedding", (V, D), scale=0.02)}
    layers = {
        "attn_norm": ones("attn_norm", L, D),
        "wq": draw("wq", (L, D, H * hd)),
        "wk": draw("wk", (L, D, KV * hd)),
        "wv": draw("wv", (L, D, KV * hd)),
        "wo": draw("wo", (L, H * hd, D)),
        "ffn_norm": ones("ffn_norm", L, D),
    }
    E = cfg.n_experts
    experts = (E,) if E > 0 else ()
    if E > 0:
        layers["router"] = draw("router", (L, D, E))
    layers["w_gate"] = draw("w_gate", (L, *experts, D, Fd))
    layers["w_up"] = draw("w_up", (L, *experts, D, Fd))
    layers["w_down"] = draw("w_down", (L, *experts, Fd, D))
    params["layers"] = layers
    params["final_norm"] = ones("final_norm", D)
    if not cfg.tie_embeddings:
        params["lm_head"] = draw("lm_head", (D, V))
    return params


LORA_TARGETS = ("wq", "wk", "wv", "wo")


def lora_dims(cfg: ModelConfig) -> dict[str, tuple[int, int]]:
    """Each LoRA target's (in, out) dimensions."""
    D, H, KV, hd = cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": (D, H * hd), "wk": (D, KV * hd), "wv": (D, KV * hd),
            "wo": (H * hd, D)}


def lora_nbytes(cfg: ModelConfig, n_adapters: int, rank: int) -> int:
    """Bytes of ``init_lora``'s stacks, from their shapes."""
    n = sum(din + dout for din, dout in lora_dims(cfg).values())
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
        din, dout = lora_dims(cfg)[name]
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


def _expert_mm(h, w):
    """Each expert's product: ``h`` [E or 1, T, in] (1 broadcasts over
    the experts) by ``w`` [E, in, out], dense or an int8
    ``QuantizedLinear`` stack with scales [E, out] -> [E, T, out] in
    ``h``'s dtype. An int8 stack is upcast to ``h``'s dtype and scaled
    after the contraction in float32, as ``ops.quant.qmatmul`` does (the
    JAX package's ``_expert_mm`` scales before its one rounding: equal
    in float32, a bf16 step apart in bf16)."""
    if isinstance(w, QuantizedLinear):
        y = torch.matmul(h, w.w.to(h.dtype))
        return (y.float() * w.scale[:, None, :]).to(h.dtype)
    return torch.matmul(h, w)


def _experts(h, w):
    """The SwiGLU of every expert over its rows: ``h`` [E or 1, T, D]
    -> [E, T, D]."""
    gated = F.silu(_expert_mm(h, w["w_gate"])) * _expert_mm(h, w["w_up"])
    return _expert_mm(gated, w["w_down"])


def _route(hf, router, k: int):
    """The one routing definition both dispatch layouts share (the JAX
    package's ``_route``): the float32 softmax of ``hf`` [T, D] by
    ``router`` [D, E], its top k (the lower expert on equal
    probabilities, as ``lax.top_k``: a stable sort) and their weights
    renormalized to sum to one. Returns (probs [T, E], topv [T, k]
    float32, topi [T, k] int64)."""
    probs = torch.softmax(torch.matmul(hf.float(), router.float()), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    return probs, topv / topv.sum(dim=-1, keepdim=True), topi


def _one_hot(idx, n: int) -> torch.Tensor:
    """``idx`` [...] -> bool [..., n], by comparison (F.one_hot reads its
    input's range back to the host)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _expert_span(cfg: ModelConfig) -> tuple[int, int]:
    """The experts [e_lo, e_hi) this rank runs: its ep block on a
    serving rank, else all of them."""
    hi = getattr(cfg, "e_hi", 0)
    return (cfg.e_lo, hi) if hi else (0, cfg.n_experts)


def _local_experts(buf, w, lo: int, hi: int, E: int):
    """``_experts`` over the rank's experts [lo, hi) of ``buf`` [E, C, D];
    the other experts' rows are zeros (another rank's share of the
    sum)."""
    if (lo, hi) == (0, E):
        return _experts(buf, w)
    out = buf.new_zeros(buf.shape)
    out[lo:hi] = _experts(buf[lo:hi], w)
    return out


def _moe_ffn_grouped(h, w, cfg: ModelConfig, valid=None):
    """Capacity-based grouped dispatch (the JAX package's
    ``_moe_ffn_grouped``): each of the T * k claims, token-major (an
    earlier token wins), takes the next place in its expert's buffer of
    C = ceil(capacity_factor * T * k / E) rows; a claim past C is
    dropped (its token's FFN gets nothing from that expert, the residual
    stream carries it), and so is any claim of a token that ``valid``
    [B, S] marks as padding, which takes no place either. Each expert
    runs its buffer [E, C, D]; the rows come back and combine by the
    renormalized router weights. Returns (out [B, S, D], probs
    [B, S, E])."""
    B, S, D = h.shape
    T = B * S
    E, K = cfg.n_experts, cfg.experts_per_token
    # ceil, not truncate: at capacity factor 1.0 a perfectly balanced
    # router fits with no drops
    cap = max(1, math.ceil(cfg.moe_capacity_factor * T * K / E))
    hf = h.reshape(T, D)
    probs, topv, topi = _route(hf, w["router"], K)
    flat_e = topi.reshape(T * K)
    tok_of = torch.arange(T * K, device=h.device) // K          # token-major
    claims = _one_hot(flat_e, E).to(torch.int32)               # [T*K, E]
    if valid is not None:
        vflat = valid.reshape(T)[tok_of]
        claims = claims * vflat[:, None].to(torch.int32)
    pos = torch.gather(torch.cumsum(claims, dim=0) - claims, 1,
                       flat_e[:, None])[:, 0]                  # [T*K]
    keep = pos < cap
    if valid is not None:
        keep = keep & vflat
    # row C of each buffer takes the dropped writes and is cut off
    buf = h.new_zeros((E, cap + 1, D))
    buf[flat_e, torch.where(keep, pos, cap)] = hf[tok_of]
    lo, hi = _expert_span(cfg)
    out_buf = _local_experts(buf[:, :cap], w, lo, hi, E)       # [E, C, D]
    vals = out_buf[flat_e, torch.where(keep, pos, 0)]          # [T*K, D]
    vals = vals * keep[:, None].to(vals.dtype)
    out = (vals.view(T, K, D) * topv.view(T, K, 1).to(vals.dtype)).sum(1)
    return out.view(B, S, D), probs.view(B, S, E)


def _moe_ffn(h, w, cfg: ModelConfig, valid=None):
    """The mixture-of-experts SwiGLU FFN (the JAX package's
    ``_moe_ffn``): with ``cfg.moe_capacity_factor > 0`` grouped dispatch
    (``_moe_ffn_grouped``), else dense dispatch: every expert computes
    every token ([E, T, D]) and a [T, E] combine that is zero off each
    token's top k sums them; exact, on fixed shapes, at E / k times the
    products of routed dispatch. ``w``: one layer's ``router`` [D, E]
    and expert stacks [E, D, F] / [E, F, D], dense or int8. Returns
    (out [B, S, D], probs [B, S, E] float32).

    On a rank (``cfg.comm``): its experts' stacks hold F/tp hidden
    units, and [e_lo, e_hi) of them under ``ep``; the partial output is
    summed over the ranks in float32 (over ep x tp with a RankView).
    With ``split_rows`` under ep the batch differs across the ep group:
    its rows are gathered first, every rank routes them all, and after
    the sum each keeps its own."""
    comm = getattr(cfg, "comm", None)
    rows = getattr(cfg, "split_rows", False) and getattr(comm, "ep", 1) > 1
    B = h.shape[0]
    if rows:
        if cfg.moe_capacity_factor > 0:
            raise ValueError("grouped MoE dispatch over rows split across "
                             "ep ranks: serving forces dense dispatch for "
                             "a batch of unrelated requests")
        h = comm.gather_rows(h, "ep")
    if cfg.moe_capacity_factor > 0:
        out, probs = _moe_ffn_grouped(h, w, cfg, valid)
    else:
        out, probs = _moe_ffn_dense(h, w, cfg)
    if comm is not None:
        total = getattr(comm, "moe_sum", comm.all_reduce)
        out = total(out.float()).to(out.dtype)
    if rows:
        i = comm.coords["ep"]
        out, probs = out[i * B:(i + 1) * B], probs[i * B:(i + 1) * B]
    return out, probs


def _moe_ffn_dense(h, w, cfg: ModelConfig):
    B, S, D = h.shape
    E = cfg.n_experts
    hf = h.reshape(B * S, D)
    probs, topv, topi = _route(hf, w["router"], cfg.experts_per_token)
    combine = (_one_hot(topi, E) * topv[..., None]).sum(1)     # [T, E]
    lo, hi = _expert_span(cfg)
    y = _experts(hf[None], w)                                  # [e, T, D]
    out = torch.einsum("etd,te->td", y, combine[:, lo:hi].to(y.dtype))
    return out.view(B, S, D), probs.view(B, S, E)


def _layer(x, w, cfg: ModelConfig, cos, sin, positions, attend,
           adapter=None, valid=None):
    """One transformer block; ``attend(q, k, v)`` runs attention;
    ``adapter`` [B] selects each row's LoRA adapter when ``w`` carries
    the stacks; ``valid`` [B, S] bool marks the real tokens for an MoE
    FFN's grouped dispatch (None: all real). Returns (x_out, (k, v),
    router_probs): this block's new keys and values, and an MoE FFN's
    router probabilities [B, S, E] float32 (None for a dense FFN), the
    load-balancing loss's input in training."""
    B, S = x.shape[0], x.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = _enter(cfg, rms_norm(x, w["attn_norm"], cfg.norm_eps))
    q = _project(h, w, "wq", adapter).reshape(B, S, H, hd)
    k = _project(h, w, "wk", adapter).reshape(B, S, KV, hd)
    v = _project(h, w, "wv", adapter).reshape(B, S, KV, hd)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    attn = attend(q, k, v).reshape(B, S, H * hd)
    base = qmatmul(attn, w["wo"])
    delta = _lora(attn, w, "wo", adapter)
    if getattr(cfg, "comm", None) is not None:
        # a row-parallel wo: the rank's delta (its rows of A) is a
        # partial sum too, so it joins the base's before the one sum
        x = x + _reduce(cfg, base if delta is None else base + delta)
    else:
        # (x + base) + delta, the JAX package's order
        x = x + base
        if delta is not None:
            x = x + delta
    h = _enter(cfg, rms_norm(x, w["ffn_norm"], cfg.norm_eps))
    if cfg.n_experts > 0:
        # on ranks each expert's F/tp and the rank's experts: _moe_ffn
        # sums the partial output over the ranks itself
        ffn, probs = _moe_ffn(h, w, cfg, valid)
        return x + ffn, (k, v), probs
    gated = F.silu(qmatmul(h, w["w_gate"])) * qmatmul(h, w["w_up"])
    return x + _reduce(cfg, qmatmul(gated, w["w_down"])), (k, v), None


def _enter(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """A column-parallel product's input: in training (a comm with
    ``enter``, models.common.TrainRanksComm) identity forward and a sum
    of the ranks' gradients backward; anywhere else ``h`` itself."""
    enter = getattr(getattr(cfg, "comm", None), "enter", None)
    return h if enter is None else enter(h)


def _reduce(cfg: ModelConfig, part: torch.Tensor) -> torch.Tensor:
    """A row-parallel projection's partial sum, summed over the
    tensor-parallel ranks in float32 (``cfg.comm``; a RankConfig); a
    model without ranks returns ``part`` itself."""
    comm = getattr(cfg, "comm", None)
    if comm is None:
        return part
    return comm.all_reduce(part.float()).to(part.dtype)


def _weights(params: dict, cfg: ModelConfig, i: int) -> dict:
    """Layer ``i``'s weights as this rank computes with them (gathered
    over fsdp from its blocks by a RankView)."""
    w = _layer_weights(params["layers"], i)
    gather = getattr(getattr(cfg, "comm", None), "gather_layer", None)
    return w if gather is None else gather(w)


def _embed(params: dict, cfg: ModelConfig, tokens) -> torch.Tensor:
    """Token embeddings in the model dtype. A rank of a vocab-split
    embedding looks up the ids in its rows [vocab_lo, vocab_hi), zeros
    the rest, and the ranks sum (one rank holds each id, so the sum is
    exact)."""
    emb = params["embedding"]
    comm = getattr(cfg, "comm", None)
    if hasattr(comm, "embed_rows"):
        # a rank over the data axes: its block of rows (RankView)
        return comm.embed_rows(emb, tokens, cfg).to(cfg.tdtype)
    if comm is None or emb.shape[0] == cfg.vocab_size:
        return emb[tokens].to(cfg.tdtype)
    local = tokens.long() - cfg.vocab_lo
    inside = (local >= 0) & (local < emb.shape[0])
    rows = emb[local.clamp(0, emb.shape[0] - 1)].float()
    rows = torch.where(inside[..., None], rows, 0.0)
    return comm.all_reduce(rows).to(cfg.tdtype)


def _logits(params: dict, cfg: ModelConfig, x) -> torch.Tensor:
    """float32 logits over the whole vocabulary. A rank of a vocab-split
    LM head writes its columns into a zeroed [.., V] and the ranks sum
    it, so every rank holds the same logits."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    comm = getattr(cfg, "comm", None)
    if hasattr(comm, "head_logits"):
        # a rank over the data axes: its block of the head (RankView)
        return comm.head_logits(params, x, cfg)
    head_w = params["embedding" if cfg.tie_embeddings else "lm_head"]
    if getattr(comm, "enter", None) is not None:
        # training: a vocab-split head's input (a whole head's product
        # is every rank's own, its gradient whole on each)
        head = head_w if cfg.tie_embeddings else head_w.t()
        if head.shape[0] != cfg.vocab_size:
            x = _enter(cfg, x)
    if cfg.tie_embeddings:
        local = torch.matmul(x, head_w.t()).float()
    else:
        local = qmatmul(x, head_w).float()
    if comm is None or local.shape[-1] == cfg.vocab_size:
        return local
    full = local.new_zeros((*local.shape[:-1], cfg.vocab_size))
    full[..., cfg.vocab_lo:cfg.vocab_lo + local.shape[-1]] = local
    return comm.all_reduce(full)


def _gathered_layer(gather, i, x, w, *rest):
    """Layer ``i`` on the weights ``gather`` makes of its stored ones."""
    return _layer(x, gather(i, w), *rest)


def _causal(params: dict, cfg: ModelConfig, tokens, lengths, rope_max: int,
            rope_tables, flash_attn: bool, collect_kv: bool = True,
            adapter=None, train: bool = False, remat: bool = False,
            gather=None):
    """Shared causal body of forward/prefill_kv/score: embed, run the
    layers (positions at or past a row's length are padding, ``valid``
    False for an MoE FFN). Attention is K1 (``flash_attn``), its plain
    version, or with ``train`` the plain ``causal_attention`` under the
    validity mask, the JAX package's training attention. ``remat`` runs
    each layer under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward pass instead of kept. ``gather(i, w)``
    (training on ranks, parallel.train) maps layer i's stored weights to
    the ones it computes with, inside the checkpointed region, so
    ``remat`` gathers them again for the recomputation. Returns (x
    [B, S, D], k_stack, v_stack [L, B, S, KV, hd] -- None without
    ``collect_kv`` --, lengths, each layer's router probabilities [B, S,
    E] float32 -- None for a dense FFN)."""
    B, S = tokens.shape
    device = tokens.device
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=device)
    lengths = lengths.to(torch.int32)
    cos, sin = rope_tables or get_rope_tables(cfg, rope_max, device)
    positions = torch.arange(S, device=device).expand(B, S)
    valid = positions < lengths[:, None]
    if train:
        def attend(q, k, v):
            return causal_attention(q, k, v, mask=valid)
    elif flash_attn:
        def attend(q, k, v):
            return flash.flash_causal_prefill(q, k, v, lengths)
    else:
        def attend(q, k, v):
            return flash.causal_prefill_plain(q, k, v, lengths)

    x = _embed(params, cfg, tokens)
    if train:
        # one unbind a stacked leaf: its backward stacks the layers'
        # gradients once, where a slice a layer (layer_weights) would
        # write a zero-filled full-size gradient per layer and sum them
        rows = {k: torch.unbind(v) for k, v in params["layers"].items()}
        weights = [{k: r[i] for k, r in rows.items()}
                   for i in range(cfg.n_layers)]
    ks, vs, probs = [], [], []
    for i in range(cfg.n_layers):
        w = weights[i] if train else _weights(params, cfg, i)
        args = (x, w, cfg, cos, sin, positions, attend, adapter, valid)
        fn = _layer
        if gather is not None:
            fn, args = _gathered_layer, (gather, i, *args)
        if remat:
            x, (k, v), p = checkpoint(fn, *args, use_reentrant=False,
                                      preserve_rng_state=False)
        else:
            x, (k, v), p = fn(*args)
        if collect_kv:
            ks.append(k)
            vs.append(v)
        probs.append(p)
    if not collect_kv:
        return x, None, None, lengths, probs
    return x, torch.stack(ks), torch.stack(vs), lengths, probs


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            lengths: torch.Tensor | None = None, rope_tables=None,
            flash: bool = False, adapter=None, *,
            return_router_probs: bool = False, train: bool = False,
            remat: bool = False, gather=None):
    """Cache-free causal forward over [B, S] tokens -> [B, S, V] float32
    logits; ``adapter`` [B]: each row's LoRA adapter.

    ``train``: the training forward (parallel.train), attention through
    ``ops.attention.causal_attention`` with the validity mask, as the JAX
    package's ``forward``; ``remat``: each layer checkpointed;
    ``gather``: a training rank's per-layer gather (``_causal``).
    ``return_router_probs``: returns (logits, probs [L, B, S, E]
    float32), probs None for a dense model."""
    x, _, _, _, probs = _causal(params, cfg, tokens, lengths,
                                tokens.shape[1], rope_tables, flash,
                                collect_kv=False, adapter=adapter,
                                train=train, remat=remat, gather=gather)
    logits = _logits(params, cfg, x)
    if not return_router_probs:
        return logits
    return logits, torch.stack(probs) if cfg.n_experts > 0 else None


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
    x, _, _, _, _ = _causal(params, cfg, tokens, lengths, tokens.shape[1],
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
    x, k_stack, v_stack, lengths, _ = _causal(
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

    x = _embed(params, cfg, tokens)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        k_l, v_l = row(cache.k, i), row(cache.v, i)
        ks_l = row(cache.k_scale, i) if cache.quantized else None
        vs_l = row(cache.v_scale, i) if cache.quantized else None

        def attend(q, k_new, v_new, k_l=k_l, v_l=v_l, ks_l=ks_l, vs_l=vs_l):
            return chunk_attention(q, k_l, v_l, k_new, v_new, start, ks_l,
                                   vs_l)

        x, (k, v), _ = _layer(x, _weights(params, cfg, i), cfg,
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

    x = _embed(params, cfg, tokens[:, None])                  # [B, 1, D]
    k_toks, v_toks = [], []
    for i in range(cfg.n_layers):
        k_l, v_l = cache.k[i], cache.v[i]
        ks_l = cache.k_scale[i] if cache.quantized else None
        vs_l = cache.v_scale[i] if cache.quantized else None

        def attend(q, k_new, v_new, k_l=k_l, v_l=v_l, ks_l=ks_l, vs_l=vs_l):
            return attn_fn(q, k_l, v_l, k_new, v_new, lengths, ks_l, vs_l)

        x, (k, v), _ = _layer(x, _weights(params, cfg, i), cfg,
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

    x = _embed(params, cfg, tokens)                           # [B, W, D]
    k_w, v_w = [], []
    for i in range(cfg.n_layers):
        k_l, v_l = cache.k[i], cache.v[i]
        ks_l = cache.k_scale[i] if cache.quantized else None
        vs_l = cache.v_scale[i] if cache.quantized else None

        def attend(q, k_new, v_new, k_l=k_l, v_l=v_l, ks_l=ks_l, vs_l=vs_l):
            return window_attention_appended(q, k_l, v_l, k_new, v_new,
                                             lengths, ks_l, vs_l)

        x, (k, v), _ = _layer(x, _weights(params, cfg, i), cfg,
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
