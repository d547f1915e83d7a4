"""Tensor-parallel slicing rules (counterpart of
gofr_tpu/parallel/sharding.py's spec table, ``shard_params`` and
``kv_head_shards``).

The JAX package maps each leaf to a ``PartitionSpec`` and lets GSPMD
insert the collectives. Here each rule is a slice of a torch tensor (or
a numpy array, for a checkpoint sliced before it reaches the device),
and the model code sums the ranks' partial results itself
(models.llama ``_reduce``, ``_embed``, ``_logits``), Megatron-style:

  column-parallel  wq, wk, wv, w_gate, w_up   split on the output dim
  row-parallel     wo, w_down                 split on the input dim
  embedding        [V, D]   split over vocab rows (a masked local
                             lookup, then a sum over the ranks)
  lm_head          [D, V]   split over vocab columns (each rank writes
                             its slice of a zeroed [.., V] and the ranks
                             sum it)
  norms                     replicated
  LoRA stacks               B of wq/wk/wv split like its projection's
                             output columns, their A replicated; A of wo
                             split like wo's input rows, its B replicated
                             (the delta joins wo's partial sum)

An int8 ``QuantizedLinear`` is sliced like its weight; its per-output
scale is split with a column split and kept whole with a row split (the
rows share their column's scale). A vocabulary the tp does not divide
stays whole on every rank, as JAX's ``fit_spec`` replicates an axis
that does not divide.

Heads: ``tp`` must divide ``n_heads`` and ``ffn_dim``, and either
divide ``n_kv_heads`` (each rank holds KV/tp KV heads) or be a multiple
of it (each KV head is replicated on tp/KV ranks, each rank holding the
one its query heads read). Anything else raises ShardingConfigError.
JAX refuses only a tp that splits a KV head beside data axes and serves
the other misfits on its jnp fallback (gofr_tpu/tpu/generator.py:
699-722); the port refuses them (ROADMAP queue 3).

Training (parallel.train) stores the state in JAX's layout: ``spec_for``
maps each leaf to a spec over the mesh axes (a tuple, one entry a dim:
None, an axis name, or a tuple of names, major first, as a JAX
``PartitionSpec``), ``fit_spec`` replicates any axis that does not
divide its dim, and ``shard_block`` is the slice of the leaf a rank
holds at its coordinates: column-parallel leaves ``(None, fsdp, tp)``,
row-parallel ``(None, tp, fsdp)``, the embedding's vocabulary over
``(tp, fsdp)``, ``lm_head`` ``(fsdp, tp)``, norms and the router
replicated. The step computes with the Megatron split above
(``train_span``), gathered from those blocks.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..errors import ShardingConfigError
from ..models.common import ModelConfig, RankConfig
from .mesh import AXIS_EP, AXIS_FSDP, AXIS_PP, AXIS_SP, AXIS_TP, DATA_AXES

# leaf name -> the dim it splits on (JAX's _COLUMN / _ROW)
_COLUMN = {"wq", "wk", "wv", "w_gate", "w_up"}
_ROW = {"wo", "w_down"}


def check_tp(cfg: ModelConfig, tp: int, row: str = "",
             model_row: str = "") -> None:
    """Refuse a tp the model's head counts do not take, or a mixture of
    experts (tp inside each expert and ep across them are not ported),
    naming the row (and ``model_row``, the TPU_MODEL value)."""
    if tp <= 1:
        return
    row = row or f"tp={tp}"
    if cfg.n_experts > 0:
        raise ShardingConfigError(
            f"TPU_SHARDING={row!r} cannot serve TPU_MODEL="
            f"{model_row or cfg.name!r}: a mixture of experts is served "
            "on one device only (tp inside each expert and ep across "
            "them are ROADMAP item 11b); unset TPU_SHARDING",
            sharding_row=row)
    H, KV, F = cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim
    bad = []
    if H % tp:
        bad.append(f"n_heads={H}")
    if F % tp:
        bad.append(f"ffn_dim={F}")
    if KV % tp and tp % KV:
        bad.append(f"n_kv_heads={KV} (tp must divide it or be a "
                   "multiple of it)")
    if bad:
        raise ShardingConfigError(
            f"TPU_SHARDING={row!r}: tp={tp} does not fit model "
            f"{cfg.name!r}: {', '.join(bad)}", sharding_row=row)


def kv_head_shards(tp: int, n_kv_heads: int) -> int:
    """How many distinct KV-head shards the ranks hold: tp when tp
    divides the KV heads, else the KV head count (each head replicated
    on tp / KV ranks)."""
    if tp <= 1:
        return 1
    return tp if n_kv_heads % tp == 0 else n_kv_heads


def kv_frame_shards(tp: int, n_kv_heads: int) -> int:
    """The KV-head shards a row's host snapshot and its T2 frames are
    cut in: the JAX package's ``kv_head_shards`` (tp when tp divides the
    KV heads, else 1: a replicated head axis is one dense shard), so a
    port engine and a JAX mesh engine of one tp share frames. The T2
    namespace carries it (``:tp{n}`` when n > 1)."""
    return tp if tp > 1 and n_kv_heads % tp == 0 else 1


def kv_head_range(cfg: ModelConfig, tp: int, rank: int) -> tuple[int, int]:
    """The KV heads [lo, hi) of the whole model that rank ``rank``'s
    caches hold: KV/tp heads a rank, or the one head the rank's query
    heads read where heads are replicated."""
    KV = cfg.n_kv_heads
    if tp <= 1:
        return 0, KV
    if KV % tp == 0:
        n = KV // tp
        return rank * n, (rank + 1) * n
    head = rank // (tp // KV)
    return head, head + 1


def kv_head_owners(cfg: ModelConfig, tp: int) -> list[int]:
    """One rank a distinct KV-head range, in head order: the ranks whose
    cache rows make up a whole row (the first of each replica group)."""
    seen, out = set(), []
    for r in range(max(tp, 1)):
        span = kv_head_range(cfg, tp, r)
        if span not in seen:
            seen.add(span)
            out.append(r)
    return out


def vocab_range(cfg: ModelConfig, tp: int, rank: int) -> tuple[int, int]:
    """The vocabulary ids [lo, hi) of rank ``rank``'s embedding rows and
    LM-head columns: an even split, or the whole vocabulary when tp does
    not divide it."""
    V = cfg.vocab_size
    if tp <= 1 or V % tp:
        return 0, V
    n = V // tp
    return rank * n, (rank + 1) * n


def rank_config(cfg: ModelConfig, tp: int, rank: int,
                comm: Any = None) -> ModelConfig:
    """Rank ``rank``'s view of ``cfg`` (models.common.RankConfig): its
    H/tp query heads, KV/tp KV heads (1 where KV heads are replicated)
    and ffn/tp hidden units, with ``comm`` to sum the ranks' partials.
    With tp = 1 the model's own config."""
    if tp <= 1:
        return cfg
    check_tp(cfg, tp)
    lo, hi = vocab_range(cfg, tp, rank)
    fields = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__
              if k in ModelConfig.__dataclass_fields__}
    fields.update(n_heads=cfg.n_heads // tp,
                  n_kv_heads=max(cfg.n_kv_heads // tp, 1),
                  ffn_dim=cfg.ffn_dim // tp)
    return RankConfig(**fields, tp=tp, rank=rank, full_heads=cfg.n_heads,
                      vocab_lo=lo, vocab_hi=hi, comm=comm)


# LoRA stack -> (the projection whose split it follows, column split)
_LORA = {"lora_b_wq": ("wq", True), "lora_b_wk": ("wk", True),
         "lora_b_wv": ("wv", True), "lora_a_wo": ("wo", False)}


def _span(name: str, cfg: ModelConfig, rank: int, tp: int
          ) -> tuple[int, int] | None:
    """[lo, hi) of the split dim of leaf ``name`` on rank ``rank``, or
    None for a replicated leaf."""
    hd = cfg.dim // cfg.n_heads
    if name in _LORA:
        return _span(_LORA[name][0], cfg, rank, tp)
    if name in ("wq", "wo"):
        n = cfg.n_heads // tp * hd
        return rank * n, (rank + 1) * n
    if name in ("wk", "wv"):
        KV = cfg.n_kv_heads
        if KV % tp == 0:
            n = KV // tp * hd
            return rank * n, (rank + 1) * n
        head = rank // (tp // KV)
        return head * hd, (head + 1) * hd
    if name in ("w_gate", "w_up", "w_down"):
        n = cfg.ffn_dim // tp
        return rank * n, (rank + 1) * n
    if name in ("embedding", "lm_head"):
        lo, hi = vocab_range(cfg, tp, rank)
        return None if (lo, hi) == (0, cfg.vocab_size) else (lo, hi)
    return None


def _is_quantized(node) -> bool:
    return isinstance(node, tuple) and getattr(node, "_fields", None) == (
        "w", "scale")


def _take(x, axis: int, lo: int, hi: int):
    """x[..., lo:hi, ...] on ``axis`` as a new contiguous array or
    tensor of its own (no view keeps the whole leaf alive)."""
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(lo, hi)
    part = x[tuple(idx)]
    if isinstance(part, np.ndarray):
        return np.ascontiguousarray(part).copy()
    return part.contiguous().clone()


def shard_leaf(name: str, leaf, cfg: ModelConfig, rank: int, tp: int):
    """Rank ``rank``'s slice of parameter leaf ``name`` (a tensor, a
    numpy array or a QuantizedLinear of either)."""
    span = _span(name, cfg, rank, tp) if tp > 1 else None
    if span is None:
        return leaf
    lo, hi = span
    if name == "embedding":
        return _take(leaf, 0, lo, hi)
    column = (name in _COLUMN or name == "lm_head"
              or _LORA.get(name, ("", False))[1])
    if _is_quantized(leaf):
        w = _take(leaf.w, leaf.w.ndim - (1 if column else 2), lo, hi)
        scale = (_take(leaf.scale, leaf.scale.ndim - 1, lo, hi) if column
                 else leaf.scale)
        return type(leaf)(w=w, scale=scale)
    return _take(leaf, leaf.ndim - (1 if column else 2), lo, hi)


def shard_params(params: dict, cfg: ModelConfig, rank: int, tp: int
                 ) -> dict:
    """Rank ``rank``'s shard of a full Llama parameter tree (the layout
    of models.llama.init, LoRA stacks (models.llama.init_lora) among the
    layers' leaves or not)."""
    if tp <= 1:
        return params
    check_tp(cfg, tp)
    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = {n: shard_leaf(n, leaf, cfg, rank, tp)
                      for n, leaf in v.items()}
        else:
            out[k] = shard_leaf(k, v, cfg, rank, tp)
    return out


# -- the training layout (gofr_tpu/parallel/sharding.py's spec table) --------

# leaf name -> the spec of the whole (possibly [L, ...]-stacked) leaf
_T_COLUMN = {"wq", "wk", "wv", "w_gate", "w_up", "w_in"}
_T_ROW = {"wo", "w_down", "w_out"}
_T_COLUMN_BIAS = {"bq", "bk", "bv", "b_in"}
_T_ROW_BIAS = {"bo", "b_out"}


def spec_for(name: str, ndim: int, stacked: bool = False) -> tuple:
    """The spec of parameter leaf ``name`` (JAX's ``spec_for``):
    ``stacked`` leaves lead with their [L] dim over pp."""
    lead = AXIS_PP if stacked else None
    if name in _T_COLUMN:
        if ndim == 4:   # MoE experts [L, E, D, F]
            return (lead, AXIS_EP, AXIS_FSDP, AXIS_TP)
        return (lead, AXIS_FSDP, AXIS_TP) if ndim == 3 \
            else (AXIS_FSDP, AXIS_TP)
    if name in _T_ROW:
        if ndim == 4:   # MoE experts [L, E, F, D]
            return (lead, AXIS_EP, AXIS_TP, AXIS_FSDP)
        return (lead, AXIS_TP, AXIS_FSDP) if ndim == 3 \
            else (AXIS_TP, AXIS_FSDP)
    if name in _T_COLUMN_BIAS:
        return (lead, AXIS_TP) if ndim == 2 else (AXIS_TP,)
    if name in _T_ROW_BIAS:
        return (lead, AXIS_FSDP) if ndim == 2 else (AXIS_FSDP,)
    if name == "embedding":
        # the vocabulary over (tp, fsdp), the feature dim whole
        return ((AXIS_TP, AXIS_FSDP), None)
    if name == "lm_head":
        return (AXIS_FSDP, AXIS_TP)
    if name in ("pos_embedding", "patch_proj", "pooler_w", "head"):
        return (None, AXIS_FSDP) if ndim == 2 else (AXIS_FSDP,)
    if stacked and ndim >= 1:   # per-layer norms and the router
        return (lead,)
    return ()


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _axis_size(plan, entry) -> int:
    n = 1
    for ax in _names(entry):
        n *= getattr(plan, ax)
    return n


def fit_spec(spec: tuple, shape: tuple, plan) -> tuple:
    """``spec`` padded or cut to ``len(shape)``, each entry whose axes
    do not divide its dim replaced by None (replicated), as JAX's
    ``fit_spec``."""
    axes = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(ax if ax is not None and dim % _axis_size(plan, ax) == 0
                 else None for dim, ax in zip(shape, axes[:len(shape)]))


def param_specs(params: dict, stacked: bool = False) -> dict:
    """The (unfitted) spec of every leaf of a Llama parameter tree, the
    tree's own nesting (JAX's ``param_specs``)."""
    return {k: (param_specs(v, stacked or k == "layers")
                if isinstance(v, dict)
                else spec_for(k, v.ndim, stacked=stacked))
            for k, v in params.items()}


def batch_spec() -> tuple:
    """Tokens [B, S]: the batch over the data axes, the sequence over
    sp (JAX's ``batch_spec``)."""
    return (DATA_AXES, AXIS_SP)


def shard_block(spec: tuple, shape: tuple, plan, coords: dict
                ) -> tuple[tuple[int, int], ...]:
    """The [lo, hi) of each dim of the block a rank at ``coords`` holds
    of a leaf of ``shape`` under the fitted ``spec``: an axis entry
    splits its dim evenly, a tuple of axes by their joint index (the
    first axis major)."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = _axis_size(plan, entry)
        idx = 0
        for ax in _names(entry):
            idx = idx * getattr(plan, ax) + coords[ax]
        k = dim // n
        out.append((idx * k, (idx + 1) * k))
    return tuple(out)


def spec_axes(spec: tuple, plan) -> set:
    """The axes above 1 that split some dim under ``spec``."""
    return {ax for entry in spec for ax in _names(entry)
            if getattr(plan, ax) > 1}


def train_span(name: str, ndim: int, cfg: ModelConfig, tp: int, t: int
               ) -> tuple[int, int, int] | None:
    """(dim, lo, hi): the part of leaf ``name`` tensor-parallel rank
    ``t`` computes with (the Megatron split of ``shard_leaf``), None
    where every rank computes with the whole leaf. A leaf the split has
    no rule for raises under tp > 1."""
    if tp <= 1:
        return None
    if name not in _COLUMN | _ROW | {"embedding", "lm_head", "attn_norm",
                                     "ffn_norm", "final_norm"}:
        raise ShardingConfigError(
            f"leaf {name!r} has no tensor-parallel training rule")
    span = _span(name, cfg, t, tp)
    if span is None:
        return None
    if name == "embedding":
        dim = 0
    elif name in _ROW:
        dim = ndim - 2
    else:
        dim = ndim - 1
    return (dim, *span)
