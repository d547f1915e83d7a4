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

Serving over the data axes (a ``TPU_SHARDING`` plan over dp, fsdp, ep
and tp, ``check_plan``) stores the weights in the same layout: each
rank its block (``block_leaf``, ``rank_blocks``; an expert stack's
experts over ep, an int8 scale split on its output axis only), a
layer's blocks gathered over fsdp at each dispatch and the embedding
and LM head computed on the rank's blocks (``RankView``). A contiguous
cache holds the rank's data index's slots (``slot_range``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..errors import ShardingConfigError
from ..models.common import ModelConfig, RankConfig
from ..ops.quant import QUANT_LEAVES, quantize_int8
from .mesh import AXIS_EP, AXIS_FSDP, AXIS_PP, AXIS_SP, AXIS_TP, DATA_AXES

# leaf name -> the dim it splits on (JAX's _COLUMN / _ROW)
_COLUMN = {"wq", "wk", "wv", "w_gate", "w_up"}
_ROW = {"wo", "w_down"}


def check_plan(cfg: ModelConfig, plan, row: str = "",
               model_row: str = "") -> None:
    """Refuse a serving plan ``cfg`` does not take, naming the row (and
    ``model_row``, the TPU_MODEL value): a tp the head counts or the
    FFN width (inside each expert, for a mixture of experts) do not
    take, an ep that does not divide a mixture's experts, and -- JAX's
    own refusal (gofr_tpu/tpu/generator.py:698-723) -- a tp that splits
    a KV head beside data axes of product above 1."""
    tp = plan.tp
    row = row or plan.row()
    model = model_row or cfg.name
    H, KV, F, E = cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim, cfg.n_experts
    if E > 0 and plan.ep > 1 and E % plan.ep:
        raise ShardingConfigError(
            f"TPU_SHARDING={row!r} cannot serve TPU_MODEL={model!r}: "
            f"ep={plan.ep} does not divide the mixture of experts' "
            f"n_experts={E}", sharding_row=row)
    if tp <= 1:
        return
    bad = []
    if H % tp:
        bad.append(f"n_heads={H}")
    if F % tp:
        bad.append(f"ffn_dim={F}" + (" (inside each expert)" if E else ""))
    if KV % tp and tp % KV:
        bad.append(f"n_kv_heads={KV} (tp must divide it or be a "
                   "multiple of it)")
    if bad:
        what = (f"TPU_SHARDING={row!r} cannot serve TPU_MODEL={model!r}"
                if E else f"TPU_SHARDING={row!r}")
        raise ShardingConfigError(
            f"{what}: tp={tp} does not fit model {cfg.name!r}: "
            f"{', '.join(bad)}", sharding_row=row)
    if KV % tp and plan.data > 1:
        raise ShardingConfigError(
            f"TPU_SHARDING={row!r}: tp={tp} splits a KV head "
            f"(n_kv_heads={KV}) on a multi-axis mesh (data axes product "
            f"{plan.data}) -- a verified wrong-logits configuration. Use "
            "a tp that divides n_kv_heads, or drop the data axes "
            "(dp/fsdp=1) to serve tp-only", sharding_row=row)


def check_tp(cfg: ModelConfig, tp: int, row: str = "",
             model_row: str = "") -> None:
    """``check_plan`` for a tensor-parallel plan of ``tp`` ranks."""
    from .mesh import MeshPlan

    check_plan(cfg, MeshPlan(tp=max(tp, 1)), row or f"tp={tp}", model_row)


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
                      vocab_lo=lo, vocab_hi=hi, comm=comm, e_lo=0,
                      e_hi=cfg.n_experts)


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
                                     "ffn_norm", "final_norm", "router"}:
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


# -- leaf layouts: training's state and serving over the data axes ---------

def _param_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    """Every leaf's path -> its shape, as ``models.llama.init`` draws
    them, in leaf order."""
    L, D, H, KV, hd, Fd, V, E = (cfg.n_layers, cfg.dim, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.head_dim, cfg.ffn_dim,
                                 cfg.vocab_size, cfg.n_experts)
    ex = (E,) if E > 0 else ()
    layers = {"attn_norm": (L, D), "wq": (L, D, H * hd),
              "wk": (L, D, KV * hd), "wv": (L, D, KV * hd),
              "wo": (L, H * hd, D), "ffn_norm": (L, D),
              "w_gate": (L, *ex, D, Fd), "w_up": (L, *ex, D, Fd),
              "w_down": (L, *ex, Fd, D)}
    if E > 0:
        layers["router"] = (L, D, E)
    out = {"embedding": (V, D), "final_norm": (D,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (D, V)
    out.update({f"layers/{k}": v for k, v in layers.items()})
    return dict(sorted(out.items()))


Box = tuple  # ((lo, hi), ...) a dim


def _slices(box: Box, base: Box) -> tuple:
    """``box`` as slices of a tensor that holds ``base``."""
    return tuple(slice(lo - b0, hi - b0)
                 for (lo, hi), (b0, _) in zip(box, base))


def _dims(box: Box) -> tuple:
    return tuple(hi - lo for lo, hi in box)


def _numel(box: Box) -> int:
    n = 1
    for lo, hi in box:
        n *= hi - lo
    return n


def _holds(spec: tuple, plan, coords: dict) -> bool:
    """Whether the rank at ``coords`` is the one that counts its block:
    dp index 0, and index 0 on each of fsdp and tp the spec does not
    split on (the block is the same on every rank along those)."""
    used = spec_axes(spec, plan)
    return coords["dp"] == 0 and all(coords[ax] == 0 for ax in ("fsdp", "tp")
                                     if ax not in used)


@dataclass(frozen=True)
class LeafLayout:
    """Where one leaf sits on one rank. Boxes are [lo, hi) a dim of the
    whole leaf: ``block`` the rank stores, ``region`` the rank gathers
    (over its ``gather`` group, None where the block is the region),
    ``compute`` the part it computes with (inside ``region``).
    ``aligned``: the rank's fsdp group's blocks make its compute part
    (else the region is the whole leaf, over the fsdp x tp group);
    ``writes``: this rank puts its block into the gather; ``tp_split``:
    the tp ranks compute with parts of the leaf (else each with all of
    it); ``holds``: this rank counts its block (the norm, the save)."""

    path: str
    shape: tuple
    spec: tuple
    block: Box
    region: Box
    compute: Box
    gather: str | None
    aligned: bool
    writes: bool
    tp_split: bool
    holds: bool

    def reduce_group(self, split: bool) -> str | None:
        """The group its gradient sums over: the data group for a split
        batch, and tp where the split differs from the stored one."""
        if self.aligned:
            return "data" if split else None
        return "world" if split else "tp"


def _leaf_spec(path: str, ndim: int, scale: bool) -> tuple:
    """The unfitted spec of leaf ``path``, or (``scale``) of the
    per-output-channel scale of its int8 form: only the output axis's
    entry, on its last dim, plus the layer dim over pp (JAX's
    ``param_specs``)."""
    name = path.rpartition("/")[2]
    stacked = path.startswith("layers/")
    if not scale:
        return spec_for(name, ndim, stacked)
    weight = spec_for(name, ndim + 1, stacked)
    tail = weight[-1] if len(weight) else None
    if ndim >= 2:
        return (AXIS_PP if stacked else None, *([None] * (ndim - 2)), tail)
    return (tail,)


def expert_range(cfg: ModelConfig, plan, coords: dict) -> tuple[int, int]:
    """The experts [e_lo, e_hi) the rank at ``coords`` runs: its block
    of E/ep (the whole set without experts' ep split)."""
    E = cfg.n_experts
    if E == 0 or plan.ep <= 1 or E % plan.ep:
        return 0, E
    n = E // plan.ep
    return coords[AXIS_EP] * n, (coords[AXIS_EP] + 1) * n


def leaf_layout(path: str, shape: tuple, cfg: ModelConfig, plan,
                coords: dict, scale: bool = False) -> LeafLayout:
    """The ``LeafLayout`` of leaf ``path`` (of ``shape``) on the rank at
    ``coords`` of ``plan``; ``scale``: of its int8 scale (``shape`` the
    scale's), whose compute part is its weight's less the contraction
    dim. A rank computes with the Megatron split of its tp index and,
    for an expert stack, the experts of its ep index."""
    name = path.rpartition("/")[2]
    spec = fit_spec(_leaf_spec(path, len(shape), scale), shape, plan)
    full = tuple((0, n) for n in shape)
    wshape = shape[:-1] + (0,) + shape[-1:] if scale else shape

    def compute_at(t):
        box = [(0, n) for n in wshape]
        span = train_span(name, len(wshape), cfg, plan.tp, t)
        if span is not None:
            box[span[0]] = span[1:]
        if len(wshape) == 4 and name in _COLUMN | _ROW:
            box[1] = expert_range(cfg, plan, coords)
        if scale:
            del box[-2]
        return tuple(box)

    def fsdp_region(t):
        blocks = [shard_block(spec, shape, plan, dict(coords, fsdp=f, tp=t))
                  for f in range(plan.fsdp)]
        return tuple((min(b[i][0] for b in blocks),
                      max(b[i][1] for b in blocks))
                     for i in range(len(shape)))

    aligned = all(fsdp_region(t) == compute_at(t) for t in range(plan.tp))
    block = shard_block(spec, shape, plan, coords)
    region = fsdp_region(coords["tp"]) if aligned else full
    axes = ("fsdp",) if aligned else ("fsdp", "tp")
    used = spec_axes(spec, plan)
    return LeafLayout(
        path=path, shape=tuple(shape), spec=spec, block=block,
        region=region, compute=compute_at(coords["tp"]),
        gather=None if block == region else ("fsdp" if aligned
                                             else "model"),
        aligned=aligned,
        writes=all(coords[ax] == 0 for ax in axes if ax not in used),
        tp_split=train_span(name, len(shape), cfg, plan.tp, 0) is not None,
        holds=_holds(spec, plan, coords))


def gather_blocks(groups, lays: list, shards: list, layer: bool) -> list:
    """The parts ``lays`` (LeafLayouts) say their ranks compute with,
    from the blocks ``shards`` they store: a slice of a block, or for a
    leaf gathered over a group (``lay.gather``) its region assembled
    over that group (``groups.gather_bytes``: one zero-filled buffer a
    group, each rank writing its block) and sliced. ``layer``: the
    shards are one layer's (the layouts' leading [L] dim is cut)."""
    cut = 1 if layer else 0

    def boxes(lay):
        return lay.block[cut:], lay.region[cut:], lay.compute[cut:]

    out: list = [None] * len(shards)
    jobs: dict[str, list] = {}
    for i, (lay, x) in enumerate(zip(lays, shards)):
        block, _, comp = boxes(lay)
        if lay.gather is None:
            out[i] = x[_slices(comp, block)]
        else:
            jobs.setdefault(lay.gather, []).append(i)
    for kind, idx in jobs.items():
        sizes = [_numel(boxes(lays[i])[1]) * shards[i].element_size()
                 for i in idx]
        offs = [0]
        for n in sizes:
            offs.append(offs[-1] + -(-n // 4) * 4)
        buf = torch.zeros(offs[-1], dtype=torch.uint8,
                          device=shards[idx[0]].device)
        regions = []
        for i, off, n in zip(idx, offs, sizes):
            lay, x = lays[i], shards[i]
            block, region, _ = boxes(lay)
            reg = buf[off:off + n].view(x.dtype).view(_dims(region))
            if lay.writes:
                reg[_slices(block, region)] = x
            regions.append(reg)
        groups.gather_bytes(buf, kind)
        for i, reg in zip(idx, regions):
            _, region, comp = boxes(lays[i])
            out[i] = reg[_slices(comp, region)]
    return out


# -- serving over the data axes ----------------------------------------------

# why a plan with data axes refuses the prefix tiers, LoRA and tenancy:
# each row's host seams would have to follow a slot's owner
NOT_BESIDE_DATA_AXES = (
    "beside the data axes (dp, fsdp, ep) the prefix tiers (T1/T2), the "
    "paged prefix index, LoRA and tenancy are not ported yet (ROADMAP "
    "item 11b step 3d); serve them under tp alone")


def slot_range(plan, coords: dict, slots: int) -> tuple[int, int]:
    """The slots [lo, hi) of a contiguous cache of ``slots`` rows that
    the rank at ``coords`` holds: its data index's even share, in
    (dp, fsdp, ep) major-to-minor order, or every slot where the data
    axes' product does not divide ``slots`` (JAX's ``fit_spec``
    replicates the batch axis then)."""
    n = plan.data
    if n <= 1 or slots % n:
        return 0, slots
    own = slots // n
    d = plan.data_index(coords)
    return d * own, (d + 1) * own


_TOP = ("embedding", "final_norm", "lm_head")


def leaf_path(name: str) -> str:
    """A Llama leaf's path in the parameter tree from its name."""
    return name if name in _TOP else f"layers/{name}"


def _cut(x, box: Box):
    """``x`` at ``box`` as an array or tensor of its own."""
    part = x[_slices(box, tuple((0, n) for n in x.shape))]
    if isinstance(part, np.ndarray):
        return np.ascontiguousarray(part).copy()
    return part.contiguous().clone()


def block_leaf(path: str, leaf, cfg: ModelConfig, plan, coords: dict,
               quant: bool = False):
    """The block of leaf ``path`` (a tensor, an array, or an int8
    QuantizedLinear of either) the rank at ``coords`` stores under a
    plan with data axes: the weight at its layout's block and an int8
    scale at its own (only its output axis split). ``quant``: a float
    projection leaf is int8-quantized on the way, its codes the block
    of the whole leaf's codes (the whole leaf's per-channel scales over
    the uncut contraction axis) and its scale the whole leaf's at the
    scale's block."""
    if _is_quantized(leaf):
        lw = leaf_layout(path, tuple(leaf.w.shape), cfg, plan, coords)
        ls = leaf_layout(path, tuple(leaf.scale.shape), cfg, plan, coords,
                         scale=True)
        return type(leaf)(w=_cut(leaf.w, lw.block),
                          scale=_cut(leaf.scale, ls.block))
    lay = leaf_layout(path, tuple(leaf.shape), cfg, plan, coords)
    name = path.rpartition("/")[2]
    if not (quant and name in QUANT_LEAVES and isinstance(leaf, torch.Tensor)
            and leaf.ndim in (2, 3, 4)):
        return _cut(leaf, lay.block)
    from ..ops.quant import QuantizedLinear

    axis = leaf.ndim - 2
    whole = tuple((0, n) for n in leaf.shape)
    rows = list(lay.block)
    rows[axis] = whole[axis]
    part = leaf[_slices(lay.block, whole)]
    wide = leaf[_slices(tuple(rows), whole)]
    codes = quantize_int8(part, axis, whole=None if wide.shape == part.shape
                          else wide).w
    shape = tuple(leaf.shape[:axis]) + tuple(leaf.shape[axis + 1:])
    sbox = list(leaf_layout(path, shape, cfg, plan, coords, scale=True).block)
    sbox.insert(axis, whole[axis])
    scale = quantize_int8(leaf[_slices(tuple(sbox), whole)], axis).scale
    return QuantizedLinear(codes.contiguous(), scale.contiguous())


def rank_blocks(params: dict, cfg: ModelConfig, plan, rank: int) -> dict:
    """Rank ``rank``'s blocks (``block_leaf``) of a whole Llama
    parameter tree under a plan with data axes."""
    coords = plan.coords(rank)
    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = {n: block_leaf(f"layers/{n}", leaf, cfg, plan, coords)
                      for n, leaf in v.items()}
        else:
            out[k] = block_leaf(k, v, cfg, plan, coords)
    return out


class RankView:
    """A serving rank's ``RankConfig.comm`` under a plan with data axes
    (``comm``: its parallel.distributed.TPComm, ``cfg`` the whole
    model's): the model's sums over ``tp`` (``all_reduce``), the parts
    of each layer's weights gathered from the stored blocks over
    ``fsdp`` (``gather_layer``: ``gather_blocks``, a slice where a block
    is its part), the embedding and the LM head on the rank's own blocks
    summed over fsdp x tp (``embed_rows``, ``head_logits``: a table of a
    quarter of the vocabulary moves no weights, only the rows' sums), a
    group's rows gathered (``gather_rows``) and an MoE layer's partial
    outputs summed over ``ep x tp`` (``moe_sum``)."""

    def __init__(self, comm, cfg: ModelConfig, plan, rank: int):
        self.comm = comm
        self.plan = plan
        self.coords = plan.coords(rank)
        self.ep = plan.ep
        self._lays: dict = {}
        for path, shape in _param_shapes(cfg).items():
            self._lays[path] = leaf_layout(path, shape, cfg, plan,
                                           self.coords)
            if len(shape) >= 2:
                sshape = shape[:-2] + shape[-1:]
            else:
                sshape = ()
            if path.rpartition("/")[2] in QUANT_LEAVES:
                self._lays[path, "scale"] = leaf_layout(
                    path, sshape, cfg, plan, self.coords, scale=True)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return self.comm.all_reduce(t)

    def gather_layer(self, w: dict) -> dict:
        """One layer's weights (its [L] slices of the stored blocks) ->
        the parts this rank computes with."""
        lays, shards, names = [], [], []
        for name, x in w.items():
            path = "layers/" + name
            if path not in self._lays:
                continue
            if _is_quantized(x):
                lays += [self._lays[path], self._lays[path, "scale"]]
                shards += [x.w, x.scale]
            else:
                lays.append(self._lays[path])
                shards.append(x)
            names.append(name)
        parts = iter(gather_blocks(self.comm.groups, lays, shards, True))
        out = dict(w)
        for name in names:
            x = w[name]
            out[name] = (type(x)(next(parts), next(parts))
                         if _is_quantized(x) else next(parts))
        return out

    def gather_rows(self, h: torch.Tensor, kind: str) -> torch.Tensor:
        """``h`` [T, ...] of every rank of this rank's ``kind`` group
        (the axis ``kind``), stacked in that axis's order: [n * T, ...]
        (a zero-filled exact gather)."""
        n = getattr(self.plan, kind)
        buf = h.new_zeros((n, *h.shape))
        buf[self.coords[kind]] = h
        self.comm.groups.gather_bytes(buf.view(-1).view(torch.uint8), kind)
        return buf.view(n * h.shape[0], *h.shape[1:])

    def moe_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum an MoE layer's partial outputs over ep x tp IN PLACE."""
        return self.comm.reduce(t, "ep_tp")

    def _model_sum(self, part: torch.Tensor, path: str, cfg,
                   B: int) -> torch.Tensor:
        """``part`` (this rank's share of a top leaf's result, float32)
        summed over fsdp x tp, counted once where the leaf's block is
        replicated over an axis; with ``cfg.split_rows`` the fsdp
        group's rows were gathered first (``B`` a rank's own), and this
        rank keeps its own."""
        used = spec_axes(self._lays[path].spec, self.plan)
        if any(self.coords[ax] for ax in (AXIS_FSDP, AXIS_TP)
               if ax not in used):
            part = torch.zeros_like(part)
        out = self.comm.reduce(part, "model")
        if getattr(cfg, "split_rows", False) and self.plan.fsdp > 1:
            f = self.coords[AXIS_FSDP]
            out = out[f * B:(f + 1) * B]
        return out

    def _rows(self, t: torch.Tensor, cfg) -> torch.Tensor:
        if getattr(cfg, "split_rows", False) and self.plan.fsdp > 1:
            return self.gather_rows(t, AXIS_FSDP)
        return t

    def embed_rows(self, emb, tokens, cfg) -> torch.Tensor:
        """The embedding of ``tokens`` from this rank's block of rows
        [lo, hi) (zeros for ids outside it), summed over fsdp x tp: one
        rank of the group holds each id, so the sum is exact."""
        (lo, hi), _ = self._lays["embedding"].block
        local = self._rows(tokens.long(), cfg) - lo
        inside = (local >= 0) & (local < hi - lo)
        rows = emb[local.clamp(0, hi - lo - 1)].float()
        rows = torch.where(inside[..., None], rows, 0.0)
        return self._model_sum(rows, "embedding", cfg, tokens.shape[0])

    def head_logits(self, params: dict, x, cfg) -> torch.Tensor:
        """float32 logits over the whole vocabulary from this rank's
        block of the LM head (its rows [d_lo, d_hi) of the input and
        columns [v_lo, v_hi) of the vocabulary, or the tied embedding's
        block of rows), written into a zeroed [.., V] and summed over
        fsdp x tp: every rank holds the same logits."""
        from ..ops.quant import qmatmul

        B = x.shape[0]
        x = self._rows(x, cfg)
        if cfg.tie_embeddings:
            path = "embedding"
            (v_lo, v_hi), _ = self._lays[path].block
            local = torch.matmul(x, params[path].t()).float()
        else:
            path = "lm_head"
            (d_lo, d_hi), (v_lo, v_hi) = self._lays[path].block
            local = qmatmul(x[..., d_lo:d_hi], params[path]).float()
        full = local.new_zeros((*local.shape[:-1], cfg.vocab_size))
        full[..., v_lo:v_hi] = local
        return self._model_sum(full, path, cfg, B)


def serve_rank_config(cfg: ModelConfig, plan, rank: int,
                      comm: Any = None) -> ModelConfig:
    """Rank ``rank``'s view of ``cfg`` under a serving plan: with data
    axes a RankConfig (its tp shard, its experts [e_lo, e_hi) and a
    ``RankView`` over ``comm``), else ``rank_config``'s."""
    if plan.data <= 1:
        return rank_config(cfg, plan.tp, rank, comm)
    check_plan(cfg, plan)
    coords = plan.coords(rank)
    t = coords[AXIS_TP]
    base = rank_config(cfg, plan.tp, t)
    fields = {k: getattr(base, k) for k in ModelConfig.__dataclass_fields__}
    lo, hi = vocab_range(cfg, plan.tp, t)
    e_lo, e_hi = expert_range(cfg, plan, coords)
    return RankConfig(**fields, tp=plan.tp, rank=t, full_heads=cfg.n_heads,
                      vocab_lo=lo, vocab_hi=hi, e_lo=e_lo, e_hi=e_hi,
                      comm=None if comm is None
                      else RankView(comm, cfg, plan, rank))
