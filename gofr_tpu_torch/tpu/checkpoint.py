"""Weight loading (counterpart of gofr_tpu/tpu/checkpoint.py).

``from_jax_params`` carries a JAX parameter tree of any model family
(Llama, BERT, ViT) across -- nested dicts of numpy arrays, with
``QuantizedLinear``-shaped leaves (a named tuple with fields ``w`` and
``scale``) -- without importing anything of the JAX package.
``load_npz`` reads the JAX package's ``.npz`` format (``/``-joined tree
paths, int8 projections as ``<path>/__qw`` and ``<path>/__qscale``).
``maybe_quantize`` int8-quantizes the projection leaves of a loaded
tree, the same leaves as the JAX package's ``maybe_quantize``.

Tensor parallelism (parallel/): ``rank_params`` builds one rank's shard
(parallel.sharding.shard_leaf) from a ``WeightSource``: a seeded init or
a ``.npz`` sliced leaf by leaf as each leaf is made or read (with int8,
the rank's part quantized on the whole leaf's per-channel scales, so a
row split keeps them and no whole leaf is quantized), so no rank ever
holds the whole model -- its peak is its shard plus the largest single
leaf -- or a shard rank 0 already sliced. Under a serving plan with
data axes (``plan``) a rank's shard is its blocks in JAX's layout
(parallel.sharding ``block_leaf``: fsdp splits a leaf further, an
expert stack is cut to the rank's ep block, an int8 scale follows only
its output axis), made or read the same way and, with int8, quantized
on the whole leaf's scales.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quant import QUANT_LEAVES, QuantizedLinear, quantize_int8


def to_tensor(arr, device: torch.device, dtype: torch.dtype | None = None
              ) -> torch.Tensor:
    """numpy array (bfloat16 included, by its bit pattern) -> tensor on
    ``device``. The data is copied, never aliased."""
    arr = np.asarray(arr)
    # bfloat16 arrives as ml_dtypes' bfloat16, or as raw 2-byte voids
    # once an .npz round trip has dropped the extension dtype
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def _is_quantized(node) -> bool:
    return isinstance(node, tuple) and getattr(node, "_fields", None) == (
        "w", "scale")


def from_jax_params(tree: Any, device="cuda") -> Any:
    """Carry a JAX parameter tree of any model family (numpy leaves;
    the layout of the ``init`` of gofr_tpu/models/llama.py, bert.py or
    vit.py) into torch tensors on ``device``, keeping the layout.
    ``QuantizedLinear`` leaves become the port's ``QuantizedLinear``."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if _is_quantized(node):
            return QuantizedLinear(w=walk(node.w), scale=walk(node.scale))
        if isinstance(node, torch.Tensor):   # made on the device already
            return node.to(device)
        return to_tensor(node, device)

    return walk(tree)


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    quant: dict[str, dict] = {}
    for path, arr in flat.items():
        parts = path.split("/")
        if parts[-1] in ("__qw", "__qscale"):
            q = quant.setdefault("/".join(parts[:-1]), {})
            q["w" if parts[-1] == "__qw" else "scale"] = arr
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    for path, q in quant.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = QuantizedLinear(w=q["w"], scale=q["scale"])
    return tree


def load_npz(path: str, device="cuda",
             leaf: Callable[[str, Any], Any] | None = None) -> dict:
    """Load a ``.npz`` written by the JAX package's ``save_npz`` onto
    ``device``. ``leaf(name, array)``, if given, maps each leaf (its
    last path element and its numpy value, a QuantizedLinear of numpy
    for an int8 projection) as it is read, before it reaches the
    device: a rank's slice."""
    with np.load(path) as f:
        tree = _unflatten({k: f[k] for k in f.files})

        def walk(node, name=""):
            if isinstance(node, dict):
                return {k: walk(v, k) for k, v in node.items()}
            return node if leaf is None else leaf(name, node)

        return from_jax_params(walk(tree), device=device)


def _quantize_leaf(name: str, node, whole=None):
    """``node`` int8-quantized when it is a projection leaf; ``whole``:
    the leaf it was sliced from (a rank's shard), whose scales a slice
    of the contraction axis keeps."""
    if (name in QUANT_LEAVES and isinstance(node, torch.Tensor)
            and node.ndim in (2, 3, 4)):
        axis = node.ndim - 2
        cut = whole is not None and whole.shape[axis] != node.shape[axis]
        return quantize_int8(node, axis=axis, whole=whole if cut else None)
    return node


def maybe_quantize(params: Any, enabled: bool) -> Any:
    """Int8-quantize the known projection leaves of a param tree per
    output channel (the contraction axis is ndim - 2 for plain and
    stacked weights and [L, E, in, out] expert stacks alike; their
    scales are [L, E, out])."""
    if not enabled:
        return params

    def walk(node: Any, name: str = "") -> Any:
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return _quantize_leaf(name, node)

    return walk(params)


@dataclass
class WeightSource:
    """Where a tensor-parallel rank's weights come from: ``kind`` "seed"
    (models.llama.init from ``seed``), "npz" (``path``), each made
    whole one leaf at a time and sliced to the rank at once (int8 first
    with ``quant``), or "shard" (``tree``: the rank's slice already,
    numpy leaves)."""

    kind: str
    seed: int = 0
    path: str = ""
    quant: bool = False
    tree: Any = None


def rank_params(cfg, source, rank: int, tp: int, device, plan=None) -> dict:
    """Rank ``rank``'s weight shard of a Llama model ``cfg`` on
    ``device``: from a ``WeightSource``, or sliced out of a whole
    parameter tree (``source`` a dict of tensors). ``plan``: a serving
    plan with data axes, whose rank ``rank`` stores its blocks
    (``rank`` then counts every rank of the plan)."""
    from ..models import llama
    from ..parallel.sharding import (block_leaf, leaf_path, rank_blocks,
                                     shard_leaf, shard_params)

    device = resolve_device(device)
    blocks = plan is not None and plan.data > 1
    if isinstance(source, dict):
        return _to(rank_blocks(source, cfg, plan, rank) if blocks
                   else shard_params(source, cfg, rank, tp), device)
    if source.kind == "shard":
        return from_jax_params(source.tree, device=device)

    def block(name, full):
        # the whole leaf on the device for a quantized block: its
        # scales are the whole leaf's
        if source.quant and isinstance(full, np.ndarray):
            full = to_tensor(full, device)
        return block_leaf(leaf_path(name), full, cfg, plan,
                          plan.coords(rank), quant=source.quant)

    def leaf(name, full):
        # sliced first, then quantized with the whole leaf's scales: the
        # rank's part of the whole leaf's codes, without the whole leaf's
        # float32 scratch (the ranks that share a card build together)
        if source.quant and isinstance(full, np.ndarray):
            full = to_tensor(full, device)
        part = shard_leaf(name, full, cfg, rank, tp)
        if source.quant:
            part = _quantize_leaf(name, part, whole=full)
        return part

    mapper = block if blocks else leaf
    if source.kind == "seed":
        return llama.init(cfg, source.seed, device=device, leaf=mapper)
    if source.kind == "npz":
        return load_npz(source.path, device=device, leaf=mapper)
    raise ValueError(f"unknown weight source {source.kind!r}")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, QuantizedLinear):
        return QuantizedLinear(tree.w.to(device), tree.scale.to(device))
    return tree.to(device)
