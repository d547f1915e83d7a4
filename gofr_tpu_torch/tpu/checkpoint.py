"""Weight loading (counterpart of gofr_tpu/tpu/checkpoint.py).

``from_jax_params`` carries a JAX parameter tree across -- nested dicts
of numpy arrays, with ``QuantizedLinear``-shaped leaves (a named tuple
with fields ``w`` and ``scale``) -- without importing anything of the
JAX package. ``load_npz`` reads the JAX package's ``.npz`` format
(``/``-joined tree paths, int8 projections as ``<path>/__qw`` and
``<path>/__qscale``). ``maybe_quantize`` int8-quantizes the projection
leaves of a loaded tree.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quant import QuantizedLinear, quantize_int8

# Llama projection leaves worth int8-quantizing (stacked [L, in, out]).
_QUANT_LEAVES = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"}


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
    """Carry a JAX Llama parameter tree (numpy leaves; layout of
    gofr_tpu/models/llama.py ``init``) into torch tensors on ``device``,
    keeping the layout. ``QuantizedLinear`` leaves become the port's
    ``QuantizedLinear``."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if _is_quantized(node):
            return QuantizedLinear(w=to_tensor(node.w, device),
                                   scale=to_tensor(node.scale, device))
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


def load_npz(path: str, device="cuda") -> dict:
    """Load a ``.npz`` written by the JAX package's ``save_npz`` onto
    ``device``."""
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    return from_jax_params(_unflatten(flat), device=device)


def maybe_quantize(params: Any, enabled: bool) -> Any:
    """Int8-quantize the known projection leaves of a Llama param tree
    per output channel (the contraction axis is ndim - 2 for plain and
    stacked weights alike)."""
    if not enabled:
        return params

    def walk(node: Any, name: str = "") -> Any:
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if (name in _QUANT_LEAVES and isinstance(node, torch.Tensor)
                and node.ndim in (2, 3, 4)):
            return quantize_int8(node, axis=node.ndim - 2)
        return node

    return walk(params)
