"""Paged attention over a block-pool KV cache (counterpart of
gofr_tpu/ops/paged_attention.py): the decode caller and the speculative
verify window.

A paged cache keeps K/V in a shared pool of fixed T-token blocks
``[N, T, KV, D]`` and gives each slot a row of block ids, its table
``[B, MB]``: position ``t`` of slot ``b`` lives at pool block
``table[b, t // T]``, offset ``t % T``. The engine keeps rows clamped
(entries past a slot's live blocks repeat its last one) and points
empty slots at block 0, a trash block no slot owns.

``paged_decode_attention`` launches the hand-written CUDA kernel
(``csrc/paged_decode.cu``) on CUDA tensors -- int8 pool with float32
scales ``[N, T, KV]``, or dense bf16 pool -- and runs the plain version,
``paged_attention_reference`` (gather the table's dense view, then
``ops.attention.decode_attention_appended``), only on CPU tensors. The
kernel folds this step's k/v in, as ``ops.flash_decode``'s does, and is
its body with another address policy: the same split, grid and
workspace (``ops.flash_decode.split_geometry``). A CUDA tensor the
kernel does not take raises; nothing falls back.

``paged_window_attention`` is the same kernel's second caller, the
verify pass of speculative decoding: a window of W query positions per
slot, each attending the pool below ``lengths[b]`` and the window's own
positions up to it (``csrc/paged_decode.cu``'s window launchers, the
same body with W*G query rows per KV head read in place from q). Its
plain version is ``paged_window_reference`` (the dense view, then
``ops.attention.window_attention_appended``).

``launches``/``plain_calls`` count the decode caller's kernel launches
and plain calls, ``window_launches``/``window_plain_calls`` the window
caller's, so a run can tell the two callers apart.
"""

from __future__ import annotations

import torch

from . import kernels
from .attention import decode_attention_appended, window_attention_appended
from .flash_decode import launch_split

launches = 0
plain_calls = 0
window_launches = 0
window_plain_calls = 0


def reset_counts() -> None:
    global launches, plain_calls, window_launches, window_plain_calls
    launches = 0
    plain_calls = 0
    window_launches = 0
    window_plain_calls = 0


def gather_blocks(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Dense per-slot view of a paged buffer: [N, T, ...] gathered by
    table [B, MB] -> [B, MB*T, ...]. Materializes the whole dense cache:
    the plain version's path only."""
    g = pool[table.long()]                                  # [B, MB, T, ...]
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def paged_attention_reference(q, k_pool, v_pool, k_new, v_new, table,
                              lengths, k_scale=None, v_scale=None
                              ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather the table's dense
    view, run the reference decode attention."""
    global plain_calls
    plain_calls += 1
    ks = gather_blocks(k_scale, table) if k_scale is not None else None
    vs = gather_blocks(v_scale, table) if v_scale is not None else None
    return decode_attention_appended(q, gather_blocks(k_pool, table),
                                     gather_blocks(v_pool, table), k_new,
                                     v_new, lengths, ks, vs)


def paged_window_reference(q, k_pool, v_pool, k_new, v_new, table, lengths,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """The window kernel's function in plain PyTorch: gather the table's
    dense view, run ``window_attention_appended``."""
    global window_plain_calls
    window_plain_calls += 1
    ks = gather_blocks(k_scale, table) if k_scale is not None else None
    vs = gather_blocks(v_scale, table) if v_scale is not None else None
    return window_attention_appended(q, gather_blocks(k_pool, table),
                                     gather_blocks(v_pool, table), k_new,
                                     v_new, lengths, ks, vs)


def _check(q, k_pool, v_pool, k_new, v_new, table, lengths, k_scale,
           v_scale, kernel: str = "paged_decode"):
    """What ``kernel`` (paged_decode: W = 1; paged_window: W = q's second
    dimension) takes; raises on anything else."""
    b, w, h, d = q.shape
    n, t, kv, dc = k_pool.shape
    quant = k_scale is not None
    if (v_scale is None) != (k_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if (kernel == "paged_decode" and w != 1) or dc != d:
        raise ValueError(f"{kernel} kernel takes q [B, W, H, D] (W = 1 for "
                         f"a decode step) and pools [N, T, KV, D], got q "
                         f"{tuple(q.shape)} pool {tuple(k_pool.shape)}")
    kernels.check_attention_shape(kernel, head_dim=d, n_heads=h,
                                  n_kv_heads=kv, dtype=q.dtype, block_size=t,
                                  window=w)
    if k_new.dtype != torch.bfloat16 or v_new.dtype != torch.bfloat16:
        raise TypeError(f"{kernel} kernel takes bf16 q/k_new/v_new")
    pool_dtype = torch.int8 if quant else torch.bfloat16
    if k_pool.dtype != pool_dtype or v_pool.dtype != pool_dtype:
        raise TypeError(f"{kernel} kernel takes a {pool_dtype} pool "
                        f"{'with' if quant else 'without'} scales, got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"{kernel} table {tuple(table.shape)} is not "
                         f"[{b}, MB]")
    shapes = [(v_pool, (n, t, kv, d)), (k_new, (b, w, kv, d)),
              (v_new, (b, w, kv, d)), (lengths, (b,))]
    if quant:
        shapes += [(k_scale, (n, t, kv)), (v_scale, (n, t, kv))]
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError(f"{kernel} kernel takes float32 scales")
    for x, want in shapes:
        if tuple(x.shape) != want:
            raise ValueError(f"{kernel} shape {tuple(x.shape)} != {want}")
    if lengths.dtype != torch.int32 or table.dtype != torch.int32:
        raise TypeError(f"{kernel} kernel takes int32 lengths and table")
    tensors = [q, k_pool, v_pool, k_new, v_new, table, lengths]
    if quant:
        tensors += [k_scale, v_scale]
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"{kernel} inputs on {x.device} and "
                             f"{q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel} kernel needs contiguous inputs")


def _launch(kernel: str, q, k_pool, v_pool, k_new, v_new, table, lengths,
            k_scale, v_scale) -> torch.Tensor:
    _check(q, k_pool, v_pool, k_new, v_new, table, lengths, k_scale, v_scale,
           kernel)
    n, t, kv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    mb = table.shape[1]
    shape = [mb, t, n] + ([q.shape[1]] if kernel == "paged_window" else [])
    name = f"gofr_{kernel}_{'int8' if k_scale is not None else 'bf16'}"
    return launch_split(
        name, q, [k_pool.data_ptr(), v_pool.data_ptr(),
                  k_scale.data_ptr() if k_scale is not None else None,
                  v_scale.data_ptr() if v_scale is not None else None,
                  table.data_ptr(), lengths.data_ptr(), k_new.data_ptr(),
                  v_new.data_ptr()],
        shape, kv, mb * t)


def paged_decode_attention(q, k_pool, v_pool, k_new, v_new, table, lengths,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """Single-token decode attention against a paged pool.

    q: [B, 1, H, D]; k_pool/v_pool: [N, T, KV, D]; k_new/v_new:
    [B, 1, KV, D] (this step's k/v, not yet in the pool); table [B, MB]
    int32 block ids; lengths [B] valid tokens EXCLUDING the current
    one; ``k_scale``/``v_scale`` [N, T, KV] for an int8 pool. Returns
    [B, 1, H, D] in q's dtype.
    """
    global launches
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, k_new, v_new,
                                         table, lengths, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode runs on cuda or cpu, not {q.device}")
    out = _launch("paged_decode", q, k_pool, v_pool, k_new, v_new, table,
                  lengths, k_scale, v_scale)
    launches += 1
    return out


def paged_window_attention(q, k_pool, v_pool, k_new, v_new, table, lengths,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """The speculative verify pass's attention against a paged pool:
    query position w of slot b attends the pool's positions below
    ``lengths[b]`` and the window's positions t <= w.

    q: [B, W, H, D]; k_pool/v_pool: [N, T, KV, D]; k_new/v_new:
    [B, W, KV, D] (the window's k/v, not yet in the pool); table [B, MB]
    int32 block ids; lengths [B] valid tokens EXCLUDING the window;
    ``k_scale``/``v_scale`` [N, T, KV] for an int8 pool. Returns
    [B, W, H, D] in q's dtype. On CUDA tensors W is 1 to
    ``kernels.MAX_WINDOW``.
    """
    global window_launches
    if q.device.type == "cpu":
        return paged_window_reference(q, k_pool, v_pool, k_new, v_new,
                                      table, lengths, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_window runs on cuda or cpu, not {q.device}")
    out = _launch("paged_window", q, k_pool, v_pool, k_new, v_new, table,
                  lengths, k_scale, v_scale)
    window_launches += 1
    return out
