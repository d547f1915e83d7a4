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

``paged_window_attention`` is the verify pass of speculative decoding:
a window of W query positions per slot, each attending the pool below
``lengths[b]`` and the window's own positions up to it. For 2 <= W <= 16
it launches a kernel of its own (``csrc/paged_window.cu``: a work item
carries all W*G query rows of a KV head through one read of a chunk's
K/V, both products on tensor cores), whose grid and workspace
``window_geometry`` sizes from shapes alone; a window of one position is
a decode step and launches the paged decode kernel. Its plain version is
``paged_window_reference`` (the dense view, then
``ops.attention.window_attention_appended``).

``launches``/``plain_calls`` count the decode caller's kernel launches
and plain calls, ``window_launches``/``window_plain_calls`` the window
caller's, so a run can tell the two callers apart.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import kernels
from .attention import decode_attention_appended, window_attention_appended
from .flash_decode import HEAD_DIM, SPLIT_CHUNK, launch_split, sm_count

WINDOW_TILE = 16            # query rows an mma tile: R padded to these
WINDOW_ROW = HEAD_DIM + 4   # floats a row of a partial: acc, m, l, pad
WINDOW_BLOCKS_PER_SM = 2    # blocks of the window kernel an SM holds

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


class WindowGeometry(NamedTuple):
    rows: int         # R = W*G query rows a KV head
    rows_padded: int  # R padded to whole WINDOW_TILE-row tiles
    tiles: int        # those tiles
    slices: int       # warps a tile, each a slice of a sub-tile's positions
    warps: int        # warps a block: tiles x slices
    n_chunks: int     # chunks a slot at capacity: ceil(capacity / chunk)
    items: int        # work items a KV head at most: one a slot and chunk
    blocks: int       # NB, blocks per KV head that walk the live items
    work: int         # float32 workspace: a partial per item, slice, row


def window_geometry(b: int, kv: int, g: int, w: int, capacity: int,
                    sms: int = 132) -> WindowGeometry:
    """The window kernel's grid and workspace, from shapes alone (the
    lengths stay on the card): an item (KV head, slot, chunk of
    SPLIT_CHUNK positions) carries all R = W*G rows, padded to 16-row
    tiles; 1 or 2 tiles take 4 warps (a tile's warps split each
    sub-tile's positions 4 or 2 ways), more a warp each (the kernel's
    pos_split). A partial of R rows x WINDOW_ROW floats per item and
    slice; NB = enough blocks per KV head for WINDOW_BLOCKS_PER_SM an
    SM, no more than there can be items. ``sms``: the card's SM count
    (132 on an H100 SXM)."""
    rows = w * g
    tiles = -(-rows // WINDOW_TILE)
    slices = 1 if tiles >= 3 else 4 // tiles
    n_chunks = -(-capacity // SPLIT_CHUNK)
    items = b * n_chunks
    blocks = max(1, min(items, -(-WINDOW_BLOCKS_PER_SM * sms // kv)))
    return WindowGeometry(rows, tiles * WINDOW_TILE, tiles, slices,
                          tiles * slices, n_chunks, items, blocks,
                          b * kv * n_chunks * slices * rows * WINDOW_ROW)


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


def _pointers(k_pool, v_pool, k_new, v_new, table, lengths, k_scale,
              v_scale) -> list:
    """The launchers' pointers after q, up to k_new/v_new."""
    return [k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            table.data_ptr(), lengths.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr()]


def _launch_decode(q, k_pool, v_pool, k_new, v_new, table, lengths, k_scale,
                   v_scale) -> torch.Tensor:
    n, t, kv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    mb = table.shape[1]
    name = f"gofr_paged_decode_{'int8' if k_scale is not None else 'bf16'}"
    return launch_split(
        name, q, _pointers(k_pool, v_pool, k_new, v_new, table, lengths,
                           k_scale, v_scale), [mb, t, n], kv, mb * t)


def _launch_window(q, k_pool, v_pool, k_new, v_new, table, lengths, k_scale,
                   v_scale) -> torch.Tensor:
    b, w, h, d = q.shape
    n, t, kv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    mb = table.shape[1]
    geo = window_geometry(b, kv, h // kv, w, mb * t, sm_count(q.device))
    out = torch.empty_like(q)
    work = torch.empty(geo.work, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    name = f"gofr_paged_window_{'int8' if k_scale is not None else 'bf16'}"
    err = kernels.function(name)(
        q.data_ptr(), *_pointers(k_pool, v_pool, k_new, v_new, table,
                                 lengths, k_scale, v_scale),
        out.data_ptr(), work.data_ptr(), b, mb, t, n, w, h, kv, geo.blocks,
        SPLIT_CHUNK, d ** -0.5, stream)
    kernels.check(err, name)
    return out


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
    _check(q, k_pool, v_pool, k_new, v_new, table, lengths, k_scale,
           v_scale)
    out = _launch_decode(q, k_pool, v_pool, k_new, v_new, table, lengths,
                         k_scale, v_scale)
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
    ``kernels.MAX_WINDOW``; at W = 1 the launch is the paged decode
    kernel's (a window of one position is a decode step), counted here.
    """
    global window_launches
    if q.device.type == "cpu":
        return paged_window_reference(q, k_pool, v_pool, k_new, v_new,
                                      table, lengths, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_window runs on cuda or cpu, not {q.device}")
    _check(q, k_pool, v_pool, k_new, v_new, table, lengths, k_scale,
           v_scale, "paged_window")
    launch = _launch_decode if q.shape[1] == 1 else _launch_window
    out = launch(q, k_pool, v_pool, k_new, v_new, table, lengths, k_scale,
                 v_scale)
    window_launches += 1
    return out
