"""Paged decode attention over a block-pool KV cache (counterpart of
gofr_tpu/ops/paged_attention.py, the decode caller).

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

``launches`` counts kernel launches and ``plain_calls`` calls of the
plain version. The speculative-verify window over the pool waits for
speculative decode.
"""

from __future__ import annotations

import torch

from .attention import decode_attention_appended
from .flash_decode import launch_split

HEAD_DIM = 128
GROUP_SIZES = (1, 2, 4, 8)

launches = 0
plain_calls = 0


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


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


def _check(q, k_pool, v_pool, k_new, v_new, table, lengths, k_scale,
           v_scale):
    b, one, h, d = q.shape
    n, t, kv, dc = k_pool.shape
    quant = k_scale is not None
    if (v_scale is None) != (k_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if one != 1 or d != HEAD_DIM or dc != d:
        raise ValueError(f"paged_decode kernel takes q [B, 1, H, {HEAD_DIM}]"
                         f" and pools [N, T, KV, {HEAD_DIM}], got q "
                         f"{tuple(q.shape)} pool {tuple(k_pool.shape)}")
    if kv == 0 or h % kv or h // kv not in GROUP_SIZES:
        raise ValueError(f"paged_decode kernel takes H/KV in {GROUP_SIZES}, "
                         f"got H={h} KV={kv}")
    if t % 8:
        raise ValueError(f"paged_decode kernel takes a block size that is a "
                         f"multiple of 8, got T={t}")
    if q.dtype != torch.bfloat16 or k_new.dtype != torch.bfloat16 \
            or v_new.dtype != torch.bfloat16:
        raise TypeError("paged_decode kernel takes bf16 q/k_new/v_new")
    pool_dtype = torch.int8 if quant else torch.bfloat16
    if k_pool.dtype != pool_dtype or v_pool.dtype != pool_dtype:
        raise TypeError(f"paged_decode kernel takes a {pool_dtype} pool "
                        f"{'with' if quant else 'without'} scales, got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"paged_decode table {tuple(table.shape)} is not "
                         f"[{b}, MB]")
    shapes = [(v_pool, (n, t, kv, d)), (k_new, (b, 1, kv, d)),
              (v_new, (b, 1, kv, d)), (lengths, (b,))]
    if quant:
        shapes += [(k_scale, (n, t, kv)), (v_scale, (n, t, kv))]
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError("paged_decode kernel takes float32 scales")
    for x, want in shapes:
        if tuple(x.shape) != want:
            raise ValueError(f"paged_decode shape {tuple(x.shape)} != {want}")
    if lengths.dtype != torch.int32 or table.dtype != torch.int32:
        raise TypeError("paged_decode kernel takes int32 lengths and table")
    tensors = [q, k_pool, v_pool, k_new, v_new, table, lengths]
    if quant:
        tensors += [k_scale, v_scale]
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"paged_decode inputs on {x.device} and "
                             f"{q.device}")
        if not x.is_contiguous():
            raise ValueError("paged_decode kernel needs contiguous inputs")


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
    _check(q, k_pool, v_pool, k_new, v_new, table, lengths, k_scale, v_scale)
    n, t, kv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    mb = table.shape[1]
    name = ("gofr_paged_decode_int8" if k_scale is not None
            else "gofr_paged_decode_bf16")
    out = launch_split(
        name, q, [k_pool.data_ptr(), v_pool.data_ptr(),
                  k_scale.data_ptr() if k_scale is not None else None,
                  v_scale.data_ptr() if v_scale is not None else None,
                  table.data_ptr(), lengths.data_ptr(), k_new.data_ptr(),
                  v_new.data_ptr()],
        [mb, t, n], kv, mb * t)
    launches += 1
    return out
