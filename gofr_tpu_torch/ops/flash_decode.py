"""Flash-decode attention over the KV cache (counterpart of
gofr_tpu/ops/flash_decode.py).

``flash_decode_appended`` launches the hand-written CUDA kernel
(``csrc/flash_decode.cu``) on CUDA tensors -- int8 cache with float32
scales, or dense bf16 cache -- and runs the plain version,
``decode_plain`` (``ops.attention.decode_attention_appended``), only on
CPU tensors. The kernel folds this step's k/v into its epilogue, so it
is the whole of ``decode_attention_appended``, append included. A CUDA
tensor the kernel does not take raises; nothing falls back.

The kernel splits each slot's cache into chunks of ``SPLIT_CHUNK``
positions (``csrc/decode_attention.cuh``, shared with the paged kernel),
writes a float32 partial per live chunk into a workspace the wrapper
allocates, and folds them in a second launch. ``split_geometry`` sizes
the grid and the workspace from shapes alone, for both wrappers.

``launches`` counts wrapper calls that launched the kernel and
``plain_calls`` calls of the plain version.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import kernels
from .attention import decode_attention_appended

HEAD_DIM = kernels.HEAD_DIM
SPLIT_CHUNK = 256      # positions a work item; kChunk in the kernel
BLOCKS_PER_SM = 4      # blocks a wave aims to keep on each SM

launches = 0
plain_calls = 0


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0


class SplitGeometry(NamedTuple):
    chunk: int       # positions a work item
    n_chunks: int    # chunks a slot at capacity: ceil(capacity / chunk)
    blocks: int      # W, blocks per KV head that walk the live items
    work: int        # float32 workspace: a partial per (slot, head, chunk)


def split_geometry(b: int, kv: int, g: int, capacity: int,
                   sms: int = 132) -> SplitGeometry:
    """The decode kernels' grid and workspace, from shapes alone (the
    lengths stay on the card): B*KV*n_chunks partials of G heads x (128
    accumulators + max + sum), and W = enough blocks per KV head for
    BLOCKS_PER_SM a streaming multiprocessor, no more than there can be
    items. ``sms``: the card's SM count (132 on an H100 SXM)."""
    n_chunks = -(-capacity // SPLIT_CHUNK)
    blocks = max(1, min(b * n_chunks, -(-BLOCKS_PER_SM * sms // kv)))
    return SplitGeometry(SPLIT_CHUNK, n_chunks, blocks,
                         b * kv * n_chunks * g * (HEAD_DIM + 2))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_split(name: str, q: torch.Tensor, pointers: list,
                 shape_args: list, kv: int, capacity: int) -> torch.Tensor:
    """Allocate the output and the workspace and run launcher ``name``
    (``q``'s pointer and ``pointers`` up to k_new/v_new, then out, work,
    B, ``shape_args``, H, KV, W, chunk, scale, stream)."""
    b, _, h, d = q.shape
    geo = split_geometry(b, kv, h // kv, capacity, sm_count(q.device))
    out = torch.empty_like(q)
    work = torch.empty(geo.work, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = kernels.function(name)(
        q.data_ptr(), *pointers, out.data_ptr(), work.data_ptr(), b,
        *shape_args, h, kv, geo.blocks, geo.chunk, d ** -0.5, stream)
    kernels.check(err, name)
    return out


def decode_plain(q, k_cache, v_cache, k_new, v_new, lengths,
                 k_scale=None, v_scale=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    global plain_calls
    plain_calls += 1
    return decode_attention_appended(q, k_cache, v_cache, k_new, v_new,
                                     lengths, k_scale, v_scale)


def _check(q, k_cache, v_cache, k_new, v_new, lengths, k_scale, v_scale):
    b, one, h, d = q.shape
    _, smax, kv, dc = k_cache.shape
    quant = k_scale is not None
    if (v_scale is None) != (k_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if one != 1 or dc != d:
        raise ValueError(f"flash_decode kernel takes q [B, 1, H, {HEAD_DIM}]"
                         f" and caches [B, Smax, KV, {HEAD_DIM}], got q "
                         f"{tuple(q.shape)} cache {tuple(k_cache.shape)}")
    kernels.check_attention_shape("flash_decode", head_dim=d, n_heads=h,
                                  n_kv_heads=kv, dtype=q.dtype)
    if k_new.dtype != torch.bfloat16 or v_new.dtype != torch.bfloat16:
        raise TypeError("flash_decode kernel takes bf16 q/k_new/v_new")
    cache_dtype = torch.int8 if quant else torch.bfloat16
    if k_cache.dtype != cache_dtype or v_cache.dtype != cache_dtype:
        raise TypeError(f"flash_decode kernel takes a {cache_dtype} cache "
                        f"{'with' if quant else 'without'} scales, got "
                        f"{k_cache.dtype}/{v_cache.dtype}")
    shapes = [(v_cache, (b, smax, kv, d)), (k_new, (b, 1, kv, d)),
              (v_new, (b, 1, kv, d)), (lengths, (b,))]
    if quant:
        shapes += [(k_scale, (b, smax, kv)), (v_scale, (b, smax, kv))]
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError("flash_decode kernel takes float32 scales")
    if k_cache.shape[0] != b:
        raise ValueError(f"cache batch {k_cache.shape[0]} != q batch {b}")
    for t, want in shapes:
        if tuple(t.shape) != want:
            raise ValueError(f"flash_decode shape {tuple(t.shape)} != {want}")
    if lengths.dtype != torch.int32:
        raise TypeError("flash_decode kernel takes int32 lengths")
    tensors = [q, k_cache, v_cache, k_new, v_new, lengths]
    if quant:
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"flash_decode inputs on {t.device} and "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError("flash_decode kernel needs contiguous inputs")


def flash_decode_appended(q, k_cache, v_cache, k_new, v_new, lengths,
                          k_scale=None, v_scale=None) -> torch.Tensor:
    """Decode attention over the cache plus this step's token.

    q: [B, 1, H, D]; k_cache/v_cache: [B, Smax, KV, D]; k_new/v_new:
    [B, 1, KV, D]; lengths [B] valid entries EXCLUDING the current
    token; ``k_scale``/``v_scale`` [B, Smax, KV] for an int8 cache.
    Returns [B, 1, H, D] in q's dtype.
    """
    global launches
    if q.device.type == "cpu":
        return decode_plain(q, k_cache, v_cache, k_new, v_new, lengths,
                            k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not {q.device}")
    _check(q, k_cache, v_cache, k_new, v_new, lengths, k_scale, v_scale)
    smax, kv = k_cache.shape[1], k_cache.shape[2]
    name = ("gofr_flash_decode_int8" if k_scale is not None
            else "gofr_flash_decode_bf16")
    out = launch_split(
        name, q, [k_cache.data_ptr(), v_cache.data_ptr(),
                  k_scale.data_ptr() if k_scale is not None else None,
                  v_scale.data_ptr() if v_scale is not None else None,
                  lengths.data_ptr(), k_new.data_ptr(), v_new.data_ptr()],
        [smax], kv, smax)
    launches += 1
    return out
