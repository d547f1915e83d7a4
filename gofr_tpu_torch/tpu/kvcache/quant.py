"""Host-side KV snapshots and the int8 block codec for the Redis tier
(the port's own copy of gofr_tpu/tpu/kvcache/quant.py).

``HostKV`` is the host half of a cache row: CPU torch tensors in the
engine's cache-native layout ([L, plen, KV, hd] values, [L, plen, KV]
float32 scale planes when the cache is int8-quantized). A bfloat16
cache's snapshot stays bfloat16 (numpy has no such dtype, so the host
side keeps torch tensors throughout). The T1 host tier stores them
verbatim, so a T1 round trip is bit-exact by construction.

The T2 Redis tier serializes per BLOCK (the radix block size) so
replicas can share partial prefixes: each payload is a self-describing
frame of int8 values + float32 per-vector scales + a truncated sha256
checksum. The frame format is the JAX package's byte for byte, so a
port replica and a JAX replica read each other's blocks. int8-cache
engines store their native planes (lossless round trip); fp-cache
engines quantize on write with the per-vector max-abs scheme and
dequantize on read, rounding to the cache dtype to nearest even as the
JAX package's ml_dtypes cast does.

A tensor-parallel engine's snapshot of one row is a ``ShardedHostKV``:
one ``HostKV`` a KV-head shard, in head order, each read off its own
rank. The T2 tier frames each part through the unchanged codec with the
per-shard head count; the write paths consume the assembled dense row
(``dense_hostkv``).
"""

from __future__ import annotations

import hashlib
import struct
from typing import NamedTuple

import numpy as np
import torch

_MAGIC = b"GKV1"
# magic, version, flags, L, T, KV, hd
_HEADER = struct.Struct("<4sBBHHHH")
_DIGEST_LEN = 16
FLAG_INT8_SRC = 1  # payload came off an int8 cache (round trip exact)


class KVLayout(NamedTuple):
    """The engine-side shape contract a decoded block must satisfy
    before its bytes are allowed anywhere near a pool row."""

    layers: int
    kv_heads: int
    head_dim: int
    quantized: bool        # serving cache is int8 + scale planes
    dtype: torch.dtype     # cache value dtype (int8 / float32 / bfloat16)
    max_seq: int


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class HostKV(NamedTuple):
    k: torch.Tensor                  # [L, plen, KV, hd] cache-native dtype
    v: torch.Tensor
    k_scale: torch.Tensor | None     # [L, plen, KV] f32 (int8 caches)
    v_scale: torch.Tensor | None

    @property
    def plen(self) -> int:
        return int(self.k.shape[1])

    @property
    def nbytes(self) -> int:
        n = _nbytes(self.k) + _nbytes(self.v)
        if self.k_scale is not None:
            n += _nbytes(self.k_scale) + _nbytes(self.v_scale)
        return n

    def slice_tokens(self, start: int, stop: int) -> "HostKV":
        return HostKV(
            self.k[:, start:stop], self.v[:, start:stop],
            self.k_scale[:, start:stop] if self.k_scale is not None else None,
            self.v_scale[:, start:stop] if self.v_scale is not None else None)


class ShardedHostKV(NamedTuple):
    """A tensor-parallel engine's host snapshot of one cache row: one
    :class:`HostKV` per KV-head shard, ordered by head offset (part i
    holds heads [i*KV/n, (i+1)*KV/n)). The spill reads each part off its
    own rank (no assembly on the spill path); the T2 tier frames each
    part through the UNCHANGED int8 block codec with the per-shard head
    count, which is why its namespace carries the shard count (a 4-shard
    frame must never decode on a 2-shard reader). ``assemble()`` is the
    restore side's canonical dense row, so a T1 snapshot serves any
    shard layout."""

    parts: tuple  # of HostKV, kv-head order

    @property
    def shards(self) -> int:
        return len(self.parts)

    @property
    def plen(self) -> int:
        return self.parts[0].plen if self.parts else 0

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.parts)

    def slice_tokens(self, start: int, stop: int) -> "ShardedHostKV":
        return ShardedHostKV(tuple(p.slice_tokens(start, stop)
                                   for p in self.parts))

    def assemble(self) -> HostKV:
        """The shards concatenated back into one cache-native dense
        HostKV along the KV-head axis."""
        if len(self.parts) == 1:
            return self.parts[0]
        k = torch.cat([p.k for p in self.parts], dim=2)
        v = torch.cat([p.v for p in self.parts], dim=2)
        if self.parts[0].k_scale is not None:
            ks = torch.cat([p.k_scale for p in self.parts], dim=2)
            vs = torch.cat([p.v_scale for p in self.parts], dim=2)
        else:
            ks = vs = None
        return HostKV(k, v, ks, vs)


def dense_hostkv(kv: "HostKV | ShardedHostKV") -> HostKV:
    """The canonical dense view of either snapshot flavour: what the
    promote and ingest write paths (and their shape checks) consume."""
    return kv.assemble() if isinstance(kv, ShardedHostKV) else kv


def _quantize(x: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """Per-vector max-abs int8: scale [..., KV] over the head dim, in
    numpy float32 exactly as the JAX package's codec computes it."""
    x32 = x.float().numpy()
    scale = np.max(np.abs(x32), axis=-1) / 127.0
    scale = np.maximum(scale, 1e-12)
    i8 = np.clip(np.rint(x32 / scale[..., None]), -127, 127).astype(np.int8)
    return i8, scale.astype(np.float32)


def encode_block(kv: HostKV) -> bytes:
    """One radix block's KV -> a checksummed wire frame."""
    L, T, KV, hd = kv.k.shape
    if kv.k.dtype == torch.int8:
        flags = FLAG_INT8_SRC
        k8, v8 = kv.k.contiguous().numpy(), kv.v.contiguous().numpy()
        ks = kv.k_scale.float().contiguous().numpy()
        vs = kv.v_scale.float().contiguous().numpy()
    else:
        flags = 0
        k8, ks = _quantize(kv.k)
        v8, vs = _quantize(kv.v)
    body = _HEADER.pack(_MAGIC, 1, flags, L, T, KV, hd) \
        + k8.tobytes() + v8.tobytes() + ks.tobytes() + vs.tobytes()
    return body + hashlib.sha256(body).digest()[:_DIGEST_LEN]


def decode_block(data: bytes, layout: KVLayout) -> HostKV | None:
    """Wire frame -> HostKV in the layout's cache-native dtype, or None
    for anything malformed: wrong magic/version, shape not matching
    this engine's layout, bad checksum, truncated payload. A None is a
    cache miss, never an error: shared-tier bytes are untrusted input."""
    if data is None or len(data) < _HEADER.size + _DIGEST_LEN:
        return None
    body, digest = data[:-_DIGEST_LEN], data[-_DIGEST_LEN:]
    if hashlib.sha256(body).digest()[:_DIGEST_LEN] != digest:
        return None
    magic, version, flags, L, T, KV, hd = _HEADER.unpack_from(body)
    if magic != _MAGIC or version != 1:
        return None
    if (L, KV, hd) != (layout.layers, layout.kv_heads, layout.head_dim) \
            or T <= 0:
        return None
    nval = L * T * KV * hd
    nsc = L * T * KV
    want = _HEADER.size + 2 * nval + 2 * nsc * 4
    if len(body) != want:
        return None
    off = _HEADER.size
    k8 = np.frombuffer(body, np.int8, nval, off).reshape(L, T, KV, hd)
    off += nval
    v8 = np.frombuffer(body, np.int8, nval, off).reshape(L, T, KV, hd)
    off += nval
    ks = np.frombuffer(body, np.float32, nsc, off).reshape(L, T, KV)
    off += nsc * 4
    vs = np.frombuffer(body, np.float32, nsc, off).reshape(L, T, KV)
    if layout.quantized:
        return HostKV(*(torch.from_numpy(a.copy()) for a in (k8, v8, ks, vs)))
    # float32 products, then one cast to the cache dtype: to bfloat16
    # that rounds to nearest even, as the JAX package's ml_dtypes does
    k = torch.from_numpy(k8.astype(np.float32) * ks[..., None])
    v = torch.from_numpy(v8.astype(np.float32) * vs[..., None])
    return HostKV(k.to(layout.dtype), v.to(layout.dtype), None, None)


def concat_blocks(blocks: list[HostKV]) -> HostKV:
    """Consecutive decoded blocks -> one HostKV along the token axis."""
    k = torch.cat([b.k for b in blocks], dim=1)
    v = torch.cat([b.v for b in blocks], dim=1)
    if blocks[0].k_scale is not None:
        ks = torch.cat([b.k_scale for b in blocks], dim=1)
        vs = torch.cat([b.v_scale for b in blocks], dim=1)
    else:
        ks = vs = None
    return HostKV(k, v, ks, vs)
