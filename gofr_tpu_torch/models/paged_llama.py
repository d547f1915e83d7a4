"""Paged (block-pool) KV cache for Llama-family serving (counterpart of
gofr_tpu/models/paged_llama.py, the decode and admission half).

The contiguous ``llama.KVCache`` reserves [B, Smax] rows per slot. This
module keeps the same model math (the layer loop calls the same
``llama._layer``) but stores KV in a shared pool of fixed T-token
blocks with a per-slot block table:

    k/v        [L, N, T, KV, hd]   (int8 with [L, N, T, KV] f32 scales)
    table      [B, MB] int32       host-owned, passed per decode block
    lengths    [B] int32           live tokens per slot

Table invariants (kept by the engine's allocator):
  - entries for live logical blocks hold real pool block ids;
  - entries past the live range repeat the LAST live block, or block 0
    for empty and retired slots;
  - block 0 is a reserved trash block no slot ever owns: writes at a
    retired slot's frozen cursor, and past capacity, land there.

As in ``llama``, the pool is updated IN PLACE, and each step takes
``adapter`` [B], every slot's LoRA adapter (``llama._lora``, on the
projections around attention). ``paged_verify_step`` is
the speculative verify pass over the pool, through the paged window
kernel. A long prompt is chunk-prefilled into a dense single-slot
scratch row (``llama.KVCache``, B=1) and lands in the pool through
``write_row_to_blocks``; ``read_blocks_to_row`` is the restore half of
paged prefix sharing (``SharedPrefixIndex``): a hit gathers the shared
blocks into the scratch row and the chunked prefill resumes there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import paged_attention
from ..ops.quant import quantize_kv
from . import llama
from .common import ModelConfig


@dataclass
class PagedKVCache:
    k: torch.Tensor        # [L, N, T, KV, hd]
    v: torch.Tensor        # [L, N, T, KV, hd]
    lengths: torch.Tensor  # [B] int32, live tokens per slot
    k_scale: torch.Tensor | None = None  # [L, N, T, KV] f32 (int8 pools)
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def n_blocks(self) -> int:
        return self.k.shape[1]


def init_paged_cache(cfg: ModelConfig, slots: int, n_blocks: int,
                     block_size: int = 128, dtype: torch.dtype | None = None,
                     device="cuda") -> PagedKVCache:
    """Pool of ``n_blocks`` blocks (block 0 is the reserved trash block:
    size the pool as usable_tokens // block_size + 1).
    ``dtype=torch.int8`` allocates the quantized pool with scale planes;
    anything else a dense pool in that dtype."""
    device = resolve_device(device)
    dtype = dtype or cfg.tdtype
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    quant = dtype == torch.int8

    def zeros(s, dt):
        return torch.zeros(s, dtype=dt, device=device)

    return PagedKVCache(
        k=zeros(shape, dtype), v=zeros(shape, dtype),
        lengths=zeros((slots,), torch.int32),
        k_scale=zeros(shape[:-1], torch.float32) if quant else None,
        v_scale=zeros(shape[:-1], torch.float32) if quant else None)


def _pool_coords(table: torch.Tensor, positions: torch.Tensor, T: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(block_ids, offsets), shaped as ``positions`` ([B] or [B, W]), for
    writing at ``positions`` through a clamped ``table`` [B, MB].
    Past-capacity positions route to the trash block: the paged form of
    the contiguous cache's dropped write (without it the offset would
    wrap into the slot's own live last block)."""
    mb = table.shape[1]
    pos = positions.long()
    idx = torch.clamp(pos // T, max=mb - 1)
    blk = torch.gather(table.long(), 1, idx if idx.ndim == 2 else idx[:, None])
    if pos.ndim == 1:
        blk = blk[:, 0]
    blk = torch.where(pos < mb * T, blk, torch.zeros_like(blk))
    return blk, pos % T


def _write_pool_rows(cache: PagedKVCache, blk, off, k_rows, v_rows) -> None:
    """cache[:, blk, off] = rows (quantized on write for an int8 pool);
    ``blk``/``off`` index the rows' dims after L. IN PLACE."""
    if cache.quantized:
        qk, sk = quantize_kv(k_rows)
        qv, sv = quantize_kv(v_rows)
        cache.k[:, blk, off] = qk
        cache.v[:, blk, off] = qv
        cache.k_scale[:, blk, off] = sk
        cache.v_scale[:, blk, off] = sv
    else:
        cache.k[:, blk, off] = k_rows.to(cache.k.dtype)
        cache.v[:, blk, off] = v_rows.to(cache.v.dtype)


def paged_decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: PagedKVCache, table: torch.Tensor,
                      rope_tables=None, adapter=None
                      ) -> tuple[torch.Tensor, PagedKVCache]:
    """One decode step for tokens [B] against the paged pool.

    ``table`` [B, MB] int32: clamped block ids (see the module
    docstring). The pool is read-only inside the layer loop (each
    layer's attention takes this token's k/v beside the pool), and all
    layers' new k/v [L, B, KV, hd] are written by one scatter
    afterwards, at each slot's cursor. IN PLACE: returns (logits [B, V]
    float32, the same cache with lengths + 1).

    The caller guarantees that each live slot's current block
    (table[b, lengths[b] // T]) is allocated. Attention runs through the
    paged kernel (ops.paged_attention), which takes its plain version on
    CPU tensors."""
    cfg = llama.multi_request_serving_config(cfg)
    T = cache.block_size
    mb = table.shape[1]
    cos, sin = rope_tables or llama.get_rope_tables(cfg, mb * T,
                                                    tokens.device)
    lengths = cache.lengths
    # a frozen cursor past the rope table reads its last row, as JAX's
    # clamped gather does; such a slot's output is never delivered
    positions = lengths.clamp(max=cos.shape[0] - 1).long()[:, None]

    x = llama._embed(params, cfg, tokens[:, None])            # [B, 1, D]
    k_toks, v_toks = [], []
    for i in range(cfg.n_layers):
        k_l, v_l = cache.k[i], cache.v[i]
        ks_l = cache.k_scale[i] if cache.quantized else None
        vs_l = cache.v_scale[i] if cache.quantized else None

        def attend(q, k_new, v_new, k_l=k_l, v_l=v_l, ks_l=ks_l, vs_l=vs_l):
            return paged_attention.paged_decode_attention(
                q, k_l, v_l, k_new, v_new, table, lengths, ks_l, vs_l)

        x, (k, v), _ = llama._layer(
            x, llama._weights(params, cfg, i), cfg, cos, sin,
            positions, attend, adapter)
        k_toks.append(k[:, 0])
        v_toks.append(v[:, 0])
    blk, off = _pool_coords(table, lengths, T)
    _write_pool_rows(cache, blk, off, torch.stack(k_toks),
                     torch.stack(v_toks))                     # [L,B,KV,hd]
    cache.lengths = lengths + 1
    return llama._logits(params, cfg, x[:, 0]), cache


def paged_verify_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: PagedKVCache, table: torch.Tensor,
                      rope_tables=None, adapter=None
                      ) -> tuple[torch.Tensor, PagedKVCache]:
    """The speculative verify pass over the paged pool: the contract of
    ``llama.verify_step`` (logits [B, W, V] float32; all W KV rows
    written at each slot's cursor; ``lengths`` returned UNCHANGED), with
    the pool addressed through ``table`` [B, MB].

    Attention is the paged window kernel (ops.paged_attention.
    paged_window_attention; its plain version on CPU tensors): the pool
    side streams each slot's live blocks, the W x W in-window part folds
    in exactly. All layers' window rows [L, B, W, KV, hd] are written by
    one scatter through ``_pool_coords``; rows past capacity go to the
    trash block. The caller guarantees that each live slot owns the
    blocks its window covers (positions lengths[b] .. + W - 1), and
    honours acceptance only where lengths + W <= capacity. IN PLACE."""
    cfg = llama.multi_request_serving_config(cfg)
    W = tokens.shape[1]
    T = cache.block_size
    mb = table.shape[1]
    device = tokens.device
    cos, sin = rope_tables or llama.get_rope_tables(cfg, mb * T, device)
    lengths = cache.lengths
    positions = lengths.long()[:, None] + torch.arange(W, device=device)
    # a frozen cursor past the rope table reads its last rows; such a
    # slot's rows land in the trash block and are never delivered
    rope_pos = positions.clamp(max=cos.shape[0] - 1)

    x = llama._embed(params, cfg, tokens)                     # [B, W, D]
    k_w, v_w = [], []
    for i in range(cfg.n_layers):
        k_l, v_l = cache.k[i], cache.v[i]
        ks_l = cache.k_scale[i] if cache.quantized else None
        vs_l = cache.v_scale[i] if cache.quantized else None

        def attend(q, k_new, v_new, k_l=k_l, v_l=v_l, ks_l=ks_l, vs_l=vs_l):
            return paged_attention.paged_window_attention(
                q, k_l, v_l, k_new, v_new, table, lengths, ks_l, vs_l)

        x, (k, v), _ = llama._layer(
            x, llama._weights(params, cfg, i), cfg, cos, sin,
            rope_pos, attend, adapter)
        k_w.append(k)
        v_w.append(v)
    blk, off = _pool_coords(table, positions, T)              # [B, W]
    _write_pool_rows(cache, blk, off, torch.stack(k_w), torch.stack(v_w))
    return llama._logits(params, cfg, x), cache


def write_prompt_blocks(cache: PagedKVCache, k_stack, v_stack, blocks,
                        length=None) -> PagedKVCache:
    """Write one admitted prompt's KV stacks [L, 1, S, KV, hd] (S the
    prompt's bucket) into its ``blocks``: at least ceil(S/T) ids, a
    list or an integer tensor on the pool's device (one captured graph
    a bucket serves every admission). ``length`` is the true prompt
    length, as in JAX's signature: rows in [length, S) are bucket
    padding, landing in the slot's own last block past its cursor
    (invisible behind ``lengths``, overwritten as decode advances) or,
    through the ids past the prompt's own blocks, in the trash block.
    Quantizes on write for an int8 pool, then one block copy
    (write_row_to_blocks) moves the rows. IN PLACE."""
    if cache.quantized:
        qk, sk = quantize_kv(k_stack)
        qv, sv = quantize_kv(v_stack)
        row = llama.KVCache(k=qk, v=qv, lengths=None, k_scale=sk,
                            v_scale=sv)
    else:
        row = llama.KVCache(k=k_stack, v=v_stack, lengths=None)
    return write_row_to_blocks(cache, row, blocks)


def _block_ids(blocks, device) -> torch.Tensor:
    if isinstance(blocks, torch.Tensor):
        return blocks.long()
    return torch.as_tensor(list(blocks), dtype=torch.long, device=device)


def write_row_to_blocks(cache: PagedKVCache, row: llama.KVCache,
                        blocks) -> PagedKVCache:
    """Copy a dense single-slot row (``llama.KVCache`` with B=1,
    [L, 1, S, KV, hd]) into pool blocks: position p goes to
    blocks[p // T] at offset p % T. ``blocks``: a list or an integer
    tensor on the pool's device, at least ceil(S/T) ids; ids past
    ceil(S/T) are not touched, and positions routed to block 0 land in
    the trash block. The paged admissions' one block copy: a bucket
    prefill's quantized stacks (write_prompt_blocks) and a long prompt's
    chunked scratch row. Same-dtype copy for a quantized row (int8 and
    scales move as they are). IN PLACE."""
    T = cache.block_size
    S = row.k.shape[2]
    need = -(-S // T)
    if len(blocks) < need:
        raise ValueError(f"{S} positions need {need} blocks of {T}, got "
                         f"{len(blocks)}")
    device = cache.k.device
    pos = torch.arange(S, device=device)
    blk, off = _block_ids(blocks, device)[pos // T], pos % T
    cache.k[:, blk, off] = row.k[:, 0].to(cache.k.dtype)
    cache.v[:, blk, off] = row.v[:, 0].to(cache.v.dtype)
    if cache.quantized:
        cache.k_scale[:, blk, off] = row.k_scale[:, 0]
        cache.v_scale[:, blk, off] = row.v_scale[:, 0]
    return cache


def read_blocks_to_row(row: llama.KVCache, cache: PagedKVCache,
                       blocks) -> llama.KVCache:
    """Inverse of write_row_to_blocks: gather pool blocks into a dense
    single-slot row [L, 1, S, KV, hd], position p from blocks[p // T]
    at offset p % T, for p below min(S, len(blocks) * T); the rest of
    the row keeps what it held. The restore half of paged prefix
    sharing (shared blocks into the scratch row, then the chunked
    prefill resumes from the match point). IN PLACE on ``row``."""
    T = cache.block_size
    n = min(row.k.shape[2], len(blocks) * T)
    device = cache.k.device
    pos = torch.arange(n, device=device)
    blk, off = _block_ids(blocks, device)[pos // T], pos % T
    row.k[:, 0, :n] = cache.k[:, blk, off].to(row.k.dtype)
    row.v[:, 0, :n] = cache.v[:, blk, off].to(row.v.dtype)
    if cache.quantized:
        row.k_scale[:, 0, :n] = cache.k_scale[:, blk, off]
        row.v_scale[:, 0, :n] = cache.v_scale[:, blk, off]
    return row


class BlockAllocator:
    """Host-side refcounted free list over pool blocks 1..N-1 (block 0
    is the reserved trash block). Refcounts are for blocks held by more
    than one owner (a slot and the shared prefix index); a block returns
    to the free list only when its last holder drops it. Thread-
    compatible: the engine calls it only from the serving loop."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("paged pool needs >= 2 blocks "
                             "(block 0 is reserved)")
        self._free = list(range(n_blocks - 1, 0, -1))
        self._rc = np.zeros(n_blocks, np.int32)
        self.n_blocks = n_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """n block ids (each at refcount 1), or None (nothing allocated)
        if the pool cannot cover the request: the caller picks what to
        do under pressure."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._rc[b] = 1
        return out

    def ref(self, blocks) -> None:
        """One more holder for already-allocated blocks."""
        for b in blocks:
            if self._rc[b] <= 0:
                raise ValueError(f"ref of unallocated block {b}")
            self._rc[b] += 1

    def free(self, blocks) -> None:
        """Drop one reference per block; blocks with no remaining holder
        return to the free list."""
        for b in blocks:
            if self._rc[b] <= 0:
                raise ValueError(f"double free of block {b}")
            self._rc[b] -= 1
            if self._rc[b] == 0:
                self._free.append(b)

    def sole_holder(self, blocks) -> bool:
        """True when the caller's reference is the only one on every
        block: freeing would return them all to the free list."""
        return all(self._rc[b] == 1 for b in blocks)


class SharedPrefixIndex:
    """Zero-copy prefix reuse over the paged pool (the JAX engine's
    index of the same name): an entry records the FULL T-token blocks
    of a stored prompt and holds one reference on each; no KV is copied
    to store. Full blocks are immutable once written (decode only writes
    the block at a slot's cursor, past its prompt's full blocks), so an
    entry stays valid for any continuation; a hit refs the shared blocks
    into the new slot and the prefill resumes at the match point.
    Matches clamp to whole blocks and never take the whole prompt (at
    least one token recomputes). Least-recently-used entries evict under
    pool pressure: eviction drops the entry's references. ``version``
    counts the mutations that can change a ``match`` outcome, so callers
    may memoize a peek. Thread-compatible: serving loop only."""

    def __init__(self, max_entries: int, alloc: BlockAllocator,
                 block_size: int):
        self.max_entries = int(max_entries)
        self._alloc = alloc
        self._t = int(block_size)
        self._entries: list[dict] = []  # {key, blocks, adapter, used}
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.version = 0

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, prompt, adapter: int = 0) -> tuple[list[int], int]:
        """(shared blocks, matched tokens): the longest stored common
        prefix, clamped to whole blocks and to len(prompt) - 1; ([], 0)
        on a miss. Pure: ``accept``/``reject`` do the accounting."""
        prompt = np.asarray(prompt, np.int32)
        limit = (len(prompt) - 1) // self._t  # blocks fully reusable
        best, best_blocks = 0, []
        for e in self._entries:
            if e["adapter"] != adapter:
                continue
            key = e["key"]
            n = min(len(key), len(prompt))
            neq = np.nonzero(key[:n] != prompt[:n])[0]
            m = int(neq[0]) if len(neq) else n
            nb = min(m // self._t, limit)
            if nb * self._t > best:
                best = nb * self._t
                best_blocks = e["blocks"][:nb]
        return (list(best_blocks), best) if best else ([], 0)

    def accept(self, blocks: list[int]) -> None:
        """A hit went live: count it and touch its entry's LRU stamp."""
        self.hits += 1
        self._tick += 1
        lead = blocks[0] if blocks else -1
        for e in self._entries:
            if e["blocks"] and e["blocks"][0] == lead:
                e["used"] = self._tick

    def reject(self) -> None:
        self.misses += 1

    def covered(self, prompt, adapter: int = 0) -> bool:
        """True when an entry already stores at least this prompt's full
        blocks with the same tokens: storing again would only duplicate
        references."""
        prompt = np.asarray(prompt, np.int32)
        n_full = len(prompt) // self._t
        if n_full == 0:
            return True  # nothing storable
        head = prompt[:n_full * self._t]
        for e in self._entries:
            if e["adapter"] == adapter and len(e["key"]) >= len(head) \
                    and np.array_equal(e["key"][:len(head)], head):
                return True
        return False

    def store(self, prompt, blocks: list[int], adapter: int = 0) -> None:
        """Record ``prompt``'s full blocks as an entry, holding one
        reference on each (the blocks are the slot's own, already
        written). Evicts LRU entries past capacity."""
        prompt = np.asarray(prompt, np.int32)
        n_full = len(prompt) // self._t
        if n_full == 0:
            return
        held = list(blocks[:n_full])
        self._alloc.ref(held)
        self._tick += 1
        self.version += 1
        self._entries.append({"key": prompt[:n_full * self._t].copy(),
                              "blocks": held, "adapter": int(adapter),
                              "used": self._tick})
        while len(self._entries) > self.max_entries:
            self.evict_one()

    def evict_one(self) -> bool:
        """Drop one entry's references (the pool-pressure valve); False
        when there is nothing left to evict. Prefers the LRU entry among
        those whose blocks will really return to the free list (no live
        slot still holds them): evicting a share-held entry reclaims
        nothing. Share-held entries go only when nothing reclaimable is
        left (their references still unpin the blocks once the sharing
        slots retire, so a caller's retry loop stays finite)."""
        if not self._entries:
            return False
        order = sorted(range(len(self._entries)),
                       key=lambda i: self._entries[i]["used"])
        victim = next(
            (i for i in order
             if self._alloc.sole_holder(self._entries[i]["blocks"])),
            order[0])
        e = self._entries.pop(victim)
        self._alloc.free(e["blocks"])
        self.version += 1
        return True

    def clear(self) -> int:
        """Drop every entry, releasing its references. Engine recovery
        calls this before it resets the pool: an entry would otherwise
        match prompts against zeroed blocks."""
        n = len(self._entries)
        for e in self._entries:
            self._alloc.free(e["blocks"])
        self._entries = []
        self.version += 1
        return n

    def invalidate_adapter(self, adapter: int) -> int:
        """Drop every entry stored under ``adapter`` (its KV flowed
        through that adapter's weights)."""
        keep, dropped = [], 0
        for e in self._entries:
            if e["adapter"] == int(adapter):
                self._alloc.free(e["blocks"])
                dropped += 1
            else:
                keep.append(e)
        self._entries = keep
        if dropped:
            self.version += 1
        return dropped

    def stats(self) -> dict:
        return {"slots": self.max_entries, "entries": len(self._entries),
                "hits": self.hits, "misses": self.misses,
                "blocks_held": sum(len(e["blocks"]) for e in self._entries)}
