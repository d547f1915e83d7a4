"""Continuous-batching token generation: the serving loop (counterpart of
gofr_tpu/tpu/generator.py, reduced to this slice).

  - A fixed pool of B slots shares one preallocated KV cache
    [L, B, Smax, KV, hd]; slots are admitted and retired independently
    through the per-slot ``lengths`` cursor.
  - Or, with ``paged_blocks``, a pool of fixed T-token blocks
    (models.paged_llama) that the slots share through a host-owned
    block table: the host allocates each admission's prompt blocks,
    grows every active slot's blocks before each decode block, and a
    slot the pool cannot grow is truncated and counted, never
    corrupted. Pool pressure plays out as in the JAX engine.
  - Admission pads a prompt of at most the largest prompt bucket
    (``prompt_buckets``, default 32..512 as in JAX) to its bucket and
    prefills it once, writes its KV into the slot and samples the first
    token, so TTFT is one prefill. A longer prompt runs JAX's chunk
    lattice: mid chunks of C = ``prefill_chunk`` tokens (default the
    largest bucket) against the slot's row with the slot's cursor parked
    at capacity, then a final chunk of one bucket's width ending at the
    prompt's end; with interleave on (JAX's default) one admission pass
    for arrivals and one decode block for the live slots run between
    mid chunks. A paged engine runs the lattice on a dense single-slot
    scratch row and lands it in the slot's blocks in one copy. The
    lattice runs only from the loop's synchronous pass, with no block
    in flight: an arrival that needs it while blocks are queued is put
    back at the front of the queue and drops the pipeline to depth 1.
    On the card each admission dispatch (a bucket's prefill, a mid
    chunk, a final chunk, the paged write-back) is one replay of a CUDA
    graph captured at construction (the port of ``_prefill_jit``,
    ``_chunk_mid_jit``, ``_chunk_final_jit``); the CPU runs the same
    functions eagerly.
  - Decode runs K = ``decode_block`` steps per dispatch over all slots
    (``fused_decode_block``, the port of the JAX engine's fused scan)
    with the sampled token fed back on the device and per-slot stop
    masks (EOS set, budget, capacity) evaluated on the device. Last
    token, active, budget and position ride a device carry from block
    to block; the host's one [B, W] dispatch pack is uploaded only when
    a mutation marked it dirty, and per slot its ``host_wins`` column
    picks the pack's values over the carry's (after an admission, a
    retirement or a verify pass). On the card the block is one CUDA
    graph replay, captured at construction (the port of ``_step_jit``);
    the CPU runs the same function eagerly.
  - Up to ``decode_pipeline`` blocks (default 2, as in JAX) are in
    flight on the device stream: the host reaps block N, delivers its
    tokens and admits arrivals while block N+1 runs
    (``resilience.DecodePipelinePolicy``; a spec engine runs depth 1).
  - Sampling (greedy, temperature, top-k) is keyed on each request's
    (seed, absolute position) as ``fold_in(PRNGKey(seed), pos)`` with
    JAX's threefry (tpu.prng), so a stream is a pure function of its
    seed and draws JAX's random bits, at any depth.
  - With ``spec_decode_k`` = k, prompt-lookup speculative decoding: a
    tick whose active slots are all greedy and clear of capacity, and
    at least half of which find a draft (the k tokens that followed the
    last earlier occurrence of their history's trailing 2-gram), runs
    one verify pass over a window of k + 1 tokens per slot
    (models.llama.verify_step, or paged_llama.paged_verify_step through
    the paged window kernel) and delivers each slot's agreeing prefix
    plus one token; otherwise a decode block runs. Streams are the
    spec-less engine's, token for token.
  - On a CUDA device the engine refuses at construction a model the
    attention kernels do not take (ops.kernels.check_attention_shape),
    naming its shape and the kernel, so nothing raises in the loop for
    that reason.

Consumers call ``generate()`` from any thread and read tokens off a
stream; one background thread, ``gofr-torch-gen``, owns the device loop.
A failed step takes the engine down for good (every stream and waiter
fails). Features outside the slice (prefix cache, LoRA, the kv-cache
tiers, meshes) raise when asked for.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from ..device import resolve_device
from ..models import llama, paged_llama
from ..models.common import ModelConfig
from ..ops import flash, flash_decode, kernels, paged_attention
from ..resilience import DecodePipelinePolicy
from ..wire import PushStream
from . import prng

_REQ_IDS = itertools.count(1)


class GenerationError(RuntimeError):
    """A generation request failed or the engine cannot take it."""


# top-k truncation width: ranks past a request's k are masked within this
# fixed top set (larger k saturates to it)
TOP_K_MAX = 64

# on-device EOS stop-set width: requests with more stop ids keep the host
# check as their only stop for the extra ids
EOS_MAX = 8

# dispatch-pack columns, the JAX engine's layout (_dispatch_pack and
# fused_decode_block agree): 0 last token, 1 active, 2 budget, 3 temp
# (float32 bits), 4 top_k, 5 adapter (0: LoRA is not ported), 6 host_wins,
# 7 seed, 8 position of the next sample (the host's value, read only
# under host_wins), 9.. the EOS set, then (paged) the block-table row
PACK_EXTRA = 9

# the JAX engine's default prompt buckets (gofr_tpu/tpu/engine.py)
DEFAULT_SEQ_BUCKETS = (32, 64, 128, 256, 512)


def pad_bucket(n: int, buckets) -> int:
    """Smallest configured bucket >= n (each bucket is one captured
    graph; the largest when none is that wide)."""
    for b in sorted(buckets):
        if b >= n:
            return b
    return max(buckets)


class _Pending(queue.Queue):
    """The admission queue: FIFO, plus ``put_front`` for a request the
    in-flight admission pass defers to the next synchronous pass."""

    def put_front(self, item) -> None:
        with self.not_empty:
            self.queue.appendleft(item)
            self.unfinished_tasks += 1
            self.not_empty.notify()


# the kernel wrappers' counters: a graph replay runs no Python, so the
# engine adds what each graph's capture counted at every replay
_COUNTERS = ((flash, "launches"), (flash, "plain_calls"),
             (flash_decode, "launches"), (flash_decode, "plain_calls"),
             (paged_attention, "launches"), (paged_attention, "plain_calls"),
             (paged_attention, "window_launches"),
             (paged_attention, "window_plain_calls"))


def _counts() -> list[int]:
    return [getattr(mod, name) for mod, name in _COUNTERS]


def _add_counts(deltas: list[int]) -> None:
    for (mod, name), d in zip(_COUNTERS, deltas):
        if d:
            setattr(mod, name, getattr(mod, name) + d)


def sample(logits: torch.Tensor, temps: torch.Tensor, seeds: torch.Tensor,
           pos: torch.Tensor, top_ks: torch.Tensor, draw: bool = True):
    """Greedy where temp == 0; categorical(logits / temp) otherwise,
    truncated to the request's top-k logits when top_k > 0 -- per slot,
    by the Gumbel-max rule under the key ``fold_in(PRNGKey(seed), pos)``,
    as the JAX engine's ``_sample`` draws it: one key per slot for both
    draws, words 0..V-1 for the full vocabulary and words 0..kmax-1 for
    the top-k set. ``draw=False`` (no slot samples) skips the noise.
    Returns (tokens [B] int64, logprob [B] of each token under the
    untempered model)."""
    greedy = torch.argmax(logits, dim=-1)
    tok = greedy
    if draw:
        V = logits.shape[-1]
        noise = prng.gumbel(prng.fold_in(prng.prng_key(seeds), pos), V)
        scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
        sampled = torch.argmax(scaled + noise, dim=-1)
        kmax = min(TOP_K_MAX, V)
        vals, idx = torch.topk(scaled, kmax, dim=-1)
        kk = torch.clamp(torch.where(top_ks > 0, top_ks, kmax), max=kmax)
        ranks = torch.arange(kmax, device=logits.device)
        vals = vals.masked_fill(ranks[None, :] >= kk[:, None], float("-inf"))
        in_k = torch.argmax(vals + noise[:, :kmax], dim=-1)
        topk_tok = torch.gather(idx, 1, in_k[:, None])[:, 0]
        sampled = torch.where(top_ks > 0, topk_tok, sampled)
        tok = torch.where(temps > 0, sampled, greedy)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return tok, torch.gather(logp, 1, tok[:, None])[:, 0]


def fused_decode_block(params: dict, cfg: ModelConfig, cache, pack, carry,
                       rope_tables, *, steps: int, capacity: int,
                       draw: bool) -> torch.Tensor:
    """``steps`` fused decode steps over all slots (the JAX engine's
    ``_fused_decode_scan``): each step feeds its sampled tokens to the
    next on the device; a slot whose token is in its EOS set, whose
    budget is spent or whose cursor reached ``capacity`` deactivates
    there, and inactive cursors stay frozen.

    ``cache``: a ``llama.KVCache`` or (paged) ``paged_llama.
    PagedKVCache``. ``pack`` [B, W] int64: the dispatch pack (PACK_EXTRA
    columns, the EOS_MAX-wide EOS set, then for a paged cache the
    block-table row). ``carry``: (last token, active, budget, position)
    [B] each, the slot state the previous block left on the device; per
    slot, the pack's ``host_wins`` column picks the pack's values or the
    carry's. Position rides the carry because the host, packing block
    N+1, cannot know how many tokens block N emitted.

    Updates the cache (KV rows and ``lengths``) and the carry IN PLACE
    and returns [steps, 3, B] float64: each step's tokens, their
    logprobs and the emitted mask. Tensors in, tensors out, no host
    read: the engine captures it into a CUDA graph on the card, and the
    CPU (or a check of a replay) runs it eagerly."""
    host_wins = pack[:, 6].bool()
    tokens = torch.where(host_wins, pack[:, 0], carry[0])
    active = torch.where(host_wins, pack[:, 1].bool(), carry[1])
    budget = torch.where(host_wins, pack[:, 2], carry[2])
    pos = torch.where(host_wins, pack[:, 8], carry[3])
    temps = pack[:, 3].to(torch.int32).view(torch.float32)
    top_ks = pack[:, 4]
    seeds = pack[:, 7]
    eos_ids = pack[:, PACK_EXTRA:PACK_EXTRA + EOS_MAX]
    # the model steps rebind their cache's cursor tensor: they run on a
    # shallow copy, and the last cursors are copied into the cache's own
    # tensor, the one a captured graph reads and writes
    work = dataclasses.replace(cache)
    if isinstance(cache, paged_llama.PagedKVCache):
        # constant through the block: the host has allocated blocks
        # covering ``steps`` positions per slot
        table = pack[:, PACK_EXTRA + EOS_MAX:].to(torch.int32)

        def step(toks):
            return paged_llama.paged_decode_step(params, cfg, toks, work,
                                                 table, rope_tables)
    else:
        def step(toks):
            return llama.decode_step(params, cfg, toks, work, rope_tables,
                                     flash=True)
    rows = []
    for _ in range(steps):
        before = work.lengths
        logits, _ = step(tokens)
        lengths = torch.where(active, work.lengths, before)
        work.lengths = lengths
        toks, lps = sample(logits, temps, seeds, pos, top_ks, draw)
        toks = torch.where(active, toks, tokens)
        emitted = active
        budget = torch.where(active, budget - 1, budget)
        # position advances only where a token was emitted
        pos = pos + emitted.long()
        stop = active & llama.decode_stop_mask(toks, lengths, budget,
                                               eos_ids, capacity)
        rows.append(torch.stack([toks.double(), lps.double(),
                                 emitted.double()]))
        tokens, active = toks, active & ~stop
    cache.lengths.copy_(work.lengths)
    for dst, src in zip(carry, (tokens, active, budget, pos)):
        dst.copy_(src)
    return torch.stack(rows)


def verify_epilogue(logits: torch.Tensor, window: torch.Tensor,
                    active: torch.Tensor):
    """The verify pass's tail: greedy tokens [B, W] and their logprobs,
    each slot's accepted draft count (the longest run of drafts
    window[:, 1:] that agree with the greedy tokens before them) and
    emit [B] = accepted + 1 for active slots (the pass's guaranteed
    token), 0 for the rest: how many leading greedy tokens are real and
    how far the slot's cursor advances. Returns (greedy, logprobs,
    accepted, emit)."""
    greedy = torch.argmax(logits, dim=-1)                     # [B, W]
    logp = torch.log_softmax(logits.float(), dim=-1)
    lps = torch.gather(logp, -1, greedy[..., None])[..., 0]
    agree = (greedy[:, :-1] == window[:, 1:]).long()
    accepted = torch.cumprod(agree, dim=1).sum(dim=1)
    emit = torch.where(active, accepted + 1, torch.zeros_like(accepted))
    return greedy, lps, accepted, emit


class AdmissionInputs:
    """The admission dispatches' device inputs: views of one int64
    vector the host fills before each dispatch (one upload; the
    captured admission graphs read these very tensors, so nothing of a
    request is baked into a graph). Layout: the prompt's length (the
    cursor the admission leaves), the slot (the batch row written), a
    chunk's start, the position the first token is sampled at, the
    request's temperature (float32 bits), top-k and seed, then
    ``n_blocks`` pool block ids (paged), then ``width`` token ids,
    zero-padded."""

    LENGTH, SLOT, START, LOGIT_POS, TEMP, TOP_K, SEED = range(7)
    HEAD = 7

    def __init__(self, n_blocks: int, width: int, device):
        self.n_blocks = n_blocks
        self.width = width
        self.buf = torch.zeros((self.HEAD + n_blocks + width,),
                               dtype=torch.long, device=device)

    def _at(self, i: int) -> torch.Tensor:
        return self.buf[i:i + 1]

    @property
    def length(self) -> torch.Tensor:
        return self._at(self.LENGTH).to(torch.int32)

    @property
    def slot(self) -> torch.Tensor:
        return self._at(self.SLOT)

    @property
    def start(self) -> torch.Tensor:
        return self._at(self.START)

    @property
    def logit_pos(self) -> torch.Tensor:
        return self._at(self.LOGIT_POS)

    @property
    def temp(self) -> torch.Tensor:
        return self._at(self.TEMP).to(torch.int32).view(torch.float32)

    @property
    def top_k(self) -> torch.Tensor:
        return self._at(self.TOP_K)

    @property
    def seed(self) -> torch.Tensor:
        return self._at(self.SEED)

    def blocks(self, n: int) -> torch.Tensor:
        return self.buf[self.HEAD:self.HEAD + n]

    def tokens(self, width: int) -> torch.Tensor:
        lo = self.HEAD + self.n_blocks
        return self.buf[lo:lo + width][None]

    def pack(self, host: np.ndarray, tokens, *, length: int, slot: int,
             start: int, logit_pos: int, temp: float, top_k: int, seed: int,
             blocks) -> None:
        """Fill ``host`` (this vector's host image) for one dispatch."""
        host[:] = 0
        host[self.LENGTH] = length
        host[self.SLOT] = slot
        host[self.START] = start
        host[self.LOGIT_POS] = logit_pos
        host[self.TEMP] = np.float32(temp).view(np.int32)
        host[self.TOP_K] = top_k
        host[self.SEED] = seed
        host[self.HEAD:self.HEAD + len(blocks)] = blocks
        lo = self.HEAD + self.n_blocks
        host[lo:lo + len(tokens)] = tokens


def _first_token(logits: torch.Tensor, inp: AdmissionInputs,
                 draw: bool) -> torch.Tensor:
    """The first token and its logprob, [2] float64, sampled from
    logits [1, V] under the request's key at position 0 (the JAX
    engine's ``fold_in(PRNGKey(seed), 0)``)."""
    tok, lp = sample(logits, inp.temp, inp.seed, torch.zeros_like(inp.seed),
                     inp.top_k, draw)
    return torch.cat([tok.double(), lp.double()])


def prefill_admission(params: dict, cfg: ModelConfig, cache,
                      inp: AdmissionInputs, rope_tables, *, bucket: int,
                      draw: bool) -> torch.Tensor:
    """A bucket admission (the JAX engine's ``_prefill_fn``, or
    ``_paged_prefill_fn`` for a ``paged_llama.PagedKVCache``): prefill
    the prompt padded to ``bucket`` tokens through flash_prefill with
    its true length, write its KV into the slot's row (paged: into
    ``inp.blocks``, ceil(bucket/T) ids, those past the prompt's own
    blocks the trash block), set the slot's cursor to the length and
    sample the first token at the prompt's last position. Tensors in,
    [2] float64 (token, logprob) out, no host read: the engine captures
    one graph per (bucket, draw) on the card."""
    length = inp.length
    logits, k, v, _ = llama.prefill_kv(
        params, cfg, inp.tokens(bucket), length, rope_tables=rope_tables,
        flash=True, logit_pos=inp.logit_pos)
    if isinstance(cache, paged_llama.PagedKVCache):
        paged_llama.write_prompt_blocks(
            cache, k, v, inp.blocks(-(-bucket // cache.block_size)), length)
    else:
        llama.write_kv(cache, k, v, slot=inp.slot)
    cache.lengths.index_copy_(0, inp.slot, length)
    return _first_token(logits[:, 0], inp, draw)


def chunk_admission(params: dict, cfg: ModelConfig, cache: llama.KVCache,
                    inp: AdmissionInputs, rope_tables, *, width: int,
                    final: bool, draw: bool = False):
    """One chunk of the lattice (the JAX engine's ``_chunk_fn``):
    ``width`` tokens at ``inp.start`` into row ``inp.slot`` of
    ``cache`` (a serving cache, or a paged engine's B=1 scratch row).
    A mid chunk parks the row's cursor at capacity, so the decode blocks
    interleaved between chunks drop their writes for it, and returns
    None; the final chunk sets the cursor to the prompt's length and
    returns the first token, sampled at ``inp.logit_pos`` within the
    chunk ([2] float64)."""
    logits, _ = llama.prefill_chunk(
        params, cfg, inp.tokens(width), cache, inp.start, inp.slot,
        rope_tables=rope_tables, compute_logits=final,
        logit_pos=inp.logit_pos if final else None)
    if not final:
        cache.lengths.index_fill_(0, inp.slot, cache.k.shape[2])
        return None
    cache.lengths.index_copy_(0, inp.slot, inp.length)
    return _first_token(logits[:, 0], inp, draw)


def writeback_admission(cache: paged_llama.PagedKVCache,
                        row: llama.KVCache, inp: AdmissionInputs) -> None:
    """A paged long prompt's last dispatch: its chunked scratch row into
    the slot's blocks (``inp.blocks``, one id per MB block, those past
    the prompt's own the trash block), then the slot's cursor."""
    T = cache.block_size
    paged_llama.write_row_to_blocks(cache, row,
                                    inp.blocks(-(-row.k.shape[2] // T)))
    cache.lengths.index_copy_(0, inp.slot, inp.length)


class GenStream(PushStream):
    """Iterator over generated token ids; ``cancel()`` releases the slot.
    ``trace`` holds time.monotonic() stamps: "submit", "admit",
    "prefill_done" and "first_put" (the first token's delivery);
    ``chunks`` counts the mid chunks of its prefill (0 for a bucket
    admission)."""

    def __init__(self, request_id: int, logprobs: bool = False):
        super().__init__()
        self.request_id = request_id
        self.cancelled = threading.Event()
        self.prompt_len = 0
        self.logprobs = logprobs  # items are (token, logprob) tuples
        self.trace: dict[str, float] = {}
        self.seed: int | None = None
        self.chunks = 0

    def tokens(self) -> list[int]:
        """Drain the whole stream (blocking) into a list of ids."""
        return [t[0] if isinstance(t, tuple) else t for t in self]

    def cancel(self) -> None:
        self.cancelled.set()


class _Request:
    __slots__ = ("stream", "prompt", "max_new", "temperature", "top_k",
                 "eos_id", "seed")

    def __init__(self, stream: GenStream, prompt: np.ndarray, max_new: int,
                 temperature: float, top_k: int, eos_id, seed: int):
        self.stream = stream
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        self.seed = seed

    @property
    def logprobs(self) -> bool:
        return self.stream.logprobs


class _Inflight:
    """A dispatched-but-unreaped tick. ``done``: the CUDA event recorded
    after the dispatch's results were queued for the host (None when the
    work finished at dispatch, as on the CPU), the readiness probe;
    ``reap(overlapped)``: fetch the results and deliver tokens, under
    the engine's device lock (``overlapped``: a block is still queued
    behind this one); ``ready_t``: when the loop saw the results ready,
    the instant the device stream ran dry unless another block was
    queued behind this one."""
    __slots__ = ("done", "reap", "ready_t")

    def __init__(self, done, reap):
        self.done = done
        self.reap = reap
        self.ready_t: float | None = None

    def ready(self) -> bool:
        return self.done is None or self.done.query()


class _Slot:
    __slots__ = ("request", "remaining", "generated")

    def __init__(self):
        self.request: _Request | None = None
        self.remaining = 0
        self.generated = 0

    @property
    def free(self) -> bool:
        return self.request is None


class GenerationEngine:
    def __init__(self, cfg: ModelConfig, params: dict, *, slots: int = 8,
                 max_seq: int | None = None, logger=None, seed: int = 0,
                 kv_dtype: torch.dtype | None = None, decode_block: int = 4,
                 decode_pipeline: int = 2, admit_window_ms: float = 2.0,
                 device="cuda",
                 prompt_buckets: tuple[int, ...] = DEFAULT_SEQ_BUCKETS,
                 prefill_chunk: int | None = None,
                 prefix_cache_slots: int = 0,
                 spec_decode_k: int = 0, lora_adapters: int = 0,
                 paged_blocks: int = 0, paged_block_size: int = 128,
                 kvcache=None, mesh=None):
        unported = {"prefix_cache_slots": prefix_cache_slots != 0,
                    "lora_adapters": lora_adapters != 0,
                    "kvcache": kvcache is not None,
                    "mesh": mesh is not None}
        asked = [name for name, on in unported.items() if on]
        if asked:
            raise ValueError(f"not ported to gofr_tpu_torch yet: {asked} "
                             "(the port serves contiguous or paged slots)")
        if cfg.n_experts > 0:
            raise ValueError("the port serves dense Llama models; MoE is "
                             "not ported yet")
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self._spec_k = max(0, int(spec_decode_k))
        if self.device.type == "cuda":
            self._check_kernels(kv_dtype, paged_blocks > 0,
                                int(paged_block_size))
        self.n_slots = slots
        self.decode_block = max(1, int(decode_block))
        self.max_seq = min(max_seq or cfg.max_seq, cfg.max_seq)
        self.prompt_buckets = tuple(sorted(
            b for b in prompt_buckets if b <= self.max_seq)) \
            or (self.max_seq,)
        # The chunked-prefill budget (TPU_PREFILL_CHUNK), as in JAX: None
        # is the largest bucket with interleave on; <= 0 interleave off
        # (the chunks run back to back); any other value snaps up to a
        # bucket (a chunk width is a captured graph)
        c_max = self.prompt_buckets[-1]
        if prefill_chunk is None:
            self._chunk, self._chunk_interleave = c_max, True
        elif prefill_chunk <= 0:
            self._chunk, self._chunk_interleave = c_max, False
        else:
            self._chunk = pad_bucket(min(int(prefill_chunk), c_max),
                                     self.prompt_buckets)
            self._chunk_interleave = True
        self.logger = logger
        self._seed = int(seed)
        self._auto_seed = itertools.count(1)
        # Paged KV: slots share a pool of T-token blocks through a
        # host-owned table instead of owning [max_seq] rows, so the
        # pool is sized to the expected live tokens
        self._paged = paged_blocks > 0
        if self._paged:
            self._block_t = int(paged_block_size)
            if self._block_t <= 0:
                raise ValueError(f"paged_block_size={paged_block_size} "
                                 "must be positive")
            self._mb = -(-self.max_seq // self._block_t)
            min_blocks = 2 + self.prompt_buckets[-1] // self._block_t
            if paged_blocks < min_blocks:
                raise ValueError(f"paged_blocks={paged_blocks} too small: "
                                 f"need >= {min_blocks} (trash block + "
                                 "one prompt's worth)")
            self._alloc = paged_llama.BlockAllocator(paged_blocks)
            self._table = np.zeros((slots, self._mb), np.int32)
            self._slot_blocks: list[list[int]] = [[] for _ in range(slots)]
            # the host's view of each slot's device cursor, advanced at
            # dispatch
            self._cursors = np.zeros((slots,), np.int64)
            # where each slot's on-device stop mask freezes its cursor
            # (budget/capacity; 0 = none): blocks past it are never
            # demanded for the slot
            self._stop_cursors = np.zeros((slots,), np.int64)
            self._paged_evictions = 0
            self.cache = paged_llama.init_paged_cache(
                cfg, slots, paged_blocks, self._block_t, dtype=kv_dtype,
                device=self.device)
        else:
            self.cache = llama.init_cache(cfg, slots, self.max_seq,
                                          dtype=kv_dtype, device=self.device)
        self.rope_tables = llama.get_rope_tables(cfg, self.max_seq,
                                                 self.device)
        # a prompt past the chunk budget runs the chunk lattice; a paged
        # engine runs it on a dense single-slot scratch row (one slot's
        # row of memory), landed in the slot's blocks in one copy
        self._lattice = self.max_seq - 1 > self._chunk
        if self._paged and self._lattice:
            self._scratch = llama.init_cache(cfg, 1, self.max_seq,
                                             dtype=kv_dtype,
                                             device=self.device)
        # the admission dispatches' inputs, one vector uploaded per
        # dispatch (AdmissionInputs); no dispatch is wider than the chunk
        # budget, itself a bucket
        self._adm_in = AdmissionInputs(self._mb if self._paged else 0,
                                       self._chunk, self.device)
        self._adm_uploads = 0
        self.admission_replays = 0   # admission dispatches run as replays
        # set when the in-flight admission pass deferred a lattice
        # admission; drops the pipeline to depth 1 until the synchronous
        # pass that runs it
        self._lattice_deferred = False

        self._slots = [_Slot() for _ in range(slots)]
        self._last_tokens = np.zeros((slots,), np.int64)
        self._active = np.zeros((slots,), bool)
        self._budgets = np.zeros((slots,), np.int64)
        self._temps = np.zeros((slots,), np.float32)
        self._top_ks = np.zeros((slots,), np.int64)
        self._slot_seed = np.zeros((slots,), np.int64)
        self._pos_abs = np.zeros((slots,), np.int64)
        self._eos_mat = np.full((slots, EOS_MAX), llama.EOS_PAD, np.int64)
        # per slot: the next decode dispatch takes the pack's slot state
        # over the device carry's (set at admission, retirement and after
        # a verify pass, cleared by a decode dispatch)
        self._host_wins = np.ones((slots,), bool)

        # The decode dispatch's device inputs, allocated once (a captured
        # graph reads these very tensors): the pack, rewritten only when
        # a mutation site marked it dirty (_touch), and the slot-state
        # carry each block leaves for the next
        width = PACK_EXTRA + EOS_MAX + (self._mb if self._paged else 0)
        self._pack = torch.zeros((slots, width), dtype=torch.long,
                                 device=self.device)
        self._pack_dirty = True
        self.pack_uploads = 0
        self._carry = self._host_carry()

        # Prompt-lookup speculative decoding (greedy slots only): each
        # slot's token history in a preallocated buffer, so _draft reads
        # views and an append is one index write
        if self._spec_k:
            self._spec_windows = 0   # slot-windows verified
            self._spec_emitted = 0   # tokens those windows emitted
            self._hist_buf = np.zeros((slots, self.max_seq), np.int32)
            self._hist_n = np.zeros((slots,), np.int64)

        # The decode dispatch pipeline (the JAX engine's): up to depth
        # blocks in flight on the device stream, the host reaping the
        # oldest while the next runs
        self._pipeline = DecodePipelinePolicy(decode_pipeline)
        # in-flight admission poll cadence (seconds), TPU_ADMIT_WINDOW_MS;
        # 0 polls every millisecond
        self._admit_window = max(0.0, float(admit_window_ms)) / 1e3
        self._depth_now = 0
        # inter-block host gaps: _idle_from marks when the device stream
        # ran dry (a reap with no block queued behind it), the next
        # dispatch closes the gap; overlapped reaps record 0.0
        self._idle_from: float | None = None
        self._gap_samples: "deque[float]" = deque(maxlen=2048)
        self._reaps = 0
        self._overlapped_reaps = 0
        # reap time of the last reap that had a block queued behind it
        # (decode_step_ms_mean's reap-to-reap anchor)
        self._steady_from: float | None = None

        self._pending: "_Pending[_Request]" = _Pending()
        self._device_lock = threading.Lock()
        self._admission_lock = threading.Lock()
        self._work = threading.Event()
        self._closed = False
        self.down: str | None = None
        self.total_tokens = 0
        self.total_requests = 0
        self.admissions = 0      # prefills run (one per admission)
        self.decode_steps = 0    # decode steps dispatched (K per block)
        self.verify_passes = 0   # speculative verify passes run
        self.graph_replays = 0   # decode blocks run as a graph replay
        self._block_s: "deque[float]" = deque(maxlen=1024)
        self._verify_s: "deque[float]" = deque(maxlen=1024)
        if self.device.type == "cuda":
            self._capture_graphs()
            self._capture_admission_graphs()
        if self._spec_k:
            self._warm_verify()
        self._thread = threading.Thread(target=self._loop,
                                        name="gofr-torch-gen", daemon=True)
        self._thread.start()

    # -- public API ----------------------------------------------------------
    def generate(self, prompt, max_new_tokens: int = 128,
                 temperature: float = 0.0, top_k: int = 0, eos_id=None,
                 logprobs: bool = False, seed: int | None = None
                 ) -> GenStream:
        """Enqueue a prompt (sequence of token ids); returns a GenStream
        yielding generated ids as the device produces them.

        ``temperature=0`` is greedy; ``top_k > 0`` truncates sampling to
        the k most likely tokens (capped at TOP_K_MAX). ``eos_id``: one
        stop id or an iterable of them; the stream ends at, and
        includes, the first generated token in the set. ``seed`` fixes a
        sampled request's stream; sampled requests without one get a
        deterministic per-engine seed, surfaced as ``stream.seed``."""
        if self._closed:
            raise GenerationError("generation engine is closed")
        if self.down is not None:
            raise GenerationError(f"generation engine is down: {self.down}")
        if eos_id is not None and not isinstance(eos_id, (int, np.integer)):
            eos_id = frozenset(int(t) for t in eos_id) or None
        elif isinstance(eos_id, np.integer):
            eos_id = int(eos_id)
        if seed is not None:
            seed = int(seed) & 0x7FFFFFFF
        elif temperature > 0:
            seed = (self._seed * 1000003 + next(self._auto_seed)) & 0x7FFFFFFF
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        stream = GenStream(next(_REQ_IDS), logprobs=logprobs)
        stream.trace["submit"] = time.monotonic()
        stream.prompt_len = len(prompt)
        stream.seed = seed
        limit = self.max_seq - 1
        why = None
        if len(prompt) == 0 or len(prompt) > limit:
            why = ("empty prompt" if len(prompt) == 0 else
                   f"prompt length {len(prompt)} exceeds serving limit "
                   f"{limit}")
        elif self._paged:
            # fail fast when the POOL can never hold this prompt: a
            # transient shortage requeues at admission, a structural one
            # would requeue forever
            need = -(-len(prompt) // self._block_t)
            usable = self._alloc.n_blocks - 1
            if need > usable:
                why = (f"prompt needs {need} pool blocks but the pool has "
                       f"{usable} (raise TPU_PAGED_BLOCKS or "
                       "TPU_PAGED_BLOCK)")
        if why is not None:
            stream._q.put(GenerationError(why))
            stream._q.put(None)
            return stream
        with self._admission_lock:
            # checked under the lock the failure path sets ``down``
            # under, so no request is queued after the queue was failed
            if self._closed:
                raise GenerationError("generation engine is closed")
            if self.down is not None:
                raise GenerationError(
                    f"generation engine is down: {self.down}")
            self._pending.put(_Request(stream, prompt, int(max_new_tokens),
                                       float(temperature), int(top_k),
                                       eos_id, seed or 0))
        self._work.set()
        return stream

    def stats(self) -> dict:
        blocks = list(self._block_s)
        step_ms = (1e3 * sum(blocks) / (len(blocks) * self.decode_block)
                   if blocks else None)
        out = {
            "slots": self.n_slots,
            "active": int(self._active.sum()),
            "queued": self._pending.qsize(),
            "max_seq": self.max_seq,
            "prompt_buckets": list(self.prompt_buckets),
            "decode_block": self.decode_block,
            "kv_dtype": str(self.cache.k.dtype),
            "device": str(self.device),
            "total_requests": self.total_requests,
            "total_tokens": self.total_tokens,
            "admissions": self.admissions,
            "decode_steps": self.decode_steps,
            "decode_step_ms_mean": step_ms,
            "graph_replays": self.graph_replays,
            "admission_replays": self.admission_replays,
            "pack_uploads": self.pack_uploads,
            "scheduler": {"prefill_chunk": self._chunk,
                          "chunk_interleave": self._chunk_interleave,
                          "pipeline": self._pipeline_stats()},
            "down": self.down,
        }
        if self._paged:
            n_usable = self._alloc.n_blocks - 1
            out["paged"] = {
                "block_size": self._block_t,
                "blocks": n_usable,
                "free": self._alloc.free_blocks,
                "utilization": round(1 - self._alloc.free_blocks
                                     / max(1, n_usable), 3),
                "evictions": self._paged_evictions,
            }
        if self._spec_k:
            out["spec_decode"] = {
                "k": self._spec_k,
                "windows": self._spec_windows,
                "emitted": self._spec_emitted,
                "tokens_per_window": (
                    round(self._spec_emitted / self._spec_windows, 3)
                    if self._spec_windows else None),
                "verify_ms_mean": (1e3 * sum(self._verify_s)
                                   / len(self._verify_s)
                                   if self._verify_s else None),
            }
        return out

    def _pipeline_stats(self) -> dict:
        """The decode pipeline as the JAX engine reports it: the
        configured ceiling, the depth the next top-up targets, the depth
        in flight, and the inter-block host-gap distribution (overlapped
        reaps are those whose successor was already queued)."""
        samples: list = []
        for _ in range(4):  # the loop appends concurrently
            try:
                samples = list(self._gap_samples)
                break
            except RuntimeError:
                continue
        return {
            "depth": self._pipeline.depth,
            "target_depth": self._target_depth(),
            "depth_now": self._depth_now,
            "reaps": self._reaps,
            "overlapped_reaps": self._overlapped_reaps,
            "gap_p50_ms": (round(float(np.median(samples)) * 1e3, 4)
                           if samples else None),
            "gap_samples": len(samples),
        }

    def close(self) -> None:
        with self._admission_lock:
            self._closed = True
        self._work.set()
        self._thread.join(timeout=60.0)
        with self._device_lock:
            if self.device.type == "cuda":
                # blocks still in flight finish before their graphs and
                # buffers can go
                torch.cuda.synchronize(self.device)
            self._fail_all(GenerationError("engine closed"))

    # -- the serving loop ----------------------------------------------------
    def _loop(self) -> None:
        # the decode dispatch pipeline: an oldest-first deque of in-flight
        # blocks. Each pass tops it up to the target depth, admits
        # arrivals while the oldest block runs, then reaps that block
        pipe: "deque[_Inflight]" = deque()
        while not self._closed:
            try:
                if pipe or self._active.any() or not self._pending.empty():
                    with self._device_lock:
                        if not pipe:
                            # the synchronous pass, the only one that
                            # may run a chunk lattice (its interleaved
                            # decode blocks need a fully reaped loop)
                            self._lattice_deferred = False
                            self._admit()
                        depth = self._target_depth()
                        while len(pipe) < depth and not self._closed:
                            inflight = self._tick(decode_only=bool(pipe))
                            if inflight is None:
                                break
                            pipe.append(inflight)
                        self._depth_now = len(pipe)
                    if not pipe:
                        continue
                    self._admit_inflight(pipe[0])
                    with self._device_lock:
                        inflight = pipe.popleft()
                        self._reaps += 1
                        if pipe:
                            # a block still queued on the device: no gap
                            self._overlapped_reaps += 1
                            self._gap_samples.append(0.0)
                        else:
                            # the stream ran dry when this block's results
                            # came ready; the next dispatch closes the gap
                            self._idle_from = (inflight.ready_t
                                               or time.monotonic())
                        inflight.reap(bool(pipe))
                else:
                    self._work.clear()
                    if self._pending.empty() and not self._closed:
                        self._work.wait(0.05)
            except Exception as e:  # noqa: BLE001 — waiters must not hang
                # the blocks in flight died with the failure, and the
                # cache is in an unknown state: drop every handle, fail
                # every stream and waiter, and stay down
                pipe.clear()
                self._go_down(e)
                return

    def _go_down(self, e: Exception) -> None:
        with self._admission_lock:
            self.down = repr(e)
        if self.logger is not None:
            self.logger.error({"event": "generation loop failed",
                               "error": repr(e)})
        with self._device_lock:
            self._fail_all(GenerationError(f"generation failed: {e!r}"))

    def _fail_all(self, err: Exception) -> None:
        for idx, slot in enumerate(self._slots):
            if slot.request is not None:
                slot.request.stream._q.put(err)
                self._retire(idx, slot)
        while True:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            req.stream._q.put(err)
            req.stream._q.put(None)

    def _admit_inflight(self, inflight: _Inflight) -> None:
        """Admit arrivals while a dispatched block runs on the device
        (the JAX engine's ``_admit_inflight``): their prefills queue on
        the stream behind it, so a first token costs the rest of the
        block plus a prefill. One admission pass comes before the first
        readiness probe, so a device that finishes blocks before the
        host looks (the CPU runs them at dispatch) still admits while
        blocks are queued; then it polls the block's event every
        TPU_ADMIT_WINDOW_MS, admitting what arrives. An arrival that needs
        the chunk lattice waits for the next synchronous pass
        (``defer_lattice``). The deadline bounds the poll: the reap then
        waits on the event."""
        deadline = time.monotonic() + 60.0
        poll = self._admit_window or 1e-3
        while not self._closed and time.monotonic() < deadline:
            started = 0
            if not self._pending.empty():
                with self._device_lock:
                    started = self._admit(defer_lattice=True)
            if inflight.ready():
                inflight.ready_t = time.monotonic()
                return
            if started:
                continue  # more may be queued behind the ones admitted
            self._work.clear()
            self._work.wait(poll)

    def _target_depth(self) -> int:
        """Pipeline depth for the next top-up (also in stats()): the
        policy's verdict on the facts this engine has. A deferred
        lattice admission and spec decoding pin depth 1 (no latency
        class is ported)."""
        return self._pipeline.target(lattice_deferred=self._lattice_deferred,
                                     spec_decode=bool(self._spec_k))

    def _note_dispatch(self, now: float) -> None:
        """Close an open inter-block gap: the device stream ran dry at
        ``_idle_from`` and this dispatch is the first work queued
        since."""
        if self._idle_from is None:
            return
        gap, self._idle_from = max(0.0, now - self._idle_from), None
        self._gap_samples.append(gap)

    def _admit(self, defer_lattice: bool = False) -> int:
        """Start pending requests in free slots; returns how many
        started. ``defer_lattice``: the in-flight pass must not start a
        chunk-lattice admission (its interleaved decode blocks would
        decode the active slots a second time under the unreaped block),
        so such a request goes back to the front of the queue for the
        next synchronous pass, and the pipeline drops to depth 1 so that
        pass comes within one reap."""
        started = 0
        for idx, slot in enumerate(self._slots):
            if not slot.free:
                continue
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            if defer_lattice and self._needs_lattice(req):
                self._lattice_deferred = True
                self._pending.put_front(req)
                break
            if req.stream.cancelled.is_set():
                req.stream._q.put(None)
                continue
            blocks = None
            if self._paged:
                # the prompt's ceil(L/T) blocks, or None (nothing held)
                blocks = self._alloc.alloc(-(-len(req.prompt)
                                             // self._block_t))
                if blocks is None:
                    # transient pool pressure: requeue and let active
                    # slots retire blocks
                    self._pending.put(req)
                    break
            self._start(idx, slot, req, blocks)
            started += 1
        return started

    def _needs_lattice(self, req: _Request) -> bool:
        """Would admitting ``req`` run the chunk lattice? (A prompt past
        the chunk budget.)"""
        return len(req.prompt) > self._chunk

    def _prefill(self, idx: int, req: _Request,
                 blocks: list[int] | None) -> tuple[int, float]:
        """Prefill the prompt into slot ``idx`` (paged: into ``blocks``)
        and sample the first token (position 0 of the request's stream):
        one bucket dispatch, or the chunk lattice past the chunk budget.
        Queued on the stream behind any blocks in flight; reading the
        first token waits for them."""
        if self._paged:
            return self._paged_admit_prefill(idx, req, blocks)
        if len(req.prompt) <= self._chunk:
            return self._bucket_prefill(idx, req)
        return self._chunk_lattice(idx, req)

    def _bucket_prefill(self, idx: int, req: _Request,
                        blocks: list[int] = ()) -> tuple[int, float]:
        n = len(req.prompt)
        bucket = pad_bucket(n, self.prompt_buckets)
        self._admission_inputs(req.prompt, req, length=n, slot=idx,
                               logit_pos=n - 1, blocks=blocks)
        return self._run_admission(("prefill", bucket,
                                    req.temperature > 0))

    def _paged_admit_prefill(self, idx: int, req: _Request,
                             blocks: list[int]) -> tuple[int, float]:
        """Paged admission (the JAX engine's ``_paged_admit_prefill``
        without a prefix hit). The blocks are the slot's from the start,
        so every exit path frees them through ``_retire``; its table row
        stays zeroed (trash-routed) until the prompt is in, because the
        decode blocks a lattice interleaves step the slot at its stale
        cursor. A bucket prompt is one dispatch writing ceil(bucket/T)
        blocks (ids past the prompt's own: the trash block); a longer one
        runs the lattice on the scratch row, then one copy lands the row
        in the blocks and sets the cursor."""
        n = len(req.prompt)
        self._slot_blocks[idx] = blocks
        self._cursors[idx] = n
        if n <= self._chunk:
            width = -(-pad_bucket(n, self.prompt_buckets) // self._block_t)
            first = self._bucket_prefill(
                idx, req, blocks + [0] * (width - len(blocks)))
            self._write_table_row(idx)
            return first
        first = self._chunk_lattice(0, req)
        if req.stream.cancelled.is_set():
            return first   # the slot retires at delivery, freeing blocks
        self._admission_inputs((), req, length=n, slot=idx,
                               blocks=blocks + [0] * (self._mb - len(blocks)))
        self._run_admission(("writeback",))
        self._write_table_row(idx)
        return first

    def _chunk_lattice(self, row: int, req: _Request) -> tuple[int, float]:
        """The chunked-prefill lattice (the JAX engine's
        ``_chunk_lattice``) for ``req.prompt`` into batch row ``row`` of
        the serving cache (paged: row 0 of the scratch row): mid chunks
        of C tokens from position 0 while more than C remain, then a
        final chunk of bucket width Sb ending exactly at the prompt's
        end (it may overlap the last mid chunk: those positions
        recompute the same KV). With interleave on, between mid chunks:
        one admission pass for arrivals into other free slots (lattice
        arrivals deferred: one lattice at a time), then one decode block
        for the live slots, reaped at once. Returns the first token and
        its logprob, or (0, 0.0) when the stream was cancelled mid-way
        (the slot retires at delivery)."""
        n = len(req.prompt)
        c = self._chunk
        pos = 0
        while n - pos > c:
            if req.stream.cancelled.is_set():
                return 0, 0.0
            self._admission_inputs(req.prompt[pos:pos + c], req, slot=row,
                                   start=pos)
            self._run_admission(("mid",))
            pos += c
            req.stream.chunks += 1
            if not self._chunk_interleave:
                continue
            self._admit(defer_lattice=True)
            inflight = self._decode_tick()
            if inflight is not None:
                inflight.reap(False)
        if req.stream.cancelled.is_set():
            return 0, 0.0
        width = pad_bucket(n - pos, self.prompt_buckets)
        self._admission_inputs(req.prompt[n - width:], req, length=n,
                               slot=row, start=n - width,
                               logit_pos=width - 1)
        return self._run_admission(("final", width, req.temperature > 0))

    def _admission_inputs(self, tokens, req: _Request, *, slot: int,
                          length: int = 0, start: int = 0,
                          logit_pos: int = 0, blocks=()) -> None:
        """Upload one admission dispatch's inputs (AdmissionInputs). On
        the card through one of two pinned staging buffers, copied
        ``non_blocking`` behind whatever the stream holds, a buffer
        written again only once the copy that read it has completed."""
        inp = self._adm_in
        cuda = self.device.type == "cuda"
        if cuda:
            staged, copied = self._adm_staging[self._adm_uploads % 2]
            copied.synchronize()
            host = staged.numpy()
        else:
            host = np.empty(tuple(inp.buf.shape), np.int64)
        inp.pack(host, tokens, length=length, slot=slot, start=start,
                 logit_pos=logit_pos, temp=req.temperature,
                 top_k=req.top_k, seed=req.seed, blocks=blocks)
        if cuda:
            inp.buf.copy_(staged, non_blocking=True)
            copied.record()
        else:
            inp.buf.copy_(torch.from_numpy(host))
        self._adm_uploads += 1

    def _admission_fn(self, key: tuple):
        """The admission dispatch ``key`` names, bound to the engine's
        tensors: ("prefill", bucket, draw), ("mid",), ("final", width,
        draw) or ("writeback",)."""
        kind = key[0]
        if kind == "prefill":
            return functools.partial(
                prefill_admission, self.params, self.cfg, self.cache,
                self._adm_in, self.rope_tables, bucket=key[1], draw=key[2])
        if kind == "writeback":
            return functools.partial(writeback_admission, self.cache,
                                     self._scratch, self._adm_in)
        final = kind == "final"
        return functools.partial(
            chunk_admission, self.params, self.cfg,
            self._scratch if self._paged else self.cache, self._adm_in,
            self.rope_tables, width=key[1] if final else self._chunk,
            final=final, draw=final and key[2])

    def _admission_keys(self) -> list[tuple]:
        """Every admission dispatch this engine can run: a prefill per
        bucket within the chunk budget (wider buckets never dispatch)
        and draw value; with the lattice, the mid chunk, a final chunk
        per such bucket and draw value, and (paged) the write-back."""
        buckets = [b for b in self.prompt_buckets if b <= self._chunk]
        keys = [("prefill", b, d) for b in buckets for d in (False, True)]
        if self._lattice:
            keys.append(("mid",))
            keys += [("final", b, d) for b in buckets for d in (False, True)]
            if self._paged:
                keys.append(("writeback",))
        return keys

    def _run_admission(self, key: tuple):
        """Run one admission dispatch on the inputs uploaded last: its
        (first token, logprob), or None for a mid chunk and the
        write-back. On the card one replay of its graph, whose first
        token is copied into a pinned buffer and read after the copy's
        event (as JAX reads ``int(tok)``: behind the blocks in flight);
        on the CPU the function, eagerly."""
        if self.device.type != "cuda":
            with torch.no_grad():
                out = self._admission_fn(key)()
            return None if out is None else (int(out[0]), float(out[1]))
        graph, out, deltas = self._adm_graphs[key]
        graph.replay()
        _add_counts(deltas)
        self.admission_replays += 1
        if out is None:
            return None
        host, done = self._adm_out
        host.copy_(out, non_blocking=True)
        done.record()
        done.synchronize()
        return int(host[0]), float(host[1])

    def _start(self, idx: int, slot: _Slot, req: _Request,
               blocks: list[int] | None = None) -> None:
        req.stream.trace["admit"] = time.monotonic()
        slot.request = req
        try:
            first, first_lp = self._prefill(idx, req, blocks)
        except Exception as e:
            if self._paged:
                # clear the slot's blocks, table row and cursor before
                # freeing, so no stale row points at reallocated blocks
                self._slot_blocks[idx] = []
                self._table[idx, :] = 0
                self._cursors[idx] = 0
                self._alloc.free(blocks)
                self._touch()
            slot.request = None
            req.stream._q.put(GenerationError(f"prefill failed: {e!r}"))
            req.stream._q.put(None)
            raise
        req.stream.trace["prefill_done"] = time.monotonic()
        self.admissions += 1
        self.total_requests += 1
        slot.generated = 0
        slot.remaining = req.max_new
        self._temps[idx] = req.temperature
        self._top_ks[idx] = req.top_k
        self._slot_seed[idx] = req.seed
        self._touch()
        if self._spec_k:
            self._hist_set(idx, req.prompt)
            self._hist_append(idx, first)
        self._deliver(idx, slot, first, first_lp)
        if slot.request is not None:  # not finished by the first token
            self._last_tokens[idx] = first
            self._active[idx] = True
            self._budgets[idx] = slot.remaining
            self._eos_row(idx, req.eos_id)
            # the next sample's absolute position: the prefill's first
            # token took position 0
            self._pos_abs[idx] = slot.generated
            if self._paged:
                # where the device's budget/capacity stop masks will
                # freeze this slot's cursor (EOS may stop earlier)
                self._stop_cursors[idx] = min(
                    req.stream.prompt_len + slot.remaining,
                    self.max_seq - 2)
            # the pack's slot state wins over whatever the device carry
            # holds for this slot
            self._host_wins[idx] = True
            self._touch()

    def _eos_row(self, idx: int, eos_id) -> None:
        row = self._eos_mat[idx]
        row[:] = llama.EOS_PAD
        if eos_id is None:
            return
        ids = (eos_id,) if isinstance(eos_id, int) else tuple(eos_id)
        for j, t in zip(range(EOS_MAX), ids):
            row[j] = t

    # -- the decode dispatch -------------------------------------------------
    def _touch(self) -> None:
        """A mutation site changed host state the dispatch pack carries:
        the next decode dispatch uploads the pack."""
        self._pack_dirty = True

    def _warm_pack(self) -> np.ndarray:
        """All-inactive dispatch pack for the warm-up: host_wins set so
        the carry is ignored, active clear so no cursor moves, EOS rows
        padded, (paged) table zeroed so the step's writes land in the
        trash block."""
        p = np.zeros(tuple(self._pack.shape), np.int64)
        p[:, 6] = 1
        p[:, PACK_EXTRA:PACK_EXTRA + EOS_MAX] = llama.EOS_PAD
        return p

    def _host_carry(self) -> tuple:
        """The device slot-state carry built from the host arrays: the
        first block's stand-in for a previous block's (every slot starts
        under host_wins). ``torch.tensor`` copies the arrays."""
        return tuple(torch.tensor(a, device=self.device)
                     for a in (self._last_tokens, self._active,
                               self._budgets, self._pos_abs))

    def _dispatch_pack(self) -> None:
        """Upload every host-owned per-slot decode input as one [B, W]
        int64 matrix into the device pack, only when a mutation site
        marked it dirty (_touch): in steady state nothing is uploaded.

        On the card the matrix is built in a pinned staging buffer and
        copied ``non_blocking``, queued on the stream behind the blocks
        in flight: a copy from pageable memory would synchronise the
        stream, and the host would wait for the block in flight (depth 2
        would run as depth 1). A staging buffer is written again only
        once the copy that read it has completed (its event)."""
        if not self._pack_dirty:
            return
        cuda = self.device.type == "cuda"
        if cuda:
            staged, copied = self._staging[self.pack_uploads % 2]
            copied.synchronize()
            p = staged.numpy()
        else:
            p = np.empty(tuple(self._pack.shape), np.int64)
        p[:, 0] = self._last_tokens
        p[:, 1] = self._active
        p[:, 2] = self._budgets
        p[:, 3] = self._temps.view(np.int32)
        p[:, 4] = self._top_ks
        p[:, 5] = 0
        p[:, 6] = self._host_wins
        p[:, 7] = self._slot_seed
        p[:, 8] = self._pos_abs
        p[:, PACK_EXTRA:PACK_EXTRA + EOS_MAX] = self._eos_mat
        if self._paged:
            p[:, PACK_EXTRA + EOS_MAX:] = self._table
        if cuda:
            self._pack.copy_(staged, non_blocking=True)
            copied.record()
        else:
            self._pack.copy_(torch.from_numpy(p))
        self._pack_dirty = False
        self.pack_uploads += 1

    def _block(self, draw: bool) -> torch.Tensor:
        return fused_decode_block(
            self.params, self.cfg, self.cache, self._pack, self._carry,
            self.rope_tables, steps=self.decode_block,
            # the host retires one delivered token before the cursor
            # reaches capacity (see _deliver): post-step cursors at
            # max_seq - 2 mean the NEXT delivery would reach the bound
            capacity=self.max_seq - 2, draw=draw)

    def _capture(self, fns: dict, label: str) -> dict:
        """Capture each ``fns[key]()`` into a CUDA graph, all the graphs
        in one memory pool of their own: each function runs once on a
        side stream first (as JAX warms its programs), then the captures.
        A capture launches nothing, so the launch counters go back to
        what they were, and what they counted is added at each replay.
        Returns key -> (graph, output, counter deltas). Raises when a
        capture fails: on the card there is no eager path."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side), torch.no_grad():
            for fn in fns.values():
                fn()
        main.wait_stream(side)
        torch.cuda.synchronize(self.device)
        graphs = {}
        pool = None
        for key, fn in fns.items():
            graph = torch.cuda.CUDAGraph()
            before = _counts()
            try:
                with torch.no_grad(), torch.cuda.graph(
                        graph, pool=pool, capture_error_mode="thread_local"):
                    out = fn()
            except Exception as e:
                raise RuntimeError(
                    f"capturing the {label.format(key)} as a CUDA graph "
                    f"failed: {e!r}") from e
            finally:
                deltas = [a - b for a, b in zip(_counts(), before)]
                _add_counts([-d for d in deltas])
            pool = graph.pool()
            graphs[key] = (graph, out, deltas)
        return graphs

    def _capture_graphs(self) -> None:
        """The port of the JAX engine's ``_step_jit``: the decode block
        captured into one CUDA graph per ``draw`` value (``_capture``),
        warmed over the all-inactive warm pack. The kernels are built and
        loaded first."""
        kernels.build_all()
        self._staging = [(torch.empty(tuple(self._pack.shape),
                                      dtype=torch.long, pin_memory=True),
                          torch.cuda.Event()) for _ in range(2)]
        self._out_free: list = []   # pinned output buffers for reaps
        self._pack.copy_(torch.from_numpy(self._warm_pack()))
        self._graphs = self._capture(
            {draw: functools.partial(self._block, draw)
             for draw in (False, True)}, "decode block (draw={})")
        self._pack_dirty = True   # the device pack holds the warm pack

    def _capture_admission_graphs(self) -> None:
        """The port of the JAX engine's ``_prefill_jit``,
        ``_chunk_mid_jit`` and ``_chunk_final_jit`` (and, paged, its
        write-back): one CUDA graph per admission dispatch
        (``_admission_keys``, ``_capture``), in a pool apart from the
        decode graphs', so no decode replay can reuse what an
        admission's output holds before it is copied out. The warm-up
        writes only what is rewritten before it is read (slot 0's row,
        the trash block, the scratch row), and the cursors are zeroed
        afterwards. ``admission_graph_bytes``: the memory the captures
        reserved."""
        reserved = torch.cuda.memory_reserved(self.device)
        self._adm_staging = [(torch.zeros(tuple(self._adm_in.buf.shape),
                                          dtype=torch.long, pin_memory=True),
                              torch.cuda.Event()) for _ in range(2)]
        self._adm_out = (torch.empty((2,), dtype=torch.float64,
                                     pin_memory=True), torch.cuda.Event())
        warm = _Request(GenStream(0), np.zeros((0,), np.int64), 0, 0.0, 0,
                        None, 0)
        self._admission_inputs((), warm, slot=0, length=1)
        self._adm_graphs = self._capture(
            {key: self._admission_fn(key) for key in self._admission_keys()},
            "admission dispatch {}")
        self.cache.lengths.zero_()
        torch.cuda.synchronize(self.device)
        self.admission_graph_bytes = (torch.cuda.memory_reserved(self.device)
                                      - reserved)

    def _run_block(self, draw: bool):
        """Run one decode block: (its [K, 3, B] results on the host, the
        event the reap waits on). On the card: one graph replay, then a
        ``non_blocking`` copy of the graph's output (the next replay
        overwrites it) into a pinned buffer the handle owns, and an
        event. On the CPU: the block, eagerly."""
        if self.device.type != "cuda":
            with torch.no_grad():
                return self._block(draw), None
        graph, out, deltas = self._graphs[draw]
        graph.replay()
        _add_counts(deltas)
        self.graph_replays += 1
        if self._out_free:
            host, done = self._out_free.pop()
        else:
            host = torch.empty(tuple(out.shape), dtype=out.dtype,
                               pin_memory=True)
            done = torch.cuda.Event()
        host.copy_(out, non_blocking=True)
        done.record()
        return host, done

    def _tick(self, decode_only: bool = False) -> _Inflight | None:
        """Dispatch one serving tick: a verify pass when every active
        slot is greedy and clear of capacity and at least half of them
        draft (a slot without a draft emits one token a pass where a
        decode block gives it K), else a decode block. ``decode_only``:
        a top-up behind an unreaped block, where verify windows cannot
        be built (they need the host-delivered history). Returns the
        in-flight handle, or None."""
        if not decode_only and self._spec_k and self._spec_eligible():
            drafts = {idx: self._draft(idx)
                      for idx in range(self.n_slots) if self._active[idx]}
            drafted = sum(d is not None for d in drafts.values())
            if drafted > 0 and 2 * drafted >= len(drafts):
                return self._verify_tick(drafts)
        return self._decode_tick()

    def _decode_tick(self) -> _Inflight | None:
        """Dispatch one fused decode block. A slot that finishes (EOS,
        budget, capacity) at step k deactivates on the device, in the
        carry, so a block dispatched before this one's tokens reached
        the host freezes it instead of emitting junk."""
        if not self._active.any():
            return None
        if self._paged:
            self._ensure_blocks()  # may retire starving slots
            if not self._active.any():
                return None
        t_dispatch = time.monotonic()
        self._note_dispatch(t_dispatch)
        self._dispatch_pack()
        # Gumbel noise only when some slot samples (host-known, no sync)
        out, done = self._run_block(bool((self._temps > 0).any()))
        self.decode_steps += self.decode_block
        if self._paged:
            # cursors advance by K, bounded by each slot's device stop
            # cursor (the block freezes a slot there), so the host view
            # does not run past it while unreaped blocks pile up; EOS
            # stops land wherever they land (bounded by one reap)
            adv = np.minimum(self.decode_block,
                             np.maximum(self._stop_cursors - self._cursors, 0))
            adv = np.where(self._stop_cursors > 0, adv, self.decode_block)
            self._cursors[self._active] += adv[self._active]
        if self._host_wins.any():
            self._host_wins[:] = False
            self._touch()
        # dispatch-time snapshots: admissions while the block runs mutate
        # _active and slot.request, and this block's tokens belong to the
        # slots as dispatched
        snap_active = self._active.copy()
        snap_reqs = [s.request for s in self._slots]
        return _Inflight(done, functools.partial(
            self._decode_reap, out, done, snap_active, snap_reqs,
            t_dispatch))

    def _decode_reap(self, out, done, snap_active, snap_reqs,
                     t_dispatch: float, overlapped: bool) -> None:
        """Wait for the block's results and deliver its [K, B] tokens in
        step order; the emitted mask replays the device stop masks, so
        a slot that deactivated on the device gets no more tokens.
        Records the block's share of the step time: reap to reap while
        a block stayed queued behind the last reap, else dispatch to
        reap."""
        if done is not None:
            done.synchronize()
        now = time.monotonic()
        start = self._steady_from if self._steady_from is not None \
            else t_dispatch
        self._block_s.append(now - start)
        self._steady_from = now if overlapped else None
        res = out.numpy()
        toks_l = res[:, 0].astype(np.int64).tolist()
        lps_l = res[:, 1].tolist()
        emit_l = res[:, 2].tolist()
        if done is not None:
            self._out_free.append((out, done))
        for k in range(len(toks_l)):
            trow, lrow, erow = toks_l[k], lps_l[k], emit_l[k]
            for idx, slot in enumerate(self._slots):
                if not snap_active[idx] or not self._active[idx] \
                        or slot.request is not snap_reqs[idx] \
                        or not erow[idx]:
                    continue
                self._last_tokens[idx] = trow[idx]
                if self._spec_k:
                    self._hist_append(idx, trow[idx])
                self._deliver(idx, slot, trow[idx], lrow[idx])

    def _deliver(self, idx: int, slot: _Slot, token: int,
                 lp: float | None = None) -> None:
        """Push one token to the consumer; retire the slot when done."""
        req = slot.request
        if req.stream.cancelled.is_set():
            self._retire(idx, slot)
            return
        if slot.generated == 0:
            req.stream.trace["first_put"] = time.monotonic()
        req.stream._push((token, lp) if req.logprobs else token)
        slot.generated += 1
        slot.remaining -= 1
        self.total_tokens += 1
        at_eos = req.eos_id is not None and (
            token in req.eos_id if isinstance(req.eos_id, frozenset)
            else token == req.eos_id)
        # cursor positions used so far: prompt_len + generated
        at_capacity = req.stream.prompt_len + slot.generated >= self.max_seq - 1
        if at_eos or slot.remaining <= 0 or at_capacity:
            self._retire(idx, slot)

    def _retire(self, idx: int, slot: _Slot) -> None:
        if self._paged:
            # freed blocks may be handed out at once; the retired slot's
            # frozen-cursor writes go to the trash block because its
            # table row zeroes before the next dispatch. Freed before
            # the stream ends, so a consumer that sees the end sees its
            # blocks back in the pool.
            if self._slot_blocks[idx]:
                self._alloc.free(self._slot_blocks[idx])
                self._slot_blocks[idx] = []
            self._table[idx, :] = 0
            self._cursors[idx] = 0
            self._stop_cursors[idx] = 0
        slot.request.stream._push(None)
        slot.request = None
        self._active[idx] = False
        self._temps[idx] = 0.0
        self._top_ks[idx] = 0
        self._budgets[idx] = 0
        self._slot_seed[idx] = 0
        self._pos_abs[idx] = 0
        self._eos_mat[idx, :] = llama.EOS_PAD
        # the host wins the next dispatch's merge for this slot: a
        # host-only retirement (cancel, paged starvation, a stop id past
        # EOS_MAX) deactivates a slot the device carry may still run
        self._host_wins[idx] = True
        self._touch()

    # -- paged-mode host side ------------------------------------------------
    def _write_table_row(self, idx: int) -> None:
        """Clamped table row: entries past the slot's live blocks repeat
        the last one; an empty slot stays on the trash block."""
        blocks = self._slot_blocks[idx]
        self._touch()
        if not blocks:
            self._table[idx, :] = 0
            return
        n = min(len(blocks), self._mb)
        self._table[idx, :n] = blocks[:n]
        self._table[idx, n:] = blocks[n - 1]

    def _ensure_blocks(self, horizon: int | None = None) -> None:
        """Before each dispatch: every active slot owns blocks covering
        its next ``horizon`` positions (default: one decode block,
        bounded by its stop cursor; a verify pass passes its window
        width, unbounded: its rows past acceptance are the clamped
        table's contract). A slot the pool cannot grow is retired at
        once (its stream ends as if at capacity), freeing its blocks for
        the rest; the eviction is logged and counted."""
        K = horizon or self.decode_block
        T = self._block_t
        for idx, slot in enumerate(self._slots):
            if not self._active[idx]:
                continue
            cur = int(self._cursors[idx])
            hi = cur + K  # the highest write is at position hi - 1
            stop = int(self._stop_cursors[idx])
            if horizon is None and stop > 0:
                hi = min(hi, stop)
                if hi <= cur:
                    continue  # stopped on the device; retires at delivery
            need = min((hi - 1) // T + 1, self._mb)
            if len(self._slot_blocks[idx]) >= need:
                continue
            starved = False
            while len(self._slot_blocks[idx]) < need:
                got = self._alloc.alloc(1)
                if got is None:
                    starved = True
                    break
                self._slot_blocks[idx].extend(got)
            if starved:
                self._paged_evictions += 1
                if self.logger is not None:
                    self.logger.warn({
                        "event": "paged pool exhausted: stream truncated",
                        "slot": idx, "generated": slot.generated,
                        "free_blocks": self._alloc.free_blocks})
                self._retire(idx, slot)
                continue
            self._write_table_row(idx)

    def _check_kernels(self, kv_dtype, paged: bool, block_size: int) -> None:
        """Refuse, before anything is allocated or started, a model the
        attention kernels of this engine's path do not take on the
        card: flash_prefill at every admission, flash_decode or
        paged_decode at every decode step, the paged window at every
        verify pass of a paged spec engine."""
        cfg = self.cfg
        path = [("flash_prefill", {}),
                ("paged_decode", {"block_size": block_size}) if paged
                else ("flash_decode", {})]
        if paged and self._spec_k:
            path.append(("paged_window", {"block_size": block_size,
                                          "window": self._spec_k + 1}))
        shape = (f"model {cfg.name!r} (head_dim {cfg.head_dim}, "
                 f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, "
                 f"{cfg.dtype})")
        if kv_dtype not in (None, torch.int8, torch.bfloat16):
            raise ValueError(f"{shape}: the decode kernels take an int8 or "
                             f"bf16 KV cache, not {kv_dtype}")
        for kernel, extra in path:
            try:
                kernels.check_attention_shape(
                    kernel, head_dim=cfg.head_dim, n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads, dtype=cfg.tdtype, **extra)
            except (TypeError, ValueError) as e:
                raise ValueError(f"{shape} cannot be served on "
                                 f"{self.device}: {e}") from None

    # -- speculative decoding ------------------------------------------------
    def _hist_set(self, idx: int, tokens) -> None:
        n = min(len(tokens), self._hist_buf.shape[1])
        self._hist_buf[idx, :n] = tokens[:n]
        self._hist_n[idx] = n

    def _hist_append(self, idx: int, token: int) -> None:
        n = self._hist_n[idx]
        if n < self._hist_buf.shape[1]:
            self._hist_buf[idx, n] = token
            self._hist_n[idx] = n + 1

    def _draft(self, idx: int) -> list[int] | None:
        """Prompt-lookup draft: the k tokens that followed the most
        recent earlier occurrence of the history's trailing 2-gram
        (zero-padded), or None when there is none."""
        n = int(self._hist_n[idx])
        K = self._spec_k
        if n < 3:
            return None
        h = self._hist_buf[idx, :n]
        a, b = h[-2], h[-1]
        hits = np.flatnonzero((h[:-2] == a) & (h[1:-1] == b))
        if len(hits) == 0:
            return None
        j = int(hits[-1])
        cont = h[j + 2:j + 2 + K]
        if cont.size == 0:
            return None
        return cont.tolist() + [0] * (K - cont.size)

    def _spec_eligible(self) -> bool:
        W = self._spec_k + 1
        saw_active = False
        for idx, slot in enumerate(self._slots):
            if not self._active[idx]:
                continue
            req = slot.request
            if req is None or req.temperature > 0:
                return False  # sampling slots need the decode sampler
            if req.stream.prompt_len + slot.generated + W > self.max_seq:
                return False  # its window would write past capacity
            saw_active = True
        return saw_active

    def _verify(self, window: torch.Tensor, active: torch.Tensor,
                table: torch.Tensor | None):
        """One verify pass (models.llama.verify_step, or paged_llama.
        paged_verify_step through ``table``), then the epilogue; the
        cursors advance by emit, in place (a captured decode graph reads
        the cache's own cursor tensor). Returns (greedy, logprobs,
        emit)."""
        if self._paged:
            logits, _ = paged_llama.paged_verify_step(
                self.params, self.cfg, window, self.cache, table,
                self.rope_tables)
        else:
            logits, _ = llama.verify_step(self.params, self.cfg, window,
                                          self.cache, self.rope_tables)
        toks, lps, _, emit = verify_epilogue(logits, window, active)
        self.cache.lengths.add_(emit.to(torch.int32))
        return toks, lps, emit

    def _warm_verify(self) -> None:
        """One verify pass with no slot active before serving, so the
        first real one builds and loads nothing under the device lock:
        it emits nothing and leaves every cursor where it was; its rows
        land past the cursors (paged: in the trash block, through an
        all-zero table)."""
        W = self._spec_k + 1
        zeros = torch.zeros((self.n_slots, W), dtype=torch.long,
                            device=self.device)
        table = (torch.zeros((self.n_slots, self._mb), dtype=torch.int32,
                             device=self.device) if self._paged else None)
        with torch.no_grad():
            self._verify(zeros, zeros[:, 0].bool(), table)

    def _verify_tick(self, drafts: dict) -> _Inflight | None:
        """One verify pass over window = [last token, k drafts] per slot
        (zero drafts for a slot without a match: it still emits its one
        guaranteed token), run at once (spec engines run at depth 1);
        the reap delivers each slot's emitted tokens in order, and a
        retirement mid-window discards the rest."""
        W = self._spec_k + 1
        window = np.zeros((self.n_slots, W), np.int64)
        window[:, 0] = self._last_tokens
        for idx, d in drafts.items():
            if d is not None:
                window[idx, 1:] = d
        if self._paged:
            self._ensure_blocks(W)  # a window writes up to W positions
            if not self._active.any():
                return None
        t0 = time.monotonic()
        with torch.no_grad():
            table = (torch.from_numpy(self._table.copy()).to(self.device)
                     if self._paged else None)
            toks, lps, emit = self._verify(
                torch.from_numpy(window).to(self.device),
                torch.from_numpy(self._active.copy()).to(self.device), table)
            out = torch.cat([toks.double(), lps.double(),
                             emit.double()[:, None]], dim=1).cpu().numpy()
        self._verify_s.append(time.monotonic() - t0)
        self.verify_passes += 1
        snap_active = self._active.copy()
        snap_reqs = [s.request for s in self._slots]
        return _Inflight(None, functools.partial(
            self._verify_reap, out, snap_active, snap_reqs))

    def _verify_reap(self, out: np.ndarray, snap_active, snap_reqs,
                     overlapped: bool) -> None:
        W = self._spec_k + 1
        toks_np, lps_np = out[:, :W], out[:, W:2 * W]
        emit_np = out[:, 2 * W].astype(np.int64)
        self._spec_windows += int(snap_active.sum())
        self._spec_emitted += int(emit_np.sum())
        if self._paged:
            # device cursors advanced by emit (0 for inactive slots)
            self._cursors += emit_np
        for idx, slot in enumerate(self._slots):
            if not snap_active[idx] or slot.request is not snap_reqs[idx]:
                continue
            for k in range(emit_np[idx]):
                if not self._active[idx]:
                    break  # retired mid-window (EOS, budget, cancel)
                tok = int(toks_np[idx, k])
                self._last_tokens[idx] = tok
                self._hist_append(idx, tok)
                self._deliver(idx, slot, tok, float(lps_np[idx, k]))
        # the pass advanced host state outside the decode carry: the
        # host wins the next decode dispatch's merge for these slots,
        # with its mirrors of the device stop state synced to what the
        # deliveries left
        for idx in np.flatnonzero(snap_active):
            s = self._slots[idx]
            live = s.request is not None
            self._budgets[idx] = s.remaining if live else 0
            self._pos_abs[idx] = s.generated if live else 0
            if self._paged:
                self._stop_cursors[idx] = (
                    min(int(self._cursors[idx]) + s.remaining,
                        self.max_seq - 2) if live else 0)
        self._host_wins |= snap_active
        self._touch()
