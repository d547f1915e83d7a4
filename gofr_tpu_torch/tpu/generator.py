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
    spec-less engine's, token for token. On the card the pass is one
    replay of a CUDA graph captured at construction (``verify_pass``,
    the port of ``_verify_jit``), in flight like a decode block.
  - With ``prefix_cache_slots`` on a paged engine, zero-copy prefix
    sharing (models.paged_llama.SharedPrefixIndex): an admitted prompt
    of at least ``prefix_store_min`` tokens leaves an entry that holds a
    reference on its full blocks; a later prompt with a common prefix
    takes those blocks into its slot, gathers them into the scratch row
    (one replay of the read-back graph) and runs the lattice from the
    match point, writing back only its fresh blocks. Entries evict
    (least recently used first) before a live stream is truncated.
  - ``generate(continue_from=(prompt, emitted))`` resumes an
    interrupted stream: prompt + emitted prefill as one prompt (a hit on
    the prompt's own stored blocks once prefix sharing is on), the
    budget counts from the original request, and sampling resumes at
    absolute position ``len(emitted)``, so greedy and seeded streams
    splice token for token.
  - Requests carry a deadline and an SLO class (resilience): the
    pending line picks latency-class requests first, with every Nth
    pick going to the throughput line while both wait, and keeps the
    last ``slo_latency_slots`` free slots from throughput; an optional
    admission gate sheds with TooManyRequests and caps the token budget
    in its brownout band; a deadline that runs out fails the stream with
    DeadlineExceeded before queueing, in the queue, between lattice
    chunks or at a reap, and its device work stops there. ``drain``
    refuses new requests and serves the accepted ones (the App's
    graceful stop).
  - With ``lora_adapters`` = n, multi-LoRA serving: n adapter slots of
    rank-``lora_rank`` deltas on the attention projections, stacked in
    ``params["layers"]`` (models.llama.init_lora, adapter 0 the base
    model); ``generate(adapter=i)`` picks a request's adapter and every
    dispatch gathers each row's (the decode block from the pack's column
    5, an admission from its inputs, a verify pass from its own column),
    so one weight stream serves every tenant. ``load_adapter`` copies an
    adapter's weights into its slot of the stacks IN PLACE, so every
    captured graph reads them from its next replay on, and drops the
    adapter's stored prefixes from every tier.
  - With a tenancy plane (``install_tenancy``; tenancy.TenantPlane, the
    ``TPU_TENANTS`` rows), ``generate`` resolves the ambient tenant:
    its class default and adapter apply, its quota is admitted before
    the gate, each class line serves tenants deficit-round-robin by
    weight (tenancy.WeightedFairLine), the T0 rows are charged to the
    tenant that stored them under its cache share, and every stream
    gives its tenant's concurrency slot back at its terminal.
  - Disaggregated serving (pd/): ``generate(kv_sink=)`` runs a request
    prefill-only on a contiguous engine, shipping its slot row through
    the sink as it is prefilled (after each mid chunk up to the final
    window's start, the rest before the first token) and retiring it
    after token 0; ``generate(ingest=)`` is the decode worker's half,
    which copies shipped rows into the slot's cache row (paged: the
    scratch row, then one write-back replay) in place of a prefill and
    decodes on from the shipped first token.
  - On a CUDA device the engine refuses at construction a model the
    attention kernels do not take (ops.kernels.check_attention_shape),
    naming its shape and the kernel, so nothing raises in the loop for
    that reason.

Consumers call ``generate()`` from any thread and read tokens off a
stream; one background thread, ``gofr-torch-gen``, owns the device loop.
A failed step fails the live streams, clears the prefix index, resets
the device state in place (the captured graphs stay bound to it) and
keeps serving the queue, as the JAX engine does; only a device that no
longer synchronises takes the engine down (``down`` names the error).
The seams of ``chaos`` inject such failures.

With ``mesh`` = ``MeshPlan(tp=N)`` (``TPU_SHARDING=tp=N``) the engine is
rank 0 of N tensor-parallel ranks (parallel/): every device dispatch
(``_dispatch``: an admission, a decode block, a verify pass, the
recovery's reset, a ``score`` batch) first broadcasts one command with
the host inputs it uploads, then rank 0 runs its share; the workers'
follower engines (``follow``) run the same op on their head shards, and
the model sums the partials over the device group. Every rank samples
the same tokens from the same summed logits. A TP engine dispatches
eagerly, without CUDA graphs, and a lost rank fails the live streams
and takes it down.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import gc
import itertools
import queue
import threading
import time
import weakref
from collections import deque

import numpy as np
import torch

from .. import chaos, tracing
from ..device import resolve_device
from ..errors import DeadlineExceeded
from ..models import llama, paged_llama
from ..models.common import ModelConfig
from ..ops import flash, flash_decode, kernels, paged_attention
from ..parallel.distributed import DEFAULT_TIMEOUT_S, TPRanks
from ..parallel.mesh import MeshPlan
from ..parallel.sharding import (check_tp, kv_head_shards, rank_config,
                                 shard_params)
from ..resilience import (SLO_LATENCY, SLO_THROUGHPUT, DecodePipelinePolicy,
                          current_deadline, current_slo_class)
from ..tenancy.fair import WeightedFairLine
from ..tenancy.registry import current_tenant
from ..wire import PushStream
from . import hbm, prng
from .checkpoint import WeightSource, rank_params, to_tensor
from .kvcache import (CacheManager, HostKV, KVCacheOptions, KVLayout,
                      clamp_restore_len, dense_hostkv, dtype_name,
                      model_fingerprint)

_REQ_IDS = itertools.count(1)

# the engines whose serving loop runs, stopped at interpreter exit
_LOOPS: "weakref.WeakSet[GenerationEngine]" = weakref.WeakSet()


@atexit.register
def _stop_loops_at_exit() -> None:
    """A process may exit with an engine open (a CLI App's does). Its
    loop is a daemon thread, and one that finalization stops inside a
    CUDA call that released the interpreter lock unwinds through C++
    frames that may not unwind ("terminate called without an active
    exception"): stop every loop and join it first."""
    for eng in list(_LOOPS):
        eng._stop_loop()


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
# (float32 bits), 4 top_k, 5 adapter (LoRA id), 6 host_wins,
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


def _cache_nbytes(cfg: ModelConfig, rows: int, positions: int,
                  dtype: torch.dtype | None, lengths: int) -> int:
    """Bytes of a KV cache of ``rows`` x ``positions`` (a contiguous
    cache's slots x max_seq, or a paged pool's blocks x block size) with
    ``lengths`` int32 cursors, from its shapes: what the arbiter leases
    before the cache is allocated."""
    dtype = dtype or cfg.tdtype
    vectors = cfg.n_layers * rows * positions * cfg.n_kv_heads
    n = 2 * vectors * cfg.head_dim * dtype.itemsize + 4 * lengths
    if dtype == torch.int8:
        n += 2 * vectors * 4   # the float32 scale planes
    return n


class _ClassPending:
    """The SLO-class-aware admission line (the JAX engine's
    ``_ClassPending``): latency-class requests are picked first; a
    weighted anti-starvation streak hands every Nth pick to the
    throughput line while it has waiters, so saturating interactive
    traffic never starves batch streams out of the slots.

    Any thread puts (``generate``); only the serving loop pops, which is
    what makes pop-then-``put_front`` exact. Each class line is a
    ``WeightedFairLine``: inside a class, tenants are served
    deficit-round-robin over their registry weight (2:1:1 pops A, A, B,
    C under saturation). Requests without a tenant all ride the default
    line, which makes each class the plain FIFO it was; the class split
    and the streak are unchanged."""

    def __init__(self, throughput_share: float = 0.25):
        share = min(max(float(throughput_share), 0.0), 1.0)
        # share -> latency picks per throughput pick, floored so the
        # contended throughput fraction 1/(weight + 1) is at least the
        # share; None: throughput drains only when no latency request
        # waits
        self._weight = int((1.0 - share) / share) if share > 0 else None
        self._lat = WeightedFairLine()
        self._thr = WeightedFairLine()
        self._lock = threading.Lock()
        self._lat_streak = 0
        self._prev_streak = 0   # the streak before the latest pop

    def _line(self, req) -> WeightedFairLine:
        return self._thr if req.slo_class == SLO_THROUGHPUT else self._lat

    def put(self, req) -> None:
        with self._lock:
            self._line(req).append(req)

    def put_front(self, req) -> None:
        """Undo the latest pop (the in-flight pass deferring a lattice
        admission): the request goes back to the head of its line and
        the streak to its value before the pop, so a throughput turn
        deferred is not a turn spent."""
        with self._lock:
            self._line(req).appendleft(req)
            self._lat_streak = self._prev_streak

    def get_nowait(self, allow_throughput: bool = True):
        """Pop the next admissible request (queue.Empty when there is
        none). ``allow_throughput=False``: the caller fills one of the
        slots reserved for latency, which only the latency line may
        serve."""
        with self._lock:
            use_thr = allow_throughput and bool(self._thr) and (
                not self._lat
                or (self._weight is not None
                    and self._lat_streak >= self._weight))
            line = self._thr if use_thr else self._lat
            if not line:
                raise queue.Empty
            self._prev_streak = self._lat_streak
            self._lat_streak = 0 if use_thr else self._lat_streak + 1
            return line.popleft()

    def qsize(self) -> int:
        return len(self._lat) + len(self._thr)

    def qsize_class(self, slo_class: str) -> int:
        return len(self._thr if slo_class == SLO_THROUGHPUT else self._lat)

    def qsize_by_tenant(self) -> dict[str, int]:
        """Queued requests per tenant across both class lines (the
        per-tenant queue gauge), read under the put lock."""
        with self._lock:
            out = dict(self._lat.by_tenant())
            for tid, n in self._thr.by_tenant().items():
                out[tid] = out.get(tid, 0) + n
            return out

    def empty(self) -> bool:
        return not (self._lat or self._thr)


# the constructor arguments a worker rank's follower engine is built with
_TP_KWARGS = ("slots", "max_seq", "seed", "kv_dtype", "decode_block",
              "prompt_buckets", "prefill_chunk", "spec_decode_k",
              "paged_blocks", "paged_block_size")


class _RankLeases:
    """The owner of a worker rank's lease rows in rank 0's arbiter."""

    def __init__(self, rank: int):
        self.rank = rank


def _host_tree(tree):
    """A rank's weight tree with numpy leaves (bfloat16 as 2-byte
    voids, which ``checkpoint.to_tensor`` reads back), to pickle."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_host_tree(v) for v in tree))
    t = tree.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


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


@contextlib.contextmanager
def no_collection():
    """Collect Python's garbage now, then keep the collector off until
    the block ends. A CUDA graph destroyed while another is being
    captured invalidates that capture, and a graph left in a reference
    cycle (an engine closed earlier, a traceback's frame) is destroyed
    whenever the collector happens to run."""
    gc.collect()
    was_on = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_on:
            gc.enable()


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
    N+1, cannot know how many tokens block N emitted. Each slot's LoRA
    adapter is the pack's column 5 (read only when the params carry
    adapter stacks).

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
    adapter = pack[:, 5]
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
                                                 table, rope_tables, adapter)
    else:
        def step(toks):
            return llama.decode_step(params, cfg, toks, work, rope_tables,
                                     flash=True, adapter=adapter)
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


def verify_pass(params: dict, cfg: ModelConfig, cache, window: torch.Tensor,
                active: torch.Tensor, table, rope_tables,
                adapter=None) -> torch.Tensor:
    """One speculative verify pass (the JAX engine's ``_verify_fn``, or
    ``_paged_verify_fn`` for a ``paged_llama.PagedKVCache`` through
    ``table`` [B, MB] int32, then ``_verify_epilogue``): ``window``
    [B, W] is each slot's last token then its drafts, ``active`` [B]
    bool the slots that verify, ``adapter`` [B] each slot's LoRA adapter
    (None without stacks). The cursors advance by emit IN PLACE
    (a captured graph reads the cache's own cursor tensor). Returns
    [B, 2W + 1] float64: the greedy tokens, their logprobs, emit.
    Tensors in, tensors out, no host read: the engine captures it into
    one CUDA graph on the card, and the CPU runs it eagerly."""
    if isinstance(cache, paged_llama.PagedKVCache):
        logits, _ = paged_llama.paged_verify_step(params, cfg, window, cache,
                                                  table, rope_tables, adapter)
    else:
        logits, _ = llama.verify_step(params, cfg, window, cache,
                                      rope_tables, adapter)
    toks, lps, _, emit = verify_epilogue(logits, window, active)
    cache.lengths.add_(emit.to(torch.int32))
    return torch.cat([toks.double(), lps.double(), emit.double()[:, None]],
                     dim=1)


def check_kernel_shapes(cfg: ModelConfig, device, kv_dtype, paged: bool,
                        block_size: int, spec_k: int) -> None:
    """Refuse, before anything is allocated or started, a model the
    attention kernels of an engine's path do not take on the card:
    flash_prefill at every admission, flash_decode or paged_decode at
    every decode step, the paged window at every verify pass of a paged
    spec engine. A TP rank checks its own head counts."""
    path = [("flash_prefill", {}),
            ("paged_decode", {"block_size": block_size}) if paged
            else ("flash_decode", {})]
    if paged and spec_k:
        path.append(("paged_window", {"block_size": block_size,
                                      "window": spec_k + 1}))
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
                             f"{device}: {e}") from None


class _Staged:
    """Uploads into one int64 device tensor that a captured graph reads
    (the dispatch pack, the admission inputs, the verify inputs): fill
    ``host()``, then ``upload()``. On the card through two pinned
    staging buffers, copied ``non_blocking`` behind whatever the stream
    holds (a copy from pageable memory would synchronise the stream and
    the host would wait for the blocks in flight), a buffer written
    again only once the copy that read it has completed (its event); on
    the CPU a plain copy. ``uploads`` counts them. ``record``: keep a
    copy of the latest upload's image for ``take`` (rank 0 of a TP
    group sends it with its next command)."""

    def __init__(self, dst: torch.Tensor, record: bool = False):
        self.dst = dst
        self.uploads = 0
        self._bufs = None
        self._image = None
        self._record = record
        self._sent: np.ndarray | None = None
        if dst.device.type == "cuda":
            self._bufs = [(torch.zeros(tuple(dst.shape), dtype=torch.long,
                                       pin_memory=True), torch.cuda.Event())
                          for _ in range(2)]

    def host(self) -> np.ndarray:
        """The host image of the next upload (holding stale values)."""
        if self._bufs is None:
            self._image = np.empty(tuple(self.dst.shape), np.int64)
            return self._image
        staged, copied = self._bufs[self.uploads % 2]
        copied.synchronize()
        return staged.numpy()

    def upload(self) -> None:
        if self._bufs is None:
            image = self._image
            self.dst.copy_(torch.from_numpy(image))
        else:
            staged, copied = self._bufs[self.uploads % 2]
            image = staged.numpy()
            self.dst.copy_(staged, non_blocking=True)
            copied.record()
        if self._record:
            self._sent = image.copy()
        self.uploads += 1

    def take(self) -> np.ndarray | None:
        """The image uploaded since the last ``take`` (None if none)."""
        sent, self._sent = self._sent, None
        return sent


class AdmissionInputs:
    """The admission dispatches' device inputs: views of one int64
    vector the host fills before each dispatch (one upload; the
    captured admission graphs read these very tensors, so nothing of a
    request is baked into a graph). Layout: the prompt's length (the
    cursor the admission leaves), the slot (the batch row written), a
    chunk's start, the position the first token is sampled at, the
    request's temperature (float32 bits), top-k and seed, the absolute
    stream position of its first token (``pos_base``: 0, or the emitted
    count of a continuation), its LoRA adapter, then ``n_blocks`` pool
    block ids (paged), then ``width`` token ids, zero-padded."""

    (LENGTH, SLOT, START, LOGIT_POS, TEMP, TOP_K, SEED, POS_BASE,
     ADAPTER) = range(9)
    HEAD = 9

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

    @property
    def pos_base(self) -> torch.Tensor:
        return self._at(self.POS_BASE)

    @property
    def adapter(self) -> torch.Tensor:
        return self._at(self.ADAPTER)

    def blocks(self, n: int) -> torch.Tensor:
        return self.buf[self.HEAD:self.HEAD + n]

    def tokens(self, width: int) -> torch.Tensor:
        lo = self.HEAD + self.n_blocks
        return self.buf[lo:lo + width][None]

    def pack(self, host: np.ndarray, tokens, *, length: int, slot: int,
             start: int, logit_pos: int, temp: float, top_k: int, seed: int,
             blocks, pos_base: int = 0, adapter: int = 0) -> None:
        """Fill ``host`` (this vector's host image) for one dispatch."""
        host[:] = 0
        host[self.LENGTH] = length
        host[self.SLOT] = slot
        host[self.START] = start
        host[self.LOGIT_POS] = logit_pos
        host[self.TEMP] = np.float32(temp).view(np.int32)
        host[self.TOP_K] = top_k
        host[self.SEED] = seed
        host[self.POS_BASE] = pos_base
        host[self.ADAPTER] = adapter
        host[self.HEAD:self.HEAD + len(blocks)] = blocks
        lo = self.HEAD + self.n_blocks
        host[lo:lo + len(tokens)] = tokens


def _first_token(logits: torch.Tensor, inp: AdmissionInputs,
                 draw: bool) -> torch.Tensor:
    """The first token and its logprob, [2] float64, sampled from
    logits [1, V] under the request's key at its absolute stream
    position ``pos_base`` (the JAX engine's ``fold_in(PRNGKey(seed),
    pos_base)``: 0 for a fresh request), read on the device."""
    tok, lp = sample(logits, inp.temp, inp.seed, inp.pos_base, inp.top_k,
                     draw)
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
    sample the first token at the prompt's last position, the prompt
    through its LoRA adapter (``inp.adapter``). Tensors in, [2]
    float64 (token, logprob) out, no host read: the engine captures one
    graph per (bucket, draw) on the card."""
    length = inp.length
    logits, k, v, _ = llama.prefill_kv(
        params, cfg, inp.tokens(bucket), length, rope_tables=rope_tables,
        flash=True, logit_pos=inp.logit_pos, adapter=inp.adapter)
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
    chunk ([2] float64). The chunk runs through the request's LoRA
    adapter (``inp.adapter``)."""
    logits, _ = llama.prefill_chunk(
        params, cfg, inp.tokens(width), cache, inp.start, inp.slot,
        rope_tables=rope_tables, compute_logits=final,
        logit_pos=inp.logit_pos if final else None, adapter=inp.adapter)
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


def readback_admission(cache: paged_llama.PagedKVCache,
                       row: llama.KVCache, inp: AdmissionInputs) -> None:
    """A paged prefix hit's first dispatch (the JAX engine's
    ``_blocks_to_row_jit``): the shared blocks (``inp.blocks``, one id
    per MB block, those past the hit's own the trash block) gathered
    into the scratch row, so its positions [0, m) hold the stored
    prefix's KV and the lattice resumes at m."""
    T = cache.block_size
    paged_llama.read_blocks_to_row(row, cache,
                                   inp.blocks(-(-row.k.shape[2] // T)))


class GenStream(PushStream):
    """Iterator over generated token ids; ``cancel()`` releases the slot.
    ``trace`` holds time.monotonic() stamps: "submit", "admit",
    "prefill_done" and "first_put" (the first token's delivery);
    ``chunks`` counts the mid chunks of its prefill (0 for a bucket
    admission). What the App's ``/generate`` route reads:
    ``prompt_len`` (a continuation's prompt + emitted), ``cache_tokens``
    and ``cache_tier`` (the prompt positions a prefix hit covered, and
    "paged", or "pd-ship" for KV a prefill worker shipped), ``seed`` (a
    sampled request's, for a resume), ``cursor_base`` (the absolute index
    of its first token: a continuation's emitted count, 0 for a fresh
    request) and ``failed`` (why the loop failed it). ``slo_class``: the
    request's class; ``where``: where its deadline ran out ("queue",
    "mid-prefill", "mid-decode", or "post-handoff" for an ingested
    request), if it did; ``tenant``: the canonical
    tenant id on an engine with a tenancy plane ("default" otherwise)
    and ``adapter`` the LoRA adapter it runs through. ``obs_entry``: its
    entry in the in-flight registry of the engine's ``Observe`` bundle
    (None without one)."""

    def __init__(self, request_id: int, logprobs: bool = False):
        super().__init__()
        self.request_id = request_id
        self.cancelled = threading.Event()
        self.prompt_len = 0
        self.logprobs = logprobs  # items are (token, logprob) tuples
        self.trace: dict[str, float] = {}
        self.seed: int | None = None
        self.cursor_base = 0
        self.chunks = 0
        self.cache_tier: str | None = None
        self.cache_tokens = 0
        self.failed: str | None = None
        self.slo_class = SLO_LATENCY
        self.where: str | None = None
        self.trace_id = ""
        self.traceparent: str | None = None
        self.tenant = "default"
        self.adapter = 0
        self.obs_entry = None
        # the stream holds one of its tenant's concurrency slots until
        # its terminal gives it back (_end_stream)
        self._tenant_held = False

    def tokens(self) -> list[int]:
        """Drain the whole stream (blocking) into a list of ids."""
        return [t[0] if isinstance(t, tuple) else t for t in self]

    def cancel(self) -> None:
        self.cancelled.set()


def _trace(stream: GenStream, traceparent: str | None) -> None:
    """The stream's trace, as the JAX engine sets it: the explicit
    ``traceparent``, else the submitting thread's span, else a fresh
    trace id without a parent."""
    ids = tracing.parse_traceparent(traceparent)
    if ids is not None:
        stream.traceparent, stream.trace_id = traceparent, ids[0]
        return
    span = tracing.current_span()
    if span is not None:
        stream.traceparent, stream.trace_id = span.traceparent(), \
            span.trace_id
    else:
        stream.trace_id = tracing._new_trace_id()


class _Request:
    __slots__ = ("stream", "prompt", "max_new", "temperature", "top_k",
                 "eos_id", "seed", "pos_base", "adapter", "lattice_peek",
                 "kv_match", "deadline", "slo_class", "enqueued_at",
                 "tenant", "tenant_weight", "kv_sink", "kv_shipped",
                 "ingest")

    def __init__(self, stream: GenStream, prompt: np.ndarray, max_new: int,
                 temperature: float, top_k: int, eos_id, seed: int,
                 pos_base: int = 0, deadline=None,
                 slo_class: str = SLO_LATENCY, adapter: int = 0):
        self.stream = stream
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        self.seed = seed
        # the absolute stream position of the first token (a
        # continuation's emitted count)
        self.pos_base = pos_base
        # the LoRA adapter the prompt and every token run through; also
        # part of every prefix key (KV flows through its wk/wv)
        self.adapter = adapter
        # (prefix index version, verdict): _needs_lattice's memo
        self.lattice_peek: tuple[int, bool] | None = None
        # (cache manager version, Match): _kv_match's memo, so the
        # in-flight peek and the admission see one tier verdict
        self.kv_match = None
        # resilience.Deadline: an expired request is dropped at
        # admission, between lattice chunks or at a reap
        self.deadline = deadline
        # the pending line it waits in and the gate's band it is held to
        self.slo_class = slo_class
        self.enqueued_at = time.monotonic()
        # the fair line's scheduling key and quantum (the registry's
        # weight); without a plane every request is the default tenant
        self.tenant = "default"
        self.tenant_weight = 1
        # disaggregated serving (pd/): ``kv_sink`` marks a prefill-only
        # request, whose slot row ships out through the sink as it is
        # prefilled (``kv_shipped`` positions so far) and which retires
        # after its first token; ``ingest`` is the decode side's
        # (HostKV, first token, logprob) a prefill worker shipped, which
        # admission installs in place of a prefill
        self.kv_sink = None
        self.kv_shipped = 0
        self.ingest = None

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
    __slots__ = ("request", "remaining", "generated", "last_token_t")

    def __init__(self):
        self.request: _Request | None = None
        self.remaining = 0
        self.generated = 0
        # when the slot's last token was delivered (inter-token latency)
        self.last_token_t = 0.0

    @property
    def free(self) -> bool:
        return self.request is None


class GenerationEngine:
    """The serving loop (see the module docstring).

    ``mesh`` (parallel.mesh.MeshPlan, the ``TPU_SHARDING`` row's plan):
    a plan with ``tp`` = N > 1 serves the model as N tensor-parallel
    ranks (parallel.distributed). This process is rank 0 and keeps the
    whole engine; ranks 1..N-1 are worker processes, each a follower
    engine (``tp_comm``) over its own head shard of the weights and
    caches: contiguous [L, B, Smax, KV/tp, hd], paged [L, N, T, KV/tp,
    hd] with the block table replicated. ``cfg`` is the whole model's
    and ``params`` either the whole model's weights (rank 0 slices
    every rank's shard and passes it) or a ``checkpoint.WeightSource``
    each rank builds its own shard from. ``tp_timeout_s``: every
    collective's limit. A TP engine dispatches
    its blocks, admissions and verify passes eagerly on every backend
    (no CUDA graphs: gloo collectives cannot be captured), and refuses
    LoRA, the prefix caches and the P/D halves (ROADMAP item 11b)."""

    def __init__(self, cfg: ModelConfig, params, *, mesh=None,
                 tp_comm=None, tp_timeout_s: float = DEFAULT_TIMEOUT_S, **kw):
        self._tp = None      # rank 0 of a TP group: its TPRanks
        self._comm = tp_comm  # every rank of a TP group: its TPComm
        self._tp_holders: list = []   # the worker ranks' lease owners
        self._score_ropes: dict = {}  # a worker's score rope tables
        self.mesh = None
        if mesh is not None and not isinstance(mesh, MeshPlan):
            raise ValueError(
                f"mesh={type(mesh).__name__}: not ported to gofr_tpu_torch;"
                " the port takes a parallel.mesh.MeshPlan (the "
                "TPU_SHARDING row's plan), not a device mesh")
        try:
            if mesh is not None and mesh.tp > 1:
                cfg, params = self._tp_launch(cfg, params, mesh, kw,
                                              tp_timeout_s)
            self._construct(cfg, params, **kw)
            if self._tp is not None:
                self._tp_ready()
        except BaseException:
            self._tp_close()
            raise
        if tp_comm is None:   # a follower runs no serving loop
            self._thread = threading.Thread(target=self._loop,
                                            name="gofr-torch-gen",
                                            daemon=True)
            self._thread.start()
            _LOOPS.add(self)

    def _construct(self, cfg: ModelConfig, params: dict, *, slots: int = 8,
                 max_seq: int | None = None, logger=None, seed: int = 0,
                 kv_dtype: torch.dtype | None = None, decode_block: int = 4,
                 decode_pipeline: int = 2, admit_window_ms: float = 2.0,
                 device="cuda",
                 prompt_buckets: tuple[int, ...] = DEFAULT_SEQ_BUCKETS,
                 prefill_chunk: int | None = None,
                 prefix_cache_slots: int = 0,
                 prefix_store_min: int | None = None,
                 spec_decode_k: int = 0, lora_adapters: int = 0,
                 lora_rank: int = 16,
                 paged_blocks: int = 0, paged_block_size: int = 128,
                 kvcache=None, gate=None,
                 slo_throughput_share: float = 0.25,
                 slo_latency_slots: int = 1, metrics=None, observe=None):
        if cfg.n_experts > 0:
            raise ValueError("the port serves dense Llama models; MoE is "
                             "not ported yet")
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        # the decode, admission and verify dispatches are CUDA graph
        # replays on the card; a TP rank dispatches them eagerly
        self._graphed = self.device.type == "cuda" and self._comm is None
        # a TP rank's leases name its device and rank (tpu.hbm)
        self._hbm_place = ({"device": str(self.device),
                            "rank": getattr(cfg, "rank", 0)}
                           if self._comm is not None else {})
        self._spec_k = max(0, int(spec_decode_k))
        if self.device.type == "cuda":
            check_kernel_shapes(cfg, self.device, kv_dtype, paged_blocks > 0,
                                int(paged_block_size), self._spec_k)
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
        self.metrics = metrics
        # resilience.AdmissionGate in front of the pending line (None:
        # admit everything): sheds with TooManyRequests under overload,
        # caps max_new_tokens in its brownout band, and is fed each
        # admission's queue wait at _start
        self.gate = gate
        self._seed = int(seed)
        self._auto_seed = itertools.count(1)
        # created before the first hbm.alloc: the reclaim callbacks this
        # engine registers take it, from whichever thread's lease ran
        # short (reentrant: the loop's own admission checkpoint may
        # trigger this engine's pool shrink)
        self._device_lock = threading.RLock()
        self._kv_dtype = kv_dtype
        if metrics is not None:
            # device-byte attribution gauges (app_tpu_device_bytes)
            hbm.set_metrics(metrics)
        # the flight recorder, in-flight registry, timeline and tracer
        # (observe.Observe; None: no recorder events, no stage spans).
        # The hot paths hold the timeline, or None when it is off
        # (TPU_TIMELINE=0), so the disabled cost is one attribute test.
        # A tensor-parallel worker rank is built without one: rank 0
        # records every dispatch of the group
        self._observe = observe
        tl = getattr(observe, "timeline", None)
        self._tl = tl if (tl is not None and tl.enabled) else None
        if self._tl is not None:
            # device-byte changes land as counter samples on the trace
            hbm.set_timeline(self._tl)
        # Multi-LoRA serving: n adapter slots of rank-r deltas on the
        # attention projections, stacked inside params["layers"] so the
        # layer loop slices them with the base weights; each request
        # picks its adapter and every dispatch gathers per row. Adapter
        # 0 is the base no-op (B zero); load_adapter fills the others
        self._n_adapters = max(0, int(lora_adapters))
        if self._n_adapters:
            if "lora_a_wq" not in params["layers"]:
                def build_lora():
                    gen = torch.Generator(device=self.device)
                    gen.manual_seed(self._seed + 1)
                    return llama.init_lora(cfg, self._n_adapters,
                                           int(lora_rank), gen)

                stacks = hbm.alloc(
                    "lora", build_lora, owner=self, tag="stacks",
                    nbytes=llama.lora_nbytes(cfg, self._n_adapters,
                                             int(lora_rank)),
                    priority=hbm.PRI_CACHE)
                self.params = {**params, "layers": {**params["layers"],
                                                    **stacks}}
            else:
                # a checkpoint brought its own stacks: their width is the
                # truth. A mismatch would clamp or fault the per-row
                # gather (one tenant served another's fine-tune) and
                # misplace load_adapter's copies
                n_stack = int(params["layers"]["lora_a_wq"].shape[1])
                if n_stack != self._n_adapters:
                    raise ValueError(
                        f"params carry {n_stack} LoRA adapter slots but "
                        f"lora_adapters={self._n_adapters}; they must "
                        "match (gather clamping would silently serve "
                        "the wrong tenant)")
                hbm.account("lora", {k: v for k, v
                                     in params["layers"].items()
                                     if k.startswith("lora_")},
                            owner=self, tag="stacks")
        self._slot_adapter = np.zeros((slots,), np.int64)
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
        # every persistent device buffer is leased from the memory
        # arbiter (tpu.hbm) before it is allocated, and accounted under
        # this engine. The serving cache is PRI_SERVING: never
        # auto-reclaimed, but a paged pool's lease carries the cold
        # shared-prefix release
        if self._paged:
            self.cache = hbm.alloc(
                "engine", lambda: paged_llama.init_paged_cache(
                    cfg, slots, paged_blocks, self._block_t, dtype=kv_dtype,
                    device=self.device),
                nbytes=_cache_nbytes(cfg, paged_blocks, self._block_t,
                                     kv_dtype, slots),
                owner=self, tag="cache", priority=hbm.PRI_SERVING,
                reclaim=self._hbm_paged_reclaim, **self._hbm_place)
        else:
            self.cache = hbm.alloc(
                "engine", lambda: llama.init_cache(
                    cfg, slots, self.max_seq, dtype=kv_dtype,
                    device=self.device),
                nbytes=_cache_nbytes(cfg, slots, self.max_seq, kv_dtype,
                                     slots),
                owner=self, tag="cache", priority=hbm.PRI_SERVING,
                **self._hbm_place)
        # zero-copy prefix sharing over the pool: entries hold references
        # on a stored prompt's full blocks; a hit takes them into the new
        # slot and the prefill resumes at the match point
        self._prefix_idx = None
        if self._paged and prefix_cache_slots > 0:
            self._prefix_idx = paged_llama.SharedPrefixIndex(
                prefix_cache_slots, self._alloc, self._block_t)
            self._store_min = int(prefix_store_min
                                  or self.prompt_buckets[-1])
        # The contiguous engine's hierarchical prefix cache (tpu/kvcache):
        # a P-row device pool (T0) indexed by a block-hash radix tree,
        # spilling LRU-evicted rows to host RAM (T1) and sharing int8
        # blocks through Redis (T2), behind one CacheManager. A hit
        # replaces the matched positions' prefill with a row copy (T0)
        # or a host -> device upload and a row copy (T1/T2, promoted
        # into a pool row first); the rest (at least one token, so the
        # first sample recomputes) runs the lattice from the match
        # point. The pool copies run eagerly on the serving stream,
        # outside every captured graph, so a shrink may reallocate it
        self._pool = None
        self._kvc = None
        self._stage = None   # pinned staging of a promotion's upload
        if not self._paged and prefix_cache_slots > 0:
            opts = kvcache or KVCacheOptions()
            self._pool = self._alloc_pool(prefix_cache_slots)
            layout = KVLayout(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
                              self._pool.quantized, self._pool.k.dtype,
                              self.max_seq)
            self._kvc = CacheManager(
                prefix_cache_slots, layout, block=opts.block,
                host_bytes=opts.host_mb << 20, redis=opts.redis,
                redis_ttl_s=opts.redis_ttl_s,
                epoch_refresh_s=opts.epoch_refresh_s,
                fingerprint=model_fingerprint(
                    cfg, params, extra=dtype_name(layout.dtype)),
                metrics=metrics, logger=logger)
            self._store_min = int(prefix_store_min
                                  or self.prompt_buckets[-1])
        if self._kvc is None and kvcache is not None \
                and kvcache.redis is not None:
            # KVCacheOptions hands the engine the client: an engine that
            # builds no cache manager (paged, or no prefix cache) closes
            # it rather than leak the socket
            if logger is not None:
                logger.warn({"event": "kvcache redis client discarded "
                             "(engine has no prefix cache: paged or "
                             "prefix_cache_slots=0)"})
            kvcache.redis.close()
        self.rope_tables = llama.get_rope_tables(cfg, self.max_seq,
                                                 self.device)
        # a prompt past the chunk budget runs the chunk lattice; a paged
        # engine runs it, and a prefix hit's resume, on a dense
        # single-slot scratch row (one slot's row of memory), landed in
        # the slot's blocks in one copy. A P/D ingest stages its shipped
        # row there too, so every paged engine has the row and its
        # write-back graph from construction: capturing one later, with
        # blocks in flight, is not safe
        self._lattice = self.max_seq - 1 > self._chunk
        if self._paged:
            self._scratch = hbm.alloc(
                "engine", lambda: llama.init_cache(
                    cfg, 1, self.max_seq, dtype=kv_dtype,
                    device=self.device),
                nbytes=_cache_nbytes(cfg, 1, self.max_seq, kv_dtype, 1),
                owner=self, tag="scratch", priority=hbm.PRI_SCRATCH,
                **self._hbm_place)
        # the admission dispatches' inputs, one vector uploaded per
        # dispatch (AdmissionInputs); no dispatch is wider than the chunk
        # budget, itself a bucket
        self._adm_in = AdmissionInputs(self._mb if self._paged else 0,
                                       self._chunk, self.device)
        self._adm_up = _Staged(self._adm_in.buf, record=self._tp is not None)
        self.admission_replays = 0   # admission dispatches run as replays
        # set when the in-flight admission pass deferred a lattice
        # admission; drops the pipeline to depth 1 until the synchronous
        # pass that runs it
        self._lattice_deferred = False
        # set while a paged engine's chunk lattice holds the scratch row:
        # an ingest, which stages its row there, waits for it to land
        self._scratch_busy = False

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
        self._pack_up = _Staged(self._pack, record=self._tp is not None)
        self._pack_dirty = True
        self._carry = self._host_carry()

        # Prompt-lookup speculative decoding (greedy slots only): each
        # slot's token history in a preallocated buffer, so _draft reads
        # views and an append is one index write
        if self._spec_k:
            self._spec_windows = 0   # slot-windows verified
            self._spec_emitted = 0   # tokens those windows emitted
            self._hist_buf = np.zeros((slots, self.max_seq), np.int32)
            self._hist_n = np.zeros((slots,), np.int64)
            # the verify pass's device inputs, one [B, W + 1 (+ MB) + 1]
            # int64 matrix uploaded per pass (the window, the active mask,
            # then the paged table, then each slot's LoRA adapter):
            # the captured verify graph reads this very tensor, so nothing
            # of a pass is baked into it
            self._verify_in = torch.zeros(
                (slots, self._spec_k + 3 + (self._mb if self._paged else 0)),
                dtype=torch.long, device=self.device)
            self._verify_up = _Staged(self._verify_in,
                                      record=self._tp is not None)

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

        self._pending = _ClassPending(slo_throughput_share)
        # throughput-class admissions never take the last
        # ``slo_latency_slots`` free slots, so a latency arrival under
        # batch saturation finds a slot (the gate bounds the line, this
        # the slots); clamped so that throughput can always run
        self._lat_reserve = max(0, min(int(slo_latency_slots), slots - 1))
        self._admission_lock = threading.Lock()
        self._work = threading.Event()
        self._closed = False
        self._draining = False
        # requests popped off the line but not yet live in a slot: drain()
        # counts them as in flight
        self._admitting = 0
        # requests whose deadline ran out, by where
        self._expired = dict.fromkeys(
            ("pre-queue", "queue", "mid-prefill", "mid-decode",
             "post-handoff"), 0)
        self.down: str | None = None
        self._recoveries = 0     # failed steps the loop recovered from
        self.total_tokens = 0
        self.total_requests = 0
        self.admissions = 0      # prefills run (one per admission)
        self.decode_steps = 0    # decode steps dispatched (K per block)
        self.verify_passes = 0   # speculative verify passes run
        self.verify_replays = 0  # verify passes run as a graph replay
        self.graph_replays = 0   # decode blocks run as a graph replay
        self._block_s: "deque[float]" = deque(maxlen=1024)
        self._verify_s: "deque[float]" = deque(maxlen=1024)
        # the tenancy plane (tenancy.TenantPlane), installed after
        # construction by install_tenancy; None: every request is the
        # anonymous default tenant and nothing tenant-shaped runs
        self.tenancy = None
        self._tenant_leased: set[str] = set()   # live tenant:{id} leases
        self._gauge_tenants: set[str] = set()   # tenants ever gauged
        self.admission_graph_bytes = 0
        if self._graphed:
            self._capture_graphs()
            self._capture_admission_graphs()
            if self._spec_k:
                self._capture_verify_graph()
        elif self.device.type == "cuda":
            kernels.build_all()

    # -- public API ----------------------------------------------------------
    def install_tenancy(self, plane) -> None:
        """Attach the multi-tenant serving plane (tenancy.TenantPlane).
        From here on ``generate`` resolves the ambient tenant against
        the registry: quota admission, weighted fair lines, per-tenant
        T0 budgets and tenant-labelled telemetry all switch on."""
        self.tenancy = plane
        if plane is not None and self._kvc is not None:
            row_bytes = 0
            if self._pool is not None and self._kvc.slots > 0:
                row_bytes = hbm.tree_nbytes(self._pool) // self._kvc.slots
            self._kvc.set_tenancy(plane.cache_shares, row_bytes=row_bytes)

    def generate(self, prompt, max_new_tokens: int = 128,
                 temperature: float = 0.0, top_k: int = 0, eos_id=None,
                 adapter: int = 0, logprobs: bool = False, deadline=None,
                 slo_class: str | None = None, seed: int | None = None,
                 continue_from=None, traceparent: str | None = None,
                 kv_sink=None, ingest=None) -> GenStream:
        """Enqueue a prompt (sequence of token ids); returns a GenStream
        yielding generated ids as the device produces them.

        ``temperature=0`` is greedy; ``top_k > 0`` truncates sampling to
        the k most likely tokens (capped at TOP_K_MAX). ``eos_id``: one
        stop id or an iterable of them; the stream ends at, and
        includes, the first generated token in the set. ``seed`` fixes a
        sampled request's stream; sampled requests without one get a
        deterministic per-engine seed, surfaced as ``stream.seed``.
        ``adapter``: the LoRA adapter the request runs through (0, the
        base model, by default; 1..n-1 on an engine built with
        ``lora_adapters`` = n).

        ``continue_from=(prompt, emitted)`` admits the continuation of
        an interrupted stream (the JAX engine's durable-stream resume):
        prompt + emitted prefill as one prompt, ``max_new_tokens`` still
        counts from the original request (a spent budget raises), and
        sampling resumes at absolute position ``len(emitted)``, so the
        spliced stream equals the uninterrupted one, greedy or seeded.

        ``deadline`` (resilience.Deadline) defaults to the calling
        thread's ambient one (``resilience.deadline_scope``): an expired
        request raises DeadlineExceeded here, and one that expires while
        queued, between lattice chunks or while decoding fails its
        stream with DeadlineExceeded and stops its device work.
        ``slo_class`` (resilience.SLO_LATENCY or SLO_THROUGHPUT) defaults
        to the ambient class (latency): latency-class requests take
        slots first; throughput-class ones are shed and browned out
        first by the gate and drain through the line's anti-starvation
        turns. With a gate, overload sheds with TooManyRequests and the
        brownout band caps ``max_new_tokens``. While ``drain`` runs,
        ``generate`` raises.

        ``traceparent`` (W3C) names the trace the request joins; without
        one the stream joins the calling thread's span (the App's request
        span), else a fresh trace id is minted. ``stream.trace_id`` and
        ``stream.traceparent`` carry it.

        Disaggregated serving (pd/): ``kv_sink`` runs the request
        prefill-only (a contiguous engine only): the stream delivers
        exactly the sampled first token while the slot's KV ships out
        through ``kv_sink(HostKV, start, total)`` in order, during the
        chunk lattice and then the rest before the first token.
        ``ingest=(HostKV, first_token, first_lp)`` is the decode side's
        mirror: admission installs the shipped rows under a ``pd-ingest``
        stage lease instead of running a prefill, delivers the shipped
        first token and decodes on. The two are exclusive.

        With a tenancy plane (``install_tenancy``) the ambient tenant
        (``tenancy.tenant_scope``) is resolved against the registry: its
        class default applies to an untagged request, its adapter to a
        request that picked none, and its quota is admitted before the
        gate (a 429 with ``reason`` ``tenant_quota`` over it). The
        stream holds one of the tenant's concurrency slots until its
        terminal, whichever it is."""
        if self._closed:
            raise GenerationError("generation engine is closed")
        if self._draining:
            raise GenerationError("generation engine is draining")
        if self.down is not None:
            raise GenerationError(f"generation engine is down: {self.down}")
        pos_base = 0
        if continue_from is not None:
            base, emitted = continue_from
            base = np.asarray(base, np.int64).reshape(-1)
            emitted = np.asarray(emitted, np.int64).reshape(-1)
            prompt = np.concatenate([base, emitted])
            pos_base = int(emitted.size)
            max_new_tokens = int(max_new_tokens) - pos_base
            if max_new_tokens <= 0:
                raise GenerationError(
                    f"continue_from carries {pos_base} emitted tokens but "
                    "the request budget allows no more: nothing to resume")
        if self.mesh is not None and (kv_sink is not None
                                      or ingest is not None):
            raise GenerationError(
                "the P/D halves (kv_sink, ingest) are not served under "
                "TPU_SHARDING yet (ROADMAP item 11b)")
        if kv_sink is not None and ingest is not None:
            raise GenerationError("kv_sink and ingest are exclusive (a "
                                  "request is prefill-only or decode-only, "
                                  "never both)")
        if kv_sink is not None and self._paged:
            raise GenerationError("kv_sink (prefill-only serving) requires "
                                  "a contiguous engine")
        if ingest is not None:
            self._validate_ingest(ingest,
                                  np.asarray(prompt, np.int64).reshape(-1))
        if deadline is None:
            deadline = current_deadline()
        if slo_class is None:
            slo_class = current_slo_class()
        elif slo_class not in (SLO_LATENCY, SLO_THROUGHPUT):
            raise GenerationError(f"unknown slo_class {slo_class!r}")
        spec = tenant = None
        if self.tenancy is not None:
            # the ambient tenant (the transport's tenant_scope) against
            # the registry: the canonical id, the class default for an
            # untagged request, the registry-routed adapter
            spec = self.tenancy.resolve(current_tenant())
            tenant = spec.tenant_id
            slo_class = self.tenancy.effective_class(spec, slo_class)
            adapter = self.tenancy.effective_adapter(spec, int(adapter))
        if deadline is not None and deadline.expired():
            self._count_expired("post-handoff" if ingest is not None
                                else "pre-queue")
            raise DeadlineExceeded("deadline expired before generate() "
                                   "was queued")
        if spec is not None:
            # the tenant's quota first: an over-quota tenant sheds on its
            # own 429 (reason tenant_quota), before the gate judges the
            # global pressure
            try:
                self.tenancy.admit(spec, program="generate",
                                   slo_class=slo_class, gate=self.gate)
            except BaseException:
                self._wide_shed(slo_class, tenant=tenant)
                raise
        # from here to the queue the tenant holds a concurrency slot:
        # every raise gives it back, and once the stream exists the
        # stream's terminal does
        held = spec is not None
        stream = None
        try:
            if self.gate is not None:
                try:
                    self.gate.admit(self._pending.qsize(),
                                    program="generate", slo_class=slo_class,
                                    tenant=tenant or "")
                except BaseException:
                    # shed before a stream exists: its wide event and
                    # timeline marker are the only record of the request
                    self._wide_shed(slo_class, tenant=tenant)
                    raise
                max_new_tokens = self.gate.cap_tokens(max_new_tokens,
                                                      slo_class=slo_class)
            if eos_id is not None and not isinstance(eos_id,
                                                     (int, np.integer)):
                eos_id = frozenset(int(t) for t in eos_id) or None
            elif isinstance(eos_id, np.integer):
                eos_id = int(eos_id)
            if adapter and not 0 <= adapter < max(self._n_adapters, 1):
                raise GenerationError(
                    f"adapter {adapter} out of range (engine has "
                    f"{self._n_adapters} LoRA adapter slots)")
            if seed is not None:
                seed = int(seed) & 0x7FFFFFFF
            elif temperature > 0:
                seed = (self._seed * 1000003
                        + next(self._auto_seed)) & 0x7FFFFFFF
            prompt = np.asarray(prompt, np.int64).reshape(-1)
            stream = GenStream(next(_REQ_IDS), logprobs=logprobs)
            stream.tenant = tenant or "default"
            stream._tenant_held, held = held, False
            stream.trace["submit"] = time.monotonic()
            stream.prompt_len = len(prompt)
            stream.seed = seed
            stream.cursor_base = pos_base
            stream.slo_class = slo_class
            stream.adapter = int(adapter)
            _trace(stream, traceparent)
            limit = self.max_seq - 1
            why = None
            if len(prompt) == 0 or len(prompt) > limit:
                why = ("empty prompt" if len(prompt) == 0 else
                       f"prompt length {len(prompt)} exceeds serving "
                       f"limit {limit}")
            elif self._paged:
                # fail fast when the POOL can never hold this prompt: a
                # transient shortage requeues at admission, a structural
                # one would requeue forever
                need = -(-len(prompt) // self._block_t)
                usable = self._alloc.n_blocks - 1
                if need > usable:
                    why = (f"prompt needs {need} pool blocks but the pool "
                           f"has {usable} (raise TPU_PAGED_BLOCKS or "
                           "TPU_PAGED_BLOCK)")
            if why is not None:
                self._end_stream(stream, GenerationError(why))
                return stream
            if self._observe is not None:
                # detail.request_id is the flight recorder's key, the one
                # /debug/events filters by (registry entry ids are a
                # separate counter)
                stream.obs_entry = self._observe.requests.add(
                    "generate", "generate", stream.trace_id, stage="queued",
                    detail={"request_id": stream.request_id,
                            "prompt_len": len(prompt),
                            "max_new": int(max_new_tokens),
                            "slo_class": slo_class})
                self._observe.recorder.record(
                    "submitted", request_id=stream.request_id,
                    trace_id=stream.trace_id, prompt_len=len(prompt),
                    max_new=int(max_new_tokens))
            req = _Request(stream, prompt, int(max_new_tokens),
                           float(temperature), int(top_k), eos_id, seed or 0,
                           pos_base=pos_base, deadline=deadline,
                           slo_class=slo_class, adapter=int(adapter))
            if spec is not None:
                req.tenant = tenant
                req.tenant_weight = spec.weight
            req.kv_sink = kv_sink
            req.ingest = ingest
            with self._admission_lock:
                # checked under the lock the failure path sets ``down``
                # under, so no request is queued after the queue failed
                if self._closed:
                    raise GenerationError("generation engine is closed")
                if self._draining:
                    # drain() sets the flag under this lock: without the
                    # re-check a racing generate() could slip a request
                    # in after the drain began
                    raise GenerationError("generation engine is draining")
                if self.down is not None:
                    raise GenerationError(
                        f"generation engine is down: {self.down}")
                self._pending.put(req)
        except BaseException:
            if stream is not None:
                self._obs_end(stream, "failed",
                              error="rejected at admission")
            elif held:
                self.tenancy.release(tenant)
            raise
        self._obs_gauges()
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
            "draining": self._draining,
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
            "pack_uploads": self._pack_up.uploads,
            "scheduler": {
                "prefill_chunk": self._chunk,
                "chunk_interleave": self._chunk_interleave,
                "latency_reserved_slots": self._lat_reserve,
                "queued_latency": self._pending.qsize_class(SLO_LATENCY),
                "queued_throughput":
                    self._pending.qsize_class(SLO_THROUGHPUT),
                "pipeline": self._pipeline_stats(),
            },
            "expired": dict(self._expired),
            "recoveries": self._recoveries,
            "down": self.down,
        }
        if self.tenancy is not None:
            out["scheduler"]["queued_by_tenant"] = \
                self._pending.qsize_by_tenant()
            out["tenancy"] = self.tenancy.stats()
        if self.mesh is not None:
            out["mesh"] = {
                "devices": self.mesh.tp,
                "axes": {"tp": self.mesh.tp},
                "kv_shards": self._kv_shards,
                "backend": self._tp.backend,
                "graphs": False,
                "ranks": self._tp.devices(),
                "alive": self._tp.alive(),
            }
        if self.gate is not None:
            out["admission"] = self.gate.stats()
        if self._kvc is not None:
            out["prefix_cache"] = self._kvc.stats()
        if self._prefix_idx is not None:
            out["prefix_cache"] = self._prefix_idx.stats()
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
        if self._n_adapters:
            out["lora"] = {"adapters": self._n_adapters,
                           "rank": int(self.params["layers"]
                                       ["lora_a_wq"].shape[-1])}
        if self._spec_k:
            out["spec_decode"] = {
                "k": self._spec_k,
                "windows": self._spec_windows,
                "emitted": self._spec_emitted,
                "tokens_per_window": (
                    round(self._spec_emitted / self._spec_windows, 3)
                    if self._spec_windows else None),
                "verify_replays": self.verify_replays,
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

    def kvcache_stats(self) -> dict | None:
        """Prefix-cache stats for the App's ``/debug/cache``: the
        contiguous engine's tiers, the paged pool's shared-prefix index,
        or None when no prefix cache is configured."""
        if self._kvc is not None:
            return {"kind": "hierarchical", **self._kvc.stats()}
        if self._prefix_idx is not None:
            return {"kind": "paged-shared", **self._prefix_idx.stats()}
        return None

    def load_adapter(self, idx: int, tree: dict) -> None:
        """Install adapter weights into slot ``idx``: ``tree`` maps a
        projection name ('wq'/'wk'/'wv'/'wo') to its (A [L, in, r],
        B [L, r, out]) pair, the layout LoRA training produces per
        layer (numpy, bfloat16 included, or tensors). Safe while serving:
        every pair is checked first, then, under the device lock, copied
        IN PLACE into the existing stack tensors, on the default stream
        the replays run on, so a block already queued reads the old
        weights and every later replay (each captured graph binds these
        very tensors) reads the new ones. The adapter's stored prefixes
        are dropped after the copy, from the paged index or from every
        tier (T2 by an epoch bump): their KV flowed through the old
        wk/wv."""
        if not self._n_adapters:
            raise GenerationError("engine built without lora_adapters")
        if not 0 < idx < self._n_adapters:
            raise GenerationError(
                f"adapter slot {idx} invalid (1..{self._n_adapters - 1}; "
                "slot 0 is the base no-op)")
        layers = self.params["layers"]
        for name in tree:
            if f"lora_a_{name}" not in layers:
                raise GenerationError(f"unknown LoRA target {name!r}")
        copies = []
        for name, (a, b) in tree.items():
            for key, val in ((f"lora_a_{name}", a), (f"lora_b_{name}", b)):
                dst = layers[key][:, idx]
                src = val if isinstance(val, torch.Tensor) \
                    else to_tensor(val, torch.device("cpu"))
                if tuple(src.shape) != tuple(dst.shape):
                    raise GenerationError(
                        f"{key}: adapter weights of shape "
                        f"{tuple(src.shape)}, the slot holds "
                        f"{tuple(dst.shape)}")
                copies.append((dst, src))
        with self._device_lock, torch.no_grad():
            for dst, src in copies:
                dst.copy_(src.to(dst.dtype))
            if self._prefix_idx is not None:
                # invalidated under the device lock, after the copy: the
                # loop matches and stores only under this lock, so no
                # entry computed through the old weights survives
                self._prefix_idx.invalidate_adapter(idx)
            if self._kvc is not None:
                self._kvc.invalidate_adapter(idx)

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful shutdown, phase 1 (the App's ``stop(grace_s=...)``):
        refuse new requests (``generate`` raises) and keep serving every
        accepted one -- live slots and the queue -- until idle or
        ``timeout``. Returns True when fully drained; the caller still
        owns ``close()``."""
        with self._admission_lock:
            self._draining = True

        def idle() -> bool:
            return (not self._active.any() and self._pending.empty()
                    and self._admitting == 0)

        deadline = time.monotonic() + max(0.0, timeout)
        while time.monotonic() < deadline:
            if idle():
                return True
            time.sleep(0.05)
        return idle()

    def _stop_loop(self, timeout: float = 60.0) -> None:
        """Stop the serving loop and wait for its thread."""
        with self._admission_lock:
            self._closed = True
        self._work.set()
        self._thread.join(timeout=timeout)

    def close(self) -> None:
        if self._comm is None or self._tp is not None:
            self._stop_loop()
        else:
            with self._admission_lock:
                self._closed = True
        with self._device_lock:
            if self.device.type == "cuda":
                # blocks still in flight finish before their graphs and
                # buffers can go
                torch.cuda.synchronize(self.device)
            self._fail_all(GenerationError("engine closed"),
                           "engine closed")
        # every worker rank stops, and its lease rows go with it
        self._tp_close()
        # the arbiter must not keep claiming bytes for a closed engine
        hbm.release(owner=self)
        if self._kvc is not None and self._kvc.redis is not None:
            # the engine owns the T2 client (KVCacheOptions.redis)
            self._kvc.redis.client.close()

    # -- tensor parallelism (parallel/) --------------------------------------
    def _tp_launch(self, cfg: ModelConfig, params, mesh: MeshPlan, kw: dict,
                   timeout_s: float):
        """Rank 0: refuse what the slice does not serve under TP, start
        the worker ranks (parallel.distributed.TPRanks), each building
        its own shard, and build this rank's. Returns (rank 0's config,
        rank 0's weights)."""
        from ..errors import ShardingConfigError

        tp, row = mesh.tp, mesh.row()
        check_tp(cfg, tp, row)
        refused = [what for what, on in (
            ("LoRA (lora_adapters)", int(kw.get("lora_adapters", 0)) > 0),
            ("the prefix caches (prefix_cache_slots)",
             int(kw.get("prefix_cache_slots", 0)) > 0),
            ("the kv-cache tiers (kvcache)", kw.get("kvcache") is not None))
            if on]
        if refused:
            raise ShardingConfigError(
                f"TPU_SHARDING={row!r}: {', '.join(refused)} not served "
                "under tensor parallelism yet (ROADMAP item 11b)",
                sharding_row=row)
        device = resolve_device(kw.get("device", "cuda"))
        if device.type == "cuda":
            # the per-rank shapes are refused before any rank starts, and
            # the kernels are built once, here, for every rank
            check_kernel_shapes(
                rank_config(cfg, tp, 0), device, kw.get("kv_dtype"),
                int(kw.get("paged_blocks", 0)) > 0,
                int(kw.get("paged_block_size", 128)),
                max(0, int(kw.get("spec_decode_k", 0))))
            kernels.build_all()
        shards = None
        if not isinstance(params, WeightSource):
            shards = [None] + [WeightSource(
                "shard", tree=_host_tree(shard_params(params, cfg, r, tp)))
                for r in range(1, tp)]
        spec = {"model": cfg, "weights": None if shards else params,
                "engine": {k: kw[k] for k in _TP_KWARGS if k in kw},
                "budget_bytes": hbm.budget(),
                "device_budget_bytes": hbm.device_budget()}
        self._tp = TPRanks(tp, device, spec, shards=shards,
                           timeout_s=timeout_s)
        self._comm = self._tp.comm
        self.mesh = mesh
        self._kv_shards = kv_head_shards(tp, cfg.n_kv_heads)
        own = rank_params(cfg, params, 0, tp, device)
        return rank_config(cfg, tp, 0, self._comm), own

    def _tp_ready(self) -> None:
        """Rank 0: wait for every worker's shard, then record each
        worker's leases in this process's arbiter, one row a rank with
        its device (tpu.hbm; ranks sharing a card are checked together
        against TPU_HBM_DEVICE_BUDGET_MB)."""
        for report in self._tp.wait_ready(self.tp_report())[1:]:
            holder = _RankLeases(report["rank"])
            self._tp_holders.append(holder)
            for lease in report["leases"]:
                hbm.lease(lease["subsystem"], lease["bytes"], owner=holder,
                          tag=lease["tag"], priority=lease["priority"],
                          device=report["device"], rank=report["rank"])

    def _tp_close(self) -> None:
        if self._tp is not None:
            self._tp.close()
        for holder in self._tp_holders:
            hbm.release(owner=holder)
        self._tp_holders = []

    def tp_report(self) -> dict:
        """This rank's device, leases and (on the card) peak allocated
        bytes so far, as a worker reports them when it is ready."""
        pri = {"serving": hbm.PRI_SERVING, "cache": hbm.PRI_CACHE,
               "scratch": hbm.PRI_SCRATCH}
        leases = [{"subsystem": r["subsystem"], "tag": r["tag"],
                   "bytes": r["bytes"], "priority": pri[r["priority"]]}
                  for r in hbm.arbiter_stats()["leases"]
                  if r["owner"] == id(self)]
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else None)
        return {"rank": getattr(self.cfg, "rank", 0),
                "device": str(self.device), "leases": leases,
                "peak_bytes": peak}

    def tp_alive(self) -> bool:
        """False once a worker rank of this engine has died."""
        return self._tp is None or self._tp.alive()

    def _dispatch(self, op: str, *args):
        """Rank 0 of a TP group: send command ``op`` (a dispatch carries
        the host images uploaded since the last one: the pack, the
        admission inputs, the verify inputs), then run this rank's share
        in the ``with`` block, under the group lock. Elsewhere nothing."""
        if self._tp is None:
            return contextlib.nullcontext()
        if op in ("adm", "block", "verify"):
            args = (*args, (self._pack_up.take(), self._adm_up.take(),
                            self._verify_up.take() if self._spec_k
                            else None))
        elif op == "reset":
            # every rank zeroes the pack and the admission inputs: their
            # pending images are void. Any other command (a score batch,
            # a probe) leaves the images pending for the next dispatch
            self._pack_up.take()
            self._adm_up.take()
        return self._tp.step(op, *args)

    def follow(self, op: str, args: tuple) -> None:
        """A worker rank: apply one of rank 0's commands to this rank's
        shard (parallel.worker)."""
        if op in ("adm", "block", "verify"):
            *args, uploads = args
            targets = (self._pack, self._adm_in.buf,
                       self._verify_in if self._spec_k else None)
            for dst, image in zip(targets, uploads):
                if image is not None:
                    dst.copy_(torch.from_numpy(image))
        with torch.no_grad():
            if op == "adm":
                self._admission_fn(args[0])()
            elif op == "block":
                self._block(args[0])
            elif op == "verify":
                self._verify_fn()
            elif op == "reset":
                self._reset_device()
            elif op == "score":
                self._follow_score(*args)
            elif op == "probe":
                self._comm.gather(self._probe_row())
            elif op == "zero_counts":
                _add_counts([-c for c in _counts()])
            elif op == "time_all_reduce":
                self._reduce_loop(*args)
            else:
                raise ValueError(f"unknown tensor-parallel command {op!r}")

    def tp_score(self, tokens: torch.Tensor, lengths: torch.Tensor,
                 rope_tables, rope_max: int) -> torch.Tensor:
        """The ``score`` program on every rank: rank 0 sends the batch's
        tokens and lengths, each rank runs ``llama.score`` (K1) on its
        shard, and the logits are summed over the ranks."""
        with self._device_lock, self._dispatch(
                "score", tokens.cpu().numpy(), lengths.cpu().numpy(),
                rope_max):
            return llama.score(self.params, self.cfg, tokens, lengths,
                               rope_tables=rope_tables, flash=True)

    def _follow_score(self, tokens, lengths, rope_max: int) -> None:
        ropes = self._score_ropes
        if rope_max not in ropes:
            ropes[rope_max] = llama.get_rope_tables(self.cfg, rope_max,
                                                    self.device)
        llama.score(self.params, self.cfg,
                    torch.from_numpy(tokens).to(self.device),
                    torch.from_numpy(lengths).to(self.device),
                    rope_tables=ropes[rope_max], flash=True)

    def _probe_row(self) -> np.ndarray:
        return np.concatenate(
            [t.long().cpu().numpy() for t in self._carry]
            + [self.cache.lengths.long().cpu().numpy(),
               np.asarray(_counts(), np.int64)])

    def tp_probe(self) -> np.ndarray:
        """Rank 0: every rank's device state, a [tp, 5B + 8] int64 array:
        a row a rank, its carry (last token, active, budget, position,
        B each), its cache cursors (B) and its kernel wrappers' counters
        (``_COUNTERS``' order). The carries and cursors agree when the
        ranks follow rank 0."""
        with self._device_lock, self._dispatch("probe"):
            return self._comm.gather(self._probe_row())

    def _reduce_loop(self, shape: tuple, n: int) -> None:
        t = torch.zeros(shape, dtype=torch.float32, device=self.device)
        for _ in range(n):
            self._comm.all_reduce(t)

    def tp_time_all_reduce(self, shape: tuple, n: int) -> float:
        """Rank 0: milliseconds of one float32 ``all_reduce`` of
        ``shape`` on the device group, the mean of ``n`` that every rank
        runs back to back (host clock, synchronised)."""
        with self._device_lock, self._dispatch("time_all_reduce", shape, n):
            self._reduce_loop(shape, 1)   # warm
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            self._reduce_loop(shape, n - 1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return 1e3 * (time.perf_counter() - t0) / max(n - 1, 1)

    def tp_zero_counts(self) -> None:
        """Rank 0: set every worker rank's kernel counters to 0 (rank
        0's are this process's module counters)."""
        with self._device_lock, self._dispatch("zero_counts"):
            pass

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
                        chaos.fire(chaos.GENERATOR_STEP)
                        depth = self._target_depth()
                        while len(pipe) < depth and not self._closed:
                            inflight = self._tick(decode_only=bool(pipe))
                            if inflight is None:
                                break
                            pipe.append(inflight)
                        self._note_depth(len(pipe))
                    if not pipe:
                        continue
                    self._admit_inflight(pipe[0])
                    with self._device_lock:
                        inflight = pipe.popleft()
                        self._reaps += 1
                        if pipe:
                            # a block still queued on the device: no gap
                            self._overlapped_reaps += 1
                            self._record_gap(0.0)
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
                # the blocks in flight died with the failure: drop every
                # handle (reaping one would only meet the same error),
                # then recover once for however many were in flight
                pipe.clear()
                if self._closed:
                    return
                self._recover(e)
                if self.down is not None:
                    return

    def _recover(self, e: Exception) -> None:
        """Recovery after a failed step (the JAX engine's ``_loop``
        handler), in JAX's three phases and order:

          1. host invariants: the dispatch state (pack, idle clock,
             deferral) is dropped, every slot's next dispatch takes the
             host's state (``host_wins``), the recovery is counted, and
             the prefix index (or the tiers' T0) is cleared before
             anything touches the pool (its entries would match prompts
             against zeroed blocks or rows); T1 and T2 survive, so the
             next admission of a spilled or shared prefix rewarms the
             fresh pool from them;
          2. delivery: every live slot's stream fails with
             GenerationError and the slot retires, freeing its blocks
             through the refcounts; queued requests are not failed, they
             are served after the recovery;
          3. device reset, in place: the captured decode and admission
             graphs bind the cache's, the scratch row's, the pack's, the
             carry's and the admission inputs' tensors, so those are
             zeroed where they lie (the cursors to 0) and every graph is
             kept; the T0 pool, which no graph binds, is reallocated
             through the arbiter as in JAX. The stream is synchronised
             first, so no pinned staging or output buffer is reused
             under an unmet copy, and
             again after, as the probe: a device that no longer
             synchronises (a sticky CUDA error) takes the engine down,
             ``down`` naming the error, and the queue fails -- the
             counterpart of JAX going down when its reallocation fails.

        The sampling salt: the JAX engine reseeds its chained key with
        ``PRNGKey(seed + recoveries)``, but no draw reads that key (every
        sample is keyed on the request's seed and absolute position), and
        an automatic seed is ``seed * 1000003 + n`` with n running on
        across recoveries; the port keeps the same counter, so a
        post-recovery request gets the seed the JAX engine would give it
        in the same position."""
        if self.logger is not None:
            self.logger.error({"event": "generation loop failed",
                               "error": repr(e)})
        if self._comm is not None and self._comm.broken is not None:
            # a lost tensor-parallel rank: no reset can bring its shard
            # back, so the engine goes down before any stream hears of it
            self._go_down(f"a tensor-parallel rank was lost: "
                          f"{self._comm.broken}", e)
            return
        err = GenerationError(f"generation failed: {e!r}")
        with self._device_lock:
            self._pack_dirty = True
            self._idle_from = None
            self._steady_from = None
            self._lattice_deferred = False
            self._host_wins[:] = True
            self._recoveries += 1
            if self._prefix_idx is not None:
                self._prefix_idx.clear()
            if self._kvc is not None:
                self._kvc.clear_device()
                self._tenant_cache_sync()
            for idx, slot in enumerate(self._slots):
                if slot.request is not None:
                    slot.request.stream.failed = repr(e)
                    self._retire(idx, slot, err)
            try:
                self._reset_device()
            except Exception as e2:  # noqa: BLE001 — the engine stops here
                self._go_down(f"device reset failed: {e2!r} "
                              f"(after: {e!r})", e)
                return
        if self.logger is not None:
            self.logger.warn({"event": "generation state reset after a "
                              "failed step", "recoveries": self._recoveries})

    def _go_down(self, why: str, e: Exception) -> None:
        """Take the engine down (``down`` names ``why``): every live
        stream and the queue fail with GenerationError, and ``generate``
        refuses from here on."""
        with self._admission_lock:
            self.down = why
        if self.logger is not None:
            self.logger.error({"event": "generation engine down",
                               "error": self.down})
        with self._device_lock:
            for slot in self._slots:
                if slot.request is not None:
                    slot.request.stream.failed = repr(e)
            self._fail_all(GenerationError(
                f"generation engine is down: {self.down}"), self.down)

    def _device_tensors(self) -> list[torch.Tensor]:
        """Every tensor a captured graph reads or writes that holds
        serving state: the cache (the pool), the scratch row, the
        dispatch pack, the carry and the admission inputs."""
        out = []
        for c in (self.cache, getattr(self, "_scratch", None)):
            if c is not None:
                out += [t for t in (c.k, c.v, c.k_scale, c.v_scale,
                                    c.lengths) if t is not None]
        return out + [self._pack, *self._carry, self._adm_in.buf]

    def _reset_device(self) -> None:
        """Phase 3 of ``_recover``: zero the serving state in place; the
        captured graphs, bound to these tensors, stay as they are. Every
        rank of a TP group zeroes its own; a group that lost a rank
        raises here, which takes the engine down."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        with self._dispatch("reset"), torch.no_grad():
            for t in self._device_tensors():
                t.zero_()
        if self._pool is not None:
            self._pool = None
            self._pool = self._alloc_pool(self._kvc.slots)
        if cuda:
            torch.cuda.synchronize(self.device)   # the probe

    def _fail_all(self, err: Exception, why: str) -> None:
        """Fail every live stream and the queue with ``err``; ``why`` is
        the terminal event's ``error`` (a live stream that already
        carries its failure, on a down engine, records that one)."""
        for idx, slot in enumerate(self._slots):
            if slot.request is not None:
                self._retire(idx, slot, err, end=(
                    None if slot.request.stream.failed is not None
                    else ("failed", {"error": why})))
        while True:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            self._end_stream(req.stream, err, "failed", error=why)

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
        policy's verdict on the facts this engine has. A waiting
        latency-class request, a deferred lattice admission and spec
        decoding pin depth 1."""
        return self._pipeline.target(
            latency_waiting=self._pending.qsize_class(SLO_LATENCY) > 0,
            lattice_deferred=self._lattice_deferred,
            spec_decode=bool(self._spec_k))

    def _note_dispatch(self, now: float) -> None:
        """Close an open inter-block gap: the device stream ran dry at
        ``_idle_from`` and this dispatch is the first work queued
        since."""
        if self._idle_from is None:
            return
        gap, self._idle_from = max(0.0, now - self._idle_from), None
        self._record_gap(gap, now)

    def _note_depth(self, depth: int) -> None:
        """The blocks in flight after a top-up: the gauge and the
        timeline's counter track change only when the depth does."""
        if depth == self._depth_now:
            return
        self._depth_now = depth
        if self.metrics is not None:
            self.metrics.set_gauge("app_tpu_pipeline_depth", float(depth),
                                   program="generate")
        if self._tl is not None:
            self._tl.pipeline_depth(depth)

    def _record_gap(self, gap: float, now: float | None = None) -> None:
        """One inter-block gap: 0 for a reap with a block queued behind
        it, else the device stream's idle time up to the dispatch at
        ``now``, which also lands on the timeline's device track."""
        self._gap_samples.append(gap)
        if self.metrics is not None:
            self.metrics.record_histogram("app_tpu_dispatch_gap_duration",
                                          gap, program="generate")
        if self._tl is not None and now is not None and gap > 0.0:
            self._tl.dispatch_gap(now - gap, now)

    def _admit(self, defer_lattice: bool = False) -> int:
        """Start pending requests in free slots; returns how many
        started. ``defer_lattice``: the in-flight pass must not start a
        chunk-lattice admission (its interleaved decode blocks would
        decode the active slots a second time under the unreaped block),
        so such a request goes back to the front of the queue for the
        next synchronous pass, and the pipeline drops to depth 1 so that
        pass comes within one reap. A throughput-class request never
        takes one of the last ``_lat_reserve`` free slots, and a request
        whose deadline ran out in the queue fails without a prefill."""
        started = 0
        for idx, slot in enumerate(self._slots):
            if not slot.free:
                continue
            # up BEFORE the pop: between the pop and the slot going live
            # the request is neither queued nor active, and drain() must
            # still see it
            self._admitting += 1
            try:
                free_now = sum(1 for s in self._slots if s.free)
                try:
                    req = self._pending.get_nowait(
                        allow_throughput=free_now > self._lat_reserve)
                except queue.Empty:
                    return started
                if defer_lattice and self._needs_lattice(req):
                    self._lattice_deferred = True
                    self._pending.put_front(req)
                    return started
                if req.stream.cancelled.is_set():
                    self._end_stream(req.stream, None, "cancelled",
                                     tokens=0)
                    continue
                if req.deadline is not None and req.deadline.expired():
                    # an ingested request's budget ran out after the
                    # pool handoff: this worker records it as such
                    where = self._expiry_where(req, "queue")
                    self._count_expired(where, req.stream.request_id)
                    req.stream.where = where
                    wait_s = time.monotonic() - req.enqueued_at
                    self._end_stream(
                        req.stream, DeadlineExceeded(
                            f"deadline expired after {wait_s:.3f}s in the "
                            "admission queue"), "failed",
                        error="deadline expired in queue",
                        wait_s=round(wait_s, 6))
                    continue
                try:
                    # the arbiter's checkpoint, one zero-byte lease per
                    # admission: the seeded HBM_ALLOC seam and the
                    # over-budget reclaim live behind it, and a failure
                    # sheds THIS request (429 + Retry-After) instead of
                    # failing the loop: memory pressure degrades the
                    # request, never the engine
                    hbm.check("engine")
                except hbm.HBMExhausted as e:
                    self._shed_oom(req, e)
                    continue
                blocks = None
                if self._paged:
                    # (shared, matched, fresh) with one reference a block
                    # held for the slot, or None (nothing held)
                    blocks = (self._ingest_blocks(req)
                              if req.ingest is not None
                              else self._paged_admission_blocks(req))
                    if blocks is None:
                        # transient pool pressure: requeue and let active
                        # slots retire blocks
                        self._pending.put(req)
                        return started
                self._start(idx, slot, req, blocks)
                started += 1
            finally:
                self._admitting -= 1
        return started

    def _needs_lattice(self, req: _Request) -> bool:
        """Would admitting ``req`` run the chunk lattice? A prompt past
        the chunk budget does, and so does a prefix hit -- a paged one,
        or a tier hit of a contiguous engine -- that
        ``_lattice_resume_valid`` accepts (the lattice resumes at the
        match point). ``match`` is pure, so the peek perturbs nothing;
        the verdict is memoized on the request, keyed by the index's
        version, as the in-flight pass re-peeks the queue's head at
        every poll. A contiguous engine's memo is the tier match itself
        (``_kv_match``): a T2 consult does network I/O, and the peek
        and the restore must see one answer. An ingested request never
        does: its install is copies, whatever its length. But a paged
        install stages its row in the scratch row, so while a lattice
        holds that row (an admission pass between its mid chunks) the
        ingest is deferred like a lattice admission."""
        if req.ingest is not None:
            return self._scratch_busy
        L = len(req.prompt)
        if L > self._chunk:
            return True
        if self._kvc is not None:
            mt = self._kv_match(req)
            if mt is None:
                return False
            m_eff = clamp_restore_len(mt.matched_len, L)
            return (m_eff >= self.prompt_buckets[0]
                    and self._lattice_resume_valid(L, m_eff))
        if self._prefix_idx is None:
            return False
        ver = self._prefix_idx.version
        if req.lattice_peek is not None and req.lattice_peek[0] == ver:
            return req.lattice_peek[1]
        _, m = self._prefix_idx.match(req.prompt, req.adapter)
        verdict = bool(m) and self._lattice_resume_valid(L, m)
        req.lattice_peek = (ver, verdict)
        return verdict

    def _lattice_resume_valid(self, L: int, m: int) -> bool:
        """Can the chunk lattice resume at position ``m`` of an L-token
        prompt? The final chunk's bucket must not pad wider than the
        prompt (its window would start before position 0): a hit that
        fails this is a miss. Mirrors ``_chunk_lattice``'s loop, whose
        mid chunks advance by the chunk budget."""
        rem = L - m
        while rem > self._chunk:
            rem -= self._chunk
        return L - pad_bucket(rem, self.prompt_buckets) >= 0

    def _paged_admission_blocks(self, req: _Request):
        """Blocks for one paged admission (the JAX engine's
        ``_paged_admission_blocks``): consult the prefix index (an
        off-lattice hit is a miss), take the slot's reference on the
        shared blocks before any evict-and-retry could free them,
        allocate the fresh remainder (evicting LRU entries under
        pressure), then count the hit or the miss. Returns (shared,
        matched tokens, fresh), one reference a block held for the slot,
        or None (nothing held) when the pool cannot cover the request
        now."""
        shared, m = [], 0
        idx = self._prefix_idx
        if idx is not None:
            shared, m = idx.match(req.prompt, req.adapter)
            if m and not self._lattice_resume_valid(len(req.prompt), m):
                shared, m = [], 0
            if shared:
                self._alloc.ref(shared)
        need = -(-len(req.prompt) // self._block_t) - len(shared)
        fresh = self._alloc.alloc(need)
        while fresh is None and idx is not None and idx.evict_one():
            fresh = self._alloc.alloc(need)
        if fresh is None:
            if shared:
                self._alloc.free(shared)
            return None
        if idx is not None:
            if m:
                idx.accept(shared)
            else:
                idx.reject()
        return shared, m, fresh

    def _prefill(self, idx: int, req: _Request, blocks) -> tuple[int, float]:
        """Prefill the prompt into slot ``idx`` (paged: into ``blocks``,
        the (shared, matched, fresh) of ``_paged_admission_blocks``) and
        sample the first token (position ``req.pos_base`` of the
        request's stream): one bucket dispatch, or the chunk lattice
        past the chunk budget or from a prefix hit. Queued on the stream
        behind any blocks in flight; reading the first token waits for
        them."""
        if self._paged:
            return self._paged_admit_prefill(idx, req, *blocks)
        pos = self._prefix_restore(idx, req)
        if pos == 0 and len(req.prompt) <= self._chunk:
            return self._bucket_prefill(idx, req)
        return self._chunk_lattice(idx, req, pos)

    def _bucket_prefill(self, idx: int, req: _Request,
                        blocks: list[int] = ()) -> tuple[int, float]:
        n = len(req.prompt)
        bucket = pad_bucket(n, self.prompt_buckets)
        self._admission_inputs(req.prompt, req, length=n, slot=idx,
                               logit_pos=n - 1, blocks=blocks)
        return self._run_admission(("prefill", bucket,
                                    req.temperature > 0))

    def _paged_admit_prefill(self, idx: int, req: _Request,
                             shared: list[int], m: int,
                             fresh: list[int]) -> tuple[int, float]:
        """Paged admission (the JAX engine's ``_paged_admit_prefill``).
        ``shared``/``m``: a prefix hit, m tokens of KV already in the
        shared blocks (the slot holds a reference on each); ``fresh``:
        the blocks allocated for the rest. The blocks are the slot's
        from the start, so every exit path frees them through
        ``_retire``; its table row stays zeroed (trash-routed) until the
        prompt is in, because the decode blocks a lattice interleaves
        step the slot at its stale cursor: through an installed row
        those writes would land in the new blocks, for a hit in the
        SHARED blocks of every other holder. A bucket prompt without a
        hit is one dispatch writing ceil(bucket/T) blocks (ids past the
        prompt's own: the trash block). Anything else runs the lattice
        on the scratch row -- for a hit from position m, after the
        read-back gathered the shared blocks into positions [0, m) --
        and one copy lands only the FRESH region in the pool (the
        shared blocks' ids route to the trash block: they are never
        rewritten), then the cursor, then the table row."""
        n = len(req.prompt)
        blocks = shared + fresh
        self._slot_blocks[idx] = blocks
        self._cursors[idx] = n
        if m == 0 and n <= self._chunk:
            width = -(-pad_bucket(n, self.prompt_buckets) // self._block_t)
            first = self._bucket_prefill(
                idx, req, blocks + [0] * (width - len(blocks)))
            self._write_table_row(idx)
            return first
        if m > 0:
            self._admission_inputs((), req, slot=0,
                                   blocks=shared + [0] * (self._mb
                                                          - len(shared)))
            self._run_admission(("readback",))
            # a zero-copy block-share hit: the wide event and the
            # timeline call its tier "paged"
            req.stream.cache_tier = "paged"
            req.stream.cache_tokens = m
            if self._tl is not None:
                self._tl.kvcache("paged", m, idx)
        self._scratch_busy = True
        try:
            first = self._chunk_lattice(0, req, m, track_slot=idx)
        finally:
            self._scratch_busy = False
        if req.stream.cancelled.is_set():
            return first   # the slot retires at delivery, freeing blocks
        self._admission_inputs(
            (), req, length=n, slot=idx,
            blocks=[0] * len(shared) + fresh + [0] * (self._mb - len(blocks)))
        self._run_admission(("writeback",))
        self._write_table_row(idx)
        return first

    def _chunk_lattice(self, row: int, req: _Request, pos: int = 0,
                       track_slot: int | None = None) -> tuple[int, float]:
        """The chunked-prefill lattice (the JAX engine's
        ``_chunk_lattice``) for ``req.prompt[pos:]`` into batch row
        ``row`` of the serving cache (paged: row 0 of the scratch row;
        ``pos`` > 0 resumes a prefix hit): mid chunks of C tokens while
        more than C remain, then a final chunk of bucket width Sb ending
        exactly at the prompt's end (it may overlap the last mid chunk,
        or the restored prefix: those positions recompute the same KV).
        With interleave on, between mid chunks: one admission pass for
        arrivals into other free slots (lattice arrivals deferred: one
        lattice at a time), then one decode block for the live slots,
        reaped at once. Returns the first token and its logprob, or (0,
        0.0) when the stream was cancelled mid-way (the slot retires at
        delivery).

        A prefill-only request (``kv_sink``) ships each mid chunk's KV as
        soon as the chunk is in, so the decode peer's assembly and the
        wire overlap the rest of the prompt's compute; the read waits
        for the chunk. Shipping stops at the final window's start: on an
        int8 cache the final chunk recomputes its overlap over already
        quantized positions and the row keeps that version, which
        ``_start`` ships from the settled row.

        Each mid chunk's host dispatch lands on the timeline's track of
        ``track_slot`` (the serving slot; ``row`` by default)."""
        n = len(req.prompt)
        c = self._chunk
        tslot = row if track_slot is None else track_slot
        ship_cap = n
        if req.kv_sink is not None:
            rem = n - pos
            while rem > c:
                rem -= c
            ship_cap = n - pad_bucket(rem, self.prompt_buckets)
        while n - pos > c:
            if req.stream.cancelled.is_set():
                return 0, 0.0
            if self._expire_mid_lattice(req, pos):
                return 0, 0.0
            chaos.fire(chaos.GENERATOR_CHUNK)
            t0c = time.monotonic() if self._tl is not None else 0.0
            self._admission_inputs(req.prompt[pos:pos + c], req, slot=row,
                                   start=pos)
            self._run_admission(("mid",))
            pos += c
            req.stream.chunks += 1
            if self._tl is not None:
                # the host's dispatch slice (the device work runs behind
                # it); index and length make the lattice readable
                self._tl.chunk(t0c, time.monotonic(), tslot,
                               req.stream.chunks - 1, c,
                               req.stream.request_id)
            if self.metrics is not None:
                self.metrics.increment_counter("app_tpu_prefill_chunks_total")
            if req.kv_sink is not None and not self._ship_range(
                    row, req, min(pos, ship_cap)):
                return 0, 0.0
            if not self._chunk_interleave:
                continue
            self._admit(defer_lattice=True)
            inflight = self._decode_tick()
            if inflight is not None:
                inflight.reap(False)
        if req.stream.cancelled.is_set():
            return 0, 0.0
        if self._expire_mid_lattice(req, pos):
            return 0, 0.0
        width = pad_bucket(n - pos, self.prompt_buckets)
        self._admission_inputs(req.prompt[n - width:], req, length=n,
                               slot=row, start=n - width,
                               logit_pos=width - 1)
        return self._run_admission(("final", width, req.temperature > 0))

    def _expire_mid_lattice(self, req: _Request, pos: int) -> bool:
        """Deadline check between chunk dispatches: a half-prefilled
        request whose caller gave up stops using the device now. Fails
        the stream with DeadlineExceeded and cancels it, so the cancel
        path retires the slot (paged: its blocks back to the pool)."""
        if req.deadline is None or not req.deadline.expired():
            return False
        self._count_expired("mid-prefill", req.stream.request_id)
        req.stream.where = "mid-prefill"
        req.stream.failed = "deadline expired mid-prefill"
        req.stream._q.put(DeadlineExceeded(
            f"deadline expired after {pos}/{len(req.prompt)} prompt "
            "tokens were prefilled"))
        req.stream.cancel()
        if self._observe is not None:
            self._observe.recorder.record(
                "expired_mid_prefill", request_id=req.stream.request_id,
                trace_id=req.stream.trace_id, prefilled=pos,
                prompt_len=len(req.prompt))
        return True

    def _expire_decoding(self, idx: int, slot: _Slot) -> bool:
        """Deadline check at a reap, once a slot and block (or verify
        pass): a decoding stream whose deadline ran out retires now,
        even with blocks for it still in flight (their tokens are
        dropped by the reaps' snapshot guards, and ``_retire``'s
        host_wins deactivates the slot for every dispatch after them).
        Fails the stream with DeadlineExceeded."""
        req = slot.request
        if req is None or req.deadline is None or not req.deadline.expired():
            return False
        where = self._expiry_where(req, "mid-decode")
        self._count_expired(where, req.stream.request_id)
        req.stream.where = where
        req.stream.failed = "deadline expired mid-decode"
        req.stream._q.put(DeadlineExceeded(
            f"deadline expired after {slot.generated} generated tokens"))
        req.stream.cancel()
        if self._observe is not None:
            self._observe.recorder.record(
                "expired_mid_decode", request_id=req.stream.request_id,
                trace_id=req.stream.trace_id, tokens=slot.generated)
        self._retire(idx, slot)
        return True

    def _count_expired(self, where: str, request_id=None) -> None:
        self._expired[where] += 1
        if self._tl is not None:
            self._tl.expired(where, request_id)
        if self.metrics is not None:
            try:
                self.metrics.increment_counter(
                    "app_tpu_expired_dropped_total", program="generate")
            except Exception:  # noqa: BLE001 — telemetry only
                pass

    def _admission_inputs(self, tokens, req: _Request, *, slot: int,
                          length: int = 0, start: int = 0,
                          logit_pos: int = 0, blocks=()) -> None:
        """Upload one admission dispatch's inputs (AdmissionInputs,
        through ``_Staged``)."""
        self._adm_in.pack(self._adm_up.host(), tokens, length=length,
                          slot=slot, start=start, logit_pos=logit_pos,
                          temp=req.temperature, top_k=req.top_k,
                          seed=req.seed, pos_base=req.pos_base,
                          blocks=blocks, adapter=req.adapter)
        self._adm_up.upload()

    def _admission_fn(self, key: tuple):
        """The admission dispatch ``key`` names, bound to the engine's
        tensors: ("prefill", bucket, draw), ("mid",), ("final", width,
        draw), ("writeback",) or ("readback",)."""
        kind = key[0]
        if kind == "prefill":
            return functools.partial(
                prefill_admission, self.params, self.cfg, self.cache,
                self._adm_in, self.rope_tables, bucket=key[1], draw=key[2])
        if kind in ("writeback", "readback"):
            fn = writeback_admission if kind == "writeback" \
                else readback_admission
            return functools.partial(fn, self.cache, self._scratch,
                                     self._adm_in)
        final = kind == "final"
        return functools.partial(
            chunk_admission, self.params, self.cfg,
            self._scratch if self._paged else self.cache, self._adm_in,
            self.rope_tables, width=key[1] if final else self._chunk,
            final=final, draw=final and key[2])

    def _admission_keys(self) -> list[tuple]:
        """Every admission dispatch this engine can run: a prefill per
        bucket within the chunk budget (wider buckets never dispatch)
        and draw value; with the lattice, the mid chunk; with the
        lattice or a prefix index (a hit resumes the lattice), a final
        chunk per such bucket and draw value; paged, the write-back (the
        lattice's landing, and a P/D ingest's); with a prefix index, the
        read-back."""
        buckets = [b for b in self.prompt_buckets if b <= self._chunk]
        keys = [("prefill", b, d) for b in buckets for d in (False, True)]
        if self._lattice:
            keys.append(("mid",))
        if self._lattice or self._prefix_idx is not None \
                or self._kvc is not None:
            keys += [("final", b, d) for b in buckets for d in (False, True)]
        if self._paged:
            keys.append(("writeback",))
        if self._prefix_idx is not None:
            keys.append(("readback",))
        return keys

    def _run_admission(self, key: tuple):
        """Run one admission dispatch on the inputs uploaded last: its
        (first token, logprob), or None for a mid chunk and the
        write-back. On the card one replay of its graph, whose first
        token is copied into a pinned buffer and read after the copy's
        event (as JAX reads ``int(tok)``: behind the blocks in flight);
        on the CPU, and on every rank of a TP group, the function,
        eagerly."""
        if not self._graphed:
            with self._dispatch("adm", key), torch.no_grad():
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
               blocks=None) -> None:
        t0 = time.monotonic()
        req.stream.trace["admit"] = t0
        if self.gate is not None:
            self.gate.note_wait(t0 - req.enqueued_at)
        if self._tl is not None:
            self._tl.admit(idx, req.slo_class, t0 - req.enqueued_at,
                           req.stream.request_id, req.stream.trace_id)
        self._obs_stage(req.stream, "prefill")
        if self._observe is not None:
            self._observe.recorder.record(
                "admitted", request_id=req.stream.request_id,
                trace_id=req.stream.trace_id, slot=idx,
                slo_class=req.slo_class,
                wait_s=round(t0 - req.enqueued_at, 6))
        # claim the slot before any dispatch: a lattice runs nested
        # admission passes between its chunks
        slot.request = req
        try:
            chaos.fire(chaos.GENERATOR_PREFILL)
            if req.ingest is not None:
                # shipped KV: the install takes the prefill's place, and
                # the rest runs as after a prefill (the T0 store too)
                first, first_lp = self._ingest_install(idx, req, blocks)
            else:
                first, first_lp = self._prefill(idx, req, blocks)
        except Exception as e:
            if self._paged:
                # clear the slot's blocks, table row and cursor before
                # freeing, so no stale row points at reallocated blocks;
                # the slot holds one reference on shared and fresh alike
                shared, _, fresh = blocks
                self._slot_blocks[idx] = []
                self._table[idx, :] = 0
                self._cursors[idx] = 0
                self._alloc.free(shared + fresh)
                self._touch()
            # un-claimed before the loop's recovery, which fails every
            # slot holding a request: this stream is failed here, once
            slot.request = None
            if isinstance(e, hbm.HBMExhausted):
                # an admission-path lease the arbiter could not cover:
                # memory pressure, a 429 shed of THIS request, never the
                # loop's recovery
                self._shed_oom(req, e)
                self._obs_gauges()
                return
            self._end_stream(req.stream,
                             GenerationError(f"prefill failed: {e!r}"),
                             "failed", stage="prefill", error=repr(e))
            raise
        prefill_done = req.stream.trace["prefill_done"] = time.monotonic()
        if self._tl is not None:
            self._tl.prefill(t0, prefill_done, idx, len(req.prompt),
                             req.stream.request_id, req.stream.trace_id)
        self._obs_span("tpu.admit-wait", req.enqueued_at, t0, req.stream,
                       {"slot": idx, "slo_class": req.slo_class})
        self._obs_span("tpu.prefill", t0, prefill_done, req.stream,
                       {"slot": idx, "prompt_len": len(req.prompt),
                        "slo_class": req.slo_class})
        if req.kv_sink is not None:
            # prefill-only: ship what the chunk hooks have not (the whole
            # row for a bucket prompt) before the first token's delivery,
            # since frame order on the wire is the ingest contract. A ship
            # failure cancelled the stream; _deliver retires the slot
            self._ship_range(idx, req, len(req.prompt))
        self._prefix_store(idx, req)
        if self.metrics is not None:
            self.metrics.record_histogram("app_tpu_batch_wait_duration",
                                          t0 - req.enqueued_at,
                                          program="generate")
        if req.ingest is None:
            self.admissions += 1
        self.total_requests += 1
        slot.generated = 0
        # a prefill-only request delivers its first token and retires:
        # the decode pool owns the rest of the budget
        slot.remaining = 1 if req.kv_sink is not None else req.max_new
        self._temps[idx] = req.temperature
        self._top_ks[idx] = req.top_k
        self._slot_seed[idx] = req.seed
        self._slot_adapter[idx] = req.adapter
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
            # token took pos_base itself
            self._pos_abs[idx] = req.pos_base + slot.generated
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
        self._obs_gauges()

    def _prefix_store(self, idx: int, req: _Request) -> None:
        """After a completed admission and before the slot's first
        decode block (the JAX engine's ``_prefix_store``), remember the
        prompt's KV. Paged: reference the slot's full prompt blocks as
        an index entry (immutable from here on: decode writes only the
        cursor's block). Contiguous: claim a T0 row (a victim spills to
        the host tier before its row is overwritten), copy the slot's
        positions [0, L) into it, and with the Redis tier on write the
        fresh KV's full blocks through, so sibling replicas skip the
        prefill too. The admission has run, so nothing is stored over a
        failed prefill. Skipped for cancelled streams, prompts under
        ``prefix_store_min`` and prompts already covered."""
        if req.stream.cancelled.is_set():
            return
        if self._prefix_idx is not None:
            if len(req.prompt) < self._store_min or \
                    self._prefix_idx.covered(req.prompt, req.adapter):
                return
            self._prefix_idx.store(req.prompt, self._slot_blocks[idx],
                                   req.adapter)
            return
        kvc = self._kvc
        prompt = np.asarray(req.prompt, np.int32)
        if kvc is None or len(prompt) < self._store_min \
                or kvc.covered(prompt, req.adapter):
            return
        row, victim = kvc.store(prompt, req.adapter,
                                tenant=self._tenant(req))
        self._offload_victim(victim)
        self._pool_copy(self._pool, row, self.cache, idx, len(prompt))
        if self.tenancy is not None:
            self._tenant_cache_sync()
        if kvc.shares:
            # write-through: a host copy of the slot's fresh KV is the
            # price of warming every replica, but only through the last
            # full block this replica hasn't already shared
            want = kvc.redis.pending_put_len(prompt, req.adapter)
            if want > 0:
                kvc.store_shared(prompt, req.adapter,
                                 self._kv_row_get(self.cache, idx, want))

    # -- the contiguous engine's prefix tiers --------------------------------
    def _new_pool(self, slots: int) -> llama.KVCache:
        return llama.init_cache(self.cfg, slots, self.max_seq,
                                dtype=self._kv_dtype, device=self.device)

    def _alloc_pool(self, slots: int) -> llama.KVCache:
        """The T0 pool through the arbiter: PRI_CACHE with the shrink
        callback, so under pressure from ANY subsystem the arbiter
        spills its entries to the host tier and reallocates it
        smaller."""
        return hbm.alloc(
            "kvcache-t0", functools.partial(self._new_pool, slots),
            nbytes=_cache_nbytes(self.cfg, slots, self.max_seq,
                                 self._kv_dtype, slots),
            owner=self, tag="pool", priority=hbm.PRI_CACHE,
            reclaim=self._hbm_pool_reclaim)

    @staticmethod
    def _planes(c: llama.KVCache) -> list[torch.Tensor]:
        return [t for t in (c.k, c.v, c.k_scale, c.v_scale) if t is not None]

    def _pool_copy(self, dst: llama.KVCache, dst_row: int,
                   src: llama.KVCache, src_row: int, n: int) -> None:
        """Copy positions [0, n) of one batch row (values and scale
        planes) between the pool and the serving cache: the T0 store and
        load (the JAX engine's ``_copy_row``; positions past n are never
        read, so only the prefix moves). Strided copies queued on the
        serving stream, behind the admission's replays and ahead of the
        slot's first decode block; the cursors are untouched."""
        with torch.no_grad():
            for d, s in zip(self._planes(dst), self._planes(src)):
                d[:, dst_row, :n].copy_(s[:, src_row, :n])

    def _kv_match(self, req: _Request, prompt: np.ndarray | None = None):
        """Request-memoized ``CacheManager.match``, keyed by the
        manager's version counter: the in-flight admission peek
        (``_needs_lattice``) and the real admission must see ONE verdict
        -- a disagreement would start a chunk lattice inside an
        in-flight admission -- and a T2 consult does network I/O the
        peek's poll must not repeat. Only the serving-loop thread calls
        this, and it cannot store between peek and admit, so a memo
        keyed by version is exact."""
        ver = self._kvc.version
        if req.kv_match is not None and req.kv_match[0] == ver:
            return req.kv_match[1]
        if prompt is None:
            prompt = np.asarray(req.prompt, np.int32)
        mt = self._kvc.match(prompt, req.adapter)
        req.kv_match = (ver, mt)
        return mt

    def _kv_row_get(self, store: llama.KVCache, row: int, plen: int,
                    start: int = 0) -> HostKV:
        """Positions [start, plen) of one pool or cache row as CPU
        tensors: the spill half of T1 offload, the read half of T2
        write-through and (``start`` > 0) a prefill worker's incremental
        KV ship. The copy waits for the stream (every block in flight
        included)."""
        quant = store.k_scale is not None

        def host(t):
            return t[:, row, start:plen].contiguous().cpu()

        return HostKV(host(store.k), host(store.v),
                      host(store.k_scale) if quant else None,
                      host(store.v_scale) if quant else None)

    def _offload_victim(self, victim) -> None:
        """Spill a T0-evicted entry's pool row to the host tier. MUST
        run before the copy that overwrites the row (store and promote
        call it between claiming the row and copying into it)."""
        if victim is None or not self._kvc.wants_offload:
            return
        plen = min(len(victim.key), self.max_seq)
        self._kvc.offload(victim, self._kv_row_get(self._pool, victim.row,
                                                   plen))

    def _upload_row(self, kv: HostKV, row: int,
                    target: llama.KVCache | None = None) -> None:
        """Land a host snapshot's positions [0, plen) in row ``row`` of
        ``target`` (the T0 pool by default; a P/D ingest's serving cache
        or scratch row), the JAX engine's ``_write_row_from_host``
        without its zero-padded Smax-wide row. Values are copied into
        the target's tensors in place, which the captured graphs bind.
        On the card each plane goes through a pinned staging buffer, as
        one contiguous [L, plen, ...] block, so the upload is an
        asynchronous copy on the serving stream, behind the blocks in
        flight; the staging is reused once the previous upload's event
        has passed."""
        target = self._pool if target is None else target
        planes = list(zip(self._planes(target), self._planes(kv)))
        with torch.no_grad():
            if self.device.type != "cuda":
                for dst, src in planes:
                    dst[:, row, :kv.plen].copy_(src)
                return
            if self._stage is None:
                self._stage = ([torch.empty(
                    (d.shape[0] * d.shape[2] * d[0, 0, 0].numel(),),
                    dtype=d.dtype, pin_memory=True) for d, _ in planes],
                    torch.cuda.Event())
            bufs, done = self._stage
            done.synchronize()
            for (dst, src), buf in zip(planes, bufs):
                stage = buf[:src.numel()].view(src.shape)
                stage.copy_(src)
                dst[:, row, :kv.plen].copy_(stage, non_blocking=True)
            done.record()

    def _promote_hostkv(self, mt) -> int | None:
        """Land a T1/T2 match's host KV in a T0 pool row and register it
        under the entry's key: the next hit on this prefix is a T0 row
        copy. Returns the row, or None when the payload cannot serve
        this engine (shape or quantization drift: a miss, never an
        error)."""
        kv = dense_hostkv(mt.hostkv) if mt.hostkv is not None else None
        pool = self._pool
        if (kv is None or kv.plen > self.max_seq or len(mt.key) < kv.plen
                or (pool.quantized and kv.k_scale is None)
                or kv.k.dtype != pool.k.dtype
                or kv.k.shape[0] != pool.k.shape[0]
                or kv.k.shape[2:] != pool.k.shape[3:]):
            return None
        row, victim = self._kvc.store(mt.key[:kv.plen], mt.adapter)
        self._offload_victim(victim)
        self._upload_row(kv, row)
        return row

    def _prefix_restore(self, idx: int, req: _Request) -> int:
        """Consult the cache hierarchy; on a useful hit land the prefix
        KV in slot ``idx`` and return the position prefill resumes from
        (0 = no hit). T0 hits are one pool-row copy; T1/T2 hits promote
        through a pool row first (``_promote_hostkv``). At least one
        prompt position is always recomputed: the final chunk ends at
        the prompt end and samples there."""
        if self._kvc is None:
            return 0
        L = len(req.prompt)
        prompt = np.asarray(req.prompt, np.int32)
        t_start = time.monotonic()
        mt = self._kv_match(req, prompt)
        # the memo's job (one verdict for peek AND restore) is done once
        # the restore reads it; a T2 match's decoded HostKV must not
        # stay pinned on the request for the stream's lifetime
        req.kv_match = None
        if mt is None:
            self._kvc.reject(prompt=prompt)
            return 0
        # full-prompt-hit clamp: restore at most L - 1 positions so the
        # final chunk prefills >= 1 token and samples from its logits
        m_eff = clamp_restore_len(mt.matched_len, L)
        if (m_eff < self.prompt_buckets[0]
                or not self._lattice_resume_valid(L, m_eff)):
            self._kvc.reject(mt)
            return 0
        row = mt.row if mt.tier == "t0" else self._promote_hostkv(mt)
        if row is None:
            self._kvc.reject(mt)
            return 0
        self._pool_copy(self.cache, idx, self._pool, row, m_eff)
        restore_s = time.monotonic() - t_start
        self._kvc.accept(mt, restore_s, tenant=self._tenant(req))
        req.stream.cache_tier = mt.tier
        req.stream.cache_tokens = m_eff
        if self._tl is not None:
            self._tl.kvcache(mt.tier, m_eff, idx)
        self._obs_span("tpu.prefix-restore", t_start, t_start + restore_s,
                       req.stream, {"tier": mt.tier, "tokens": m_eff,
                                    "slot": idx})
        if self.metrics is not None:
            try:
                self.metrics.increment_counter(
                    "app_tpu_prefix_cache_hits_total")
            except Exception:  # noqa: BLE001 — telemetry only
                pass
        return m_eff

    def _tenant(self, req: _Request) -> str | None:
        """The tenant a cache row or hit is charged to: the request's,
        on an engine with a tenancy plane."""
        return req.tenant if self.tenancy is not None else None

    def _tenant_cache_sync(self) -> None:
        """Reconcile the per-tenant arbiter leases with the cache ledger
        (the JAX engine's): a tenant holding more T0 rows than its
        budget gets a zero-byte ``tenant:{id}`` lease at PRI_SCRATCH
        whose reclaim evicts that tenant's rows, so arbiter pressure
        asks it for its own rows before the PRI_CACHE pool shrink
        flushes everyone's; back within budget, the lease is released.
        Zero bytes: the pool's own lease accounts them. Best effort:
        serving never stalls on it."""
        kvc = self._kvc
        if kvc is None or self.tenancy is None:
            return
        with self._device_lock:
            try:
                over = set()
                for tid, rows in kvc.tenant_rows().items():
                    budget = kvc.tenant_budget(tid)
                    if budget is not None and rows > budget:
                        over.add(tid)
                for tid in over - self._tenant_leased:
                    hbm.tenant_lease(
                        "kvcache-t0", 0, tenant=tid, owner=self,
                        priority=hbm.PRI_SCRATCH,
                        reclaim=functools.partial(self._tenant_cache_evict,
                                                  tid))
                    self._tenant_leased.add(tid)
                for tid in self._tenant_leased - over:
                    hbm.release("kvcache-t0", owner=self,
                                tag=f"tenant:{tid}")
                    self._tenant_leased.discard(tid)
            except Exception:  # noqa: BLE001 — quota leases are best effort
                pass

    def _tenant_cache_evict(self, tenant: str, need: int = 0) -> int:
        """The reclaim callback of a tenant's cache-quota lease: evict
        the over-budget tenant's own T0 rows (least recently used first,
        down to its budget), each spilled to the host tier as a store's
        victim is, so its warm state degrades to T1 and other tenants'
        rows stay. Runs on whichever thread's lease ran short, under the
        device lock, which the loop holds through every admission: no
        restore is being set up meanwhile, and an evicted row is read
        (the spill's copy to the host waits for the stream, every queued
        restore copy included) or rewritten only by copies queued on the
        serving stream behind whatever read it before, the fence a
        store's victim has. Reports 0 toward a byte deficit (the pool's
        lease holds the bytes) but frees the contended rows."""
        del need
        if self._kvc is None:
            return 0
        with self._device_lock:
            for victim in self._kvc.evict_tenant(tenant):
                self._offload_victim(victim)
            self._tenant_cache_sync()
        return 0

    def _shed_oom(self, req: _Request, e: hbm.HBMExhausted) -> None:
        """OOM-shed a popped admission: the arbiter could not cover a
        lease (the seeded HBM_ALLOC seam, or a real budget overshoot
        that survived reclaim), so THIS request ends with a 429 /
        RESOURCE_EXHAUSTED carrying the arbiter's Retry-After, through
        the gate's shed surface when there is a gate, while the engine
        keeps serving. The arbiter counted app_tpu_hbm_shed_total at its
        raise site."""
        err: Exception = e
        if self.gate is not None:
            err = self.gate.shed_memory(
                program="generate", slo_class=req.slo_class,
                retry_after=e.retry_after or 1.0,
                trace_id=req.stream.trace_id)
        else:
            now = time.monotonic()
            self._obs_span("tpu.shed", now, now, req.stream,
                           {"reason": "hbm", "slo_class": req.slo_class})
        if self._tl is not None:
            self._tl.shed("generate", req.slo_class, req.stream.trace_id)
        req.stream.failed = "hbm exhausted: shed"
        self._end_stream(req.stream, err, "shed", tokens=0, error=str(e))

    # -- disaggregated serving (pd/) -----------------------------------------
    @staticmethod
    def _expiry_where(req: _Request, default: str) -> str:
        """Where an expiry is counted: an ingested (P/D-shipped) request
        died after the pool handoff, whatever stage this worker was at."""
        return "post-handoff" if req.ingest is not None else default

    def _ship_range(self, row: int, req: _Request, upto: int) -> bool:
        """Prefill-only KV ship: positions [``req.kv_shipped``, ``upto``)
        of the slot's row to the host and into the request's sink (the
        P/D shipper frames and sends them). A sink that raises (the peer
        gone, the ship window stalled past its deadline) fails THIS
        request through the cancel path and returns False; it never
        reaches the loop's recovery, the engine is healthy."""
        if req.kv_sink is None or upto <= req.kv_shipped:
            return True
        if req.stream.cancelled.is_set():
            # a dead request (a client cancel, or an earlier ship failure
            # that cancelled it) must not block the loop for another
            # window deadline shipping KV nobody will install
            return False
        try:
            kv = self._kv_row_get(self.cache, row, upto,
                                  start=req.kv_shipped)
            req.kv_sink(kv, req.kv_shipped, len(req.prompt))
            req.kv_shipped = upto
            return True
        except BaseException as e:  # noqa: BLE001 — one request's failure
            req.stream.failed = f"kv ship failed: {e!r}"
            req.stream._q.put(GenerationError(f"kv ship failed: {e!r}"))
            req.stream.cancel()
            if self._observe is not None:
                self._observe.recorder.record(
                    "kv_ship_failed", request_id=req.stream.request_id,
                    trace_id=req.stream.trace_id, shipped=req.kv_shipped,
                    prompt_len=len(req.prompt), error=repr(e))
            if self.logger is not None:
                self.logger.warn({"event": "pd kv ship failed",
                                  "request_id": req.stream.request_id,
                                  "shipped": req.kv_shipped,
                                  "error": repr(e)})
            return False

    def _validate_ingest(self, ingest, prompt: np.ndarray) -> None:
        """Refuse shipped KV that cannot land in this engine's cache
        before it is queued (the ingest server relays the error typed);
        nothing here touches the device. Each frame's integrity was
        checked at the transfer boundary (quant.decode_block)."""
        kv, _, _ = ingest
        if kv.plen != len(prompt):
            raise GenerationError(
                f"ingest KV covers {kv.plen} tokens but the prompt has "
                f"{len(prompt)}: the transfer is incomplete")
        cfg = self.cfg
        if (kv.k.shape[0] != cfg.n_layers
                or tuple(kv.k.shape[2:]) != (cfg.n_kv_heads, cfg.head_dim)):
            raise GenerationError(
                f"ingest KV layout {tuple(kv.k.shape)} does not match this "
                f"engine ({cfg.n_layers} layers, {cfg.n_kv_heads} KV "
                f"heads, head_dim {cfg.head_dim})")
        if self.cache.k_scale is not None and kv.k_scale is None:
            raise GenerationError("ingest KV lacks scale planes but the "
                                  "serving cache is int8-quantized")
        if kv.k.dtype != self.cache.k.dtype:
            raise GenerationError(
                f"ingest KV dtype {kv.k.dtype} != serving cache dtype "
                f"{self.cache.k.dtype}")

    def _ingest_blocks(self, req: _Request):
        """Pool blocks for one shipped-KV admission on a paged engine:
        all fresh (the rows are installed, not matched), evicting LRU
        stored prefixes under pressure as a local admission does. None:
        a transient shortage, requeue."""
        need = -(-len(req.prompt) // self._block_t)
        fresh = self._alloc.alloc(need)
        while fresh is None and self._prefix_idx is not None \
                and self._prefix_idx.evict_one():
            fresh = self._alloc.alloc(need)
        if fresh is None:
            return None
        return [], 0, fresh

    def _ingest_install(self, idx: int, req: _Request,
                        blocks) -> tuple[int, float]:
        """Land a prefill worker's shipped KV in slot ``idx`` with no
        prefill compute, and return the shipped first token. The upload
        is leased from the arbiter first (``pd-ingest``, PRI_SCRATCH):
        under memory pressure the request sheds 429 here instead of the
        decode pool running out. A contiguous engine copies the rows
        straight into the slot's row of the serving cache and sets its
        cursor; a paged one stages them in the scratch row and replays
        the write-back graph into the slot's fresh blocks (``blocks``),
        which sets the cursor. Every copy writes the captured tensors in
        place, on the serving stream behind the blocks in flight. The T0
        store in ``_start`` then keeps the ingested prompt like a
        prefilled one."""
        kv, first, first_lp = req.ingest
        n = kv.plen
        hbm.lease("pd-ingest", kv.nbytes, owner=self, tag="stage",
                  priority=hbm.PRI_SCRATCH)
        try:
            if self._paged:
                fresh = blocks[2]
                self._slot_blocks[idx] = list(fresh)
                self._cursors[idx] = n
                self._upload_row(kv, 0, self._scratch)
                self._admission_inputs(
                    (), req, length=n, slot=idx,
                    blocks=list(fresh) + [0] * (self._mb - len(fresh)))
                self._run_admission(("writeback",))
                self._write_table_row(idx)
            else:
                self._upload_row(kv, idx, self.cache)
                self.cache.lengths[idx] = n
        finally:
            hbm.release("pd-ingest", owner=self, tag="stage")
        req.stream.cache_tier = "pd-ship"
        req.stream.cache_tokens = n
        if self._tl is not None:
            self._tl.kvcache("pd", n, idx)
        if self.metrics is not None:
            try:
                self.metrics.increment_counter("app_tpu_pd_ingests_total")
            except Exception:  # noqa: BLE001 — telemetry only
                pass
        return int(first), float(first_lp)

    # -- the arbiter's reclaim callbacks -------------------------------------
    def _hbm_pool_reclaim(self, need: int) -> int:
        """Shrink the T0 pool toward the host tier: spill every live
        entry's row to T1 (when configured), drop enough rows to cover
        ``need`` bytes (always keeping one), and reallocate the pool at
        the smaller size. Future hits promote back from T1/T2 exactly
        like post-recovery rewarming: the cache gets slower, the process
        survives. Runs under the device lock. Returns bytes freed."""
        with self._device_lock:
            kvc, pool = self._kvc, self._pool
            if kvc is None or pool is None or kvc.slots <= 1:
                return 0
            slots = kvc.slots
            total = hbm.tree_nbytes(pool)
            row_b = max(1, total // slots)
            drop = min(slots - 1, -(-max(int(need), 1) // row_b))
            new_slots = slots - drop
            for entry in kvc.t0.entries():
                self._offload_victim(entry)
            kvc.shrink(new_slots)
            self._tenant_cache_sync()
            # drop the old pool BEFORE allocating the smaller one:
            # holding both would spike usage past the very budget this
            # reclaim is trying to satisfy
            self._pool = pool = None
            try:
                self._pool = hbm.account("kvcache-t0",
                                         self._new_pool(new_slots),
                                         owner=self, tag="pool")
            except Exception:  # noqa: BLE001 — degrade, never crash
                # even the SMALLER pool failed to allocate (this runs
                # under memory pressure): disable the prefix tiers, so
                # serving continues cache-less, and count the whole old
                # pool as freed
                self._disable_prefix_tiers()
                hbm.release("kvcache-t0", owner=self, tag="pool")
                if self.logger is not None:
                    self.logger.error({
                        "event": "kvcache t0 disabled: arbiter shrink "
                                 "could not reallocate the smaller pool",
                        "slots_attempted": new_slots})
                return total
            if self.logger is not None:
                self.logger.warn({
                    "event": "kvcache t0 shrunk by hbm arbiter reclaim",
                    "slots": new_slots, "dropped_rows": drop,
                    "freed_bytes": drop * row_b})
            return drop * row_b

    def _disable_prefix_tiers(self) -> None:
        """Last-resort degradation: drop the hierarchical prefix cache
        (pool gone, manager detached, its Redis client closed) so every
        cache path sees what it sees on an engine built without one:
        requests keep serving, they just prefill fully."""
        kvc, self._kvc = self._kvc, None
        self._pool = None
        self._stage = None
        if kvc is not None and kvc.redis is not None:
            kvc.redis.client.close()

    def _hbm_paged_reclaim(self, need: int) -> int:
        """Release ONE cold shared-prefix entry's blocks back to the
        paged pool, the same one-at-a-time valve the in-pool pressure
        paths use. The pool is one preallocated tensor, so this frees
        BLOCK capacity, not device bytes: it reports 0 toward a byte
        deficit but still runs under pressure so the next block-level
        allocation finds room."""
        del need
        if not self._paged or self._prefix_idx is None:
            return 0
        with self._device_lock:
            if self._prefix_idx.evict_one() and self.logger is not None:
                self.logger.warn({"event": "paged prefix entry evicted "
                                  "by hbm arbiter reclaim"})
        return 0

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
        On the card the upload (``_Staged``) queues behind the blocks in
        flight without waiting for them (else depth 2 would run as depth
        1)."""
        if not self._pack_dirty:
            return
        p = self._pack_up.host()
        p[:, 0] = self._last_tokens
        p[:, 1] = self._active
        p[:, 2] = self._budgets
        p[:, 3] = self._temps.view(np.int32)
        p[:, 4] = self._top_ks
        p[:, 5] = self._slot_adapter
        p[:, 6] = self._host_wins
        p[:, 7] = self._slot_seed
        p[:, 8] = self._pos_abs
        p[:, PACK_EXTRA:PACK_EXTRA + EOS_MAX] = self._eos_mat
        if self._paged:
            p[:, PACK_EXTRA + EOS_MAX:] = self._table
        self._pack_up.upload()
        self._pack_dirty = False

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
        capture fails: on the card there is no eager path. The captures
        run under ``no_collection``: a dead CUDA graph that Python's
        collector frees mid-capture invalidates the capture."""
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
        with no_collection():
            for key, fn in fns.items():
                graph = torch.cuda.CUDAGraph()
                before = _counts()
                try:
                    with torch.no_grad(), torch.cuda.graph(
                            graph, pool=pool,
                            capture_error_mode="thread_local"):
                        out = fn()
                except Exception as e:
                    raise RuntimeError(
                        f"capturing the {label.format(key)} as a CUDA "
                        f"graph failed: {e!r}") from e
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
        event. On the CPU, and on every rank of a TP group: the block,
        eagerly."""
        if not self._graphed:
            with self._dispatch("block", draw), torch.no_grad():
                return self._block(draw).cpu(), None
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
        reap; and the block's timeline event, dispatch to this wait's
        end (the wait the tokens need anyway: no synchronisation of its
        own)."""
        if done is not None:
            done.synchronize()
        now = time.monotonic()
        if self._tl is not None:
            # one ring event a block, fanned out to the slots' tracks
            # only at export
            self._tl.decode_block(
                t_dispatch, now,
                tuple(int(i) for i in np.flatnonzero(snap_active)),
                self.decode_block)
        if self.metrics is not None:
            self.metrics.set_gauge("app_tpu_batch_fill",
                                   float(self._active.sum()) / self.n_slots,
                                   program="generate")
        start = self._steady_from if self._steady_from is not None \
            else t_dispatch
        self._block_s.append(now - start)
        self._steady_from = now if overlapped else None
        res = out.numpy()
        toks_l = res[:, 0].astype(np.int64).tolist()
        lps_l = res[:, 1].tolist()
        emit_l = res[:, 2].tolist()
        counts = res[:, 2].sum(axis=0)   # tokens each slot gets
        if done is not None:
            self._out_free.append((out, done))
        for idx, slot in enumerate(self._slots):
            if snap_active[idx] and self._active[idx] \
                    and slot.request is snap_reqs[idx]:
                if self._expire_decoding(idx, slot):
                    continue
                if counts[idx]:
                    self._record_itl(slot, int(counts[idx]))
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
        now = time.monotonic()
        if slot.generated == 0:
            req.stream.trace["first_put"] = now
            ttft = now - req.stream.trace["submit"]
            if self.metrics is not None:
                # one label-key set whether or not tenancy is on (tenant
                # "" when untenanted), so the series never split on the
                # deployment mode
                try:
                    self.metrics.record_histogram(
                        "app_tpu_ttft_duration", ttft,
                        exemplar=req.stream.trace_id or None,
                        program="generate", slo_class=req.slo_class,
                        tenant=self._tenant(req) or "")
                except Exception:  # noqa: BLE001 — telemetry only
                    pass
            self._obs_stage(req.stream, "decode")
            if self._observe is not None:
                self._observe.recorder.record(
                    "first_token", request_id=req.stream.request_id,
                    trace_id=req.stream.trace_id, slot=idx,
                    slo_class=req.slo_class, ttft_s=round(ttft, 6))
        # inter-token latency is recorded at the reap (_record_itl): a
        # block delivers its K tokens back to back
        slot.last_token_t = now
        req.stream._push((token, lp) if req.logprobs else token)
        slot.generated += 1
        slot.remaining -= 1
        self.total_tokens += 1
        try:
            # a seeded GENERATOR_MIDKILL (every=N, limit=1) kills this
            # stream after exactly N delivered tokens: the stand-in for
            # a replica dying mid-stream. Only this stream fails (typed
            # error, its slot retires); the engine keeps serving.
            chaos.fire(chaos.GENERATOR_MIDKILL)
        except Exception as e:  # noqa: BLE001 — one request's failure
            req.stream.failed = (f"chaos mid-stream kill after "
                                 f"{slot.generated} tokens")
            self._retire(idx, slot, GenerationError(
                f"mid-stream kill after {slot.generated} tokens: {e!r}"))
            return
        if req.stream.obs_entry is not None:
            req.stream.obs_entry.tokens = slot.generated
        if self.metrics is not None:
            self.metrics.increment_counter("app_tpu_tokens_generated_total")
        at_eos = req.eos_id is not None and (
            token in req.eos_id if isinstance(req.eos_id, frozenset)
            else token == req.eos_id)
        # cursor positions used so far: prompt_len + generated
        at_capacity = req.stream.prompt_len + slot.generated >= self.max_seq - 1
        if at_eos or slot.remaining <= 0 or at_capacity:
            self._retire(idx, slot)

    def _retire(self, idx: int, slot: _Slot, err: Exception | None = None,
                end: tuple | None = None) -> None:
        """Free the slot and end its stream, with ``err`` as its last
        item when the slot failed. The stream ends last, so a consumer
        that sees the end (or the error) sees the slot free and its
        blocks back in the pool. The terminal event (JAX's ``_retire``):
        ``failed`` when the stream carries a failure, ``cancelled``
        when it was cancelled, else ``finished``, with the slot, the
        tokens, the duration and the decode rate; ``end`` = (event,
        fields) replaces it (a closed engine's streams)."""
        stream = slot.request.stream
        now = time.monotonic()
        first = stream.trace.get("first_put")
        decode_s = (now - first) if first is not None else 0.0
        tps = slot.generated / decode_s if decode_s > 0 else 0.0
        if self.metrics is not None and slot.generated > 1:
            # a rate needs at least one inter-token interval
            self.metrics.set_gauge("app_tpu_tokens_per_second", tps,
                                   program="generate")
        if first is not None and slot.generated > 0:
            self._obs_span("tpu.decode", first, now, stream,
                           {"slot": idx, "tokens": slot.generated,
                            "slo_class": slot.request.slo_class})
        if end is None:
            event = ("failed" if stream.failed is not None
                     else "cancelled" if stream.cancelled.is_set()
                     else "finished")
            submit = stream.trace.get("submit")
            fields = {"slot": idx, "tokens": slot.generated,
                      "duration_s": (round(now - submit, 6)
                                     if submit is not None else None),
                      "tokens_per_s": (round(tps, 3)
                                       if slot.generated > 1 else None)}
            if stream.failed is not None:
                fields["error"] = stream.failed
        else:
            event, fields = end
        if self._paged:
            # freed blocks may be handed out at once; the retired slot's
            # frozen-cursor writes go to the trash block because its
            # table row zeroes before the next dispatch
            if self._slot_blocks[idx]:
                self._alloc.free(self._slot_blocks[idx])
                self._slot_blocks[idx] = []
            self._table[idx, :] = 0
            self._cursors[idx] = 0
            self._stop_cursors[idx] = 0
        slot.request = None
        self._active[idx] = False
        self._temps[idx] = 0.0
        self._top_ks[idx] = 0
        self._slot_adapter[idx] = 0
        self._budgets[idx] = 0
        self._slot_seed[idx] = 0
        self._pos_abs[idx] = 0
        self._eos_mat[idx, :] = llama.EOS_PAD
        # the host wins the next dispatch's merge for this slot: a
        # host-only retirement (cancel, paged starvation, a stop id past
        # EOS_MAX) deactivates a slot the device carry may still run
        self._host_wins[idx] = True
        self._touch()
        self._end_stream(stream, err, event, now, **fields)
        self._obs_gauges()

    def _end_stream(self, stream: GenStream, err: Exception | None = None,
                    event: str | None = None, now: float | None = None,
                    **fields) -> None:
        """Every stream's terminal (finish, cancel, each expiry, a failed
        step or prefill, an out-of-memory shed, a refused prompt, a
        closed engine): with ``event`` its terminal record (``_obs_end``),
        else only its tenant's concurrency slot back (a prompt refused
        before it was registered, as JAX records none); then the stream
        ends, with ``err`` as its last item when it failed. A consumer
        that sees the end sees the slot back and the record written.
        ``now``: the terminal's instant, when the caller took one."""
        if event is None:
            self._release_tenant(stream)
        else:
            self._obs_end(stream, event, now, **fields)
        if err is not None:
            stream._q.put(err)
        stream._push(None)

    # -- the flight recorder's plumbing (JAX's; the recorder, registry and
    # span parts are no-ops without an Observe bundle) -----------------------
    def _obs_end(self, stream: GenStream, event: str,
                 now: float | None = None, **fields) -> None:
        """A stream's terminal record: its tenant slot back, its registry
        entry removed, its terminal lifecycle event (finished, failed,
        cancelled, shed) and its canonical wide event, cut at ``now``
        (the terminal's instant; this call's by default)."""
        self._release_tenant(stream)
        if self._observe is not None:
            self._observe.requests.remove(stream.obs_entry)
            self._observe.recorder.record(event, request_id=stream.request_id,
                                          trace_id=stream.trace_id, **fields)
        self._wide_event(stream, event, fields, now)

    def _wide_fields(self, outcome: str, trace_id: str, slo_class: str,
                     tenant: str | None = None) -> dict:
        """The wide event's skeleton. The key order is part of the
        contract (one grep on ``"event": "request"`` reconstructs any
        request). ``tenant`` appears only on engines with a tenancy
        plane."""
        out = {"event": "request", "outcome": outcome,
               "trace_id": trace_id, "slo_class": slo_class}
        if tenant is not None:
            out["tenant"] = tenant
        return out

    def _wide_event(self, stream: GenStream, outcome: str, fields: dict,
                    now: float | None = None) -> None:
        """One structured event per request at its terminal outcome, in
        JAX's key order, through the logger (``Logger.wide``) and the
        flight recorder: the class, queue wait, chunk count, cache tier,
        tokens and trace id, and the critical-path ``breakdown`` (queue
        wait, prefill, handoff, decode), which feeds
        ``app_tpu_request_segment_duration``. The segments end at
        ``now``, the instant the terminal's ``duration_s`` was taken
        (JAX takes a second one here), so they sum to it up to the
        rounding, whatever the terminal did in between."""
        trace = stream.trace
        submit = trace.get("submit")
        admit = trace.get("admit")
        if now is None:
            now = time.monotonic()
        if stream.cursor_base and outcome == "finished":
            # a continuation that ran to completion is the resumed tail
            # of an interrupted stream
            outcome = "resumed"
        wide = self._wide_fields(
            outcome, stream.trace_id, stream.slo_class,
            tenant=stream.tenant if self.tenancy is not None else None)
        wide.update({
            "request_id": stream.request_id,
            "prompt_len": stream.prompt_len,
            "tokens": fields.get("tokens", 0),
            "queue_wait_s": (round(admit - submit, 6)
                             if admit is not None and submit is not None
                             else None),
            "duration_s": fields.get(
                "duration_s",
                round(now - submit, 6) if submit is not None else None),
            "chunks": stream.chunks,
            "cache_tier": stream.cache_tier,
            "cache_tokens": stream.cache_tokens,
        })
        if stream.cursor_base:
            # where the continuation picked up, and how much of its
            # prompt it recomputed
            wide["resumed_at_cursor"] = stream.cursor_base
            wide["recompute_tokens"] = max(
                0, stream.prompt_len - stream.cache_tokens)
        breakdown: dict = {}
        prefill_done = trace.get("prefill_done")
        first_put = trace.get("first_put")
        cuts = [("queue_wait", submit, admit),
                ("prefill", admit, prefill_done),
                ("handoff", prefill_done, first_put),
                ("decode", first_put, now)]
        for seg, a, b in cuts:
            if a is not None and b is not None:
                breakdown[seg + "_s"] = round(max(0.0, b - a), 6)
        if breakdown:
            wide["breakdown"] = breakdown
        if submit is not None:
            # the wall-clock anchor a fleet merge places the request by
            wide["submit_wall_s"] = round(time.time() - (now - submit), 6)
        if trace.get("kv_transfer_s") is not None:
            # the P/D wire segment precedes submit on a decode worker
            wide["kv_transfer_s"] = trace["kv_transfer_s"]
        if self.metrics is not None and breakdown:
            tid = stream.trace_id or None
            for i, (seg_s, v) in enumerate(sorted(breakdown.items())):
                try:
                    self.metrics.record_histogram(
                        "app_tpu_request_segment_duration", v,
                        exemplar=tid if i == 0 else None,
                        segment=seg_s[:-2], program="generate")
                except Exception:  # noqa: BLE001 — telemetry only
                    pass
        if "error" in fields:
            wide["error"] = fields["error"]
        if stream.where is not None:
            wide["where"] = stream.where
        if self._observe is not None:
            self._observe.recorder.record(
                "request", request_id=stream.request_id,
                trace_id=stream.trace_id,
                **{k: v for k, v in wide.items()
                   if k not in ("event", "request_id", "trace_id")})
        if self.logger is not None:
            try:
                self.logger.wide(wide)
            except Exception:  # noqa: BLE001 — telemetry only
                pass

    def _wide_shed(self, slo_class: str, tenant: str | None = None) -> None:
        """The wide event and timeline marker of a request shed at the
        gate or its tenant's quota: no stream exists yet, and the
        ambient span is the only trace it ever had."""
        trace_id = ""
        if self._observe is not None:
            span = tracing.current_span()
            if span is not None:
                trace_id = span.trace_id
        if self._tl is not None:
            self._tl.shed("generate", slo_class, trace_id)
        wide = self._wide_fields("shed", trace_id, slo_class, tenant=tenant)
        wide["sheds"] = 1
        if self._observe is not None:
            self._observe.recorder.record(
                "request", trace_id=trace_id,
                **{k: v for k, v in wide.items()
                   if k not in ("event", "trace_id")})
        if self.logger is not None:
            try:
                self.logger.wide(wide)
            except Exception:  # noqa: BLE001 — telemetry only
                pass

    def _obs_stage(self, stream: GenStream, stage: str) -> None:
        if stream.obs_entry is not None:
            stream.obs_entry.stage = stage

    def _obs_span(self, name: str, start_s: float, end_s: float,
                  stream: GenStream, attrs: dict | None = None) -> None:
        """Export one stage span (admit wait, prefill, decode, a prefix
        restore, a shed), parented by the request's trace context."""
        obs = self._observe
        if obs is None or obs.tracer is None:
            return
        try:
            obs.tracer.record_span(name, start_s, end_s,
                                   traceparent=stream.traceparent,
                                   trace_id=stream.trace_id or None,
                                   attributes=attrs)
        except Exception:  # noqa: BLE001 — telemetry only
            pass

    def _record_itl(self, slot: _Slot, n: int) -> None:
        """``n`` inter-token-latency samples for a slot about to receive
        ``n`` tokens from one reap: the time since its previous delivery
        spread over them (the device's cadence, not the host loop's
        microsecond gaps within one delivery)."""
        if self.metrics is None or n <= 0 or slot.last_token_t == 0.0:
            return
        gap = (time.monotonic() - slot.last_token_t) / n
        tid = slot.request.stream.trace_id or None if slot.request else None
        for i in range(n):
            self.metrics.record_histogram("app_tpu_inter_token_duration",
                                          gap, exemplar=tid if i == 0
                                          else None, program="generate")

    def _release_tenant(self, stream: GenStream) -> None:
        """Give back the stream's tenant concurrency slot, exactly once
        whichever terminal it reaches."""
        if not stream._tenant_held:
            return
        stream._tenant_held = False
        if self.tenancy is not None:
            try:
                self.tenancy.release(stream.tenant)
            except Exception:  # noqa: BLE001 — quota bookkeeping never
                pass           # takes the loop down

    def _obs_gauges(self) -> None:
        """The live-load gauges after an arrival, an admission or a
        retirement: active sequences, the queue in all and by class and,
        with a tenancy plane, by tenant (a tenant that drained reads 0,
        so every tenant ever seen is set)."""
        m = self.metrics
        if m is None:
            return
        try:
            m.set_gauge("app_tpu_active_sequences",
                        float(self._active.sum()))
            m.set_gauge("app_tpu_queue_depth", float(self._pending.qsize()),
                        program="generate")
            for cls in (SLO_LATENCY, SLO_THROUGHPUT):
                m.set_gauge("app_tpu_queue_depth",
                            float(self._pending.qsize_class(cls)),
                            program="generate", slo_class=cls)
            if self.tenancy is not None:
                by_tenant = self._pending.qsize_by_tenant()
                self._gauge_tenants.update(by_tenant)
                for tid in self._gauge_tenants:
                    m.set_gauge("app_tpu_queue_depth",
                                float(by_tenant.get(tid, 0)),
                                program="generate", tenant=tid)
        except Exception:  # noqa: BLE001 — telemetry only
            pass

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
                    # stored prefixes are the pressure valve: evict LRU
                    # entries before truncating a live stream
                    if self._prefix_idx is not None and \
                            self._prefix_idx.evict_one():
                        continue
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

    def _verify_fn(self) -> torch.Tensor:
        """``verify_pass`` bound to the engine's tensors, its inputs
        read from ``_verify_in``."""
        W = self._spec_k + 1
        buf = self._verify_in
        table = (buf[:, W + 1:W + 1 + self._mb].to(torch.int32)
                 if self._paged else None)
        return verify_pass(self.params, self.cfg, self.cache, buf[:, :W],
                           buf[:, W].bool(), table, self.rope_tables,
                           buf[:, -1])

    def _capture_verify_graph(self) -> None:
        """The port of the JAX engine's ``_verify_jit``: the verify pass
        captured into one CUDA graph (W = k + 1 is fixed for the
        engine), in a pool of its own, through ``_capture``. It warms
        over inputs with no slot active, so it emits nothing and leaves
        every cursor where it was; its rows land past the cursors
        (paged: in the trash block, through an all-zero table)."""
        self._verify_out_free: list = []   # pinned output buffers
        self._verify_in.zero_()
        self._verify_graph = self._capture({"verify": self._verify_fn},
                                           "{} pass")["verify"]

    def _verify_inputs(self, window: np.ndarray) -> None:
        """Upload one pass's inputs into ``_verify_in`` (``_Staged``):
        the window, the active mask, (paged) the table and each slot's
        adapter."""
        W = self._spec_k + 1
        host = self._verify_up.host()
        host[:, :W] = window
        host[:, W] = self._active
        if self._paged:
            host[:, W + 1:W + 1 + self._mb] = self._table
        host[:, -1] = self._slot_adapter
        self._verify_up.upload()

    def _run_verify(self):
        """Run one verify pass on the inputs uploaded last: (its
        [B, 2W + 1] results on the host, the event the reap waits on).
        On the card one replay, then a ``non_blocking`` copy of the
        graph's output into a pinned buffer the handle owns, queued
        right behind the replay (before any other graph can replay),
        and an event; on the CPU, and on every rank of a TP group,
        ``verify_pass``, eagerly."""
        if not self._graphed:
            with self._dispatch("verify"), torch.no_grad():
                return self._verify_fn().cpu().numpy(), None
        graph, out, deltas = self._verify_graph
        graph.replay()
        _add_counts(deltas)
        self.verify_replays += 1
        if self._verify_out_free:
            host, done = self._verify_out_free.pop()
        else:
            host = torch.empty(tuple(out.shape), dtype=out.dtype,
                               pin_memory=True)
            done = torch.cuda.Event()
        host.copy_(out, non_blocking=True)
        done.record()
        return host, done

    def _verify_tick(self, drafts: dict) -> _Inflight | None:
        """Dispatch one verify pass over window = [last token, k drafts]
        per slot (zero drafts for a slot without a match: it still emits
        its one guaranteed token). Its handle is in flight like a
        decode block's (the JAX engine's verify handle); the reap
        delivers each slot's emitted tokens in order, and a retirement
        mid-window discards the rest."""
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
        self._verify_inputs(window)
        out, done = self._run_verify()
        self.verify_passes += 1
        snap_active = self._active.copy()
        snap_reqs = [s.request for s in self._slots]
        return _Inflight(done, functools.partial(
            self._verify_reap, out, done, snap_active, snap_reqs, t0))

    def _verify_reap(self, out, done, snap_active, snap_reqs, t0: float,
                     overlapped: bool) -> None:
        """Wait for the pass's results (``verify_ms``: dispatch to here,
        host clock) and deliver them; a slot whose deadline ran out
        retires instead."""
        if done is not None:
            done.synchronize()
        now = time.monotonic()
        self._verify_s.append(now - t0)
        if self._tl is not None:
            self._tl.verify_block(
                t0, now, tuple(int(i) for i in np.flatnonzero(snap_active)),
                self._spec_k + 1)
        if done is not None:
            res = out.numpy().copy()
            self._verify_out_free.append((out, done))
            out = res
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
            if self._expire_decoding(idx, slot):
                continue
            self._record_itl(slot, int(emit_np[idx]))
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
            self._pos_abs[idx] = (s.request.pos_base + s.generated
                                  if live else 0)
            if self._paged:
                self._stop_cursors[idx] = (
                    min(int(self._cursors[idx]) + s.remaining,
                        self.max_seq - 2) if live else 0)
        self._host_wins |= snap_active
        self._touch()
