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
    corrupted. Pool pressure plays out as in the JAX engine at
    dispatch depth 1.
  - Admission prefills ONE prompt at its exact length (eager PyTorch has
    no compile keys, so there are no prompt buckets and no chunking up to
    ``max_seq - 1`` tokens), writes its KV into the slot and samples the
    first token, so TTFT is one prefill.
  - Decode runs K = ``decode_block`` steps per dispatch over all slots
    with the sampled token fed back on the device and per-slot stop masks
    (EOS set, budget, capacity) evaluated on the device; the host uploads
    one [B, W] state pack and reads the [K, B] tokens once per block.
    Dispatch depth is 1 (the block is reaped before the next starts).
  - Sampling (greedy, temperature, top-k) is keyed on each request's
    (seed, absolute position) as ``fold_in(PRNGKey(seed), pos)`` with
    JAX's threefry (tpu.prng), so a stream is a pure function of its
    seed and draws JAX's random bits.
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
Features outside the slice (prefix cache, LoRA, a depth-2 pipeline,
the kv-cache tiers, meshes) raise when asked for.
"""

from __future__ import annotations

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
from ..ops import kernels
from ..wire import PushStream
from . import prng

_REQ_IDS = itertools.count(1)


class GenerationError(RuntimeError):
    """A generation request failed or the engine cannot take it."""


# top-k truncation width: ranks past a request's k are masked within this
# fixed top set (larger k saturates to it)
TOP_K_MAX = 64


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


class GenStream(PushStream):
    """Iterator over generated token ids; ``cancel()`` releases the slot.
    ``trace`` holds time.monotonic() stamps: "submit", "admit",
    "prefill_done" and "first_put" (the first token's delivery)."""

    def __init__(self, request_id: int, logprobs: bool = False):
        super().__init__()
        self.request_id = request_id
        self.cancelled = threading.Event()
        self.prompt_len = 0
        self.logprobs = logprobs  # items are (token, logprob) tuples
        self.trace: dict[str, float] = {}
        self.seed: int | None = None

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
    # on-device EOS stop-set width: requests with more stop ids keep the
    # host check as their only stop for the extra ids
    EOS_MAX = 8

    # dispatch-pack columns (_dispatch_pack / _decode_block agree):
    # 0 last token, 1 active, 2 budget, 3 temp (float32 bits), 4 top_k,
    # 5 seed, 6 position of the next sample, 7.. EOS set, then (paged)
    # the block-table row
    _PACK_EXTRA = 7

    def __init__(self, cfg: ModelConfig, params: dict, *, slots: int = 8,
                 max_seq: int | None = None, logger=None, seed: int = 0,
                 kv_dtype: torch.dtype | None = None, decode_block: int = 4,
                 decode_pipeline: int = 1, device="cuda",
                 prefix_cache_slots: int = 0, spec_decode_k: int = 0,
                 lora_adapters: int = 0, paged_blocks: int = 0,
                 paged_block_size: int = 128, kvcache=None, mesh=None):
        unported = {"prefix_cache_slots": prefix_cache_slots != 0,
                    "lora_adapters": lora_adapters != 0,
                    "decode_pipeline": decode_pipeline != 1,
                    "kvcache": kvcache is not None,
                    "mesh": mesh is not None}
        asked = [name for name, on in unported.items() if on]
        if asked:
            raise ValueError(f"not ported to gofr_tpu_torch yet: {asked} "
                             "(the port serves contiguous or paged slots "
                             "at dispatch depth 1)")
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
            if paged_blocks < 2:
                # no prompt buckets here, so the floor is the trash
                # block plus one block to serve from
                raise ValueError(f"paged_blocks={paged_blocks} too small: "
                                 "need >= 2 (trash block + one block)")
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

        self._slots = [_Slot() for _ in range(slots)]
        self._last_tokens = np.zeros((slots,), np.int64)
        self._active = np.zeros((slots,), bool)
        self._budgets = np.zeros((slots,), np.int64)
        self._temps = np.zeros((slots,), np.float32)
        self._top_ks = np.zeros((slots,), np.int64)
        self._slot_seed = np.zeros((slots,), np.int64)
        self._pos_abs = np.zeros((slots,), np.int64)
        self._eos_mat = np.full((slots, self.EOS_MAX), llama.EOS_PAD,
                                np.int64)

        # Prompt-lookup speculative decoding (greedy slots only): each
        # slot's token history in a preallocated buffer, so _draft reads
        # views and an append is one index write
        if self._spec_k:
            self._spec_windows = 0   # slot-windows verified
            self._spec_emitted = 0   # tokens those windows emitted
            self._hist_buf = np.zeros((slots, self.max_seq), np.int32)
            self._hist_n = np.zeros((slots,), np.int64)

        self._pending: "queue.Queue[_Request]" = queue.Queue()
        self._device_lock = threading.Lock()
        self._admission_lock = threading.Lock()
        self._work = threading.Event()
        self._closed = False
        self.down: str | None = None
        self.total_tokens = 0
        self.total_requests = 0
        self.admissions = 0      # prefills run (one per admission)
        self.decode_steps = 0    # decode steps run (K per block)
        self.verify_passes = 0   # speculative verify passes run
        self._block_s: "deque[float]" = deque(maxlen=1024)
        self._verify_s: "deque[float]" = deque(maxlen=1024)
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
            if self._closed:
                raise GenerationError("generation engine is closed")
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
            "decode_block": self.decode_block,
            "kv_dtype": str(self.cache.k.dtype),
            "device": str(self.device),
            "total_requests": self.total_requests,
            "total_tokens": self.total_tokens,
            "admissions": self.admissions,
            "decode_steps": self.decode_steps,
            "decode_step_ms_mean": step_ms,
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

    def close(self) -> None:
        with self._admission_lock:
            self._closed = True
        self._work.set()
        self._thread.join(timeout=60.0)
        with self._device_lock:
            self._fail_all(GenerationError("engine closed"))

    # -- the serving loop ----------------------------------------------------
    def _loop(self) -> None:
        while not self._closed:
            try:
                if self._active.any() or not self._pending.empty():
                    with self._device_lock:
                        self._admit()
                        if self._active.any() and not self._closed:
                            self._tick()
                else:
                    self._work.clear()
                    if self._pending.empty() and not self._closed:
                        self._work.wait(0.05)
            except Exception as e:  # noqa: BLE001 — waiters must not hang
                # a failed device call leaves the cache in an unknown
                # state: the engine goes down and fails every stream
                self.down = repr(e)
                if self.logger is not None:
                    self.logger.error({"event": "generation loop failed",
                                       "error": repr(e)})
                with self._device_lock:
                    self._fail_all(GenerationError(
                        f"generation failed: {e!r}"))
                return

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

    def _admit(self) -> None:
        for idx, slot in enumerate(self._slots):
            if not slot.free:
                continue
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                return
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
                    return
            self._start(idx, slot, req, blocks)

    def _prefill(self, idx: int, req: _Request,
                 blocks: list[int] | None) -> tuple[int, float]:
        """Prefill the prompt into slot ``idx`` (paged: into ``blocks``)
        at its exact length and sample the first token (position 0 of
        the request's stream)."""
        n = len(req.prompt)
        dev = self.device
        tokens = torch.tensor(req.prompt[None], dtype=torch.long, device=dev)
        with torch.no_grad():
            logits, k, v, _ = llama.prefill_kv(
                self.params, self.cfg, tokens,
                torch.tensor([n], dtype=torch.int32, device=dev),
                rope_tables=self.rope_tables, flash=True,
                logit_pos=torch.tensor([n - 1], device=dev))
            if self._paged:
                # the slot owns its blocks from here: every exit path
                # frees them through _retire (or _start's failure path)
                self._slot_blocks[idx] = blocks
                self._cursors[idx] = n
                paged_llama.write_prompt_blocks(self.cache, k, v, blocks)
                self._write_table_row(idx)
            else:
                llama.write_kv(self.cache, k, v, slot=idx)
            self.cache.lengths[idx] = n
            tok, lp = sample(
                logits[:, 0],
                torch.tensor([req.temperature], dtype=torch.float32,
                             device=dev),
                torch.tensor([req.seed], device=dev),
                torch.zeros((1,), dtype=torch.long, device=dev),
                torch.tensor([req.top_k], device=dev),
                draw=req.temperature > 0)
        out = torch.stack([tok.double(), lp.double()]).cpu()
        return int(out[0, 0]), float(out[1, 0])

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
        if self._spec_k:
            self._hist_set(idx, req.prompt)
            self._hist_append(idx, first)
        self._deliver(idx, slot, first, first_lp)
        if slot.request is not None:  # not finished by the first token
            self._last_tokens[idx] = first
            self._active[idx] = True
            self._budgets[idx] = slot.remaining
            self._eos_row(idx, req.eos_id)
            self._pos_abs[idx] = slot.generated
            if self._paged:
                # where the device's budget/capacity stop masks will
                # freeze this slot's cursor (EOS may stop earlier)
                self._stop_cursors[idx] = min(
                    req.stream.prompt_len + slot.remaining,
                    self.max_seq - 2)

    def _eos_row(self, idx: int, eos_id) -> None:
        row = self._eos_mat[idx]
        row[:] = llama.EOS_PAD
        if eos_id is None:
            return
        ids = (eos_id,) if isinstance(eos_id, int) else tuple(eos_id)
        for j, t in zip(range(self.EOS_MAX), ids):
            row[j] = t

    def _dispatch_pack(self) -> torch.Tensor:
        """Every host-owned per-slot decode input in one [B, W] int64
        array, uploaded as one copy (the numpy staging array is fresh, so
        nothing aliases host state that changes later)."""
        E = self.EOS_MAX
        width = self._PACK_EXTRA + E + (self._mb if self._paged else 0)
        p = np.empty((self.n_slots, width), np.int64)
        p[:, 0] = self._last_tokens
        p[:, 1] = self._active
        p[:, 2] = self._budgets
        p[:, 3] = self._temps.view(np.int32)
        p[:, 4] = self._top_ks
        p[:, 5] = self._slot_seed
        p[:, 6] = self._pos_abs
        p[:, self._PACK_EXTRA:self._PACK_EXTRA + E] = self._eos_mat
        if self._paged:
            p[:, self._PACK_EXTRA + E:] = self._table
        return torch.from_numpy(p).to(self.device)

    def _decode_block(self) -> None:
        """K fused decode steps over all slots; each step feeds its
        sampled tokens to the next on the device. Inactive cursors stay
        frozen (their scatter lands at the frozen position, which a later
        admission overwrites; a paged slot's lands through its table
        row, in the trash block once it is retired). One host read per
        block returns the [K, B] tokens, logprobs and emitted mask,
        delivered in order."""
        if self._paged:
            self._ensure_blocks()  # may retire starving slots
            if not self._active.any():
                return
        t0 = time.monotonic()
        pack = self._dispatch_pack()
        tokens = pack[:, 0]
        active = pack[:, 1].bool()
        budget = pack[:, 2]
        temps = pack[:, 3].to(torch.int32).view(torch.float32)
        top_ks = pack[:, 4]
        seeds = pack[:, 5]
        pos = pack[:, 6]
        E = self.EOS_MAX
        eos_ids = pack[:, self._PACK_EXTRA:self._PACK_EXTRA + E]
        if self._paged:
            # the table is constant through the block: the host has
            # allocated blocks covering K positions per slot
            table = pack[:, self._PACK_EXTRA + E:].to(torch.int32)

            def step(tokens):
                return paged_llama.paged_decode_step(
                    self.params, self.cfg, tokens, self.cache, table,
                    self.rope_tables)
        else:
            def step(tokens):
                return llama.decode_step(self.params, self.cfg, tokens,
                                         self.cache, self.rope_tables,
                                         flash=True)
        # Gumbel noise only when some slot samples (host-known, no sync)
        draw = bool((self._temps > 0).any())
        # the host retires one delivered token before the cursor reaches
        # capacity (see _deliver): post-step cursors at max_seq - 2 mean
        # the NEXT delivery would reach the bound
        cap = self.max_seq - 2
        rows = []
        with torch.no_grad():
            for _ in range(self.decode_block):
                before = self.cache.lengths
                logits, _ = step(tokens)
                lengths = torch.where(active, self.cache.lengths, before)
                self.cache.lengths = lengths
                toks, lps = sample(logits, temps, seeds, pos, top_ks, draw)
                toks = torch.where(active, toks, tokens)
                emitted = active
                budget = torch.where(active, budget - 1, budget)
                pos = pos + emitted.long()
                stop = active & llama.decode_stop_mask(toks, lengths, budget,
                                                       eos_ids, cap)
                rows.append(torch.stack([toks.double(), lps.double(),
                                         emitted.double()]))
                tokens, active = toks, active & ~stop
        out = torch.stack(rows).cpu().numpy()                  # [K, 3, B]
        self._block_s.append(time.monotonic() - t0)
        self.decode_steps += self.decode_block
        if self._paged:
            # cursors advance by K, bounded by each slot's device stop
            # cursor (the scan freezes a slot there); EOS stops land
            # wherever they land, and such a slot retires below
            adv = np.minimum(self.decode_block,
                             np.maximum(self._stop_cursors - self._cursors, 0))
            adv = np.where(self._stop_cursors > 0, adv, self.decode_block)
            self._cursors[self._active] += adv[self._active]
        snap_active = self._active.copy()
        snap_reqs = [s.request for s in self._slots]
        for k in range(out.shape[0]):
            for idx, slot in enumerate(self._slots):
                if not snap_active[idx] or not self._active[idx] \
                        or slot.request is not snap_reqs[idx] \
                        or not out[k, 2, idx]:
                    continue
                tok = int(out[k, 0, idx])
                self._last_tokens[idx] = tok
                self._pos_abs[idx] += 1
                if self._spec_k:
                    self._hist_append(idx, tok)
                self._deliver(idx, slot, tok, float(out[k, 1, idx]))
        for idx, slot in enumerate(self._slots):
            if self._active[idx]:
                self._budgets[idx] = slot.remaining

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

    # -- paged-mode host side ------------------------------------------------
    def _write_table_row(self, idx: int) -> None:
        """Clamped table row: entries past the slot's live blocks repeat
        the last one; an empty slot stays on the trash block."""
        blocks = self._slot_blocks[idx]
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

    def _tick(self) -> None:
        """One serving tick: a verify pass when every active slot is
        greedy and clear of capacity and at least half of them draft
        (a slot without a draft emits one token a pass where a decode
        block gives it K), else a decode block."""
        if self._spec_k and self._spec_eligible():
            drafts = {idx: self._draft(idx)
                      for idx in range(self.n_slots) if self._active[idx]}
            drafted = sum(d is not None for d in drafts.values())
            if drafted > 0 and 2 * drafted >= len(drafts):
                self._verify_tick(drafts)
                return
        self._decode_block()

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
        cursors advance by emit. Returns (greedy, logprobs, emit)."""
        if self._paged:
            logits, _ = paged_llama.paged_verify_step(
                self.params, self.cfg, window, self.cache, table,
                self.rope_tables)
        else:
            logits, _ = llama.verify_step(self.params, self.cfg, window,
                                          self.cache, self.rope_tables)
        toks, lps, _, emit = verify_epilogue(logits, window, active)
        self.cache.lengths = self.cache.lengths + emit.to(torch.int32)
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

    def _verify_tick(self, drafts: dict) -> None:
        """One verify pass over window = [last token, k drafts] per slot
        (zero drafts for a slot without a match: it still emits its one
        guaranteed token), reaped at once: each slot's emitted tokens
        are delivered in order, and a retirement mid-window discards the
        rest."""
        W = self._spec_k + 1
        window = np.zeros((self.n_slots, W), np.int64)
        window[:, 0] = self._last_tokens
        for idx, d in drafts.items():
            if d is not None:
                window[idx, 1:] = d
        if self._paged:
            self._ensure_blocks(W)  # a window writes up to W positions
            if not self._active.any():
                return
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
        toks_np, lps_np = out[:, :W], out[:, W:2 * W]
        emit_np = out[:, 2 * W].astype(np.int64)
        snap_active = self._active.copy()
        snap_reqs = [s.request for s in self._slots]
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
                self._pos_abs[idx] += 1
                self._hist_append(idx, tok)
                self._deliver(idx, slot, tok, float(lps_np[idx, k]))
        # the host's mirrors of the device stop state follow what the
        # deliveries left
        for idx in np.flatnonzero(snap_active):
            s = self._slots[idx]
            self._budgets[idx] = s.remaining if s.request is not None else 0
            if self._paged:
                self._stop_cursors[idx] = (
                    min(int(self._cursors[idx]) + s.remaining,
                        self.max_seq - 2)
                    if s.request is not None else 0)
