"""Continuous-batching token generation: the serving loop (counterpart of
gofr_tpu/tpu/generator.py, reduced to this slice).

  - A fixed pool of B slots shares one preallocated KV cache
    [L, B, Smax, KV, hd]; slots are admitted and retired independently
    through the per-slot ``lengths`` cursor.
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
    (seed, absolute position) through a counter-based hash, so a stream
    is a pure function of its seed; the bits differ from JAX's threefry.

Consumers call ``generate()`` from any thread and read tokens off a
stream; one background thread, ``gofr-torch-gen``, owns the device loop.
Features outside the slice (prefix cache, speculative decode, LoRA,
paged KV, a depth-2 pipeline, the kv-cache tiers, meshes) raise when
asked for.
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
from ..models import llama
from ..models.common import ModelConfig
from ..wire import PushStream

_REQ_IDS = itertools.count(1)


class GenerationError(RuntimeError):
    """A generation request failed or the engine cannot take it."""


# top-k truncation width: ranks past a request's k are masked within this
# fixed top set (larger k saturates to it)
TOP_K_MAX = 64

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32) without int64
    overflow: the high half's product is cut to the 16 bits that land."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xorshift-multiply) on int64 holders."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, pos: torch.Tensor, n: int,
                 stream: int) -> torch.Tensor:
    """[B, n] float32 Gumbel noise keyed on (seed, absolute position,
    index, stream): counter-based, so the same key gives the same noise
    on any device and in any batch."""
    key = _mix32((seeds.long() & _M32) ^ 0x243F6A88)
    key = _mix32(key ^ (pos.long() & _M32))
    key = _mix32(key ^ (0x9E3779B9 + stream))
    idx = _mix32(torch.arange(n, device=seeds.device, dtype=torch.long))
    bits = _mix32(key[:, None] ^ idx[None, :])
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))       # (0, 1)
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, temps: torch.Tensor, seeds: torch.Tensor,
           pos: torch.Tensor, top_ks: torch.Tensor):
    """Greedy where temp == 0; categorical(logits / temp) otherwise,
    truncated to the request's top-k logits when top_k > 0 -- per slot,
    by the Gumbel-max rule on ``gumbel_noise``. Returns (tokens [B]
    int64, logprob [B] of each token under the untempered model)."""
    V = logits.shape[-1]
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    sampled = torch.argmax(scaled + gumbel_noise(seeds, pos, V, 0), dim=-1)
    kmax = min(TOP_K_MAX, V)
    vals, idx = torch.topk(scaled, kmax, dim=-1)
    kk = torch.clamp(torch.where(top_ks > 0, top_ks, kmax), max=kmax)
    ranks = torch.arange(kmax, device=logits.device)
    vals = vals.masked_fill(ranks[None, :] >= kk[:, None], float("-inf"))
    in_k = torch.argmax(vals + gumbel_noise(seeds, pos, kmax, 1), dim=-1)
    topk_tok = torch.gather(idx, 1, in_k[:, None])[:, 0]
    sampled = torch.where(top_ks > 0, topk_tok, sampled)
    tok = torch.where(temps > 0, sampled, torch.argmax(logits, dim=-1))
    logp = torch.log_softmax(logits.float(), dim=-1)
    return tok, torch.gather(logp, 1, tok[:, None])[:, 0]


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
    # 5 seed, 6 position of the next sample, 7.. EOS set
    _PACK_EXTRA = 7

    def __init__(self, cfg: ModelConfig, params: dict, *, slots: int = 8,
                 max_seq: int | None = None, logger=None, seed: int = 0,
                 kv_dtype: torch.dtype | None = None, decode_block: int = 4,
                 decode_pipeline: int = 1, device="cuda",
                 prefix_cache_slots: int = 0, spec_decode_k: int = 0,
                 lora_adapters: int = 0, paged_blocks: int = 0,
                 kvcache=None, mesh=None):
        unported = {"prefix_cache_slots": prefix_cache_slots != 0,
                    "spec_decode_k": spec_decode_k != 0,
                    "lora_adapters": lora_adapters != 0,
                    "paged_blocks": paged_blocks != 0,
                    "decode_pipeline": decode_pipeline != 1,
                    "kvcache": kvcache is not None,
                    "mesh": mesh is not None}
        asked = [name for name, on in unported.items() if on]
        if asked:
            raise ValueError(f"not ported to gofr_tpu_torch yet: {asked} "
                             "(the port serves contiguous slots at "
                             "dispatch depth 1)")
        if cfg.n_experts > 0:
            raise ValueError("the port serves dense Llama models; MoE is "
                             "not ported yet")
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.n_slots = slots
        self.decode_block = max(1, int(decode_block))
        self.max_seq = min(max_seq or cfg.max_seq, cfg.max_seq)
        self.logger = logger
        self._seed = int(seed)
        self._auto_seed = itertools.count(1)
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
        self._block_s: "deque[float]" = deque(maxlen=1024)
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
        if len(prompt) == 0 or len(prompt) > limit:
            why = ("empty prompt" if len(prompt) == 0 else
                   f"prompt length {len(prompt)} exceeds serving limit "
                   f"{limit}")
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
        return {
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
                            self._decode_block()
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
            self._start(idx, slot, req)

    def _prefill(self, idx: int, req: _Request) -> tuple[int, float]:
        """Prefill the prompt into slot ``idx`` at its exact length and
        sample the first token (position 0 of the request's stream)."""
        n = len(req.prompt)
        dev = self.device
        tokens = torch.tensor(req.prompt[None], dtype=torch.long, device=dev)
        with torch.no_grad():
            logits, k, v, _ = llama.prefill_kv(
                self.params, self.cfg, tokens,
                torch.tensor([n], dtype=torch.int32, device=dev),
                rope_tables=self.rope_tables, flash=True,
                logit_pos=torch.tensor([n - 1], device=dev))
            llama.write_kv(self.cache, k, v, slot=idx)
            self.cache.lengths[idx] = n
            tok, lp = sample(
                logits[:, 0],
                torch.tensor([req.temperature], dtype=torch.float32,
                             device=dev),
                torch.tensor([req.seed], device=dev),
                torch.zeros((1,), dtype=torch.long, device=dev),
                torch.tensor([req.top_k], device=dev))
        out = torch.stack([tok.double(), lp.double()]).cpu()
        return int(out[0, 0]), float(out[1, 0])

    def _start(self, idx: int, slot: _Slot, req: _Request) -> None:
        req.stream.trace["admit"] = time.monotonic()
        slot.request = req
        try:
            first, first_lp = self._prefill(idx, req)
        except Exception as e:
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
        self._deliver(idx, slot, first, first_lp)
        if slot.request is not None:  # not finished by the first token
            self._last_tokens[idx] = first
            self._active[idx] = True
            self._budgets[idx] = slot.remaining
            self._eos_row(idx, req.eos_id)
            self._pos_abs[idx] = slot.generated

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
        p = np.empty((self.n_slots, self._PACK_EXTRA + E), np.int64)
        p[:, 0] = self._last_tokens
        p[:, 1] = self._active
        p[:, 2] = self._budgets
        p[:, 3] = self._temps.view(np.int32)
        p[:, 4] = self._top_ks
        p[:, 5] = self._slot_seed
        p[:, 6] = self._pos_abs
        p[:, self._PACK_EXTRA:] = self._eos_mat
        return torch.from_numpy(p).to(self.device)

    def _decode_block(self) -> None:
        """K fused decode steps over all slots; each step feeds its
        sampled tokens to the next on the device. Inactive cursors stay
        frozen (their scatter lands at the frozen position, which a later
        admission overwrites). One host read per block returns the
        [K, B] tokens, logprobs and emitted mask, delivered in order."""
        t0 = time.monotonic()
        pack = self._dispatch_pack()
        tokens = pack[:, 0]
        active = pack[:, 1].bool()
        budget = pack[:, 2]
        temps = pack[:, 3].to(torch.int32).view(torch.float32)
        top_ks = pack[:, 4]
        seeds = pack[:, 5]
        pos = pack[:, 6]
        eos_ids = pack[:, self._PACK_EXTRA:]
        # the host retires one delivered token before the cursor reaches
        # capacity (see _deliver): post-step cursors at max_seq - 2 mean
        # the NEXT delivery would reach the bound
        cap = self.max_seq - 2
        rows = []
        with torch.no_grad():
            for _ in range(self.decode_block):
                before = self.cache.lengths
                logits, _ = llama.decode_step(self.params, self.cfg, tokens,
                                              self.cache, self.rope_tables,
                                              flash=True)
                lengths = torch.where(active, self.cache.lengths, before)
                self.cache.lengths = lengths
                toks, lps = sample(logits, temps, seeds, pos, top_ks)
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
        slot.request.stream._push(None)
        slot.request = None
        self._active[idx] = False
        self._temps[idx] = 0.0
        self._top_ks[idx] = 0
        self._budgets[idx] = 0
        self._slot_seed[idx] = 0
        self._pos_abs[idx] = 0
        self._eos_mat[idx, :] = llama.EOS_PAD
