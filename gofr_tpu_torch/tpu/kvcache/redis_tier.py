"""T2: the Redis-shared tier -- replicas warming each other's caches (the
port's own copy of gofr_tpu/tpu/kvcache/redis_tier.py).

Cache blocks travel through the port's own RESP2 client
(``gofr_tpu_torch.datasource.redisclient``), so shared prefix capacity
scales with the Redis deployment, not with any one replica's device
memory or RAM.

Layout (all keys under one namespace), the JAX package's:

  {ns}:{fingerprint}:ep:{adapter}          -> epoch integer
  {ns}:{fingerprint}:{adapter}:{epoch}:{chain-hash} -> block frame

``fingerprint`` hashes the model config + a weight sample
(``model_fingerprint``, equal to the JAX package's for the same
weights), so replicas serving different weights can share one Redis
without ever exchanging KV, while a port replica and a JAX replica of
the same model read each other's frames (quant.decode_block
additionally shape-checks and checksums every frame: shared-store
bytes are untrusted input, a bad frame is a miss). The chain hash
(radix.chain_hashes) encodes each block's whole left context, so a
lookup is: compute the prompt's chain, MGET, take the longest prefix
run of valid frames.

Every READ/WRITE is fail-open: a Redis error counts, logs once, and
reads as a miss -- the serving loop must never stall on the shared
tier. Errors also open a backoff window (exponential, capped) during
which the tier is not consulted at all: a down Redis must not tax every
admission with a fresh connect timeout.

The epoch is read (and cached for ``epoch_refresh_s``) because it is
part of every key. An adapter hot-swap (``invalidate_adapter``) bumps
the adapter's epoch with INCRBY, renaming its namespace for every
replica at once; that bump is the one fail-CLOSED path: if it cannot
reach Redis, the adapter's shared reads and writes stay off
(``_pending_bumps``) until a later bump succeeds, retried at its next
consult. The per-shard frames of mesh engines with tensor-parallel
serving come with meshes (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import time

import numpy as np

from .quant import HostKV, KVLayout, concat_blocks, decode_block, encode_block
from .radix import chain_hashes

NAMESPACE = "gofr:kv"
# cap on remembered already-written block hashes (write-once dedup);
# overflow just forgets -- a duplicate SET is wasteful, never wrong
_WRITTEN_CAP = 8192
# error backoff: first failure pauses consults for _BACKOFF_S, doubling
# per consecutive failure up to the cap; any success resets
_BACKOFF_S = 1.0
_BACKOFF_CAP_S = 30.0


class RedisTier:
    tier = "t2"

    def __init__(self, client, fingerprint: str, layout: KVLayout,
                 block: int = 16, ttl_s: float = 300.0,
                 epoch_refresh_s: float = 5.0, logger=None,
                 namespace: str = NAMESPACE):
        self.client = client
        self.fingerprint = fingerprint
        self.layout = layout
        self.block = int(block)
        self.ttl_s = float(ttl_s)
        self.epoch_refresh_s = float(epoch_refresh_s)
        self.logger = logger
        self.ns = namespace
        self._epochs: dict[int, tuple[int, float]] = {}  # adapter -> (ep, t)
        self._written: set[tuple[int, int, bytes]] = set()
        self._pending_bumps: set[int] = set()  # fail-closed invalidations
        self._down_until = 0.0
        self._backoff = _BACKOFF_S
        self.errors = 0
        self._logged_error = False
        self.blocks_put = 0
        self.blocks_got = 0
        self.bytes_put = 0
        self.bytes_got = 0
        self.checksum_rejects = 0

    # -- keys / epoch --------------------------------------------------------
    def _epoch_key(self, adapter: int) -> str:
        return f"{self.ns}:{self.fingerprint}:ep:{adapter}"

    def _block_key(self, adapter: int, epoch: int, h: bytes) -> str:
        return f"{self.ns}:{self.fingerprint}:{adapter}:{epoch}:{h.hex()}"

    def _epoch(self, adapter: int) -> int:
        if adapter in self._pending_bumps:
            # a past invalidation never reached Redis: the shared
            # namespace still holds pre-swap KV under the old epoch, so
            # the adapter stays fail-CLOSED until the bump lands (an
            # error here is the caller's miss)
            ep = int(self.client.incr(self._epoch_key(adapter)))
            self._pending_bumps.discard(adapter)
            self._epochs[adapter] = (ep, time.monotonic())
            self._ok()
            return ep
        cached = self._epochs.get(adapter)
        now = time.monotonic()
        if cached is not None and now - cached[1] < self.epoch_refresh_s:
            return cached[0]
        raw = self.client.get(self._epoch_key(adapter))
        ep = int(raw) if raw else 0
        self._epochs[adapter] = (ep, now)
        self._ok()
        return ep

    @property
    def available(self) -> bool:
        """False inside the post-error backoff window: the manager skips
        the tier entirely so a down Redis costs admissions nothing (no
        connect attempt, no counter noise)."""
        return time.monotonic() >= self._down_until

    def _ok(self) -> None:
        self._backoff = _BACKOFF_S
        self._down_until = 0.0
        # re-arm the once-per-outage log: a LATER outage must be
        # visible, only repeats within one outage are squelched
        self._logged_error = False

    def _fail(self, op: str, e: Exception) -> None:
        self.errors += 1
        self._down_until = time.monotonic() + self._backoff
        self._backoff = min(self._backoff * 2, _BACKOFF_CAP_S)
        if self.logger is not None and not self._logged_error:
            self._logged_error = True  # once: a down Redis would spam
            self.logger.warn({"event": "kvcache redis tier error "
                              "(fail-open: reads as miss)",
                              "op": op, "error": repr(e)})

    # -- tier API ------------------------------------------------------------
    def match(self, prompt: np.ndarray, adapter: int = 0
              ) -> "tuple[int, HostKV | None]":
        """(matched_tokens, kv): the longest run of consecutive valid
        shared blocks from position 0; (0, None) on miss or error."""
        nb = len(prompt) // self.block
        if nb == 0 or not self.available:
            return 0, None
        try:
            ep = self._epoch(adapter)
            hashes = list(chain_hashes(prompt, self.block, adapter))
            raw = self.client.mget(*[self._block_key(adapter, ep, h)
                                     for h in hashes])
            self._ok()
        except Exception as e:  # noqa: BLE001 — fail-open by contract
            self._fail("match", e)
            return 0, None
        blocks: list[HostKV] = []
        for d in raw:
            kv = decode_block(d, self.layout) if d is not None else None
            if kv is None or kv.plen != self.block:
                # an integrity reject is a PRESENT frame that failed
                # decode (or carries the wrong plen); a merely-absent
                # block is routine TTL/eviction churn
                if d is not None:
                    self.checksum_rejects += 1
                break
            blocks.append(kv)
            self.bytes_got += len(d)
        if not blocks:
            return 0, None
        self.blocks_got += len(blocks)
        return len(blocks) * self.block, concat_blocks(blocks)

    def pending_put_len(self, key: np.ndarray, adapter: int = 0) -> int:
        """Token positions a put() for ``key`` would actually read: up
        to the END of the last full block this replica hasn't written
        this epoch (0 = nothing to write). The engine calls this BEFORE
        the device-to-host copy that feeds put(), so an already-shared
        prefix costs no copy at all and a partially shared one copies
        only through the last unwritten block."""
        nb = len(key) // self.block
        if nb == 0 or not self.available:
            return 0
        try:
            ep = self._epoch(adapter)
        except Exception as e:  # noqa: BLE001
            self._fail("pending", e)
            return 0
        last = 0
        for i, h in enumerate(chain_hashes(key, self.block, adapter,
                                           limit=nb)):
            if (adapter, ep, h) not in self._written:
                last = i + 1
        return last * self.block

    def put(self, key: np.ndarray, adapter: int, kv: HostKV) -> int:
        """Write-through the FULL blocks of a newly stored prefix; the
        trailing partial block stays replica-local (it has no chain
        hash). Returns blocks written. One pipeline, one round trip."""
        nb = min(len(key), kv.plen) // self.block
        if nb == 0 or not self.available:
            return 0
        try:
            ep = self._epoch(adapter)
            if len(self._written) > _WRITTEN_CAP:
                self._written.clear()
            pipe = self.client.pipeline()
            wrote = []
            for i, h in enumerate(chain_hashes(key, self.block, adapter,
                                               limit=nb)):
                seen = (adapter, ep, h)
                if seen in self._written:
                    continue
                frame = encode_block(kv.slice_tokens(i * self.block,
                                                     (i + 1) * self.block))
                pipe.command("SET", self._block_key(adapter, ep, h), frame,
                             "PX", int(self.ttl_s * 1000))
                wrote.append((seen, len(frame)))
            if not wrote:
                return 0
            replies = pipe.execute()
            self._ok()
        except Exception as e:  # noqa: BLE001
            self._fail("put", e)
            return 0
        # the pipeline returns per-command ERROR REPLIES in-band (e.g.
        # -OOM at maxmemory/noeviction, -READONLY on a failed-over
        # replica): a failed SET must NOT enter _written, or
        # pending_put_len would report the block shared forever while
        # no replica can ever read it
        ok = 0
        for (seen, size), reply in zip(wrote, replies):
            if reply != "OK":
                self._fail("put-reply", reply if isinstance(reply, Exception)
                           else RuntimeError(repr(reply)))
                continue
            self._written.add(seen)
            self.bytes_put += size
            ok += 1
        self.blocks_put += ok
        return ok

    def invalidate_adapter(self, adapter: int) -> None:
        """Bump the adapter's epoch: renames the key namespace for every
        replica sharing this Redis; stale blocks TTL out. Fail-CLOSED:
        if the bump cannot reach Redis, the old-epoch namespace still
        holds pre-swap KV, so the adapter's shared reads AND writes stay
        off until a later bump succeeds (retried from ``_epoch`` at the
        next consult)."""
        adapter = int(adapter)
        try:
            ep = self.client.incr(self._epoch_key(adapter))
            self._epochs[adapter] = (int(ep), time.monotonic())
            self._pending_bumps.discard(adapter)
            self._ok()
        except Exception as e:  # noqa: BLE001
            self._fail("invalidate", e)
            self._pending_bumps.add(adapter)
            self._epochs.pop(adapter, None)
        self._written = {w for w in self._written if w[0] != adapter}

    def stats(self) -> dict:
        return {"blocks_put": self.blocks_put, "blocks_got": self.blocks_got,
                "shards": 1,
                "bytes_put": self.bytes_put, "bytes_got": self.bytes_got,
                "errors": self.errors,
                "checksum_rejects": self.checksum_rejects,
                "available": self.available,
                "pending_bumps": len(self._pending_bumps),
                "ttl_s": self.ttl_s}
