"""Hierarchical prefix-KV cache: radix index + host offload + Redis (the
port's own copy of gofr_tpu/tpu/kvcache/).

The subsystem behind a contiguous ``GenerationEngine``'s prefix reuse
(the engine owns device memory and every row copy; this package owns
indexing, host snapshots, and the shared tier):

  T0  device pool rows, block-hash radix indexed  (hbm.HBMTier)
  T1  host-RAM spill of LRU-evicted rows          (host.HostTier)
  T2  Redis-shared int8 blocks across replicas    (redis_tier.RedisTier)

behind one facade (manager.CacheManager). The T2 frames, their keys and
the model fingerprint are the JAX package's byte for byte, so port and
JAX replicas of one model warm each other through one Redis.

Config (read by ``new_engine_from_config`` via options_from_config):

  TPU_KVCACHE_BLOCK        radix block size in tokens (default 16)
  TPU_KVCACHE_HOST_MB      T1 host-RAM budget in MiB (default 0 = off)
  TPU_KVCACHE_REDIS        "true" enables the shared tier over the
                           port's Redis client (REDIS_HOST/PORT)
  TPU_KVCACHE_REDIS_TTL_S  shared-block TTL seconds (default 300)
  TPU_KVCACHE_REDIS_TIMEOUT_S  shared-tier socket timeout (default 0.25)
  TPU_KVCACHE_EPOCH_REFRESH_S  adapter-epoch staleness bound (default 5)
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import torch

from .hbm import HBMTier
from .host import HostTier
from .manager import CacheManager, Match, clamp_restore_len
from .quant import (HostKV, KVLayout, ShardedHostKV, decode_block,
                    dense_hostkv, encode_block)
from .radix import (CHAIN_SALT, Entry, RadixIndex, chain_hashes,
                    first_block_hash)
from .redis_tier import RedisTier

__all__ = [
    "CacheManager", "Match", "clamp_restore_len",
    "HBMTier", "HostTier", "RedisTier",
    "HostKV", "KVLayout", "ShardedHostKV", "dense_hostkv", "encode_block",
    "decode_block",
    "CHAIN_SALT", "Entry", "RadixIndex", "chain_hashes", "first_block_hash",
    "KVCacheOptions", "options_from_config", "model_fingerprint",
]


@dataclasses.dataclass
class KVCacheOptions:
    """Tier wiring handed to the engine. ``redis`` is a live
    RedisClient (or anything with get/mget/pipeline/close): the engine
    takes ownership and closes it on engine.close() (or at once when it
    builds no cache manager); None keeps the shared tier off."""

    block: int = 16
    host_mb: int = 0
    redis: Any = None
    redis_ttl_s: float = 300.0
    epoch_refresh_s: float = 5.0


def options_from_config(cfg, logger=None, metrics=None) -> KVCacheOptions:
    """TPU_KVCACHE_* -> options. The Redis tier is built on the port's
    own client and degrades gracefully: an unreachable Redis logs once
    and leaves the tier off (a down datasource never blocks startup)."""
    redis = None
    if cfg.get_bool("TPU_KVCACHE_REDIS"):
        try:
            from ...datasource.redisclient import RedisClient

            # a DEDICATED short socket timeout, not the datasource
            # default 5 s: T2 consults run on the serving-loop thread,
            # and a merely-degraded Redis must trip the tier's
            # fail-open error path instead of freezing every live
            # stream for seconds per lookup
            redis = RedisClient(
                host=cfg.get("REDIS_HOST") or "localhost",
                port=cfg.get_int("REDIS_PORT", 6379),
                logger=logger, metrics=metrics,
                timeout=cfg.get_float("TPU_KVCACHE_REDIS_TIMEOUT_S", 0.25))
        except OSError as e:
            if logger is not None:
                logger.warn({"event": "kvcache redis tier disabled "
                             "(connect failed)", "error": repr(e)})
    return KVCacheOptions(
        block=cfg.get_int("TPU_KVCACHE_BLOCK", 16),
        host_mb=cfg.get_int("TPU_KVCACHE_HOST_MB", 0),
        redis=redis,
        redis_ttl_s=cfg.get_float("TPU_KVCACHE_REDIS_TTL_S", 300.0),
        epoch_refresh_s=cfg.get_float("TPU_KVCACHE_EPOCH_REFRESH_S", 5.0))


def _leaves(tree) -> list:
    """The array leaves of a parameter tree in ``jax.tree_util``'s
    order: dict keys sorted, a ``QuantizedLinear`` as (w, scale), None
    dropped. The JAX package samples the same leaves by position."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for node in tree for leaf in _leaves(node)]
    return [tree]


def model_fingerprint(cfg, params=None, extra: str = "") -> str:
    """Short stable id for (architecture, weights, cache dtype): the T2
    key prefix that keeps replicas with different models from ever
    exchanging KV, equal to the JAX package's for the same weights.
    Weights contribute 8 values from each of four leaves spread ACROSS
    the tree (fine-tunes often share a frozen embedding table, first in
    tree order), as float32; on any failure the config-only hash still
    isolates architectures."""
    h = hashlib.sha256()
    h.update(repr((cfg.name, cfg.vocab_size, cfg.dim, cfg.n_layers,
                   cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                   cfg.rope_theta)).encode())
    h.update(extra.encode())
    if params is not None:
        try:
            leaves = _leaves(params)
            picks = sorted({0, len(leaves) // 3, (2 * len(leaves)) // 3,
                            len(leaves) - 1})
            # one host copy for all sampled values
            sample = torch.cat([leaves[i].reshape(-1)[:8].float()
                                for i in picks]).cpu()
            h.update(sample.numpy().tobytes())
        except (AttributeError, IndexError, RuntimeError, TypeError):
            pass
    return h.hexdigest()[:16]


def dtype_name(dtype: torch.dtype) -> str:
    """A cache dtype as the JAX package's fingerprint spells it (numpy's
    names: int8, bfloat16, float32)."""
    return str(dtype).replace("torch.", "")
