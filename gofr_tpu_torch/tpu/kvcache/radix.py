"""Block-chain hashing of token prefixes (the port's own copy of
``chain_hashes`` and ``first_block_hash`` from the JAX package's
tpu/kvcache/radix.py, bit-equal to it: the resume token of ``POST
/generate`` names the same chain on either package, so a client or a
gateway can resume a stream of one on a replica of the other).
"""

from __future__ import annotations

import hashlib

import numpy as np

# versioned salt: a format change must never collide with old chains
# (the Redis tier persists these hashes across process generations)
CHAIN_SALT = b"gofr-kvcache-v1"


def chain_hashes(tokens: np.ndarray, block: int, adapter: int = 0,
                 limit: int | None = None):
    """Chain hashes for the FULL blocks of ``tokens`` (the trailing
    partial block has no hash — it is matched by LCP compare). Yields
    lazily so a tree walk that dead-ends early never hashes the rest
    of a long prompt."""
    n = len(tokens) // block
    if limit is not None:
        n = min(n, limit)
    h = hashlib.sha256(CHAIN_SALT + str(int(adapter)).encode()).digest()
    toks = np.ascontiguousarray(tokens[:n * block], dtype=np.int32)
    for i in range(n):
        h = hashlib.sha256(h + toks[i * block:(i + 1) * block].tobytes()
                           ).digest()
        yield h


def first_block_hash(tokens, block: int = 16, adapter: int = 0) -> bytes:
    """The chain hash of the FIRST full block of ``tokens`` — the
    prefix-affinity routing key of the JAX package's gateway: every
    multi-turn continuation of a conversation shares its first ``block``
    tokens,
    so hashing exactly one block gives a key that is STABLE across
    turns while still spreading distinct sessions. Same salt, same
    chaining, same adapter separation as the radix index and the T2
    fingerprint keys — the gateway's notion of "where this prefix is
    warm" can never drift from the cache's notion of identity.

    Prompts shorter than one block (no full block to chain-hash) fall
    back to hashing the whole short prompt under the same salt: still
    deterministic, still adapter-separated, just turn-UNSTABLE — the
    router treats those as affinity-less and balances them by
    pressure, which is the right call for prompts too short to be
    worth cache affinity anyway."""
    tokens = np.asarray(tokens, np.int32).reshape(-1)
    for h in chain_hashes(tokens, block, adapter, limit=1):
        return h
    seed = hashlib.sha256(CHAIN_SALT + str(int(adapter)).encode()).digest()
    return hashlib.sha256(
        seed + np.ascontiguousarray(tokens).tobytes()).digest()
