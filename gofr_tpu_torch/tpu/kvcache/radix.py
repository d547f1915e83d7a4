"""Block-hashed radix index: O(len) prefix lookup over stored prompts
(the port's own copy of the JAX package's tpu/kvcache/radix.py).

The chain hashes are bit-equal to JAX's: the resume token of ``POST
/generate`` names the same chain on either package, and the T2 Redis
tier keys its blocks by them, so a port replica and a JAX replica
resume and warm each other.

Block-granular content hashing (vLLM's PagedAttention block reuse,
SGLang's RadixAttention): split the token stream into fixed B-token
blocks, give block i the CHAIN hash h_i = H(h_{i-1} || tokens_i) -- so
a block's identity encodes its whole left context -- and walk a tree
keyed by those hashes. Lookup cost is one hash + one dict probe per
prompt block, independent of how many entries are stored.

Entries are registered on EVERY node along their full-block path, so
the deepest node a prompt walk reaches holds exactly the entries that
share at least that many full blocks with it. The final partial block
(and the sub-block tail of short prompts) is resolved by a direct LCP
compare against a bounded set of MRU candidates at that node.

Adapters get separate roots: KV flows through an adapter's wk/wv, so
a prefix stored under one adapter must never match another.
"""

from __future__ import annotations

import hashlib
import heapq
import itertools

import numpy as np

# versioned salt: a format change must never collide with old chains
# (the Redis tier persists these hashes across process generations)
CHAIN_SALT = b"gofr-kvcache-v1"

_EIDS = itertools.count(1)


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


def lcp(a: np.ndarray, b: np.ndarray) -> int:
    """Length of the longest common prefix of two int token arrays."""
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if len(neq) else n


class Entry:
    """One stored prefix. ``payload`` is tier-specific (T0: pool row
    int; T1: a HostKV snapshot); ``tick`` is the owning tier's LRU
    clock. ``key`` is the full stored token sequence: ground truth for
    the token-granular part of a match."""

    __slots__ = ("eid", "key", "adapter", "payload", "tick")

    def __init__(self, key: np.ndarray, adapter: int, payload=None):
        self.eid = next(_EIDS)
        self.key = np.asarray(key, np.int32).copy()
        self.adapter = int(adapter)
        self.payload = payload
        self.tick = 0

    @property
    def row(self) -> int:
        return self.payload  # T0 convention: payload IS the pool row

    def __repr__(self) -> str:
        return (f"Entry(eid={self.eid}, len={len(self.key)}, "
                f"adapter={self.adapter})")


class _Node:
    __slots__ = ("children", "entries")

    def __init__(self):
        self.children: dict[bytes, _Node] = {}
        self.entries: dict[int, Entry] = {}  # eid -> entry through here


class RadixIndex:
    """The tree. Tiers are only ever mutated from the engine's
    serving-loop thread."""

    # candidates LCP-compared at the deepest matched node. Registration
    # on every path node means the set at that node already shares the
    # maximal full-block prefix; among them the true longest match can
    # only be missed if more than this many are fresher
    MAX_CANDIDATES = 16

    def __init__(self, block: int = 16):
        self.block = max(1, int(block))
        self._roots: dict[int, _Node] = {}

    def __len__(self) -> int:
        return sum(len(r.entries) for r in self._roots.values())

    def entries_for(self, adapter: int) -> int:
        root = self._roots.get(int(adapter))
        return len(root.entries) if root is not None else 0

    # -- mutation ------------------------------------------------------------
    def insert(self, entry: Entry) -> None:
        root = self._roots.setdefault(entry.adapter, _Node())
        node = root
        node.entries[entry.eid] = entry
        for h in chain_hashes(entry.key, self.block, entry.adapter):
            node = node.children.setdefault(h, _Node())
            node.entries[entry.eid] = entry

    def remove(self, entry: Entry) -> None:
        root = self._roots.get(entry.adapter)
        if root is None or entry.eid not in root.entries:
            return
        del root.entries[entry.eid]
        path = [root]
        node = root
        for h in chain_hashes(entry.key, self.block, entry.adapter):
            node = node.children.get(h)
            if node is None:
                break
            node.entries.pop(entry.eid, None)
            path.append(node)
        # prune childless, entryless suffix nodes, so dead chains do not
        # accumulate under eviction churn
        hashes = list(chain_hashes(entry.key, self.block, entry.adapter,
                                   limit=len(path) - 1))
        for i in range(len(path) - 1, 0, -1):
            child = path[i]
            if child.entries or child.children:
                break
            del path[i - 1].children[hashes[i - 1]]

    def invalidate_adapter(self, adapter: int) -> int:
        root = self._roots.pop(int(adapter), None)
        return len(root.entries) if root is not None else 0

    def clear(self) -> int:
        n = len(self)
        self._roots.clear()
        return n

    # -- lookup --------------------------------------------------------------
    def match(self, prompt: np.ndarray, adapter: int = 0
              ) -> tuple[Entry | None, int]:
        """(entry, matched_len) for the longest stored prefix sharing a
        prefix with ``prompt``. Pure: no counter or LRU side effects
        (the owning tier reports usability). (None, 0) when nothing
        matches a single token."""
        root = self._roots.get(int(adapter))
        if root is None or not root.entries:
            return None, 0
        prompt = np.asarray(prompt, np.int32)
        node, depth = root, 0
        for h in chain_hashes(prompt, self.block, adapter):
            child = node.children.get(h)
            if child is None or not child.entries:
                break
            node, depth = child, depth + 1
        base = depth * self.block
        best, best_len = None, 0
        cands = heapq.nlargest(self.MAX_CANDIDATES, node.entries.values(),
                               key=lambda e: e.tick)
        for e in cands:
            # entries at this node share >= base tokens (chain-hash
            # equality); size the match at token granularity from there
            m = base + lcp(e.key[base:], prompt[base:])
            if m > best_len:
                best, best_len = e, m
                if m >= len(prompt):
                    break
        return (best, best_len) if best is not None and best_len > 0 \
            else (None, 0)
