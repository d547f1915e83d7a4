"""The port's paged prefix sharing (gofr_tpu_torch.models.paged_llama.
SharedPrefixIndex and the engine's hit path: the read-back into the
scratch row, the lattice resumed at the match point, the write-back of
the fresh blocks only, the store after admission, eviction under pool
pressure) against the JAX package's on `tiny`, with the same seeded
weights carried across through ``from_jax_params``, on the CPU.

The index is held against JAX's under one scripted sequence of match,
accept, reject, store, evict and clear (the same results and stats).
The engines serve the same prompts with the same rows: hit streams are
token-identical to the JAX paged engine's (int8 and dense pools), and
``stats()["prefix_cache"]`` is equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.models.paged_llama import BlockAllocator as JAlloc
from gofr_tpu.models.paged_llama import SharedPrefixIndex as JIndex
from gofr_tpu.tpu.generator import GenerationEngine as JaxEngine
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.models.paged_llama import BlockAllocator, \
    SharedPrefixIndex
from gofr_tpu_torch.tpu import (UNPORTED_ROWS, GenerationEngine,
                                from_jax_params, new_engine_from_config)

JCFG = JAX_CONFIGS["tiny"]
CFG = LLAMA_CONFIGS["tiny"]
KV = {"int8": (torch.int8, jnp.int8), "dense": (None, None)}
# tests/test_paged.py's prefix engine: 2 slots, 64 positions, buckets 8
# and 16, blocks of 16, two entries, prompts of 16+ tokens stored
ROWS = dict(slots=2, max_seq=64, prompt_buckets=(8, 16),
            paged_block_size=16, prefix_cache_slots=2, prefix_store_min=16)


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JCFG, jax.random.PRNGKey(1))
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _port(weights, kv="int8", **kw):
    args = dict(ROWS, kv_dtype=KV[kv][0], device="cpu")
    args.update(kw)
    return GenerationEngine(CFG, weights[1], **args)


def _jax(weights, kv="int8", **kw):
    args = dict(ROWS, kv_dtype=KV[kv][1])
    args.update(kw)
    return JaxEngine(JCFG, weights[0], **args)


def _rand(rng, n):
    return rng.integers(1, CFG.vocab_size, n).tolist()


# -- the index ----------------------------------------------------------------

def _script(alloc_cls, index_cls):
    """One scripted sequence over an allocator and an index: every
    result the index returns, its stats and the allocator's free count
    along the way."""
    a = alloc_cls(12)
    idx = index_cls(3, a, block_size=4)
    log = []

    def note(tag, value):
        log.append((tag, value, a.free_blocks, idx.stats(), idx.version))

    p1 = np.arange(1, 11, dtype=np.int32)              # 2.5 blocks
    b1 = a.alloc(3)
    idx.store(p1, b1, adapter=0)
    a.free(b1)                                         # the slot retires
    note("store p1", len(idx))
    note("match p1+2", idx.match(np.concatenate([p1, [99, 98]]), 0))
    note("match partial", idx.match(
        np.concatenate([p1[:6], [77] * 4]).astype(np.int32), 0))
    note("match whole", idx.match(p1[:8], 0))          # >= 1 recomputes
    note("match adapter 1", idx.match(p1, 1))
    blocks, m = idx.match(np.concatenate([p1, [5]]), 0)
    a.ref(blocks)                                      # a slot shares them
    idx.accept(blocks)
    note("accept", (blocks, m))
    idx.reject()
    note("covered p1", idx.covered(p1, 0))
    note("covered p1[:3]", idx.covered(p1[:3], 0))
    note("covered other", idx.covered(np.arange(50, 60, dtype=np.int32), 0))
    for start in (50, 70, 90):                         # past capacity
        p = np.arange(start, start + 9, dtype=np.int32)
        b = a.alloc(3)
        idx.store(p, b, adapter=int(start == 70))
        a.free(b)
        note(f"store {start}", len(idx))
    note("invalidate adapter 1", idx.invalidate_adapter(1))
    while idx.evict_one():                             # sole holders first
        note("evict", len(idx))
    note("evict empty", idx.evict_one())
    a.free(blocks)                                     # the sharer retires
    b = a.alloc(2)
    idx.store(np.arange(1, 10, dtype=np.int32), b, adapter=0)
    a.free(b)
    note("clear", idx.clear())
    return log


def test_the_index_follows_jax_under_one_scripted_sequence():
    port, ref = _script(BlockAllocator, SharedPrefixIndex), \
        _script(JAlloc, JIndex)
    assert len(port) == len(ref) == 17
    for got, want in zip(port, ref):
        assert got == want, got[0]
    # the sequence ends with every block back in the pool
    assert port[-1][2] == 11


@pytest.mark.parametrize("holders,reclaimable", [([], True), ([0], False)])
def test_eviction_prefers_an_entry_that_frees_its_blocks(holders,
                                                         reclaimable):
    """The LRU entry goes first unless a live slot still holds its
    blocks; then a newer sole-held entry goes instead (as JAX's
    ``sole_holder`` choice)."""
    results = []
    for alloc_cls, index_cls in ((BlockAllocator, SharedPrefixIndex),
                                 (JAlloc, JIndex)):
        a = alloc_cls(10)
        idx = index_cls(4, a, block_size=4)
        stored = []
        for start in (1, 50):
            b = a.alloc(3)
            idx.store(np.arange(start, start + 9, dtype=np.int32), b)
            a.free(b)
            stored.append(b[:2])
        for i in holders:
            a.ref(stored[i])
        before = a.free_blocks
        assert idx.evict_one()
        old_alive = idx.match(np.arange(1, 11, dtype=np.int32), 0)[1] > 0
        results.append((a.free_blocks - before, old_alive,
                        a.sole_holder(stored[0])))
    assert results[0] == results[1]
    assert results[0][1] == (not reclaimable)


# -- the engine ---------------------------------------------------------------

@pytest.mark.parametrize("kv", ["int8", "dense"])
def test_hits_stream_the_jax_paged_engines_tokens(weights, kv):
    """tests/test_paged.py's hit case on both engines: a stored prompt,
    then a full hit, a partial hit and an exact repeat; every stream and
    the prefix stats equal the JAX engine's, and with every slot retired
    only the entries hold blocks."""
    rng = np.random.default_rng(17)
    prefix = _rand(rng, 36)                    # 2 full blocks of 16
    cont = prefix + _rand(rng, 6)
    part = prefix[:20] + _rand(rng, 8)
    outs, stats = [], []
    for make in (_jax, _port):
        eng = make(weights, kv, paged_blocks=13)
        try:
            got = [eng.generate(p, max_new_tokens=6).tokens()
                   for p in (prefix, cont, part, prefix)]
            st = eng.stats()
        finally:
            eng.close()
        outs.append(got)
        stats.append(st)
    assert outs[0] == outs[1]
    assert stats[0]["prefix_cache"] == stats[1]["prefix_cache"]
    pc = stats[1]["prefix_cache"]
    assert pc["hits"] == 3 and pc["entries"] == 1 and pc["blocks_held"] == 2
    assert stats[1]["paged"]["free"] + pc["blocks_held"] == \
        stats[1]["paged"]["blocks"]


def test_a_hit_records_its_tier_and_covered_tokens(weights):
    rng = np.random.default_rng(5)
    prefix = _rand(rng, 40)
    eng = _port(weights, paged_blocks=13)
    try:
        first = eng.generate(prefix, max_new_tokens=2)
        first.tokens()
        hit = eng.generate(prefix + _rand(rng, 7), max_new_tokens=2)
        hit.tokens()
    finally:
        eng.close()
    assert (first.cache_tier, first.cache_tokens) == (None, 0)
    assert (hit.cache_tier, hit.cache_tokens) == ("paged", 32)
    assert hit.prompt_len == 47


def test_an_off_lattice_window_is_a_miss(weights):
    """tests/test_paged.py's case: an 8-token match whose resumed final
    window would pad wider than the 10-token prompt is a miss; the
    stream equals the JAX engine's and no hit is counted."""
    rng = np.random.default_rng(23)
    base = _rand(rng, 16)
    short = base[:8] + _rand(rng, 2)
    outs, stats = [], []
    for make in (_jax, _port):
        eng = make(weights, prompt_buckets=(16,), paged_blocks=9,
                   paged_block_size=8)
        try:
            eng.generate(base, max_new_tokens=2).tokens()
            outs.append(eng.generate(short, max_new_tokens=6).tokens())
            stats.append(eng.stats()["prefix_cache"])
        finally:
            eng.close()
    assert outs[0] == outs[1]
    assert stats[0] == stats[1]
    assert stats[1]["hits"] == 0


def test_needs_lattice_defers_a_hit_as_jax_does(weights):
    """A paged hit runs the lattice from the match point, so the
    in-flight admission pass defers it like a long prompt; the verdict
    is memoized on the request under the index's version."""
    from gofr_tpu.tpu.generator import GenStream as JStream
    from gofr_tpu.tpu.generator import _Request as JRequest
    from gofr_tpu_torch.tpu.generator import GenStream, _Request

    rng = np.random.default_rng(9)
    prefix = _rand(rng, 36)
    pool = dict(paged_blocks=13, paged_block_size=8)
    jeng, teng = _jax(weights, **pool), _port(weights, **pool)
    verdicts = []
    try:
        for eng in (jeng, teng):
            eng.generate(prefix, max_new_tokens=2).tokens()
        for p in (prefix + _rand(rng, 3), _rand(rng, 12), prefix[:16],
                  prefix[:9], prefix[:8] + _rand(rng, 2), prefix[:7]):
            p = np.asarray(p)
            j = jeng._needs_lattice(JRequest(JStream(0, jeng),
                                             p.astype(np.int32), 4, 0.0, 0,
                                             None))
            req = _Request(GenStream(0), p, 4, 0.0, 0, None, 0)
            t = teng._needs_lattice(req)
            assert j == t, len(p)
            verdicts.append(t)
            if len(p) <= 16:   # past the chunk budget: no index peek
                assert req.lattice_peek == (teng._prefix_idx.version, t)
                assert teng._needs_lattice(req) == t
    finally:
        jeng.close()
        teng.close()
    # long, miss, three hits (16, 9 and 10 tokens over 8-token blocks),
    # no full block to share
    assert verdicts == [True, False, True, True, True, False]


def _shared_bytes(eng, blocks):
    c = eng.cache
    return [t[:, blocks].clone() for t in (c.k, c.v, c.k_scale, c.v_scale)]


def test_a_hit_under_interleaved_decode_leaves_the_shared_blocks(weights):
    """tests/test_paged.py's case: a hit whose remainder needs mid chunks
    admits while another slot decodes (the decode blocks between chunks
    step the new slot at its stale cursor). The shared blocks' bytes are
    the same before and after, and every stream equals the JAX
    engine's."""
    rng = np.random.default_rng(29)
    prefix = _rand(rng, 33)                    # 2 full blocks
    long_hit = prefix + _rand(rng, 20)         # 53: mid chunks after 32
    busy_prompt = _rand(rng, 5)
    outs = []
    for make in (_jax, _port):
        eng = make(weights, paged_blocks=11)
        try:
            got = [eng.generate(prefix, max_new_tokens=4).tokens()]
            if make is _port:
                shared = list(eng._prefix_idx._entries[0]["blocks"])
                before = _shared_bytes(eng, shared)
            busy = eng.generate(busy_prompt, max_new_tokens=48)
            hit = eng.generate(long_hit, max_new_tokens=4)
            got.append(hit.tokens())
            busy.cancel()
            list(busy)
            got.append(eng.generate(prefix, max_new_tokens=4).tokens())
            hits = eng.stats()["prefix_cache"]["hits"]
            if make is _port:
                after = _shared_bytes(eng, shared)
                assert hit.chunks >= 1
        finally:
            eng.close()
        outs.append((got, hits))
    assert outs[0] == outs[1]
    assert outs[1][1] >= 2
    assert all(torch.equal(x, y) for x, y in zip(before, after))


def test_entries_evict_under_pool_pressure_before_truncation(weights):
    """tests/test_paged.py's case: a stored entry holds a block that a
    long stream later needs; the entry evicts and the stream is not
    truncated, as on the JAX engine."""
    rng = np.random.default_rng(19)
    p1, p2 = _rand(rng, 16), _rand(rng, 16)
    outs = []
    for make in (_jax, _port):
        eng = make(weights, slots=1, paged_blocks=5)
        try:
            eng.generate(p1, max_new_tokens=2).tokens()
            entries = eng.stats()["prefix_cache"]["entries"]
            got = eng.generate(p2, max_new_tokens=40).tokens()
            st = eng.stats()
        finally:
            eng.close()
        outs.append((entries, got, st["paged"]["evictions"],
                     st["prefix_cache"]))
    assert outs[0] == outs[1]
    entries, got, truncations, _ = outs[1]
    assert entries == 1 and len(got) == 40 and truncations == 0


def test_the_prefix_rows(weights):
    """TPU_PREFIX_CACHE and TPU_PREFIX_MIN build the index on a paged
    engine (the store minimum defaults to the largest bucket, as in
    JAX); on a contiguous engine TPU_PREFIX_CACHE builds the kv-cache
    tiers instead, with T0 rows and radix blocks from the rows
    (TPU_KVCACHE_* are honoured since the tiers were ported)."""
    assert "TPU_PREFIX_CACHE" not in UNPORTED_ROWS
    assert "TPU_PREFIX_MIN" not in UNPORTED_ROWS
    assert "TPU_KVCACHE_BLOCK" not in UNPORTED_ROWS
    rows = {"TPU_MODEL": "tiny", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "64",
            "TPU_DECODE_BLOCK": "2", "TPU_SEQ_BUCKETS": "8,16",
            "TPU_PAGED_BLOCKS": "13", "TPU_PAGED_BLOCK": "16"}
    for extra, slots, store_min in (({"TPU_PREFIX_CACHE": "3"}, 3, 16),
                                    ({"TPU_PREFIX_CACHE": "2",
                                      "TPU_PREFIX_MIN": "20"}, 2, 20)):
        eng = new_engine_from_config(MapConfig({**rows, **extra}),
                                     device="cpu")
        try:
            gen = eng.generator
            assert gen.stats()["prefix_cache"]["slots"] == slots
            assert gen._store_min == store_min
            prompt = list(range(1, 19))
            eng.generate(prompt, max_new_tokens=2).tokens()
            assert gen.stats()["prefix_cache"]["entries"] == \
                (1 if len(prompt) >= store_min else 0)
        finally:
            eng.close()
    contiguous = {k: v for k, v in rows.items() if "PAGED" not in k}
    eng = new_engine_from_config(MapConfig({**contiguous,
                                            "TPU_PREFIX_CACHE": "2",
                                            "TPU_KVCACHE_BLOCK": "8"}),
                                 device="cpu")
    try:
        st = eng.generator.kvcache_stats()
        assert (st["kind"], st["slots"], st["block"]) == \
            ("hierarchical", 2, 8)
    finally:
        eng.close()
