"""The port's admission path (gofr_tpu_torch.tpu.generator: prompt
buckets, the chunked-prefill lattice interleaved with decode, the paged
scratch row) against the JAX package's GenerationEngine on `tiny` with the
same weights, on the CPU, where each admission dispatch runs its function
eagerly (on the card each is a replay of a graph captured at
construction).

Both engines run on the same prompt buckets and chunk budget. Prompts
past the largest bucket take the lattice, whose mid chunks read the
earlier positions back from the cache: on an int8 cache that is the
quantized KV, so a port that prefilled such a prompt in one pass would
stream other tokens than JAX (the first case). Greedy streams are
token-exact; sampled streams are too (JAX's threefry bits, as in
tests/test_torch_generator.py). Int8 codes of the admitted rows are
bit-equal to JAX's.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.tpu.generator import GenerationEngine as JaxEngine
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.tpu import (GenerationEngine, from_jax_params,
                                new_engine_from_config)
from gofr_tpu_torch.tpu import UNPORTED_ROWS

JCFG = JAX_CONFIGS["tiny"]
CFG = LLAMA_CONFIGS["tiny"]
BUCKETS = (16, 32)
MAX_SEQ = 128
NEW = 24
# three prompts past the largest bucket: 2, 2 and 3 mid chunks of 32
LONG = [np.random.default_rng(3).integers(1, CFG.vocab_size, n).tolist()
        for n in (70, 90, 100)]


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JCFG, jax.random.PRNGKey(7))
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _jax(weights, kv="int8", **kw):
    args = dict(slots=4, max_seq=MAX_SEQ, decode_block=4, decode_pipeline=1,
                prompt_buckets=BUCKETS,
                kv_dtype=jnp.int8 if kv == "int8" else None)
    args.update(kw)
    return JaxEngine(JCFG, weights[0], **args)


def _port(weights, kv="int8", **kw):
    args = dict(slots=4, max_seq=MAX_SEQ, decode_block=4, decode_pipeline=1,
                prompt_buckets=BUCKETS,
                kv_dtype=torch.int8 if kv == "int8" else None, device="cpu")
    args.update(kw)
    return GenerationEngine(CFG, weights[1], **args)


def _serve(eng, prompts, **kw):
    """Submit every prompt, then drain the streams in order."""
    streams = [eng.generate(p, **kw) for p in prompts]
    return [s.tokens() for s in streams], streams


def _both(weights, prompts, engine_kw=None, kv="int8", **kw):
    outs = []
    for make in (_jax, _port):
        eng = make(weights, kv, **(engine_kw or {}))
        try:
            outs.append(_serve(eng, prompts, **kw))
        finally:
            eng.close()
    return outs


def test_long_prompts_on_an_int8_cache_stream_jax_tokens(weights):
    """The repair: on an int8 cache, prompts past the largest bucket run
    the lattice on both engines and stream the same greedy tokens."""
    (want, _), (got, streams) = _both(weights, LONG, max_new_tokens=NEW)
    assert [len(t) for t in got] == [NEW] * 3
    assert got == want
    assert [s.chunks for s in streams] == [2, 2, 3]


@pytest.mark.parametrize("engine_kw,kw,kv", [
    ({}, {}, "dense"),
    ({}, {"temperature": 0.8, "top_k": 0, "seed": 5}, "int8"),
    ({}, {"temperature": 0.8, "top_k": 50, "seed": 6}, "int8"),
    ({"prefill_chunk": 16}, {}, "int8"),
    ({"prefill_chunk": 0}, {}, "int8"),
    ({"prefill_chunk": -1}, {"temperature": 0.8, "top_k": 50, "seed": 7},
     "int8"),
], ids=["dense", "sampled", "sampled-top50", "chunk16", "interleave-off",
        "interleave-off-sampled"])
def test_lattice_streams_equal_jax(weights, engine_kw, kw, kv):
    (want, _), (got, streams) = _both(weights, LONG, engine_kw, kv,
                                      max_new_tokens=NEW, **kw)
    assert [len(t) for t in got] == [NEW] * 3
    assert got == want
    chunk = engine_kw.get("prefill_chunk") or 0
    assert [s.chunks for s in streams] == ([4, 5, 6] if chunk == 16
                                           else [2, 2, 3])


@pytest.mark.parametrize("kv", ["int8", "dense"])
def test_paged_lattice_streams_equal_jax_and_contiguous(weights, kv):
    """A paged engine (T=8) runs the lattice on its scratch row and lands
    it in the slot's blocks: the same tokens as JAX's paged engine and
    as the port's contiguous engine, the pool whole afterwards."""
    pool = {"paged_blocks": 64, "paged_block_size": 8}
    prompts = LONG + [LONG[0][:9], LONG[1][:31]]   # and two bucket prompts
    (want, _), (got, streams) = _both(weights, prompts, pool, kv,
                                      max_new_tokens=NEW)
    dense = _port(weights, kv)
    try:
        rows, _ = _serve(dense, prompts, max_new_tokens=NEW)
    finally:
        dense.close()
    assert got == want == rows
    assert [s.chunks for s in streams] == [2, 2, 3, 0, 0]
    eng = _port(weights, kv, **pool)
    try:
        _serve(eng, prompts, max_new_tokens=NEW)
        assert eng.stats()["paged"]["free"] == 63
        assert not eng._table.any()
    finally:
        eng.close()


# -- bucket admissions ---------------------------------------------------------

EDGES = [1, 15, 16, 17, 32]


@pytest.mark.parametrize("paged", [False, True])
def test_bucket_edges_stream_jax_tokens(weights, paged):
    pool = {"paged_blocks": 40, "paged_block_size": 8} if paged else {}
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, CFG.vocab_size, n).tolist() for n in EDGES]
    (want, _), (got, streams) = _both(weights, prompts, pool,
                                      max_new_tokens=12)
    assert got == want
    assert all(s.chunks == 0 for s in streams)


@pytest.mark.parametrize("paged", [False, True])
def test_bucket_padding_lands_nowhere(weights, paged):
    """One admission per slot, run directly on both engines: the same
    first token, and each prompt's int8 codes at [0, L) bit-equal to
    JAX's (scales rtol 1e-5). Contiguous: nothing is written past the
    prompt's bucket. Paged (T=8): the bucket's ids past the prompt's own
    blocks are the trash block, so no other block of the pool is
    written. (Both packages also write the padded rows [L, bucket) behind
    the cursor; the port's padding KV differs from JAX's, as its flash
    prefill zeroes rows past the length where JAX's leaves masked values;
    neither is ever read.)"""
    from gofr_tpu.tpu.generator import GenStream as JStream
    from gofr_tpu.tpu.generator import _Request as JRequest
    from gofr_tpu_torch.tpu.generator import GenStream, _Request

    pool = {"paged_blocks": 40, "paged_block_size": 8} if paged else {}
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, CFG.vocab_size, n) for n in EDGES]
    jeng, teng = _jax(weights, slots=5, **pool), _port(weights, slots=5,
                                                       **pool)
    owned, first = [], 1
    try:
        with jeng._device_lock, teng._device_lock:
            for b, p in enumerate(prompts):
                jreq = JRequest(JStream(0, jeng), p.astype(np.int32), 4, 0.0,
                                0, None)
                treq = _Request(GenStream(0), p, 4, 0.0, 0, None, 0)
                if paged:
                    own = list(range(first, first + -(-len(p) // 8)))
                    first += len(own)
                    owned.append(own)
                    want = jeng._paged_admit_prefill(b, jreq, [], 0,
                                                     list(own))
                    got = teng._prefill(b, treq, ([], 0, list(own)))
                else:
                    want = jeng._admit_prefill(b, jreq)
                    got = teng._prefill(b, treq, None)
                assert got[0] == want[0]
                assert got[1] == pytest.approx(want[1], abs=1e-4)
        jc, tc = jeng.cache, teng.cache
        assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist()
        for b, n in enumerate(EDGES):
            pos = np.arange(n)
            if paged:
                ids = np.asarray(owned[b])[pos // 8]
                where = (slice(None), ids, pos % 8)
            else:
                where = (slice(None), b, pos)
            for name in ("k", "v"):
                np.testing.assert_array_equal(
                    getattr(tc, name).numpy()[where],
                    np.asarray(getattr(jc, name))[where])
                np.testing.assert_allclose(
                    getattr(tc, name + "_scale").numpy()[where],
                    np.asarray(getattr(jc, name + "_scale"))[where],
                    rtol=1e-5, atol=0)
            if not paged:
                bucket = 16 if n <= 16 else 32
                assert not tc.k[:, b, bucket:].any()
                assert not tc.k_scale[:, b, bucket:].any()
        if paged:
            assert not tc.k[:, first:].any()
            assert not tc.k_scale[:, first:].any()
    finally:
        jeng.close()
        teng.close()


# -- the interleave -------------------------------------------------------------

def _spy_mid_chunks(eng, on_mid=None):
    """Record the engine's delivered-token count at each mid chunk's
    dispatch (``on_mid(i)`` runs before the i-th)."""
    seen = []
    run = eng._run_admission

    def spy(key):
        if key[0] == "mid":
            if on_mid is not None:
                on_mid(len(seen))
            seen.append(eng.total_tokens)
        return run(key)

    eng._run_admission = spy
    return seen


@pytest.mark.parametrize("chunk", [None, 16, 0])
def test_a_decoding_stream_gets_tokens_between_chunks(weights, chunk):
    """A stream already decoding receives a decode block's tokens between
    each two mid chunks of a long admission (interleave on), and none
    during the lattice with interleave off; its tokens are the same
    either way, and the long stream's are JAX's."""
    eng = _port(weights, prefill_chunk=chunk)
    try:
        short = eng.generate(LONG[0][:6], max_new_tokens=80)
        it = iter(short)
        head = [next(it)]
        seen = _spy_mid_chunks(eng)
        long_toks = eng.generate(LONG[2], max_new_tokens=NEW).tokens()
        short_toks = head + list(it)
    finally:
        eng.close()
    jeng = _jax(weights, prefill_chunk=chunk)
    try:
        want_long = jeng.generate(LONG[2], max_new_tokens=NEW).tokens()
        want_short = jeng.generate(LONG[0][:6], max_new_tokens=80).tokens()
    finally:
        jeng.close()
    assert long_toks == want_long and short_toks == want_short
    assert len(seen) == (6 if chunk == 16 else 3)
    steps = np.diff(seen)
    if chunk == 0:
        assert not steps.any()
    else:
        assert (steps > 0).all()


@pytest.mark.parametrize("chunk", [None, 0])
def test_a_short_arrival_is_served_before_the_long_prompt(weights, chunk):
    """A short request arriving during a lattice is admitted between
    chunks and gets its first token before the long prompt's (interleave
    on); with interleave off it waits for the whole long prefill."""
    eng = _port(weights, prefill_chunk=chunk)
    box = {}
    try:
        _spy_mid_chunks(eng, on_mid=lambda i: i == 0 and box.setdefault(
            "short", eng.generate(LONG[1][:6], max_new_tokens=4)))
        long_s = eng.generate(LONG[2], max_new_tokens=4)
        long_toks = long_s.tokens()
        short_s = box["short"]
        assert len(short_s.tokens()) == 4 and len(long_toks) == 4
    finally:
        eng.close()
    if chunk is None:
        assert short_s.trace["first_put"] < long_s.trace["first_put"]
    else:
        assert short_s.trace["first_put"] > long_s.trace["prefill_done"]


def test_a_lattice_arrival_under_a_block_in_flight_is_deferred(weights):
    """At depth 2 a long prompt that arrives while blocks are in flight is
    put back at the front of the queue, the policy's target drops to 1,
    and the lattice starts at the next synchronous pass (never from the
    in-flight pass); both streams keep JAX's tokens."""
    eng = _port(weights, decode_pipeline=2)
    facts, entries, box = [], [], {}
    inflight = threading.local()
    admit, lattice = eng._admit_inflight, eng._chunk_lattice

    def spy_admit(handle):
        if not box:   # the long prompt arrives while a block runs
            box["long"] = eng.generate(LONG[1], max_new_tokens=NEW)
        inflight.on = True
        try:
            admit(handle)
        finally:
            inflight.on = False
        facts.append((eng._lattice_deferred, eng._target_depth()))

    def spy_lattice(row, req, pos=0):
        entries.append((getattr(inflight, "on", False),
                        eng._lattice_deferred))
        return lattice(row, req, pos)

    eng._admit_inflight, eng._chunk_lattice = spy_admit, spy_lattice
    try:
        short_toks = eng.generate(LONG[0][:6], max_new_tokens=40).tokens()
        long_toks = box["long"].tokens()
        target = eng.stats()["scheduler"]["pipeline"]["target_depth"]
    finally:
        eng.close()
    assert (True, 1) in facts
    assert entries == [(False, False)]
    assert target == 2
    jeng = _jax(weights, decode_pipeline=2)
    try:
        assert short_toks == jeng.generate(LONG[0][:6],
                                           max_new_tokens=40).tokens()
        assert long_toks == jeng.generate(LONG[1],
                                          max_new_tokens=NEW).tokens()
    finally:
        jeng.close()


@pytest.mark.parametrize("paged", [False, True])
def test_cancel_in_the_middle_of_a_lattice_frees_the_slot(weights, paged):
    """A stream cancelled between two mid chunks stops its lattice at
    once; the slot (paged: every block, its table row zero) comes back,
    repeatedly, and the engine serves the next request with JAX's
    tokens."""
    pool = {"paged_blocks": 40, "paged_block_size": 8} if paged else {}
    eng = _port(weights, prefill_chunk=16, **pool)
    box = {}
    try:
        total = eng.stats()["paged"]["free"] if paged else None
        _spy_mid_chunks(eng, on_mid=lambda i: box["s"].chunks == 1
                        and box["s"].cancel())
        for _ in range(3):
            box["s"] = eng.generate(LONG[2], max_new_tokens=8)
            assert list(box["s"]) == []
            assert box["s"].chunks == 2
            deadline = time.monotonic() + 10
            while eng.stats()["active"] and time.monotonic() < deadline:
                time.sleep(0.01)
            if paged:
                assert eng.stats()["paged"]["free"] == total
                assert not eng._table.any()
        del eng._run_admission   # the spy goes
        got = eng.generate(LONG[0], max_new_tokens=8).tokens()
    finally:
        eng.close()
    jeng = _jax(weights, prefill_chunk=16, **pool)
    try:
        assert got == jeng.generate(LONG[0], max_new_tokens=8).tokens()
    finally:
        jeng.close()


# -- configuration ---------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 0, -3, 5, 16, 17, 32, 100])
def test_chunk_budget_and_stats_equal_jax(weights, chunk):
    """The chunk budget snaps as JAX's does, and stats() reports the
    buckets and the budget under JAX's keys."""
    kw = dict(prompt_buckets=(64, 16, 32, 512), prefill_chunk=chunk)
    jeng, teng = _jax(weights, **kw), _port(weights, **kw)
    try:
        assert (teng._chunk, teng._chunk_interleave) == \
            (jeng._chunk, jeng._chunk_interleave)
        js, ts = jeng.stats(), teng.stats()
        assert ts["prompt_buckets"] == js["prompt_buckets"] == [16, 32, 64]
        for key in ("prefill_chunk", "chunk_interleave"):
            assert ts["scheduler"][key] == js["scheduler"][key]
    finally:
        jeng.close()
        teng.close()


def test_needs_lattice_verdicts_equal_jax(weights):
    from gofr_tpu.tpu.generator import GenStream as JStream
    from gofr_tpu.tpu.generator import _Request as JRequest
    from gofr_tpu_torch.tpu.generator import GenStream, _Request

    jeng, teng = _jax(weights, prefill_chunk=16), _port(weights,
                                                        prefill_chunk=16)
    try:
        for n in (1, 16, 17, 32, 33, 127):
            prompt = np.arange(1, n + 1)
            j = jeng._needs_lattice(JRequest(JStream(0, jeng), prompt, 4,
                                             0.0, 0, None))
            t = teng._needs_lattice(_Request(GenStream(0), prompt, 4, 0.0,
                                             0, None, 0))
            assert j == t == (n > 16), n
    finally:
        jeng.close()
        teng.close()


def test_a_pool_under_the_floor_is_refused_as_jax_refuses_it(weights):
    """The paged pool's floor is JAX's: the trash block, the largest
    bucket's blocks and one more; the message is the same."""
    pool = {"paged_block_size": 8}
    msgs = []
    for make in (_jax, _port):
        with pytest.raises(ValueError, match="too small") as e:
            make(weights, paged_blocks=2 + 32 // 8 - 1, **pool)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "need >= 6" in msgs[1]
    eng = _port(weights, paged_blocks=6, **pool)
    try:
        assert len(eng.generate(LONG[0][:30], max_new_tokens=3).tokens()) \
            == 3
    finally:
        eng.close()


def test_the_reader_honours_the_bucket_and_chunk_rows(weights):
    """TPU_SEQ_BUCKETS keeps the buckets below TPU_MAX_SEQ, as the JAX
    reader does; TPU_PREFILL_CHUNK reads as an optional int (a malformed
    value is unset); neither row is refused any more."""
    assert "TPU_SEQ_BUCKETS" not in UNPORTED_ROWS
    assert "TPU_PREFILL_CHUNK" not in UNPORTED_ROWS
    rows = {"TPU_MODEL": "tiny", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "64",
            "TPU_DECODE_BLOCK": "2"}
    cases = [({}, [32], 32, True),
             ({"TPU_SEQ_BUCKETS": "8,16,64,128"}, [8, 16], 16, True),
             ({"TPU_SEQ_BUCKETS": "8,16", "TPU_PREFILL_CHUNK": "9"},
              [8, 16], 16, True),
             ({"TPU_SEQ_BUCKETS": "8,16", "TPU_PREFILL_CHUNK": "0"},
              [8, 16], 16, False),
             ({"TPU_PREFILL_CHUNK": "x"}, [32], 32, True),
             ({"TPU_SEQ_BUCKETS": "64,128"}, [32], 32, True)]
    for extra, buckets, chunk, interleave in cases:
        eng = new_engine_from_config(MapConfig({**rows, **extra}),
                                     device="cpu")
        try:
            st = eng.generator.stats()
            assert st["prompt_buckets"] == buckets, extra
            assert st["scheduler"]["prefill_chunk"] == chunk, extra
            assert st["scheduler"]["chunk_interleave"] == interleave, extra
            assert len(eng.generate(LONG[1][:40], max_new_tokens=3)
                       .tokens()) == 3
        finally:
            eng.close()
