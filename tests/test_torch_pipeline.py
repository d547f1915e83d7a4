"""The port's decode dispatch layer (gofr_tpu_torch.tpu.generator at
dispatch depth 2, gofr_tpu_torch.resilience.DecodePipelinePolicy)
against the JAX package's (gofr_tpu.tpu.generator, gofr_tpu.resilience)
on `tiny`, with the same seeded weights carried across through
``from_jax_params``, on the CPU, mirroring tests/test_tpu_pipeline.py.

Up to two fused decode blocks are in flight: the host reaps block N
while block N+1 is queued, so block N+1 is built from the device carry
(last token, active, budget, position) and the dispatch pack, whose
``host_wins`` column picks the pack's slot state after an admission, a
retirement or a verify pass. On the CPU a block runs eagerly at
dispatch (``fused_decode_block``, the body the card captures into a
CUDA graph); the pipeline's bookkeeping is the same.

Exactness: greedy and seeded-sampled streams are token-identical to the
JAX engine's at depth 2 and to the port's own at depth 1 (sampling is
keyed on (seed, absolute position), so depth cannot change it),
contiguous and paged, with an int8 KV cache and with the dense cache in
the model's dtype (float32 on `tiny`; bf16 on the card's Llama-3-8B).
A bf16 cache under the float32 `tiny` is token-identical across depths;
against JAX it is not: the two frameworks' float32 k/v part in the last
bit, and the bf16 write rounds some of those apart by a bf16 step, which
moved a logit by 4e-3 against a top-2 gap of 1e-3 at one step of one of
these streams.
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
from gofr_tpu.resilience import DecodePipelinePolicy as JaxPolicy
from gofr_tpu.tpu.generator import GenerationEngine as JaxEngine
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.models import LLAMA_CONFIGS, llama
from gofr_tpu_torch.resilience import DecodePipelinePolicy
from gofr_tpu_torch.tpu import (GenerationEngine, GenerationError,
                                from_jax_params, new_engine_from_config)
from gofr_tpu_torch.tpu.generator import (EOS_MAX, PACK_EXTRA,
                                          fused_decode_block)

JCFG = JAX_CONFIGS["tiny"]
CFG = LLAMA_CONFIGS["tiny"]
PAGED = {"paged_blocks": 40, "paged_block_size": 8}
KV = {"int8": (torch.int8, jnp.int8), "dense": (None, None),
      "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JCFG, jax.random.PRNGKey(1))
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _port(weights, depth, paged=False, kv="int8", **kw):
    args = dict(slots=4, max_seq=64, decode_block=4, decode_pipeline=depth,
                kv_dtype=KV[kv][0], prompt_buckets=(8, 16, 32), device="cpu")
    if paged:
        args.update(PAGED)
    args.update(kw)
    return GenerationEngine(CFG, weights[1], **args)


def _jax(weights, depth, paged=False, kv="int8", **kw):
    args = dict(slots=4, max_seq=64, decode_block=4, decode_pipeline=depth,
                kv_dtype=KV[kv][1], prompt_buckets=(8, 16, 32))
    if paged:
        args.update(PAGED)
    args.update(kw)
    return JaxEngine(JCFG, weights[0], **args)


def _serve(eng, requests):
    """Submit every (prompt, kwargs) request, then drain them in order."""
    streams = [eng.generate(p, **kw) for p, kw in requests]
    return [s.tokens() for s in streams]


def _run(make, requests):
    eng = make()
    try:
        return _serve(eng, requests), eng.stats()
    finally:
        eng.close()


# -- the policy ---------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 1, 2, 3])
@pytest.mark.parametrize("latency,lattice,spec", [
    (False, False, False), (True, False, False), (False, True, False),
    (False, False, True), (True, True, True)])
def test_pipeline_policy_verdicts_equal_jax(depth, latency, lattice, spec):
    facts = dict(latency_waiting=latency, lattice_deferred=lattice,
                 spec_decode=spec)
    port, ref = DecodePipelinePolicy(depth), JaxPolicy(depth)
    assert port.depth == ref.depth
    assert port.target(**facts) == ref.target(**facts)


# -- token exactness ----------------------------------------------------------

def _greedy_requests():
    """Six prompts for four slots (admissions while blocks are in
    flight), lengths on and around the paged block size of 8; 20 new
    tokens each, so streams cross block boundaries."""
    rng = np.random.default_rng(11)
    return [(rng.integers(1, CFG.vocab_size, n).tolist(),
             {"max_new_tokens": 20}) for n in (7, 8, 9, 16, 23, 4)]


@pytest.mark.parametrize("kv", ["int8", "dense"])
@pytest.mark.parametrize("paged", [False, True])
def test_depth2_greedy_streams_equal_depth1_and_jax(weights, paged, kv):
    requests = _greedy_requests()
    d2, st = _run(lambda: _port(weights, 2, paged, kv), requests)
    d1, _ = _run(lambda: _port(weights, 1, paged, kv), requests)
    want, _ = _run(lambda: _jax(weights, 2, paged, kv), requests)
    assert [len(t) for t in d2] == [20] * 6
    assert d2 == d1 == want
    assert st["scheduler"]["pipeline"]["depth"] == 2
    if paged:
        assert st["paged"]["free"] == st["paged"]["blocks"]


@pytest.mark.parametrize("paged", [False, True])
def test_depth2_bf16_kv_streams_equal_depth1(weights, paged):
    requests = _greedy_requests()
    d2, st = _run(lambda: _port(weights, 2, paged, "bf16"), requests)
    d1, _ = _run(lambda: _port(weights, 1, paged, "bf16"), requests)
    assert [len(t) for t in d2] == [20] * 6
    assert d2 == d1
    assert st["kv_dtype"] == "torch.bfloat16"
    assert st["scheduler"]["pipeline"]["overlapped_reaps"] > 0


@pytest.mark.parametrize("paged", [False, True])
def test_depth2_sampled_streams_equal_jax(weights, paged):
    """Seeded temperature and top-k streams beside greedy ones at depth
    2 equal the JAX engine's at depth 2 and the port's at depth 1."""
    prompts = [[5, 9, 17], list(range(1, 20)), list(range(40, 70, 3)),
               [2, 7, 1, 8]]
    kws = [dict(temperature=0.8, top_k=0, seed=5),
           dict(temperature=0.8, top_k=20, seed=6),
           dict(temperature=0.0),
           dict(temperature=1.1, top_k=8, seed=7)]
    requests = [(p, dict(kw, max_new_tokens=16)) for p, kw in
                zip(prompts, kws)]
    got, _ = _run(lambda: _port(weights, 2, paged), requests)
    want, _ = _run(lambda: _jax(weights, 2, paged), requests)
    d1, _ = _run(lambda: _port(weights, 1, paged), requests)
    assert [len(t) for t in got] == [16] * 4
    assert got == want == d1


# -- on-device stop masks -----------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_stop_masks_match_host_retirement(weights, paged):
    """A stream that meets its EOS at depth 2 ends at exactly the first
    stop token -- no token from the block already in flight -- for a
    single id, a stop set on the device and a set wider than EOS_MAX
    (the host's check alone for the extra ids); a budget stop mid-block
    likewise; and the stopped slots free up."""
    prompt = [5, 17, 42, 7]
    (base,), _ = _run(lambda: _port(weights, 1, paged),
                      [(prompt, {"max_new_tokens": 12})])
    stop = base[2]
    want = base[:base.index(stop) + 1]
    unused = [t for t in range(CFG.vocab_size) if t not in base]
    jeng, eng = _jax(weights, 2, paged), _port(weights, 2, paged)
    try:
        for eos in (stop, {stop, unused[0]}, set(unused[:9]) | {stop}):
            got = eng.generate(prompt, max_new_tokens=50,
                               eos_id=eos).tokens()
            assert got == want, f"eos={eos!r}"
            assert jeng.generate(prompt, max_new_tokens=50,
                                 eos_id=eos).tokens() == got
        assert eng.generate(prompt, max_new_tokens=5).tokens() == base[:5]
        deadline = time.monotonic() + 5.0
        while eng.stats()["active"] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.stats()["active"] == 0
    finally:
        jeng.close()
        eng.close()


def test_capacity_stop_on_device(weights):
    """A depth-2 stream asked for more tokens than the cache holds stops
    where depth 1 and the JAX engine at depth 2 stop."""
    requests = [([5, 17, 42, 7], {"max_new_tokens": 500})]
    outs = [_run(make, requests)[0][0] for make in (
        lambda: _port(weights, 1, max_seq=32),
        lambda: _port(weights, 2, max_seq=32),
        lambda: _jax(weights, 2, max_seq=32, prompt_buckets=(8, 16)))]
    assert outs[0] == outs[1] == outs[2]
    # the last delivered token sits at position max_seq - 2
    assert len(outs[1]) == 32 - 1 - 4


# -- the paged pool at depth 2 ------------------------------------------------

def _held(eng, prompts, n):
    """Submit every prompt while the engine's device lock is held, so
    the whole batch is admitted in the loop's first pass."""
    with eng._device_lock:
        streams = [eng.generate(p, max_new_tokens=n) for p in prompts]
    return [s.tokens() for s in streams]


def test_pool_exhaustion_at_depth2_truncates_the_streams_jax_truncates(
        weights):
    """Blocks are demanded one block ahead at depth 2 (cursors advance
    at dispatch): an undersized pool truncates the streams the JAX
    engine truncates at depth 2, each a prefix of the contiguous
    engine's, and the pool is whole afterwards."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, CFG.vocab_size, 8).tolist() for _ in range(2)]
    full, _ = _run(lambda: _port(weights, 2),
                   [(p, {"max_new_tokens": 40}) for p in prompts])
    pool = {"paged_blocks": 4, "paged_block_size": 16}
    outs = []
    for make in (lambda: _jax(weights, 2, slots=2, **pool),
                 lambda: _port(weights, 2, slots=2, **pool)):
        eng = make()
        try:
            outs.append((_held(eng, prompts, 40), eng.stats()["paged"]))
        finally:
            eng.close()
    (want, jst), (got, st) = outs
    assert got == want
    for g, f in zip(got, full):
        assert g == f[:len(g)]
    assert min(len(g) for g in got) < 40
    assert st == jst
    assert st["evictions"] >= 1 and st["free"] == 3


def test_cancel_with_two_blocks_in_flight_frees_the_slot_and_blocks(weights):
    """The stream is cancelled while the loop waits on the oldest of two
    queued blocks (held there at its third reap): the slot and its pool
    blocks come back, and the slot serves the next request."""
    eng = _port(weights, 2, paged=True, slots=1, max_seq=64)
    held, release = threading.Event(), threading.Event()
    admit, calls = eng._admit_inflight, []

    def gated(inflight):
        calls.append(inflight)
        if len(calls) == 3:
            held.set()
            release.wait(10)
        return admit(inflight)

    eng._admit_inflight = gated
    try:
        total = eng.stats()["paged"]["free"]
        stream = eng.generate(list(range(1, 12)), max_new_tokens=50)
        assert held.wait(10)
        with eng._device_lock:
            assert eng._depth_now == 2
            stream.cancel()
        release.set()
        assert len(stream.tokens()) < 50
        deadline = time.monotonic() + 10
        while eng.stats()["paged"]["free"] != total \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert eng.stats()["paged"]["free"] == total
        assert eng.stats()["active"] == 0
        assert len(eng.generate([1, 2, 3], max_new_tokens=6).tokens()) == 6
    finally:
        release.set()
        eng.close()


# -- the pipeline's own bookkeeping -------------------------------------------

def test_steady_decode_overlaps_reaps(weights):
    """In steady decode a second block is queued behind every reap: the
    reaps see a non-empty pipe and record a gap of 0."""
    requests = [([3, 1, 4, 1 + i], {"max_new_tokens": 32}) for i in range(2)]
    _, st = _run(lambda: _port(weights, 2), requests)
    pipe = st["scheduler"]["pipeline"]
    assert pipe["depth"] == 2 and pipe["target_depth"] == 2
    assert pipe["overlapped_reaps"] > 0
    assert pipe["reaps"] >= pipe["overlapped_reaps"]
    assert pipe["gap_p50_ms"] is not None and pipe["gap_samples"] > 0
    assert st["decode_step_ms_mean"] is not None


def test_spec_engine_targets_depth_one(weights):
    """Verify windows are built from the host-delivered history: a spec
    engine never pipelines, says so in stats(), and streams the JAX
    spec engine's tokens."""
    eng = _port(weights, 2, spec_decode_k=3)
    jeng = _jax(weights, 2, spec_decode_k=3)
    try:
        st = eng.stats()["scheduler"]["pipeline"]
        assert st["depth"] == 2 and st["target_depth"] == 1
        prompt = [5, 17, 42, 7, 5, 17, 42, 7]
        got = eng.generate(prompt, max_new_tokens=12).tokens()
        assert got == jeng.generate(prompt, max_new_tokens=12).tokens()
        assert eng.stats()["scheduler"]["pipeline"]["depth_now"] <= 1
    finally:
        eng.close()
        jeng.close()


@pytest.mark.parametrize("n", [12, 48])
def test_steady_state_uploads_no_pack(weights, n):
    """The pack goes up only when a mutation marked it dirty: for a lone
    stream, at its admission (host_wins set) and at the next dispatch
    (host_wins cleared), however many blocks it runs."""
    eng = _port(weights, 2)
    try:
        eng.generate([2, 7, 1], max_new_tokens=4).tokens()
        st0 = eng.stats()
        assert len(eng.generate([3, 1, 4, 1, 5],
                                max_new_tokens=n).tokens()) == n
        st = eng.stats()
    finally:
        eng.close()
    blocks = (st["decode_steps"] - st0["decode_steps"]) // 4
    assert blocks >= n // 4 - 1
    assert st["pack_uploads"] - st0["pack_uploads"] == 2


def test_a_failed_step_with_two_blocks_in_flight_fails_every_stream(
        weights):
    """A block dispatch made to raise as a top-up behind an unreaped
    block: every stream and every waiter fails, the engine goes down
    and stays down, and its thread ends."""
    eng = _port(weights, 2)
    calls = {"n": 0}
    run = eng._run_block

    def flaky(draw):
        calls["n"] += 1
        if calls["n"] == 4:   # a top-up with a block in flight
            raise RuntimeError("injected device failure")
        return run(draw)

    eng._run_block = flaky
    try:
        with eng._device_lock:
            streams = [eng.generate([5, 17, 42, i], max_new_tokens=40)
                       for i in range(3)]
            streams.append(eng.generate([9, 9], max_new_tokens=40))
            streams += [eng.generate([1, i], max_new_tokens=40)
                        for i in range(2)]   # waiters: 4 slots, 6 requests
        for s in streams:
            with pytest.raises(GenerationError, match="injected"):
                s.tokens()
        eng._thread.join(timeout=10)
        assert not eng._thread.is_alive()
        assert "injected" in eng.down
        with pytest.raises(GenerationError, match="down"):
            eng.generate([1, 2], max_new_tokens=2)
        assert eng.stats()["active"] == 0
    finally:
        eng.close()
    assert not [t for t in threading.enumerate() if t is eng._thread]


@pytest.mark.parametrize("rows,depth,window_ms", [
    ({}, 2, 2.0),
    ({"TPU_DECODE_PIPELINE": "2"}, 2, 2.0),
    ({"TPU_DECODE_PIPELINE": "1"}, 1, 2.0),
    ({"TPU_ADMIT_WINDOW_MS": "5"}, 2, 5.0),
])
def test_new_engine_from_config_reads_the_pipeline_rows(rows, depth,
                                                         window_ms):
    eng = new_engine_from_config(MapConfig({
        "TPU_MODEL": "tiny", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "64",
        "TPU_DECODE_BLOCK": "2", **rows}), device="cpu")
    try:
        assert len(eng.generate([3, 4, 5], max_new_tokens=9).tokens()) == 9
        pipe = eng.health_check().details["generator"]["scheduler"][
            "pipeline"]
        assert pipe["depth"] == pipe["target_depth"] == depth
        assert eng.generator._admit_window == pytest.approx(window_ms / 1e3)
    finally:
        eng.close()


# -- the block function -------------------------------------------------------

def test_host_wins_picks_the_pack_or_the_carry(weights):
    """fused_decode_block merges per slot: a slot under host_wins takes
    the pack's last token, active flag, budget and position, the others
    the carry's. A block whose carry holds what a pack under host_wins
    would hold computes the same tokens, cache and carry."""
    _, tparams = weights
    B, K = 3, 4
    rng = np.random.default_rng(5)
    cache = llama.init_cache(CFG, B, 64, dtype=torch.int8, device="cpu")
    rope = llama.get_rope_tables(CFG, 64, "cpu")
    with torch.no_grad():
        for b, n in enumerate((5, 11, 8)):
            toks = torch.from_numpy(rng.integers(1, CFG.vocab_size, (1, n)))
            _, k, v, _ = llama.prefill_kv(tparams, CFG, toks, rope_tables=rope)
            llama.write_kv(cache, k, v, slot=b)
            cache.lengths[b] = n
    state = np.array([[7, 1, 20, 1], [9, 1, 2, 3], [11, 0, 0, 0]], np.int64)
    pack = torch.zeros((B, PACK_EXTRA + EOS_MAX), dtype=torch.long)
    pack[:, PACK_EXTRA:] = llama.EOS_PAD
    pack[:, 7] = 3
    outs = []
    for host_wins in (1, 0):
        c = llama.KVCache(cache.k.clone(), cache.v.clone(),
                          cache.lengths.clone(), cache.k_scale.clone(),
                          cache.v_scale.clone())
        p = pack.clone()
        p[:, 6] = host_wins
        if host_wins:
            for col, j in ((0, 0), (1, 1), (2, 2), (8, 3)):
                p[:, col] = torch.from_numpy(state[:, j])
            carry = (torch.zeros(B, dtype=torch.long),
                     torch.zeros(B, dtype=torch.bool),
                     torch.zeros(B, dtype=torch.long),
                     torch.zeros(B, dtype=torch.long))
        else:   # the pack's slot state is junk the merge must ignore
            p[:, :3] = 99
            p[:, 8] = 99
            carry = tuple(torch.from_numpy(state[:, j].copy())
                          for j in range(4))
            carry = (carry[0], carry[1].bool(), carry[2], carry[3])
        with torch.no_grad():
            out = fused_decode_block(tparams, CFG, c, p, carry, rope,
                                     steps=K, capacity=62, draw=False)
        outs.append((out, c, carry))
    (a, ca, ka), (b, cb, kb) = outs
    assert torch.equal(a, b)
    assert torch.equal(ca.lengths, cb.lengths) and torch.equal(ca.k, cb.k)
    for x, y in zip(ka, kb):
        assert torch.equal(x, y)
    emitted = a[:, 2].numpy()
    # slot 0 runs the whole block; slot 1's budget of 2 stops it after
    # two steps; slot 2 is inactive and emits nothing
    assert emitted[:, 0].tolist() == [1, 1, 1, 1]
    assert emitted[:, 1].tolist() == [1, 1, 0, 0]
    assert emitted[:, 2].tolist() == [0, 0, 0, 0]
    assert ca.lengths.tolist() == [5 + 4, 11 + 2, 8]
    # the carry leaves the next block's state: position advanced by the
    # tokens emitted, slot 1 inactive
    assert ka[3].tolist() == [1 + 4, 3 + 2, 0]
    assert ka[1].tolist() == [True, False, False]
