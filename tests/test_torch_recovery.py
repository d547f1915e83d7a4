"""The port's recovery after a failed step (gofr_tpu_torch.tpu.generator
``_recover``, driven through the port's own chaos seams,
gofr_tpu_torch.chaos) against the JAX engine's on `tiny`, with the same
seeded weights carried across through ``from_jax_params``, on the CPU.

The contract is the JAX engine's (tests/test_chaos.py,
tests/test_paged.py): the live streams fail with GenerationError, the
prefix index is cleared before the pool is touched, the device state is
reset in place, queued requests are served after the recovery and the
engine stays up. Only a device that no longer synchronises takes the
engine down. Tokens are identical to the JAX engine's.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import chaos as jchaos
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.tpu import GenerationError as JaxError
from gofr_tpu.tpu.generator import GenerationEngine as JaxEngine
from gofr_tpu_torch import chaos
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.tpu import (GenerationEngine, GenerationError,
                                from_jax_params)

JCFG = JAX_CONFIGS["tiny"]
CFG = LLAMA_CONFIGS["tiny"]
KV = {"int8": (torch.int8, jnp.int8), "dense": (None, None)}
# tests/test_paged.py's recovery engine
PAGED = dict(slots=2, max_seq=64, prompt_buckets=(8, 16), paged_blocks=13,
             paged_block_size=16, prefix_cache_slots=2, prefix_store_min=16)


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JCFG, jax.random.PRNGKey(1))
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _port(weights, kv="int8", **kw):
    return GenerationEngine(CFG, weights[1], kv_dtype=KV[kv][0],
                            device="cpu", **kw)


def _jax(weights, kv="int8", **kw):
    return JaxEngine(JCFG, weights[0], kv_dtype=KV[kv][1], **kw)


def _sides(weights):
    """(engine factory, its chaos module, its error type) per side."""
    return ((_jax, jchaos, JaxError), (_port, chaos, GenerationError))


def _drain(stream, error):
    """The tokens a stream delivered before it failed, and whether it
    failed."""
    got = []
    try:
        for t in stream:
            got.append(int(t))
    except error:
        return got, True
    return got, False


def test_device_loss_at_a_step_recovers_and_keeps_serving(weights):
    """tests/test_chaos.py's case on both engines: a DeviceLost at the
    loop's step seam fails the live stream (after its first token), the
    engine recovers and serves the next request; the same tokens."""
    outs = []
    for make, seams, error in _sides(weights):
        eng = make(weights, slots=2, max_seq=32, prompt_buckets=(8,))
        sched = seams.ChaosSchedule(seed=0).on(
            seams.GENERATOR_STEP, error=seams.DeviceLost, every=1, limit=1)
        try:
            with seams.scope(sched):
                failed = _drain(eng.generate([1, 2, 3], max_new_tokens=4),
                                error)
                served = eng.generate([1, 2, 3], max_new_tokens=4).tokens()
                assert eng.down is None
        finally:
            eng.close()
        outs.append((failed, served))
    assert outs[0] == outs[1]
    (got, failed), served = outs[1]
    assert failed and len(got) == 1 and len(served) == 4


@pytest.mark.parametrize("kv", ["int8", "dense"])
def test_paged_recovery_cycles_clear_the_index_and_balance_the_pool(
        weights, kv):
    """tests/test_paged.py's recovery cycles on the port: four times, a
    stored prefix serves JAX's tokens, then a step fails. The moment the
    error reaches the consumer the index is empty, ``down`` is None and
    every block is back in the pool (no reference leaks)."""
    rng = np.random.default_rng(23)
    prefix = rng.integers(1, CFG.vocab_size, 36).tolist()  # 2 full blocks
    jeng = _jax(weights, kv, **PAGED)
    try:
        want = jeng.generate(prefix, max_new_tokens=6).tokens()
    finally:
        jeng.close()
    eng = _port(weights, kv, **PAGED)
    try:
        idle_free = eng.stats()["paged"]["free"]
        for cycle in range(4):
            assert eng.generate(prefix, max_new_tokens=6).tokens() == want
            assert eng.stats()["prefix_cache"]["entries"] == 1
            assert eng.stats()["paged"]["free"] < idle_free
            real = eng._run_block
            state = {"fired": False}

            def flaky(draw):
                if not state["fired"]:
                    state["fired"] = True
                    raise RuntimeError(f"paged injected failure #{cycle}")
                return real(draw)

            eng._run_block = flaky
            with pytest.raises(GenerationError, match="injected"):
                eng.generate([1, 2, 3], max_new_tokens=4).tokens()
            eng._run_block = real
            assert eng.down is None, cycle
            assert len(eng._prefix_idx) == 0, cycle
            assert eng.stats()["paged"]["free"] == idle_free, cycle
        assert eng.stats()["recoveries"] == 4
        assert eng._thread.is_alive()
    finally:
        eng.close()


def test_a_failure_at_depth_2_fails_and_serves_what_jax_does(weights):
    """Four live streams and two waiters on four slots at dispatch depth
    2; the third loop pass fails with a block in flight. On both engines
    the same four streams fail (each having delivered a prefix of its
    uninterrupted stream), the waiters are then served the same tokens,
    and an unseeded sampled request after the recovery gets the JAX
    engine's automatic seed and tokens."""
    rng = np.random.default_rng(31)
    prompts = [rng.integers(1, CFG.vocab_size, n).tolist()
               for n in (5, 9, 14, 3, 7, 11)]
    outs = []
    for make, seams, error in _sides(weights):
        eng = make(weights, slots=4, max_seq=64, decode_block=4,
                   decode_pipeline=2, prompt_buckets=(8, 16))
        ref = make(weights, slots=4, max_seq=64, decode_block=4,
                   decode_pipeline=2, prompt_buckets=(8, 16))
        sched = seams.ChaosSchedule(seed=0).on(
            seams.GENERATOR_STEP, error=seams.DeviceLost, every=3, limit=1)
        try:
            clean = [ref.generate(p, max_new_tokens=30).tokens()
                     for p in prompts]
            with seams.scope(sched):
                with eng._device_lock:   # all queued before the loop runs
                    streams = [eng.generate(p, max_new_tokens=30)
                               for p in prompts]
                drained = [_drain(s, error) for s in streams]
            assert sched.stats()["errors_fired"] == {seams.GENERATOR_STEP: 1}
            sampled = eng.generate(prompts[0], max_new_tokens=8,
                                   temperature=0.9, top_k=20)
            seeded = (sampled.tokens(), sampled.seed)
            assert eng.down is None
        finally:
            eng.close()
            ref.close()
        for (got, failed), full in zip(drained, clean):
            assert got == full[:len(got)]
        outs.append(([failed for _, failed in drained],
                     [got for got, failed in drained if not failed],
                     seeded))
    assert outs[0] == outs[1]
    assert outs[1][0] == [True] * 4 + [False] * 2


def test_a_failure_inside_a_lattice_with_a_hit_balances_the_pool(weights):
    """A prefix hit whose remainder runs mid chunks fails at its chunk
    seam while another stream decodes: both streams fail, the hit's
    shared and fresh references and the entry's are all released (every
    block back in the pool, the index empty), and the next requests
    stream what they stream on the JAX engine under the same fault."""
    rng = np.random.default_rng(29)
    prefix = rng.integers(1, CFG.vocab_size, 33).tolist()
    long_hit = prefix + rng.integers(1, CFG.vocab_size, 20).tolist()
    busy_prompt = rng.integers(1, CFG.vocab_size, 5).tolist()
    outs = []
    for make, seams, error in _sides(weights):
        eng = make(weights, **dict(PAGED, paged_blocks=11))
        sched = seams.ChaosSchedule(seed=0).on(
            seams.GENERATOR_CHUNK, error=seams.DeviceLost, every=1, limit=1)
        try:
            idle_free = eng.stats()["paged"]["free"]
            first = eng.generate(prefix, max_new_tokens=4).tokens()
            with seams.scope(sched):
                busy = eng.generate(busy_prompt, max_new_tokens=48)
                hit = eng.generate(long_hit, max_new_tokens=4)
                hit_out = _drain(hit, error)
                busy_out = _drain(busy, error)
            st = eng.stats()
            after = [eng.generate(p, max_new_tokens=4).tokens()
                     for p in (long_hit, prefix)]
        finally:
            eng.close()
        outs.append((first, hit_out, busy_out[1], after, st["prefix_cache"],
                     st["paged"]["free"] - idle_free))
    assert outs[0] == outs[1]
    _, (hit_got, hit_failed), busy_failed, _, pc, free_delta = outs[1]
    assert hit_failed and hit_got == [] and busy_failed
    assert pc["entries"] == 0 and pc["hits"] == 1 and free_delta == 0


def test_a_device_that_no_longer_synchronises_takes_the_engine_down(
        weights):
    """The reset's probe failing (a sticky CUDA error on the card) is the
    one failure the engine does not recover from: ``down`` names both
    errors, the live stream and the queued one fail, new requests are
    refused and the loop's thread ends."""
    eng = _port(weights, slots=1, max_seq=32, prompt_buckets=(8,))

    def sticky():
        raise RuntimeError("CUDA error: an illegal memory access")

    eng._reset_device = sticky
    sched = chaos.ChaosSchedule(seed=0).on(
        chaos.GENERATOR_STEP, error=chaos.DeviceLost, every=1, limit=1)
    try:
        with chaos.scope(sched):
            with eng._device_lock:
                live = eng.generate([1, 2, 3], max_new_tokens=8)
                queued = eng.generate([4, 5], max_new_tokens=8)
            with pytest.raises(GenerationError, match="DeviceLost"):
                live.tokens()
            with pytest.raises(GenerationError, match="illegal memory"):
                queued.tokens()
        eng._thread.join(timeout=10)
        assert not eng._thread.is_alive()
        assert "illegal memory" in eng.down and "DeviceLost" in eng.down
        with pytest.raises(GenerationError, match="down"):
            eng.generate([1, 2], max_new_tokens=2)
    finally:
        eng.close()
    assert not [t for t in threading.enumerate() if t is eng._thread]


def test_the_reset_zeroes_the_device_state_in_place(weights):
    """Recovery keeps every tensor a captured graph binds (the same
    storage) and zeroes it: the pool, the scratch row, the pack, the
    carry and the admission inputs."""
    eng = _port(weights, **PAGED)
    try:
        eng.generate(list(range(1, 40)), max_new_tokens=6).tokens()
        tensors = eng._device_tensors()
        ptrs = [t.data_ptr() for t in tensors]
        assert any(bool(t.any()) for t in tensors)
        with pytest.raises(GenerationError):
            real = eng._run_block
            eng._run_block = lambda draw: (_ for _ in ()).throw(
                RuntimeError("injected"))
            try:
                eng.generate([1, 2, 3], max_new_tokens=4).tokens()
            finally:
                eng._run_block = real
        with eng._device_lock:
            after = eng._device_tensors()
            assert [t.data_ptr() for t in after] == ptrs
            assert not any(bool(t.any()) for t in after)
        assert len(eng.generate([1, 2, 3], max_new_tokens=4).tokens()) == 4
    finally:
        eng.close()
