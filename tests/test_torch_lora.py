"""Multi-LoRA serving on both packages, on `tiny` (float32): the port's
``models.llama`` LoRA (``init_lora``, ``merge_lora``, the per-row
``_lora`` delta) and its engine's adapter routing, held against the JAX
package on the same seeded weights (JAX's stacks carried across with
``from_jax_params``). Greedy tokens are compared exactly.

- tests/test_lora.py's cases but the mesh one: adapter 0 is the base,
  the gathered adapter equals the merged weights, mixed rows are
  independent, concurrent adapters through bucket and lattice
  admissions, ``load_adapter``, spec decode and the prefix cache with
  LoRA, no prefix crossing adapters, a swap invalidating the adapter's
  prefixes, a stack-width mismatch, a numpy EOS, the rows;
- tests/test_paged.py's multi-LoRA streams on a paged pool, and the
  paged pool with zero-copy prefix sharing and a hot swap;
- tests/test_kvcache_engine.py's hot swap through all three tiers, and
  tests/test_kvcache.py's three-tier invalidation, each with a T2 epoch
  bump that cannot reach Redis: the adapter's shared reads and writes
  stay off (``pending_bumps``) until a later bump lands;
- tests/test_examples.py's multi-LoRA routes (examples/tpu-multi-lora)
  on a ``gofr_tpu.App`` and on a ``gofr_tpu_torch.App(device="cpu")``;
- the port's own contract: ``load_adapter`` copies into the stacks'
  storage (same tensors, same ``params``) and the next decode reads it;
  an engine built from rows draws its A matrices and leases them from
  the memory arbiter; the checkpoint carries the stacks and
  ``maybe_quantize`` leaves them unquantized; a freed or recovered
  slot's adapter is back to 0.
"""

from __future__ import annotations

import importlib.util
import io
import json
import sys
import urllib.error
import urllib.request
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.datasource.redisclient import RedisClient as JClient
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.tpu import GenerationEngine as JaxEngine
from gofr_tpu.tpu import new_engine_from_config as jnew_engine
from gofr_tpu.tpu.checkpoint import save_npz
from gofr_tpu.tpu.kvcache import CacheManager as JManager
from gofr_tpu.tpu.kvcache import KVCacheOptions as JOptions
from gofr_tpu.tpu.kvcache import KVLayout as JLayout
from gofr_tpu_torch import chaos as pchaos
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.datasource.redisclient import RedisClient
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.testutil.redisfake import FakeRedisServer
from gofr_tpu_torch.tpu import (GenerationEngine, GenerationError,
                                from_jax_params, hbm, maybe_quantize,
                                new_engine_from_config)
from gofr_tpu_torch.tpu.kvcache import (CacheManager, HostKV,
                                        KVCacheOptions, KVLayout)

JCFG = JAX_CONFIGS["tiny"]
CFG = LLAMA_CONFIGS["tiny"]
EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _lora_tree(n_adapters: int, key: int, crc_mod: int = 1000,
               second: bool = True) -> dict:
    """JAX's tests' LoRA params: ``tiny`` from PRNGKey(1) plus stacks
    from PRNGKey(``key``), adapter 1's B filled from a crc32-seeded
    normal * 0.05 and (``second``) adapter 2's with -0.5 times it."""
    params = jllama.init(JCFG, jax.random.PRNGKey(1))
    layers = {**params["layers"],
              **jllama.init_lora(JCFG, n_adapters, 4,
                                 jax.random.PRNGKey(key))}
    for name in jllama.LORA_TARGETS:
        b = layers[f"lora_b_{name}"]
        fill = jax.random.normal(
            jax.random.PRNGKey(zlib.crc32(name.encode()) % crc_mod),
            b.shape[:1] + b.shape[2:]) * 0.05
        b = b.at[:, 1].set(fill.astype(b.dtype))
        if second:
            b = b.at[:, 2].set((fill * -0.5).astype(b.dtype))
        layers[f"lora_b_{name}"] = b
    return {**params, "layers": layers}


@pytest.fixture(scope="module")
def lora_params():
    """(JAX tree, the port's tensors) of tests/test_lora.py's params."""
    jp = _lora_tree(3, 2)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _base(tree: dict) -> dict:
    return {**tree, "layers": {k: v for k, v in tree["layers"].items()
                               if not k.startswith("lora_")}}


def _slot_tree(tree: dict, idx: int, side: str) -> dict:
    """load_adapter's tree for adapter ``idx`` of ``tree``'s stacks."""
    out = {}
    for name in llama.LORA_TARGETS:
        a = tree["layers"][f"lora_a_{name}"][:, idx]
        b = tree["layers"][f"lora_b_{name}"][:, idx]
        out[name] = (a, b) if side == "jax" else (np.asarray(a),
                                                  np.asarray(b))
    return out


def _engine(side: str, params, **kw):
    common = dict(slots=2, max_seq=64, prompt_buckets=(8, 16))
    common.update(kw)
    if side == "jax":
        return JaxEngine(JCFG, params[0], **common)
    return GenerationEngine(CFG, params[1], device="cpu", **common)


def _ref_greedy(tparams: dict, prompt, n: int, adapter: int) -> list[int]:
    """The merged-weights greedy reference, on the port's forward."""
    merged = llama.merge_lora(tparams, CFG, adapter)
    toks = list(prompt)
    for _ in range(n):
        logits = llama.forward(merged, CFG, torch.tensor([toks]))
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def _both(fn):
    out = {side: fn(side) for side in ("jax", "port")}
    assert out["port"] == out["jax"]
    return out["port"]


# -- the model ---------------------------------------------------------------

def test_adapter0_is_exact_base(lora_params):
    jp, tp = lora_params
    tokens = torch.tensor([[5, 17, 42, 7]])
    want = llama.forward(_base(tp), CFG, tokens)
    got = llama.forward(tp, CFG, tokens, adapter=torch.zeros(1, dtype=int))
    assert torch.equal(got, want)
    jgot = jllama.forward(jp, JCFG, jnp.asarray(tokens.numpy()),
                          adapter=jnp.zeros((1,), jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-5,
                               atol=1e-5)


def test_gathered_adapter_equals_merged_weights(lora_params):
    jp, tp = lora_params
    tokens = torch.tensor([[5, 17, 42, 7, 3]])
    for i in (1, 2):
        merged = llama.merge_lora(tp, CFG, i)
        assert "lora_a_wq" not in merged["layers"]
        want = llama.forward(merged, CFG, tokens)
        got = llama.forward(tp, CFG, tokens,
                            adapter=torch.full((1,), i, dtype=int))
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        jmerged = jllama.merge_lora(jp, JCFG, i)
        np.testing.assert_allclose(
            llama.merge_lora(tp, CFG, i)["layers"]["wq"].numpy(),
            np.asarray(jmerged["layers"]["wq"]), rtol=1e-6, atol=1e-6)
        jgot = jllama.forward(jp, JCFG, jnp.asarray(tokens.numpy()),
                              adapter=jnp.full((1,), i, jnp.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot),
                                   rtol=1e-5, atol=1e-5)


def test_mixed_adapter_batch_rows_are_independent(lora_params):
    _, tp = lora_params
    rows = torch.tensor([[5, 17, 42, 7]] * 3)
    adapters = torch.tensor([0, 1, 2])
    got = llama.forward(tp, CFG, rows, adapter=adapters)
    for i in range(3):
        solo = llama.forward(tp, CFG, rows[i:i + 1],
                             adapter=adapters[i:i + 1])
        torch.testing.assert_close(got[i], solo[0], rtol=2e-5, atol=2e-5)


def test_without_stacks_or_ids_no_lora_op_runs(lora_params, monkeypatch):
    _, tp = lora_params
    calls = []
    monkeypatch.setattr(torch, "bmm", lambda *a: calls.append(1))
    tokens = torch.tensor([[5, 17, 42]])
    llama.forward(_base(tp), CFG, tokens, adapter=torch.tensor([1]))
    llama.forward(tp, CFG, tokens)
    assert calls == []


def test_init_lora_draws_a_and_zeros_b():
    gen = torch.Generator()
    gen.manual_seed(3)
    st = llama.init_lora(CFG, 3, 4, gen)
    assert sorted(st) == sorted(f"lora_{ab}_{n}" for ab in "ab"
                                for n in llama.LORA_TARGETS)
    assert st["lora_a_wq"].shape == (2, 3, 64, 4)
    assert st["lora_b_wk"].shape == (2, 3, 4, 32)
    assert st["lora_a_wo"].shape == (2, 3, 64, 4)
    assert all(not v.any() for k, v in st.items() if "_b_" in k)
    assert float(st["lora_a_wq"].std()) == pytest.approx(64 ** -0.5,
                                                         rel=0.2)
    assert sum(v.numel() * v.element_size() for v in st.values()) == \
        llama.lora_nbytes(CFG, 3, 4)
    gen.manual_seed(3)
    again = llama.init_lora(CFG, 3, 4, gen)
    assert all(torch.equal(st[k], again[k]) for k in st)


def test_the_checkpoint_carries_the_stacks_and_keeps_them_unquantized(
        lora_params):
    jp, tp = lora_params
    for name in llama.LORA_TARGETS:
        for ab in "ab":
            key = f"lora_{ab}_{name}"
            np.testing.assert_array_equal(tp["layers"][key].numpy(),
                                          np.asarray(jp["layers"][key]))
    q = maybe_quantize(tp, True)
    assert type(q["layers"]["wq"]).__name__ == "QuantizedLinear"
    for k, v in tp["layers"].items():
        if k.startswith("lora_"):
            assert q["layers"][k] is v


# -- the engine (tests/test_lora.py) -------------------------------------------

def test_engine_serves_concurrent_adapters(lora_params):
    """Two streams on different adapters decode together in the same
    slot pool, through a bucket prefill and a chunk lattice (40 tokens,
    buckets 8/16), equal to JAX's streams and to the merged-weights
    reference."""
    rng = np.random.default_rng(4)
    p1 = rng.integers(1, CFG.vocab_size, 6).tolist()
    p2 = rng.integers(1, CFG.vocab_size, 40).tolist()

    def run(side):
        eng = _engine(side, lora_params, lora_adapters=3)
        try:
            s1 = eng.generate(p1, max_new_tokens=8, adapter=1)
            s2 = eng.generate(p2, max_new_tokens=8, adapter=2)
            out = (s1.tokens(), s2.tokens(), eng.stats()["lora"])
            with pytest.raises(Exception, match="adapter 7 out of range"):
                eng.generate([1, 2], adapter=7)
            return out
        finally:
            eng.close()

    t1, t2, lora = _both(run)
    assert t1 == _ref_greedy(lora_params[1], p1, 8, 1)
    assert t2 == _ref_greedy(lora_params[1], p2, 8, 2)
    assert lora == {"adapters": 3, "rank": 4}


def test_mixed_adapters_in_one_decode_batch(lora_params):
    """Both slots decoding at once on adapters 2 and 0, queued while
    the loop is held, so their blocks carry two adapters a block."""
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, CFG.vocab_size, n).tolist() for n in (7, 12)]

    def run(side):
        eng = _engine(side, lora_params, lora_adapters=3)
        try:
            with eng._device_lock:
                streams = [eng.generate(p, max_new_tokens=10, adapter=a)
                           for p, a in zip(prompts, (2, 0))]
            return [s.tokens() for s in streams]
        finally:
            eng.close()

    got = _both(run)
    assert got == [_ref_greedy(lora_params[1], prompts[0], 10, 2),
                   _ref_greedy(lora_params[1], prompts[1], 10, 0)]


def test_engine_load_adapter_roundtrip(lora_params):
    """load_adapter installs weights into a slot at runtime; serving
    picks them up; slot 0 and unknown targets are refused."""
    def run(side):
        params = (_base(lora_params[0]), _base(lora_params[1]))
        eng = _engine(side, params, prompt_buckets=(8,), lora_adapters=3,
                      lora_rank=4)
        try:
            tree = _slot_tree(lora_params[0], 1, side)
            eng.load_adapter(1, tree)
            got = eng.generate([5, 17, 42, 7], max_new_tokens=6,
                               adapter=1).tokens()
            with pytest.raises(Exception, match="slot 0"):
                eng.load_adapter(0, tree)
            with pytest.raises(Exception, match="unknown LoRA target"):
                eng.load_adapter(1, {"w_up": tree["wq"]})
            return got
        finally:
            eng.close()

    assert _both(run) == _ref_greedy(lora_params[1], [5, 17, 42, 7], 6, 1)


def test_load_adapter_copies_into_the_stacks_storage(lora_params):
    """The port's swap is a copy into the stack tensors every captured
    graph binds: the same ``params`` object and the same storage after
    it, and the next decode (a block already run before the swap
    included) reads the new weights."""
    eng = _engine("port", (None, _base(lora_params[1])), lora_adapters=3,
                  lora_rank=4)
    try:
        params = eng.params
        stacks = {k: v for k, v in params["layers"].items()
                  if k.startswith("lora_")}
        ptrs = {k: v.data_ptr() for k, v in stacks.items()}
        prompt = [5, 17, 42, 7, 9]
        before = eng.generate(prompt, max_new_tokens=5, adapter=2).tokens()
        assert before == _ref_greedy(lora_params[1], prompt, 5, 0)
        eng.load_adapter(2, _slot_tree(lora_params[0], 1, "port"))
        assert eng.params is params
        for k, v in params["layers"].items():
            if k.startswith("lora_"):
                assert v is stacks[k] and v.data_ptr() == ptrs[k]
        assert torch.equal(params["layers"]["lora_b_wq"][:, 2],
                           lora_params[1]["layers"]["lora_b_wq"][:, 1])
        after = eng.generate(prompt, max_new_tokens=5, adapter=2).tokens()
        assert after == _ref_greedy(lora_params[1], prompt, 5, 1)
        # a pair of the wrong shape refuses the whole tree: nothing copied
        bad = _slot_tree(lora_params[0], 2, "port")
        bad["wk"] = (np.zeros((2, 64, 3)), np.zeros((2, 3, 32)))
        with pytest.raises(GenerationError, match="shape"):
            eng.load_adapter(2, bad)
        assert torch.equal(params["layers"]["lora_b_wq"][:, 2],
                           lora_params[1]["layers"]["lora_b_wq"][:, 1])
    finally:
        eng.close()


@pytest.mark.parametrize("kw", [
    {"spec_decode_k": 3, "prefix_cache_slots": 2, "prefix_store_min": 8},
    {"spec_decode_k": 3, "paged_blocks": 20, "paged_block_size": 8,
     "prefix_cache_slots": 2, "prefix_store_min": 8},
])
def test_lora_composes_with_spec_decode_and_prefix_cache(lora_params, kw):
    """A repetitive prompt on adapter 1 streams the merged reference
    with speculative decoding and the prefix cache on (the contiguous
    tiers, or the paged pool's shared prefixes); a repeat hits and
    verifies; the same prompt on the base adapter reuses no adapter-1
    KV."""
    prompt = [7, 9, 7, 9, 7, 9, 7, 9]

    def run(side):
        eng = _engine(side, lora_params, lora_adapters=3, **kw)
        try:
            out = [eng.generate(prompt, max_new_tokens=12,
                                adapter=1).tokens() for _ in range(2)]
            out.append(eng.generate(prompt, max_new_tokens=12).tokens())
            spec = eng.stats()["spec_decode"]
            return out, spec["windows"] > 0
        finally:
            eng.close()

    (a1, a1_again, a0), verified = _both(run)
    assert verified
    want = _ref_greedy(lora_params[1], prompt, 12, 1)
    assert a1 == a1_again == want
    assert a0 == _ref_greedy(lora_params[1], prompt, 12, 0)


@pytest.mark.parametrize("kw", [
    {},
    {"paged_blocks": 20, "paged_block_size": 8},
])
def test_prefix_cache_never_crosses_adapters(lora_params, kw):
    """KV flows through the adapter's wk/wv: a stored adapter-1 prefix
    must never serve a base request of the same tokens (40 tokens, long
    enough that a cross-adapter restore would survive the final
    chunk's recompute); a same-adapter repeat hits."""
    rng = np.random.default_rng(9)
    prompt = rng.integers(1, CFG.vocab_size, 40).tolist()

    def run(side):
        eng = _engine(side, lora_params, lora_adapters=3,
                      prefix_cache_slots=2, prefix_store_min=16, **kw)
        try:
            got1 = eng.generate(prompt, max_new_tokens=6,
                                adapter=1).tokens()
            got0 = eng.generate(prompt, max_new_tokens=6).tokens()
            again = eng.generate(prompt, max_new_tokens=6, adapter=1)
            return (got1, got0, again.tokens(), again.cache_tokens > 0,
                    eng.stats()["prefix_cache"]["hits"])
        finally:
            eng.close()

    got1, got0, again, hit, hits = _both(run)
    assert got1 == again == _ref_greedy(lora_params[1], prompt, 6, 1)
    assert got0 == _ref_greedy(lora_params[1], prompt, 6, 0)
    assert hit and hits >= 1


@pytest.mark.parametrize("kw", [
    {},
    {"paged_blocks": 20, "paged_block_size": 8},
])
def test_load_adapter_invalidates_its_prefix_entries(lora_params, kw):
    """A swap drops the adapter's stored prefixes (the contiguous T0 or
    the paged shared index); the next same-adapter request recomputes
    through the new weights."""
    rng = np.random.default_rng(10)
    prompt = rng.integers(1, CFG.vocab_size, 40).tolist()

    def run(side):
        eng = _engine(side, lora_params, lora_adapters=3,
                      prefix_cache_slots=2, prefix_store_min=16, **kw)
        try:
            eng.generate(prompt, max_new_tokens=4, adapter=1).tokens()
            eng.generate(prompt, max_new_tokens=4, adapter=2).tokens()
            stored = eng.stats()["prefix_cache"]["entries"]
            eng.load_adapter(1, _slot_tree(lora_params[0], 2, side))
            left = eng.stats()["prefix_cache"]["entries"]
            got = eng.generate(prompt, max_new_tokens=6, adapter=1)
            return stored, left, got.tokens(), got.cache_tokens
        finally:
            eng.close()

    stored, left, got, restored = _both(run)
    assert (stored, left, restored) == (2, 1, 0)
    assert got == _ref_greedy(lora_params[1], prompt, 6, 2)


def test_adapter_stack_width_mismatch_rejected(lora_params):
    for side, error in (("jax", ValueError), ("port", ValueError)):
        with pytest.raises(error, match="must\n? ?match|match"):
            _engine(side, lora_params, prompt_buckets=(8,),
                    lora_adapters=5)


def test_numpy_integer_eos(lora_params):
    def run(side):
        eng = _engine(side, lora_params, prompt_buckets=(8,),
                      lora_adapters=3)
        try:
            base = eng.generate([5, 17, 42, 7], max_new_tokens=4).tokens()
            got = eng.generate([5, 17, 42, 7], max_new_tokens=50,
                               eos_id=np.int32(base[1])).tokens()
            return base, got
        finally:
            eng.close()

    base, got = _both(run)
    assert got == base[:base.index(base[1]) + 1]


def test_engine_from_config_with_lora():
    """TPU_LORA_ADAPTERS / TPU_LORA_RANK through either package's rows:
    each engine draws its own A matrices (so they differ), every B is
    zero, so adapter 1 streams the base model's tokens on both; the
    port leases the stacks from the memory arbiter."""
    rows = {"TPU_MODEL": "tiny", "TPU_SEQ_BUCKETS": "8,16",
            "TPU_SLOTS": "2", "TPU_MAX_SEQ": "64", "TPU_LORA_ADAPTERS": "2",
            "TPU_LORA_RANK": "4"}
    jeng = jnew_engine(JMapConfig(rows))
    peng = new_engine_from_config(MapConfig(rows), device="cpu")
    try:
        gen = peng.generator
        assert gen.stats()["lora"] == jeng.generator.stats()["lora"] == {
            "adapters": 2, "rank": 4}
        assert hbm.live_bytes().get("lora") == llama.lora_nbytes(CFG, 2, 4)
        assert gen.params["layers"]["lora_a_wq"].any()
        assert not gen.params["layers"]["lora_b_wq"].any()
        base = peng.generate([1, 2, 3], max_new_tokens=4).tokens()
        assert peng.generate([1, 2, 3], max_new_tokens=4,
                             adapter=1).tokens() == base
        assert len(jeng.generate([1, 2, 3], max_new_tokens=4,
                                 adapter=1).tokens()) == 4
    finally:
        jeng.close()
        peng.close()
    assert "lora" not in hbm.live_bytes() or \
        hbm.live_bytes()["lora"] == 0


def test_a_freed_or_recovered_slot_is_back_on_adapter_0(lora_params):
    """Retirement and the recovery path both put the slot's adapter
    back to 0, so the pack never carries a stale adapter: a stream on
    adapter 2 that ends, then one on adapter 1 live when the engine
    recovers from a failed step (the loop's ``_recover``, run while the
    stream holds its slot)."""
    eng = _engine("port", lora_params, lora_adapters=3)
    try:
        eng.generate([5, 17, 42], max_new_tokens=3, adapter=2).tokens()
        assert not eng._slot_adapter.any()
        live = eng.generate([5, 17, 42], max_new_tokens=40, adapter=1)
        first = next(iter(live))
        with eng._device_lock:
            assert sorted(eng._slot_adapter.tolist()) == [0, 1]
            eng._recover(pchaos.DeviceLost("injected at the step seam"))
            assert not eng._slot_adapter.any()
        with pytest.raises(GenerationError):
            list(live)
        assert eng.stats()["recoveries"] == 1 and eng.down is None
        got = eng.generate([5, 17, 42], max_new_tokens=4, adapter=1).tokens()
        assert got[0] == first
        assert got == _ref_greedy(lora_params[1], [5, 17, 42], 4, 1)
    finally:
        eng.close()


# -- tests/test_paged.py -------------------------------------------------------

def test_paged_multi_lora_streams_match_merged_reference():
    jp = _lora_tree(2, 2, crc_mod=997, second=False)
    params = (jp, from_jax_params(jax.tree.map(np.asarray, jp),
                                  device="cpu"))
    rng = np.random.default_rng(31)
    p = rng.integers(1, CFG.vocab_size, 6).tolist()

    def run(side):
        eng = _engine(side, params, lora_adapters=2, paged_blocks=9,
                      paged_block_size=16)
        try:
            return [eng.generate(p, max_new_tokens=8, adapter=a).tokens()
                    for a in (0, 1)]
        finally:
            eng.close()

    s0, s1 = _both(run)
    assert s0 == _ref_greedy(params[1], p, 8, 0)
    assert s1 == _ref_greedy(params[1], p, 8, 1)


# -- the three tiers (tests/test_kvcache_engine.py, tests/test_kvcache.py) ----

@pytest.fixture
def redis_server():
    srv = FakeRedisServer()
    yield srv
    srv.close()


def _tier_engine(side, params, server):
    common = dict(slots=2, max_seq=128, prompt_buckets=(8, 16, 32),
                  prefix_cache_slots=1, prefix_store_min=16,
                  lora_adapters=3)
    if side == "jax":
        opts = JOptions(block=8, host_mb=64, epoch_refresh_s=0.0,
                        redis=JClient(server.host, server.port))
        return JaxEngine(JCFG, params[0], kv_dtype=jnp.int8, kvcache=opts,
                         **common)
    opts = KVCacheOptions(block=8, host_mb=64, epoch_refresh_s=0.0,
                          redis=RedisClient(server.host, server.port))
    return GenerationEngine(CFG, params[1], kv_dtype=torch.int8,
                            kvcache=opts, device="cpu", **common)


def _end_backoff(tier) -> None:
    """End the tier's post-error backoff window now (it skips every
    consult while it lasts), so the next call reaches Redis."""
    tier._down_until = 0.0


class _BumpFails:
    """Make the tier's epoch bump (INCRBY) fail while ``down``."""

    def __init__(self, client):
        self.down = True
        self.inner = client.incr
        client.incr = self

    def __call__(self, *a, **k):
        if self.down:
            raise ConnectionError("redis unreachable for the bump")
        return self.inner(*a, **k)


def test_adapter_hot_swap_invalidates_all_three_tiers():
    """Adapter-1 KV spilled to T1 and shared through T2 was computed
    through the OLD wk/wv: ``load_adapter`` kills the key in every tier.
    The T2 bump first fails (fail closed: the adapter's shared reads
    stay off, ``pending_bumps`` 1), then lands at the next consult; the
    next adapter-1 stream is the new weights' reference on both
    packages, each over its own fake Redis."""
    jp = _lora_tree(3, 7)
    params = (jp, from_jax_params(jax.tree.map(np.asarray, jp),
                                  device="cpu"))
    rng = np.random.default_rng(9)
    prompt = rng.integers(1, CFG.vocab_size, 32).tolist()
    other = rng.integers(1, CFG.vocab_size, 20).tolist()
    key = np.asarray(prompt, np.int32)

    def run(side):
        server = FakeRedisServer()
        eng = _tier_engine(side, params, server)
        try:
            eng.generate(prompt, max_new_tokens=2, adapter=1).tokens()
            # evict adapter-1's entry into T1 (one T0 row); T2 written
            eng.generate(other, max_new_tokens=2, adapter=1).tokens()
            mgr = eng._kvc
            seen = [mgr.host.match(key, 1)[1] >= 16,
                    mgr.redis.match(key, 1)[0] >= 16]
            bump = _BumpFails(mgr.redis.client)
            eng.load_adapter(1, _slot_tree(params[0], 2, side))
            seen += [mgr.t0.index.entries_for(1),
                     mgr.host.match(key, 1)[1],
                     mgr.redis.stats()["pending_bumps"]]
            # fail closed: past the error backoff, a consult retries the
            # bump, which fails again, and reads nothing of the old epoch
            _end_backoff(mgr.redis)
            seen.append(mgr.redis.match(key, 1)[0])
            seen.append(mgr.redis.stats()["pending_bumps"])
            bump.down = False
            _end_backoff(mgr.redis)
            seen.append(mgr.redis.match(key, 1)[0])   # the bump lands
            seen.append(mgr.redis.stats()["pending_bumps"])
            got = eng.generate(prompt, max_new_tokens=4, adapter=1)
            seen += [got.tokens(), got.cache_tier]
            return seen
        finally:
            eng.close()
            server.close()

    (in_t1, in_t2, t0_left, t1_left, pending, closed_read, still_pending,
     reopened, pending_after, toks, tier) = _both(run)
    assert in_t1 and in_t2
    assert (t0_left, t1_left, pending, still_pending) == (0, 0, 1, 1)
    assert closed_read == 0 and reopened == 0 and pending_after == 0
    assert toks == _ref_greedy(params[1], prompt, 4, 2)
    assert tier is None


def _manager_kv(n: int, layout_dtype=np.int8) -> HostKV:
    rng = np.random.default_rng(n)
    k = torch.from_numpy(rng.integers(-100, 100, (2, n, 2, 16),
                                      dtype=np.int8))
    scale = torch.from_numpy(rng.random((2, n, 2), dtype=np.float32))
    return HostKV(k, k.clone(), scale, scale.clone())


def test_manager_invalidate_adapter_hits_all_tiers(redis_server):
    """tests/test_kvcache.py's three-tier invalidation on the port's
    manager, then once more with the bump failing: the adapter's T2
    reads stay off until a later bump succeeds."""
    cli = RedisClient(redis_server.host, redis_server.port)
    layout = KVLayout(2, 2, 16, True, torch.int8, 64)
    mgr = CacheManager(2, layout, block=16, host_bytes=1 << 20, redis=cli,
                       epoch_refresh_s=0.0)
    a = np.arange(1, 33, dtype=np.int32)
    try:
        mgr.store(a, adapter=1)
        mgr.host.put(a, 1, _manager_kv(32))
        mgr.store_shared(a, 1, _manager_kv(32))
        assert mgr.redis.match(a, 1)[0] == 32
        v0 = mgr.version
        out = mgr.invalidate_adapter(1)
        assert out == {"t0": 1, "t1": 1, "t2": "epoch_bumped"}
        assert mgr.version > v0
        assert mgr.match(a, adapter=1) is None
        assert mgr.redis.match(a, 1) == (0, None)
        # again, with Redis refusing the bump
        mgr.store_shared(a, 1, _manager_kv(32))
        assert mgr.redis.match(a, 1)[0] == 32
        bump = _BumpFails(cli)
        mgr.invalidate_adapter(1)
        assert mgr.redis.stats()["pending_bumps"] == 1
        _end_backoff(mgr.redis)
        assert mgr.redis.match(a, 1) == (0, None)
        _end_backoff(mgr.redis)
        assert mgr.redis.put(a, 1, _manager_kv(32)) == 0   # writes off too
        assert mgr.redis.stats()["pending_bumps"] == 1
        bump.down = False
        _end_backoff(mgr.redis)
        assert mgr.redis.match(a, 1) == (0, None)          # new epoch
        assert mgr.redis.stats()["pending_bumps"] == 0
        assert mgr.redis.put(a, 1, _manager_kv(32)) == 2
        assert mgr.redis.match(a, 1)[0] == 32
    finally:
        cli.close()


def test_manager_invalidation_matches_jax_key_for_key(redis_server):
    """The same script on each package's manager over one fake Redis:
    the same counts, and the epoch keys the bumps leave."""
    out = {}
    for side in ("jax", "port"):
        if side == "jax":
            cli = JClient(redis_server.host, redis_server.port)
            layout = JLayout(2, 2, 16, True, np.dtype(np.int8), 64)
            mgr = JManager(2, layout, block=16, host_bytes=1 << 20,
                           redis=cli, epoch_refresh_s=0.0)
        else:
            cli = RedisClient(redis_server.host, redis_server.port)
            layout = KVLayout(2, 2, 16, True, torch.int8, 64)
            mgr = CacheManager(2, layout, block=16, host_bytes=1 << 20,
                               redis=cli, epoch_refresh_s=0.0)
        a = np.arange(1, 33, dtype=np.int32)
        mgr.store(a, adapter=2)
        mgr.store(a[:16], adapter=0)
        res = mgr.invalidate_adapter(2)
        ep = cli.get(mgr.redis._epoch_key(2))
        out[side] = (res, len(mgr.t0), int(ep),
                     mgr.redis._epoch_key(2).split(":", 2)[-1])
        cli.close()
    assert out["jax"][0] == out["port"][0] == {"t0": 1, "t1": 0,
                                               "t2": "epoch_bumped"}
    assert out["jax"][1] == out["port"][1] == 1
    # the second bump of the same key: one epoch past the first
    assert out["port"][2] == out["jax"][2] + 1


# -- examples/tpu-multi-lora on both Apps --------------------------------------

@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "tiny.npz"
    save_npz(str(path), jax.tree.map(
        np.asarray, jllama.init(JCFG, jax.random.PRNGKey(1))))
    return str(path)


def _load_example(side: str, env: dict):
    """examples/tpu-multi-lora/main.py as written, on either package:
    the port's copy is the same source with ``gofr_tpu`` imports read
    as ``gofr_tpu_torch``; its App is built from ``env`` (on the CPU
    for the port)."""
    src = (EXAMPLES / "tpu-multi-lora" / "main.py").read_text()
    if side == "port":
        src = src.replace("from gofr_tpu import App",
                          "from gofr_tpu_torch import App")
        src = src.replace("from gofr_tpu.models.llama import",
                          "from gofr_tpu_torch.models.llama import")
        assert "gofr_tpu." not in src.replace("gofr_tpu_torch", "")
        cls, cfg, kw = gofr_tpu_torch.App, MapConfig, {"device": "cpu"}
    else:
        cls, cfg, kw = gofr_tpu.App, JMapConfig, {}
    orig = cls.__init__

    def patched(self, config=None, config_folder="./configs", **_):
        orig(self, cfg(env), **kw)

    cls.__init__ = patched
    try:
        name = f"example_multi_lora_{side}"
        spec = importlib.util.spec_from_loader(name, loader=None)
        mod = importlib.util.module_from_spec(spec)
        mod.__file__ = str(EXAMPLES / "tpu-multi-lora" / "main.py")
        sys.modules[name] = mod
        exec(compile(src, mod.__file__, "exec"), mod.__dict__)
        return mod
    finally:
        cls.__init__ = orig


def _http(method, url, body=None, raw: bytes | None = None):
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def test_the_multi_lora_routes_answer_alike_on_both_apps(weights_npz):
    """The example's three routes: adapter-0 tokens, ``GET /adapters``,
    an npz hot-swap into slot 1 (A and B for every target), then the
    installed adapter's tokens (they part from the base's), an adapter
    out of range and a slot-0 install refused the same way."""
    env = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR",
           "TPU_MODEL": "tiny", "TPU_WEIGHTS": weights_npz,
           "TPU_MAX_SEQ": "64", "TPU_SLOTS": "2", "TPU_SEQ_BUCKETS": "8,16",
           "TPU_LORA_ADAPTERS": "3", "TPU_LORA_RANK": "4"}
    lora = jllama.init_lora(JCFG, 1, 4, jax.random.PRNGKey(7))
    arrays = {}
    for name in jllama.LORA_TARGETS:
        a = np.asarray(lora[f"lora_a_{name}"][:, 0])
        dout = (JCFG.dim if name == "wo" else
                (JCFG.n_heads if name == "wq" else JCFG.n_kv_heads)
                * JCFG.head_dim)
        arrays[f"{name}.a"] = a
        arrays[f"{name}.b"] = np.random.default_rng(
            zlib.crc32(name.encode())).normal(
            0, 0.5, (a.shape[0], a.shape[-1], dout)).astype(np.float32)
    buf = io.BytesIO()
    np.savez(buf, **arrays)

    def run(side):
        mod = _load_example(side, env)
        app = mod.app
        with app:
            base = f"http://127.0.0.1:{app.http_port}"
            gen = {"tokens": [1, 2, 3, 4, 5], "max_new_tokens": 6}
            out = [_http("POST", base + "/generate", dict(gen, adapter=0)),
                   _http("GET", base + "/adapters"),
                   _http("POST", base + "/adapters/1",
                         raw=buf.getvalue()),
                   _http("POST", base + "/generate", dict(gen, adapter=1)),
                   _http("POST", base + "/generate", dict(gen, adapter=7))[0],
                   _http("POST", base + "/adapters/0",
                         raw=buf.getvalue())[0]]
        return out

    base0, listed, installed, tuned, bad_adapter, bad_slot = _both(run)
    assert base0[0] == 200 and len(base0[1]["data"]["tokens"]) == 6
    assert listed == (200, {"data": {"adapters": 3, "rank": 4}})
    assert installed == (200, {"data": {"installed": 1, "targets": [
        "wk", "wo", "wq", "wv"]}})
    assert tuned[0] == 200 and tuned[1]["data"]["adapter"] == 1
    assert tuned[1]["data"]["tokens"] != base0[1]["data"]["tokens"]
    # the engine's GenerationError and the refused slot: both Apps 500
    assert bad_adapter == bad_slot == 500
