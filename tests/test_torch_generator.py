"""The port's serving engine (gofr_tpu_torch.tpu) against the JAX
package's GenerationEngine on `tiny`, with the same weights carried
across, on the CPU (device="cpu": the port's entry points run there only
when asked).

Both engines: 4 slots, K=4 fused decode blocks, dispatch depth 1, an
int8 KV cache. Greedy streams are token-identical, and EOS and budget
stop both at the same token. Sampled streams are token-identical too:
the port draws JAX's threefry bits under the same key,
``fold_in(PRNGKey(seed), position)`` (the words bit-equal, the Gumbel
values within one ulp of ``log``).
"""

import threading

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
from gofr_tpu_torch.tpu import (GenerationEngine, GenerationError,
                                from_jax_params, new_engine_from_config)

SLOTS, BLOCK, MAX_SEQ = 4, 4, 128
PROMPTS = [[5, 9, 17], list(range(1, 30)), list(range(40, 100, 3))]


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JAX_CONFIGS["tiny"], jax.random.PRNGKey(7))
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


@pytest.fixture(scope="module")
def engines(weights):
    jparams, tparams = weights
    jeng = JaxEngine(JAX_CONFIGS["tiny"], jparams, slots=SLOTS,
                     max_seq=MAX_SEQ, decode_block=BLOCK, decode_pipeline=1,
                     kv_dtype=jnp.int8)
    teng = GenerationEngine(LLAMA_CONFIGS["tiny"], tparams, slots=SLOTS,
                            max_seq=MAX_SEQ, decode_block=BLOCK,
                            kv_dtype=torch.int8, device="cpu")
    yield jeng, teng
    jeng.close()
    teng.close()


def _both(engines, prompts, **kw):
    jeng, teng = engines
    js = [jeng.generate(p, **kw) for p in prompts]
    ts = [teng.generate(p, **kw) for p in prompts]
    return [s.tokens() for s in js], [s.tokens() for s in ts]


def test_concurrent_greedy_streams_match_jax(engines):
    want, got = _both(engines, PROMPTS, max_new_tokens=24)
    assert [len(t) for t in got] == [24, 24, 24]
    assert got == want


def test_eos_and_budget_stop_at_the_same_token(engines):
    (free,), _ = _both(engines, PROMPTS[1:2], max_new_tokens=12)
    eos = free[5]
    want, got = _both(engines, PROMPTS[1:2], max_new_tokens=12, eos_id=eos)
    assert got == want
    assert got[0][-1] == eos and len(got[0]) == free.index(eos) + 1
    want, got = _both(engines, PROMPTS[:2], max_new_tokens=3)
    assert got == want and [len(t) for t in got] == [3, 3]
    # a stop set, with the first token already in it, ends at once
    want, got = _both(engines, PROMPTS[2:], max_new_tokens=9,
                      eos_id={free[0], -5} | set(range(256)))
    assert got == want and len(got[0]) == 1


def test_logprobs_match_jax(engines):
    jeng, teng = engines
    want = list(jeng.generate(PROMPTS[0], max_new_tokens=6, logprobs=True))
    got = list(teng.generate(PROMPTS[0], max_new_tokens=6, logprobs=True))
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([lp for _, lp in got],
                               [lp for _, lp in want], atol=1e-4)


def test_same_seed_gives_the_same_sampled_stream(engines):
    _, teng = engines
    kw = dict(max_new_tokens=16, temperature=0.8, top_k=20)
    a = teng.generate(PROMPTS[1], seed=42, **kw)
    b = teng.generate(PROMPTS[1], seed=42, **kw)
    c = teng.generate(PROMPTS[1], seed=43, **kw)
    ta, tb, tc = a.tokens(), b.tokens(), c.tokens()
    assert ta == tb and len(ta) == 16
    assert ta != tc
    assert a.seed == 42


@pytest.mark.parametrize("seed", [0, 1, 42, 123457, 2**31 - 1])
def test_threefry_keys_and_words_equal_jax(seed):
    from gofr_tpu_torch.tpu import prng

    pos = np.array([0, 1, 7, 511, 4095, 2**20 + 3], np.int64)
    seeds = np.full(pos.shape, seed, np.int64)
    want_keys = jax.vmap(
        lambda s, p: jax.random.fold_in(jax.random.PRNGKey(s), p))(
        jnp.asarray(seeds, jnp.int32), jnp.asarray(pos, jnp.int32))
    keys = prng.fold_in(prng.prng_key(torch.from_numpy(seeds)),
                        torch.from_numpy(pos))
    np.testing.assert_array_equal(keys.numpy(),
                                  np.asarray(want_keys).astype(np.int64))
    want_bits = jax.vmap(lambda k: jax.random.bits(k, (300,)))(want_keys)
    np.testing.assert_array_equal(prng.random_bits(keys, 300).numpy(),
                                  np.asarray(want_bits).astype(np.int64))
    # Gumbel values: the same uniforms through log twice, one ulp apart
    want_g = jax.vmap(lambda k: jax.random.gumbel(k, (300,)))(want_keys)
    np.testing.assert_allclose(prng.gumbel(keys, 300).numpy(),
                               np.asarray(want_g), rtol=0, atol=1e-6)


@pytest.mark.parametrize("top_k", [0, 20])
def test_sampled_streams_match_jax(engines, top_k):
    prompts = [PROMPTS[0], PROMPTS[1], PROMPTS[2]]
    jeng, teng = engines
    kw = dict(max_new_tokens=16, temperature=0.8, top_k=top_k)
    js = [jeng.generate(p, seed=s, **kw) for p, s in zip(prompts, (5, 6, 7))]
    ts = [teng.generate(p, seed=s, **kw) for p, s in zip(prompts, (5, 6, 7))]
    want, got = [s.tokens() for s in js], [s.tokens() for s in ts]
    assert [len(t) for t in got] == [16, 16, 16]
    assert got == want
    # and they really sample: the greedy streams differ
    greedy = teng.generate(prompts[1], max_new_tokens=16).tokens()
    assert got[1] != greedy


def test_unseeded_sampling_gets_a_deterministic_seed(weights):
    _, tparams = weights
    streams = []
    for _ in range(2):
        eng = GenerationEngine(LLAMA_CONFIGS["tiny"], tparams, slots=2,
                               max_seq=64, device="cpu", seed=3)
        try:
            s = eng.generate(PROMPTS[0], max_new_tokens=8, temperature=1.0)
            streams.append((s.tokens(), s.seed))
        finally:
            eng.close()
    assert streams[0] == streams[1] and streams[0][1] is not None


def test_top_k_one_is_greedy(engines):
    _, teng = engines
    greedy = teng.generate(PROMPTS[2], max_new_tokens=8).tokens()
    top1 = teng.generate(PROMPTS[2], max_new_tokens=8, temperature=0.7,
                         top_k=1, seed=9).tokens()
    assert top1 == greedy


def test_capacity_retires_the_stream(weights):
    _, tparams = weights
    eng = GenerationEngine(LLAMA_CONFIGS["tiny"], tparams, slots=2,
                           max_seq=16, device="cpu")
    try:
        toks = eng.generate(list(range(1, 11)), max_new_tokens=50).tokens()
        # the last delivered token would sit at position max_seq - 1
        assert len(toks) == 16 - 1 - 10
        with pytest.raises(GenerationError, match="exceeds"):
            eng.generate(list(range(16)), max_new_tokens=2).tokens()
        with pytest.raises(GenerationError, match="empty"):
            eng.generate([], max_new_tokens=2).tokens()
    finally:
        eng.close()


def test_close_leaves_no_thread_and_refuses_work(weights):
    _, tparams = weights
    eng = GenerationEngine(LLAMA_CONFIGS["tiny"], tparams, slots=2,
                           max_seq=32, device="cpu")
    assert eng._thread.name == "gofr-torch-gen" and eng._thread.is_alive()
    eng.generate([1, 2, 3], max_new_tokens=2).tokens()
    eng.close()
    assert not eng._thread.is_alive()
    assert not [t for t in threading.enumerate()
                if t is eng._thread]
    with pytest.raises(GenerationError, match="closed"):
        eng.generate([1, 2], max_new_tokens=1)


def test_cancel_ends_the_stream_and_frees_the_slot(weights):
    _, tparams = weights
    eng = GenerationEngine(LLAMA_CONFIGS["tiny"], tparams, slots=1,
                           max_seq=128, device="cpu")
    try:
        stream = eng.generate([5, 9, 17], max_new_tokens=120)
        next(iter(stream))
        stream.cancel()
        rest = list(stream)   # ends at the cancel, not at the budget
        assert len(rest) < 119
        # the one slot is free again
        assert len(eng.generate([1, 2], max_new_tokens=3).tokens()) == 3
        assert eng.stats()["active"] == 0
    finally:
        eng.close()


@pytest.mark.parametrize("kw", [
    {"prefix_cache_slots": 2}, {"spec_decode_k": 4, "lora_adapters": 2},
    {"lora_adapters": 2},
    {"paged_blocks": 64, "prefix_cache_slots": 2},
    {"decode_pipeline": 2, "lora_adapters": 2},
    {"kvcache": object()},
    {"mesh": object()},
])
def test_features_outside_the_slice_raise(weights, kw):
    _, tparams = weights
    with pytest.raises(ValueError, match="not ported"):
        GenerationEngine(LLAMA_CONFIGS["tiny"], tparams, slots=2,
                         max_seq=32, device="cpu", **kw)


@pytest.fixture
def card(monkeypatch):
    """torch reports a card; the engine's construction-time check runs
    before anything is allocated on it, so no card is touched."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


LLAMA3 = LLAMA_CONFIGS["llama3-8b"]


@pytest.mark.parametrize("cfg,kw,match", [
    (LLAMA_CONFIGS["tiny"], {}, r"'tiny' \(head_dim 16, .*float32\)"),
    (LLAMA_CONFIGS["tiny"], {"paged_blocks": 9, "paged_block_size": 16},
     "head_dim 16"),
    (LLAMA_CONFIGS["llama-1b"], {}, "head_dim 64"),
    (LLAMA3.with_(dtype="float32"), {}, "bf16 activations, got "
     "torch.float32"),
    (LLAMA3, {"paged_blocks": 9, "paged_block_size": 12}, "multiple of 8"),
    (LLAMA3, {"paged_blocks": 9, "spec_decode_k": 16}, "W=17"),
    (LLAMA3.with_(n_heads=24, dim=3072), {}, "H/KV"),
    (LLAMA3, {"kv_dtype": torch.float32}, "int8 or bf16 KV cache"),
])
def test_a_cuda_engine_refuses_at_construction_what_the_kernels_do_not_take(
        card, cfg, kw, match):
    """On a CUDA device the engine names the model's shape and the
    kernel that refuses it, before it starts a stream or allocates."""
    started = threading.active_count()
    with pytest.raises(ValueError, match=match):
        GenerationEngine(cfg, {}, slots=2, max_seq=64, device="cuda", **kw)
    assert threading.active_count() == started


@pytest.mark.parametrize("kernel,kw,error", [
    ("flash_prefill", {}, None),
    ("flash_decode", {}, None),
    ("paged_decode", {"block_size": 128}, None),
    ("paged_window", {"block_size": 128, "window": 5}, None),
    ("paged_window", {"block_size": 16, "window": 16}, None),
    ("paged_window", {"block_size": 128, "window": 17}, ValueError),
    ("paged_window", {"block_size": 128, "window": 0}, ValueError),
    ("flash_decode", {"window": 2}, ValueError),
    ("paged_decode", {"block_size": 12}, ValueError),
    ("paged_decode", {}, ValueError),
    ("flash_decode", {"head_dim": 64}, ValueError),
    ("flash_prefill", {"head_dim": 16}, ValueError),
    ("flash_decode", {"dtype": torch.float32}, TypeError),
    ("flash_prefill", {"dtype": torch.float32}, TypeError),
    ("flash_prefill", {"n_heads": 24}, None),     # any whole group
    ("flash_decode", {"n_heads": 24}, ValueError),
    ("flash_prefill", {"n_heads": 20}, ValueError),
    ("unknown", {}, ValueError),
])
def test_the_shared_kernel_shape_check(kernel, kw, error):
    """The one function every wrapper's input check and the engine's
    construction-time check call, on Llama-3-8B's shapes and variants."""
    from gofr_tpu_torch.ops import kernels

    args = dict(head_dim=128, n_heads=32, n_kv_heads=8,
                dtype=torch.bfloat16)
    args.update(kw)
    if error is None:
        kernels.check_attention_shape(kernel, **args)
    else:
        with pytest.raises(error):
            kernels.check_attention_shape(kernel, **args)


def test_new_engine_from_config_serves_on_the_cpu():
    eng = new_engine_from_config(MapConfig({
        "TPU_MODEL": "tiny", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "64",
        "TPU_KV_DTYPE": "int8", "TPU_DECODE_BLOCK": "2"}), device="cpu")
    try:
        toks = eng.generate([3, 4, 5], max_new_tokens=5).tokens()
        assert len(toks) == 5
        health = eng.health_check()
        assert health.status == "UP"
        stats = health.details["generator"]
        assert stats["kv_dtype"] == "torch.int8" and stats["slots"] == 2
        assert stats["decode_block"] == 2 and stats["admissions"] == 1
    finally:
        eng.close()
    assert eng.health_check().status == "DOWN"


def test_new_engine_from_config_loads_jax_weights(weights, tmp_path):
    from gofr_tpu.tpu.checkpoint import save_npz

    jparams, _ = weights
    path = str(tmp_path / "tiny.npz")
    save_npz(path, jparams)
    jeng = JaxEngine(JAX_CONFIGS["tiny"], jparams, slots=2, max_seq=64,
                     decode_block=2, decode_pipeline=1, kv_dtype=jnp.int8)
    eng = new_engine_from_config(MapConfig({
        "TPU_MODEL": "tiny", "TPU_WEIGHTS": path, "TPU_SLOTS": "2",
        "TPU_MAX_SEQ": "64", "TPU_DECODE_BLOCK": "2"}), device="cpu")
    try:
        want = jeng.generate(PROMPTS[1], max_new_tokens=10).tokens()
        got = eng.generate(PROMPTS[1], max_new_tokens=10).tokens()
        assert got == want
    finally:
        eng.close()
        jeng.close()


@pytest.mark.parametrize("rows,name", [
    ({"TPU_PAGED_BLOCKS": "64", "TPU_PREFIX_CACHE": "4"}, "TPU_PREFIX_CACHE"),
    ({"TPU_MAX_QUEUE_DEPTH": "16"}, "TPU_MAX_QUEUE_DEPTH"),
    ({"TPU_SERVING_ROLE": "prefill"}, "TPU_SERVING_ROLE"),
])
def test_rows_the_port_does_not_honour_raise_with_their_name(rows, name):
    with pytest.raises(ValueError, match=name):
        new_engine_from_config(MapConfig({"TPU_MODEL": "tiny", **rows}),
                               device="cpu")


def test_unknown_model_raises():
    with pytest.raises(KeyError, match="mixtral"):
        new_engine_from_config(MapConfig({"TPU_MODEL": "mixtral-8x22b"}),
                               device="cpu")


def test_env_config_reads_rows_as_the_jax_reader_does(tmp_path, monkeypatch):
    from gofr_tpu.config import EnvConfig as JaxEnvConfig
    from gofr_tpu_torch.config import EnvConfig

    (tmp_path / ".env").write_text(
        "# serving rows\nTPU_MODEL=tiny\nexport TPU_SLOTS=6\n"
        "TPU_MAX_SEQ='96'\nTPU_DECODE_BLOCK=x2 # malformed\n"
        "TPU_KV_DTYPE=\"bfloat16\"\nnot a row\n")
    (tmp_path / ".stage.env").write_text("TPU_SLOTS=3\n")
    monkeypatch.setenv("APP_ENV", "stage")
    monkeypatch.setenv("TPU_MAX_SEQ", "80")
    jcfg, tcfg = JaxEnvConfig(str(tmp_path)), EnvConfig(str(tmp_path))
    for row in ("TPU_MODEL", "TPU_SLOTS", "TPU_MAX_SEQ", "TPU_DECODE_BLOCK",
                "TPU_KV_DTYPE", "TPU_WEIGHTS"):
        assert tcfg.get(row) == jcfg.get(row), row
        assert tcfg.get_int(row, -1) == jcfg.get_int(row, -1), row
    assert (tcfg.get_int("TPU_SLOTS", 0), tcfg.get_int("TPU_MAX_SEQ", 0),
            tcfg.get_int("TPU_DECODE_BLOCK", 4)) == (3, 80, 4)
