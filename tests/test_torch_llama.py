"""The port's Llama decoder (gofr_tpu_torch.models.llama) against the JAX
package's (gofr_tpu.models.llama) on the `tiny` config, with the JAX
weights carried across by gofr_tpu_torch.tpu.checkpoint.from_jax_params,
on the CPU.

Logits agree to atol 1e-4 (float32 through two layers); the int8 cache
the prefill writes is bit-equal; greedy decoding gives the same tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.ops.quant import QuantizedLinear as JaxQuantizedLinear
from gofr_tpu.tpu import checkpoint as jcheckpoint
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.ops.quant import QuantizedLinear
from gofr_tpu_torch.tpu import checkpoint

JCFG = JAX_CONFIGS["tiny"]
CFG = LLAMA_CONFIGS["tiny"]
LOGIT_ATOL = 1e-4
SMAX = 64


def _numpy_tree(tree):
    def leaf(x):
        if isinstance(x, JaxQuantizedLinear):
            return JaxQuantizedLinear(np.asarray(x.w), np.asarray(x.scale))
        return np.asarray(x)

    return jax.tree.map(leaf, tree,
                        is_leaf=lambda x: isinstance(x, JaxQuantizedLinear))


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JCFG, jax.random.PRNGKey(0))
    return jparams, checkpoint.from_jax_params(_numpy_tree(jparams),
                                               device="cpu")


def _prompts(seed=0, b=2, s=12, lengths=(12, 7)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, CFG.vocab_size, (b, s)),
            np.asarray(lengths, np.int32))


def test_config_mirrors_the_jax_package():
    for name, tcfg in LLAMA_CONFIGS.items():
        jcfg = JAX_CONFIGS[name]
        for field in ("vocab_size", "dim", "n_layers", "n_heads",
                      "n_kv_heads", "ffn_dim", "max_seq", "rope_theta",
                      "norm_eps", "tie_embeddings", "dtype", "n_experts"):
            assert getattr(tcfg, field) == getattr(jcfg, field), (name, field)
    assert LLAMA_CONFIGS["llama3-8b"].head_dim == 128


def test_carried_weights_keep_layout_and_values(weights):
    jparams, tparams = weights
    assert tparams["layers"]["wq"].shape == jparams["layers"]["wq"].shape
    for key in ("embedding", "lm_head", "final_norm"):
        np.testing.assert_array_equal(tparams[key].numpy(),
                                      np.asarray(jparams[key]))


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_kv_logits_match_jax(weights, flash):
    jparams, tparams = weights
    tokens, lengths = _prompts()
    jl, jk, jv, _ = jllama.prefill_kv(jparams, JCFG, jnp.asarray(tokens),
                                      jnp.asarray(lengths), flash=flash)
    tl, tk, tv, _ = llama.prefill_kv(tparams, CFG, torch.from_numpy(tokens),
                                     torch.from_numpy(lengths), flash=flash)
    # positions at or past a length are padding: their rows differ
    # between the kernel's function (zeros) and the reference (garbage)
    valid = np.arange(tokens.shape[1])[None, :] < lengths[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                               atol=LOGIT_ATOL, rtol=0)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy()[:, valid],
                                   np.asarray(want)[:, valid], atol=1e-5,
                                   rtol=0)


def test_prefill_kv_logit_pos_gathers_before_the_head(weights):
    jparams, tparams = weights
    tokens, lengths = _prompts(1)
    pos = lengths - 1
    jl, *_ = jllama.prefill_kv(jparams, JCFG, jnp.asarray(tokens),
                               jnp.asarray(lengths),
                               logit_pos=jnp.asarray(pos))
    tl, *_ = llama.prefill_kv(tparams, CFG, torch.from_numpy(tokens),
                              torch.from_numpy(lengths),
                              logit_pos=torch.from_numpy(pos))
    assert tl.shape == (2, 1, CFG.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)


def test_int8_cache_after_prefill_is_bit_equal(weights):
    """The int8 codes of a prefilled cache are bit-equal to JAX's, and
    the port's cache write of the same K/V stacks is bit-equal in codes
    and scales. (The two prefills' float32 K/V themselves differ in the
    last bits -- the frameworks sum matmuls in other orders -- so their
    scales agree to rtol 1e-5.)"""
    jparams, tparams = weights
    tokens, lengths = _prompts(2)
    jcache = jllama.init_cache(JCFG, 2, SMAX, dtype=jnp.int8)
    _, jk, jv, _ = jllama.prefill_kv(jparams, JCFG, jnp.asarray(tokens),
                                     jnp.asarray(lengths))
    jcache = jllama.write_kv(jcache, jk, jv, (0, 0, 0, 0, 0),
                             jnp.asarray(lengths))
    _, k, v, _ = llama.prefill_kv(tparams, CFG, torch.from_numpy(tokens),
                                  torch.from_numpy(lengths))
    ported = llama.init_cache(CFG, 2, SMAX, dtype=torch.int8, device="cpu")
    llama.write_kv(ported, k, v, lengths=torch.from_numpy(lengths))
    carried = llama.init_cache(CFG, 2, SMAX, dtype=torch.int8, device="cpu")
    llama.write_kv(carried, torch.from_numpy(np.array(jk)),
                   torch.from_numpy(np.array(jv)),
                   lengths=torch.from_numpy(lengths))
    for name in ("k", "v", "k_scale", "v_scale", "lengths"):
        np.testing.assert_array_equal(getattr(carried, name).numpy(),
                                      np.asarray(getattr(jcache, name)),
                                      err_msg=name)
    for name in ("k", "v", "k_scale", "v_scale"):
        got = getattr(ported, name).numpy()
        want = np.asarray(getattr(jcache, name))
        for b, n in enumerate(lengths):  # the live rows of each slot
            if name in ("k", "v"):
                np.testing.assert_array_equal(got[:, b, :n], want[:, b, :n],
                                              err_msg=name)
            else:
                np.testing.assert_allclose(got[:, b, :n], want[:, b, :n],
                                           rtol=1e-5, atol=0,
                                           err_msg=name)


def _greedy(step_fn, logits0, cache, n):
    tokens, out = logits0.argmax(-1), []
    for _ in range(n):
        out.append(tokens)
        logits, cache = step_fn(tokens, cache)
        tokens = logits.argmax(-1)
    return np.stack([np.asarray(t) for t in out], 1)


@pytest.mark.parametrize("kv_dtype", ["int8", "float32"])
def test_32_greedy_decode_steps_match_jax(weights, kv_dtype):
    jparams, tparams = weights
    tokens, lengths = _prompts(3)
    pos = lengths - 1
    jcache = jllama.init_cache(JCFG, 2, SMAX, dtype=getattr(jnp, kv_dtype))
    jl, jcache = jllama.prefill(jparams, JCFG, jnp.asarray(tokens), jcache,
                                jnp.asarray(lengths))
    jlast = jl[jnp.arange(2), jnp.asarray(pos)]
    step = jax.jit(lambda t, c: jllama.decode_step(jparams, JCFG, t, c))
    want = _greedy(step, jlast, jcache, 32)

    tcache = llama.init_cache(CFG, 2, SMAX, dtype=getattr(torch, kv_dtype),
                              device="cpu")
    tl, k, v, _ = llama.prefill_kv(tparams, CFG, torch.from_numpy(tokens),
                                   torch.from_numpy(lengths),
                                   logit_pos=torch.from_numpy(pos))
    llama.write_kv(tcache, k, v, lengths=torch.from_numpy(lengths))
    got = _greedy(lambda t, c: llama.decode_step(tparams, CFG, t, c,
                                                 flash=True),
                  tl[:, 0], tcache, 32)
    np.testing.assert_array_equal(got, want)
    assert tcache.lengths.tolist() == (lengths + 32).tolist()


def test_decode_write_at_capacity_drops(weights):
    _, tparams = weights
    cache = llama.init_cache(CFG, 2, 8, dtype=torch.int8, device="cpu")
    cache.k.fill_(7)
    cache.lengths = torch.tensor([8, 3], dtype=torch.int32)
    before = cache.k.clone()
    logits, cache = llama.decode_step(tparams, CFG,
                                      torch.tensor([1, 2]), cache)
    assert torch.isfinite(logits).all()
    assert torch.equal(cache.k[:, 0], before[:, 0])     # parked: dropped
    assert not torch.equal(cache.k[:, 1, 3], before[:, 1, 3])  # written
    assert cache.lengths.tolist() == [9, 4]


def test_write_kv_past_capacity_raises():
    cache = llama.init_cache(CFG, 1, 8, device="cpu")
    k = torch.zeros((CFG.n_layers, 1, 9, CFG.n_kv_heads, CFG.head_dim))
    with pytest.raises(ValueError, match="capacity"):
        llama.write_kv(cache, k, k)


def test_decode_stop_mask_matches_jax():
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 10, 6)
    lengths = rng.integers(0, 20, 6).astype(np.int32)
    budget = rng.integers(-1, 3, 6)
    eos = np.full((6, 3), llama.EOS_PAD)
    eos[:, 0] = rng.integers(0, 10, 6)
    want = jllama.decode_stop_mask(*(jnp.asarray(a) for a in
                                     (toks, lengths, budget, eos)), 15)
    got = llama.decode_stop_mask(*(torch.from_numpy(a) for a in
                                   (toks, lengths, budget, eos)), 15)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantized_weights_carry_across(weights, tmp_path):
    """An int8-quantized JAX tree, directly and through the JAX
    package's .npz format, gives the port the same logits."""
    from gofr_tpu.ops.quant import maybe_quantize_tree

    jparams, _ = weights
    jq = maybe_quantize_tree(jparams, True, min_size=1)
    path = str(tmp_path / "tiny_int8.npz")
    jcheckpoint.save_npz(path, jq)
    direct = checkpoint.from_jax_params(_numpy_tree(jq), device="cpu")
    loaded = checkpoint.load_npz(path, device="cpu")
    assert isinstance(loaded["layers"]["wq"], QuantizedLinear)
    tokens, lengths = _prompts(5)
    want = jllama.forward(jq, JCFG, jnp.asarray(tokens), jnp.asarray(lengths))
    valid = np.arange(tokens.shape[1])[None, :] < lengths[:, None]
    for tparams in (direct, loaded):
        got = llama.forward(tparams, CFG, torch.from_numpy(tokens),
                            torch.from_numpy(lengths))
        np.testing.assert_allclose(got.numpy()[valid],
                                   np.asarray(want)[valid],
                                   atol=LOGIT_ATOL, rtol=0)


def test_maybe_quantize_matches_the_jax_loader(weights):
    jparams, tparams = weights
    jq = jcheckpoint.maybe_quantize(jparams, True)
    tq = checkpoint.maybe_quantize(tparams, True)
    for key in ("wq", "w_down"):
        np.testing.assert_array_equal(tq["layers"][key].w.numpy(),
                                      np.asarray(jq["layers"][key].w))
        np.testing.assert_array_equal(tq["layers"][key].scale.numpy(),
                                      np.asarray(jq["layers"][key].scale))
    assert isinstance(tq["embedding"], torch.Tensor)


def test_random_init_is_seeded_and_shaped():
    a = llama.init(CFG, 3, device="cpu")
    b = llama.init(CFG, 3, device="cpu")
    c = llama.init(CFG, 4, device="cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
    assert a["layers"]["w_gate"].shape == (CFG.n_layers, CFG.dim,
                                           CFG.ffn_dim)
    # truncated at two standard deviations of the fan-in scale
    assert a["layers"]["wq"].abs().max() <= 2 * CFG.dim ** -0.5 + 1e-6
