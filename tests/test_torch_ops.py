"""The port's plain tensor ops (gofr_tpu_torch.ops) against their JAX
counterparts (gofr_tpu.ops) on the same seeded numpy inputs, on the CPU.

Float ops in float32 agree to atol 1e-5 (the two frameworks sum in
different orders); the int8 codecs round half to even on both sides and
must agree bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ops import attention as jattn
from gofr_tpu.ops import norms as jnorms
from gofr_tpu.ops import quant as jquant
from gofr_tpu.ops import rope as jrope
from gofr_tpu_torch.ops import attention as tattn
from gofr_tpu_torch.ops import norms as tnorms
from gofr_tpu_torch.ops import quant as tquant
from gofr_tpu_torch.ops import rope as trope

ATOL = 1e-5
LLAMA3_SCALING = {"factor": 8.0, "low_freq_factor": 1.0,
                  "high_freq_factor": 4.0, "original_max_position": 64}


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=0)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, w = _randn(rng, 3, 5, 64), _randn(rng, 64)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    _close(got, want)


@pytest.mark.parametrize("scaling", [None, LLAMA3_SCALING])
def test_rope_frequencies_match_jax(scaling):
    jc, js = jrope.rope_frequencies(128, 300, 500000.0, scaling)
    tc, ts = trope.rope_frequencies(128, 300, 500000.0, scaling,
                                    device="cpu")
    assert tc.shape == (300, 64) and tc.dtype == torch.float32
    _close(tc, jc)
    _close(ts, js)


def test_rope_tables_default_to_the_card_and_take_the_cpu_when_asked(
        monkeypatch):
    """Like every entry point, the rope tables are built on the card
    unless the caller asks for another device: without a card the default
    raises, and device="cpu" works."""
    from gofr_tpu_torch.models import LLAMA_CONFIGS, llama

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = LLAMA_CONFIGS["tiny"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trope.rope_frequencies(32, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.get_rope_tables(tiny, 16)
    cos, sin = llama.get_rope_tables(tiny, 16, "cpu")
    assert cos.device.type == sin.device.type == "cpu"
    assert cos.shape == (16, tiny.head_dim // 2)
    want = trope.rope_frequencies(tiny.head_dim, 16, tiny.rope_theta,
                                  tiny.rope_scaling, device="cpu")
    assert torch.equal(cos, want[0]) and torch.equal(sin, want[1])


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = _randn(rng, 2, 7, 4, 32)
    pos = rng.integers(0, 50, (2, 7))
    jc, js = jrope.rope_frequencies(32, 50, 10000.0)
    tc, ts = trope.rope_frequencies(32, 50, 10000.0, device="cpu")
    want = jrope.apply_rope(jnp.asarray(x), jc, js, jnp.asarray(pos))
    got = trope.apply_rope(torch.from_numpy(x), tc, ts, torch.from_numpy(pos))
    _close(got, want)


@pytest.mark.parametrize("quantized", [False, True])
def test_qmatmul_matches_jax(quantized):
    rng = np.random.default_rng(2)
    x, w = _randn(rng, 3, 4, 64), _randn(rng, 64, 48)
    jw = jnp.asarray(w)
    tw = torch.from_numpy(w)
    if quantized:
        jw, tw = jquant.quantize_int8(jw), tquant.quantize_int8(tw)
    want = jquant.qmatmul(jnp.asarray(x), jw)
    got = tquant.qmatmul(torch.from_numpy(x), tw)
    _close(got, want, atol=1e-4 if quantized else ATOL)


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_int8_is_bit_exact(axis):
    rng = np.random.default_rng(3)
    w = _randn(rng, 96, 80)
    # values on a rounding midpoint exercise round-half-to-even
    w[0, :4] = [0.5, 1.5, -2.5, 127.0]
    jq = jquant.quantize_int8(jnp.asarray(w), axis=axis)
    tq = tquant.quantize_int8(torch.from_numpy(w), axis=axis)
    assert tq.w.dtype == torch.int8 and tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(tq.w.numpy(), np.asarray(jq.w))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))


def test_quantize_kv_is_bit_exact_and_round_trips():
    rng = np.random.default_rng(4)
    x = _randn(rng, 2, 9, 3, 32)
    x[0, 0, 0, :] = 0.0  # an all-zero vector hits the scale floor
    jq, js = jquant.quantize_kv(jnp.asarray(x))
    tq, ts = tquant.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = tquant.dequantize_kv(tq, ts, torch.float32)
    want = jquant.dequantize_kv(jq, js, jnp.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))


def test_maybe_quantize_tree_picks_the_same_leaves():
    rng = np.random.default_rng(5)
    tree = {"layers": {"wq": _randn(rng, 2, 128, 512),
                       "attn_norm": _randn(rng, 2, 128)},
            "embedding": _randn(rng, 600, 128),
            "lm_head": _randn(rng, 128, 600)}
    jt = jquant.maybe_quantize_tree(
        {"layers": {k: jnp.asarray(v) for k, v in tree["layers"].items()},
         "embedding": jnp.asarray(tree["embedding"]),
         "lm_head": jnp.asarray(tree["lm_head"])}, True)
    tt = tquant.maybe_quantize_tree(
        {"layers": {k: torch.from_numpy(v)
                    for k, v in tree["layers"].items()},
         "embedding": torch.from_numpy(tree["embedding"]),
         "lm_head": torch.from_numpy(tree["lm_head"])}, True)
    for path in (("layers", "wq"), ("lm_head",)):
        j, t = jt, tt
        for p in path:
            j, t = j[p], t[p]
        assert isinstance(t, tquant.QuantizedLinear)
        np.testing.assert_array_equal(t.w.numpy(), np.asarray(j.w))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    assert isinstance(tt["layers"]["attn_norm"], torch.Tensor)
    assert isinstance(tt["embedding"], torch.Tensor)


@pytest.mark.parametrize("masked", [False, True])
def test_causal_attention_matches_jax(masked):
    rng = np.random.default_rng(6)
    b, s, h, kv, d = 2, 12, 8, 2, 16
    q, k, v = _randn(rng, b, s, h, d), _randn(rng, b, s, kv, d), \
        _randn(rng, b, s, kv, d)
    mask = np.arange(s)[None, :] < np.array([s, 5])[:, None]
    want = jattn.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v),
                                  jnp.asarray(mask) if masked else None)
    got = tattn.causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(mask) if masked else None)
    _close(got, want)


@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_appended_matches_jax(quant):
    rng = np.random.default_rng(7)
    b, smax, h, kv, d = 3, 20, 8, 4, 16
    q = _randn(rng, b, 1, h, d)
    kc, vc = _randn(rng, b, smax, kv, d), _randn(rng, b, smax, kv, d)
    kn, vn = _randn(rng, b, 1, kv, d), _randn(rng, b, 1, kv, d)
    lengths = np.array([0, 7, smax], np.int32)
    j_args = [jnp.asarray(a) for a in (q, kc, vc, kn, vn, lengths)]
    if quant:
        jk, jks = jquant.quantize_kv(j_args[1])
        jv, jvs = jquant.quantize_kv(j_args[2])
        j_args[1:3] = [jk, jv]
        j_args += [jks, jvs]
    want = jattn.decode_attention_appended(*j_args)
    t_args = [torch.from_numpy(np.array(a)) for a in j_args]
    got = tattn.decode_attention_appended(*t_args)
    assert got.shape == (b, 1, h, d)
    _close(got, want)
