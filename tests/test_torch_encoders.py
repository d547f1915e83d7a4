"""The port's encoders (gofr_tpu_torch.models.bert and .vit) and their
ops (ops.norms.layer_norm, ops.attention.full_attention) against the
JAX package's, on the CPU, on the same seeded numpy inputs, with the
JAX weights carried across by ``from_jax_params`` or through a ``.npz``
written by JAX's ``save_npz``.

The models run on the ``tiny`` configs and on 2-layer cuts of BERT-base
and ViT-L/14 at full width (ViT at an image size of 28, two patches a
side), in float32, where the two packages agree to 2e-5 (embeddings,
probabilities of unit scale) and 1e-4 (hidden states, logits); the
int8 cases quantize the projections on the JAX side and carry the int8
leaves across. BERT-base's cut also runs in its own bfloat16, where the
two packages' roundings differ: there the unit-norm embeddings agree
to 2e-2 in L2 norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import BERT_CONFIGS as JBERT
from gofr_tpu.models import VIT_CONFIGS as JVIT
from gofr_tpu.models import bert as jbert
from gofr_tpu.models import vit as jvit
from gofr_tpu.ops import attention as jattention
from gofr_tpu.ops import norms as jnorms
from gofr_tpu.ops.quant import QuantizedLinear as JaxQuantizedLinear
from gofr_tpu.tpu import checkpoint as jcheckpoint
from gofr_tpu_torch.models import BERT_CONFIGS, VIT_CONFIGS, bert, vit
from gofr_tpu_torch.ops import attention, norms
from gofr_tpu_torch.ops.quant import QuantizedLinear
from gofr_tpu_torch.tpu import checkpoint

EMBED_ATOL = 2e-5
HIDDEN_ATOL = 1e-4
BF16_EMBED_L2 = 2e-2


def _numpy_tree(tree):
    def leaf(x):
        if isinstance(x, JaxQuantizedLinear):
            return JaxQuantizedLinear(np.asarray(x.w), np.asarray(x.scale))
        return np.asarray(x)

    return jax.tree.map(leaf, tree,
                        is_leaf=lambda x: isinstance(x, JaxQuantizedLinear))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got: torch.Tensor, want, atol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


# -- configs and ops -----------------------------------------------------------

@pytest.mark.parametrize("family", ["bert", "vit"])
def test_configs_mirror_the_jax_package(family):
    mine, theirs = {"bert": (BERT_CONFIGS, JBERT),
                    "vit": (VIT_CONFIGS, JVIT)}[family]
    assert sorted(mine) == sorted(theirs)
    for name, cfg in mine.items():
        for field in ("name", "vocab_size", "dim", "n_layers", "n_heads",
                      "n_kv_heads", "ffn_dim", "max_seq", "norm_eps",
                      "dtype", "n_classes", "image_size", "patch_size",
                      "type_vocab_size"):
            assert getattr(cfg, field) == getattr(theirs[name], field), \
                (name, field)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 48)) * 4 + 2).astype(np.float32)
    w = rng.normal(size=(48,)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jnorms.layer_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                             jnp.asarray(b, jdt), 1e-12)
    got = norms.layer_norm(_t(x).to(tdt), _t(w).to(tdt), _t(b).to(tdt),
                           1e-12)
    assert got.dtype == tdt
    # float32: the population variance, not torch's unbiased default
    # (which is off by 48/47 here); bf16: the one output rounding
    _close(got, want.astype(jnp.float32),
           1e-5 if dtype == "float32" else 2 ** -7 * 8)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kv", [4, 2])
def test_full_attention_matches_jax(masked, kv):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 9, kv, 16)).astype(np.float32)
    v = rng.normal(size=(2, 9, kv, 16)).astype(np.float32)
    mask = (np.arange(9)[None] < np.array([[9], [4]])) if masked else None
    want = jattention.full_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if mask is None else jnp.asarray(mask))
    got = attention.full_attention(_t(q), _t(k), _t(v),
                                   mask=None if mask is None else _t(mask))
    _close(got, want, 1e-5)


# -- BERT ---------------------------------------------------------------------

BERT_CASES = {
    "tiny": lambda: JBERT["tiny"],
    "base-2-layers": lambda: JBERT["bert-base"].with_(n_layers=2,
                                                      dtype="float32"),
}


def _bert_weights(jcfg, quant: bool):
    jparams = jbert.init(jcfg, jax.random.PRNGKey(3))
    if quant:
        jparams = jcheckpoint.maybe_quantize(jparams, True)
    return jparams, checkpoint.from_jax_params(_numpy_tree(jparams),
                                               device="cpu")


def _bert_inputs(jcfg, b=3, s=16, lengths=(16, 9, 1)):
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.arange(s)[None] < np.asarray(lengths)[:, None]
    return tokens, mask


def _port_cfg(jcfg):
    from gofr_tpu_torch.models.common import ModelConfig

    return ModelConfig(**{f: getattr(jcfg, f) for f in (
        "name", "vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
        "ffn_dim", "max_seq", "norm_eps", "dtype", "n_classes",
        "image_size", "patch_size", "type_vocab_size")})


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("case", sorted(BERT_CASES))
def test_bert_matches_jax(case, quant):
    jcfg = BERT_CASES[case]()
    cfg = _port_cfg(jcfg)
    jparams, tparams = _bert_weights(jcfg, quant)
    if quant:
        assert isinstance(tparams["layers"]["wq"], QuantizedLinear)
        assert tparams["layers"]["wq"].w.dtype == torch.int8
    tokens, mask = _bert_inputs(jcfg)
    jt, jm = jnp.asarray(tokens), jnp.asarray(mask)
    tt, tm = _t(tokens), _t(mask)
    with torch.inference_mode():
        hidden = bert.encode(tparams, cfg, tt, tm)
        emb = bert.embed(tparams, cfg, tt, tm)
        cls = bert.pool_cls(tparams, cfg, tt, tm)
    want = jax.jit(lambda p, t, m: (
        jbert.encode(p, jcfg, t, m), jbert.embed(p, jcfg, t, m),
        jbert.pool_cls(p, jcfg, t, m)))(jparams, jt, jm)
    # hidden states of padded positions too: the mask hides keys only
    _close(hidden, want[0], HIDDEN_ATOL)
    _close(emb, want[1], EMBED_ATOL)
    _close(cls, want[2], HIDDEN_ATOL)
    assert emb.dtype == torch.float32
    np.testing.assert_allclose(torch.linalg.vector_norm(emb, dim=-1),
                               1.0, atol=1e-5)


def test_bert_embed_of_an_empty_row_is_zero_not_nan():
    """A padded batch row (length 0) divides by 1: zeros, as in JAX."""
    jcfg = JBERT["tiny"]
    jparams, tparams = _bert_weights(jcfg, False)
    tokens, mask = _bert_inputs(jcfg, b=2, s=8, lengths=(5, 0))
    want = np.asarray(jbert.embed(jparams, jcfg, jnp.asarray(tokens),
                                  jnp.asarray(mask)))
    got = bert.embed(tparams, _port_cfg(jcfg), _t(tokens), _t(mask))
    assert not torch.isnan(got).any()
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    _close(got, want, EMBED_ATOL)


def test_bert_base_cut_in_bfloat16_matches_jax():
    jcfg = JBERT["bert-base"].with_(n_layers=2)
    jparams, tparams = _bert_weights(jcfg, False)
    assert tparams["embedding"].dtype == torch.bfloat16
    tokens, mask = _bert_inputs(jcfg)
    want = np.asarray(jbert.embed(jparams, jcfg, jnp.asarray(tokens),
                                  jnp.asarray(mask)))
    got = bert.embed(tparams, _port_cfg(jcfg), _t(tokens), _t(mask)).numpy()
    assert np.linalg.norm(got - want, axis=-1).max() < BF16_EMBED_L2


def test_bert_init_has_the_jax_layout():
    jcfg = JBERT["tiny"]
    want = jax.tree.map(lambda x: (x.shape, str(x.dtype)),
                        jbert.init(jcfg, jax.random.PRNGKey(0)))
    got = bert.init(_port_cfg(jcfg), 0, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                       got)
    assert got == want


# -- ViT ----------------------------------------------------------------------

VIT_CASES = {
    "tiny": lambda: JVIT["tiny"],
    "l14-2-layers": lambda: JVIT["vit-l-14"].with_(n_layers=2,
                                                   image_size=28,
                                                   dtype="float32"),
}


def _vit_weights(jcfg, quant: bool):
    jparams = jvit.init(jcfg, jax.random.PRNGKey(5))
    if quant:
        jparams = jcheckpoint.maybe_quantize(jparams, True)
    return jparams, checkpoint.from_jax_params(_numpy_tree(jparams),
                                               device="cpu")


def _images(jcfg, b=3):
    return np.random.default_rng(6).normal(
        size=(b, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)


def test_patchify_matches_jax_element_order():
    images = np.arange(2 * 28 * 42 * 3, dtype=np.float32).reshape(
        2, 28, 42, 3)
    want = np.asarray(jvit.patchify(jnp.asarray(images), 14))
    got = vit.patchify(_t(images), 14)
    assert tuple(got.shape) == want.shape == (2, 6, 14 * 14 * 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("case", sorted(VIT_CASES))
def test_vit_forward_matches_jax(case, quant):
    jcfg = VIT_CASES[case]()
    cfg = _port_cfg(jcfg)
    jparams, tparams = _vit_weights(jcfg, quant)
    images = _images(jcfg)
    assert vit.n_patches(cfg) == jvit.n_patches(jcfg)
    with torch.inference_mode():
        logits = vit.forward(tparams, cfg, _t(images))
    want = jax.jit(lambda p, x: jvit.forward(p, jcfg, x))(
        jparams, jnp.asarray(images))
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (3, cfg.n_classes)
    _close(logits, want, HIDDEN_ATOL)
    _close(torch.softmax(logits, dim=-1), jax.nn.softmax(want, axis=-1),
           EMBED_ATOL)


def test_vit_init_has_the_jax_layout():
    jcfg = JVIT["tiny"]
    want = jax.tree.map(lambda x: (x.shape, str(x.dtype)),
                        jvit.init(jcfg, jax.random.PRNGKey(0)))
    got = vit.init(_port_cfg(jcfg), 0, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                       got)
    assert got == want


# -- weights across -----------------------------------------------------------

@pytest.mark.parametrize("family", ["bert", "vit"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_an_npz_from_save_npz_loads_into_the_port(tmp_path, family, quant):
    """JAX's ``save_npz`` of a BERT or ViT tree (int8 leaves included)
    loads through the port's ``load_npz`` to the same values, and the
    port's ``maybe_quantize`` picks the leaves JAX's picks, to the same
    codes."""
    mod, jcfg = {"bert": (jbert, JBERT["tiny"]),
                 "vit": (jvit, JVIT["tiny"])}[family]
    jparams = mod.init(jcfg, jax.random.PRNGKey(7))
    saved = jcheckpoint.maybe_quantize(jparams, quant)
    path = str(tmp_path / f"{family}.npz")
    jcheckpoint.save_npz(path, saved)
    loaded = checkpoint.load_npz(path, device="cpu")
    want = _numpy_tree(saved)
    ported = checkpoint.maybe_quantize(
        checkpoint.from_jax_params(_numpy_tree(jparams), device="cpu"),
        quant)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            elif isinstance(v, tuple):
                out[f"{prefix}{k}/w"], out[f"{prefix}{k}/scale"] = v
            else:
                out[prefix + k] = v
        return out

    want, loaded, ported = flat(want), flat(loaded), flat(ported)
    assert sorted(loaded) == sorted(want) == sorted(ported)
    for key, arr in want.items():
        np.testing.assert_array_equal(loaded[key].numpy(), arr, err_msg=key)
        np.testing.assert_array_equal(ported[key].numpy(), arr, err_msg=key)
    assert any(k.endswith("/scale") for k in want) == quant
