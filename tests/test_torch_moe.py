"""The port's mixture of experts (gofr_tpu_torch.models.llama: ``_route``,
``_moe_ffn``, ``_moe_ffn_grouped``, the MoE layer through every model
entry point) against the JAX package's (gofr_tpu/models/llama.py) on
``tiny-moe``, with the JAX weights carried across by
tpu.checkpoint.from_jax_params, on the CPU; and the port's copies of
tests/test_moe.py's invariants.

Tolerances: float32, rtol = atol = 2e-5 (tests/test_moe.py's), and the
same top-k experts. bfloat16 (``tiny-moe`` with dtype bfloat16): the
routing on the same inputs is the same (float32 softmax either side);
the FFN's output is within BF16_REL = 2^-5 of its largest value and the
logits within BF16_LOGIT_ATOL = 0.1 (chip_smoke.py's LOGIT_ATOL): the
frameworks round each expert product, SiLU, the combine and the
attention to bf16 in their own order, a bf16 step being 2^-8 relative
of logits of unit scale (the port's int8 product also rounds to bf16
before its scale, as ops.quant.qmatmul does). Through whole layers
those roundings reach the router (a few bf16 steps of its logits), and
a token whose k-th and (k+1)-th probabilities lie within TIE_GAP = 2^-7
of each other may take the other expert: a row whose every routing in
the case was further from a tie than that is held to the tolerance, and
a row past it must have had such a near tie (the port's own
probabilities, recorded; the flips seen had gaps of 0.001-0.004).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.models import paged_llama as jpaged
from gofr_tpu.ops.quant import QuantizedLinear as JaxQuantizedLinear
from gofr_tpu.tpu import checkpoint as jcheckpoint
from gofr_tpu.tpu import kvcache as jkv
from gofr_tpu_torch.models import LLAMA_CONFIGS, llama, paged_llama
from gofr_tpu_torch.models.common import layer_weights
from gofr_tpu_torch.ops.quant import QuantizedLinear
from gofr_tpu_torch.tpu import checkpoint
from gofr_tpu_torch.tpu import kvcache as pkv

RTOL = ATOL = 2e-5
BF16_REL = 2.0 ** -5
BF16_LOGIT_ATOL = 0.1
TIE_GAP = 2.0 ** -7
DTYPES = ("float32", "bfloat16")
SMAX = 64


def _cfgs(dtype="float32", quant=False, **kw):
    """(JAX config, port config): the JAX one in ``_jax_dtype``."""
    return (JAX_CONFIGS["tiny-moe"].with_(dtype=_jax_dtype(dtype, quant),
                                          **kw),
            LLAMA_CONFIGS["tiny-moe"].with_(dtype=dtype, **kw))


def _numpy_tree(tree):
    def leaf(x):
        if isinstance(x, JaxQuantizedLinear):
            return JaxQuantizedLinear(np.asarray(x.w), np.asarray(x.scale))
        return np.asarray(x)

    return jax.tree.map(leaf, tree,
                        is_leaf=lambda x: isinstance(x, JaxQuantizedLinear))


_WEIGHTS: dict = {}


def _weights(dtype: str, quant: bool):
    """(JAX params, port params) of tiny-moe in ``dtype``, int8 experts
    and projections with ``quant``; made once a module. bf16 with int8
    weights: the JAX side's leaves are the same values in float32 (the
    codes as they are), since XLA's CPU backend runs no bf16 x bf16 ->
    float32 product (JAX's int8 path asks for one): the port is then
    held against JAX's float32 arithmetic on the same weights."""
    key = (dtype, quant)
    if key not in _WEIGHTS:
        jparams = jllama.init(JAX_CONFIGS["tiny-moe"].with_(dtype=dtype),
                              jax.random.PRNGKey(3))
        if quant:
            jparams = jcheckpoint.maybe_quantize(jparams, True)
        tparams = checkpoint.from_jax_params(_numpy_tree(jparams),
                                             device="cpu")
        if quant and dtype != "float32":
            jparams = jax.tree.map(
                lambda x: x if x.dtype == jnp.int8 else x.astype(
                    jnp.float32), jparams)
        _WEIGHTS[key] = (jparams, tparams)
    return _WEIGHTS[key]


def _jax_dtype(dtype: str, quant: bool) -> str:
    """The dtype the JAX side runs in (see ``_weights``)."""
    return "float32" if quant else dtype


def _close(got, want, dtype, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=BF16_REL * float(np.abs(want).max()),
            err_msg=what)


class _Gaps:
    """Records, for each token of each ``llama._route`` call, the gap
    between its k-th and (k+1)-th router probabilities; ``near(b)``:
    which of ``b`` batch rows had a gap under TIE_GAP in any call since
    the recorder was made (a call's tokens are its batch rows' positions
    in order; a row that took another expert once keeps its own cache
    rows from then on)."""

    def __init__(self, monkeypatch):
        self.gaps = []
        self.seen = None
        route = llama._route

        def recording(hf, router, k):
            probs, topv, topi = route(hf, router, k)
            top = torch.sort(probs, dim=-1, descending=True).values
            self.gaps.append(top[:, k - 1] - top[:, k])
            return probs, topv, topi

        monkeypatch.setattr(llama, "_route", recording)

    def near(self, b: int) -> np.ndarray:
        if self.seen is None:
            self.seen = np.zeros(b, bool)
        for g in self.gaps:
            self.seen |= (g.view(b, -1) < TIE_GAP).any(-1).numpy()
        self.gaps.clear()
        return self.seen


def _logits_close(got, want, dtype, what="", gaps=None):
    """``got`` [B, ...] against JAX's; in bf16 a row past the tolerance
    must have had a near tie (``gaps``, a _Gaps over this call)."""
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)
        return
    err = np.abs(got.numpy() - want).reshape(len(want), -1).max(-1)
    near = gaps.near(len(want)) if gaps is not None else \
        np.zeros(len(want), bool)
    far = ~near
    assert (err[far] <= BF16_LOGIT_ATOL).all(), \
        f"{what}: rows {np.flatnonzero(far & (err > BF16_LOGIT_ATOL))} " \
        f"off by {err.tolist()} with no near tie"


def _jax_layer(jparams, i=0):
    out = {}
    for k, v in jparams["layers"].items():
        out[k] = (JaxQuantizedLinear(v.w[i], v.scale[i])
                  if isinstance(v, JaxQuantizedLinear) else v[i])
    return out


def _hidden(dtype, b=2, s=8, seed=0, quant=False):
    """Seeded activations [b, s, D] rounded to ``dtype``: (JAX's, in
    ``_jax_dtype``, the port's)."""
    h = np.random.default_rng(seed).standard_normal(
        (b, s, LLAMA_CONFIGS["tiny-moe"].dim)).astype(np.float32)
    h = np.asarray(jnp.asarray(h).astype(jnp.dtype(dtype)).astype(
        jnp.float32))
    return (jnp.asarray(h).astype(jnp.dtype(_jax_dtype(dtype, quant))),
            torch.tensor(h).to(getattr(torch, dtype)))


# -- the functions -------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_route_matches_jax(dtype):
    jparams, tparams = _weights(dtype, False)
    jh, th = _hidden(dtype, 3, 16, seed=1)
    D = th.shape[-1]
    jp, jv, ji = jllama._route(jh.reshape(-1, D),
                               jparams["layers"]["router"][0], 2)
    tp, tv, ti = llama._route(th.reshape(-1, D),
                              tparams["layers"]["router"][0], 2)
    assert tp.dtype == tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tv.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_route_takes_the_lower_expert_on_a_tie():
    """Equal probabilities: the lower expert index first, as lax.top_k
    (torch.topk makes no such promise)."""
    router = np.zeros((4, 6), np.float32)
    router[:, 1] = router[:, 4] = router[:, 5] = 1.0
    hf = np.ones((3, 4), np.float32)
    jp, jv, ji = jllama._route(jnp.asarray(hf), jnp.asarray(router), 2)
    tp, tv, ti = llama._route(torch.from_numpy(hf), torch.from_numpy(router),
                              2)
    assert ti.tolist() == np.asarray(ji).tolist() == [[1, 4]] * 3
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("factor", [0.0, 8.0, 1.0, 0.05])
def test_moe_ffn_matches_jax(dtype, quant, masked, factor):
    """Dense dispatch (factor 0) and grouped dispatch with ample
    capacity (8.0), a balanced router's (1.0) and drops (0.05), with and
    without a ``valid`` mask, on dense and int8 experts: the FFN's output
    and the router's probabilities."""
    jcfg, tcfg = _cfgs(dtype, quant, moe_capacity_factor=factor)
    jparams, tparams = _weights(dtype, quant)
    jh, th = _hidden(dtype, 2, 8, seed=2, quant=quant)
    lengths = np.asarray([8, 3])
    valid = np.arange(8)[None, :] < lengths[:, None]
    jvalid = jnp.asarray(valid) if masked else None
    tvalid = torch.from_numpy(valid) if masked else None
    jout, jprobs = jllama._moe_ffn(jh, _jax_layer(jparams), jcfg, jvalid)
    tout, tprobs = llama._moe_ffn(th, layer_weights(tparams["layers"], 0),
                                  tcfg, tvalid)
    assert tout.shape == th.shape and tout.dtype == th.dtype
    assert tprobs.shape == (2, 8, tcfg.n_experts)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                               rtol=RTOL, atol=ATOL)
    _close(tout, jnp.asarray(jout, jnp.float32), dtype,
           f"factor {factor}")
    if masked and factor > 0:
        # a padded token claims nothing: its output is zero
        assert not tout[1, 3:].any()


@pytest.mark.parametrize("quant", [False, True])
def test_grouped_dispatch_with_ample_capacity_is_dense_dispatch(quant):
    _, tparams = _weights("float32", quant)
    _, th = _hidden("float32", 2, 16, seed=5)
    w = layer_weights(tparams["layers"], 1)
    _, dense = _cfgs()
    grouped = dense.with_(moe_capacity_factor=float(dense.n_experts))
    np.testing.assert_allclose(llama._moe_ffn(th, w, grouped)[0].numpy(),
                               llama._moe_ffn(th, w, dense)[0].numpy(),
                               rtol=RTOL, atol=ATOL)


def test_drops_past_capacity_leave_the_residual_stream():
    """At capacity factor 0.05 a buffer holds one row (ceil(0.05 * 16 *
    2 / 4)): only the first claim of each expert, token-major, gets an
    output, so at most E tokens have one."""
    _, tcfg = _cfgs(moe_capacity_factor=0.05)
    _, tparams = _weights("float32", False)
    _, th = _hidden("float32", 2, 8, seed=6)
    out, _ = llama._moe_ffn(th, layer_weights(tparams["layers"], 0), tcfg)
    served = out.reshape(16, -1).abs().sum(-1) > 0
    assert 1 <= int(served.sum()) <= tcfg.n_experts
    assert torch.isfinite(out).all()


# -- the entry points ----------------------------------------------------------

def _prompts(seed=0, b=2, s=12, lengths=(12, 7)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, s)), np.asarray(lengths, np.int32))


def _valid_rows(tokens, lengths):
    return np.arange(tokens.shape[1])[None, :] < lengths[:, None]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("factor", [0.0, 1.0])
def test_forward_matches_jax(dtype, quant, factor):
    """Ragged rows: at capacity factor 1.0 the padding must claim no
    capacity (``valid`` threaded from ``lengths``), as in JAX."""
    jcfg, tcfg = _cfgs(dtype, quant, moe_capacity_factor=factor)
    jparams, tparams = _weights(dtype, quant)
    tokens, lengths = _prompts(1)
    want = jllama.forward(jparams, jcfg, jnp.asarray(tokens),
                          jnp.asarray(lengths))
    got = llama.forward(tparams, tcfg, torch.from_numpy(tokens),
                        torch.from_numpy(lengths))
    valid = _valid_rows(tokens, lengths)
    _logits_close(got[torch.from_numpy(valid)], np.asarray(want)[valid],
                  dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant", [False, True])
def test_score_matches_jax_s_score_program(dtype, quant):
    """The port's ``score`` against JAX's score program: forward under
    multi_request_serving_config, the row at lengths - 1."""
    jcfg, tcfg = _cfgs(dtype, quant, moe_capacity_factor=1.0)
    jparams, tparams = _weights(dtype, quant)
    tokens, lengths = _prompts(2, 3, 16, (16, 5, 1))
    serving = jllama.multi_request_serving_config(jcfg)
    logits = jllama.forward(jparams, serving, jnp.asarray(tokens),
                            jnp.asarray(lengths))
    want = np.asarray(logits)[np.arange(3), np.maximum(lengths - 1, 0)]
    got = llama.score(tparams, llama.multi_request_serving_config(tcfg),
                      torch.from_numpy(tokens), torch.from_numpy(lengths))
    _logits_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("factor", [0.0, 1.0])
def test_prefill_kv_matches_jax(dtype, factor):
    jcfg, tcfg = _cfgs(dtype, moe_capacity_factor=factor)
    jparams, tparams = _weights(dtype, False)
    tokens, lengths = _prompts(3)
    jl, jk, jv, _ = jllama.prefill_kv(jparams, jcfg, jnp.asarray(tokens),
                                      jnp.asarray(lengths), flash=True)
    tl, tk, tv, _ = llama.prefill_kv(tparams, tcfg, torch.from_numpy(tokens),
                                     torch.from_numpy(lengths), flash=True)
    valid = _valid_rows(tokens, lengths)
    _logits_close(tl[torch.from_numpy(valid)], np.asarray(jl)[valid], dtype)
    for got, want in ((tk, jk), (tv, jv)):
        _close(got[:, torch.from_numpy(valid)],
               np.asarray(jnp.asarray(want, jnp.float32))[:, valid], dtype)


def _prefilled(dtype, quant_w, quant_kv, lengths=(12, 7, 9)):
    """Both packages' caches after prefilling three prompts, one per
    slot: (JAX cache, port cache, last tokens)."""
    jcfg, tcfg = _cfgs(dtype, quant_w)
    jparams, tparams = _weights(dtype, quant_w)
    b = len(lengths)
    tokens, lens = _prompts(4, b, max(lengths), lengths)
    jcache = jllama.init_cache(jcfg, b, SMAX,
                               dtype=jnp.int8 if quant_kv else None)
    _, jk, jv, _ = jllama.prefill_kv(jparams, jcfg, jnp.asarray(tokens),
                                     jnp.asarray(lens), rope_max=SMAX)
    jcache = jllama.write_kv(jcache, jk, jv, (0, 0, 0, 0, 0),
                             jnp.asarray(lens))
    tcache = llama.init_cache(tcfg, b, SMAX,
                              dtype=torch.int8 if quant_kv else None,
                              device="cpu")
    _, tk, tv, _ = llama.prefill_kv(tparams, tcfg, torch.from_numpy(tokens),
                                    torch.from_numpy(lens), rope_max=SMAX)
    llama.write_kv(tcache, tk, tv, lengths=torch.from_numpy(lens))
    last = tokens[np.arange(b), lens - 1]
    return jcache, tcache, last


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant", [False, True])
def test_decode_steps_match_jax(dtype, quant, monkeypatch):
    """8 greedy decode steps through flash_decode's function (its plain
    version on the CPU; JAX's kernel in interpret mode), int8 weights
    and KV with ``quant``."""
    jcfg, tcfg = _cfgs(dtype, quant)
    jparams, tparams = _weights(dtype, quant)
    jcache, tcache, last = _prefilled(dtype, quant, quant)
    gaps = _Gaps(monkeypatch)
    jrope = jllama.get_rope_tables(jcfg, SMAX)
    trope = llama.get_rope_tables(tcfg, SMAX, "cpu")
    tokens = last.astype(np.int32)
    for step in range(8):
        jl, jcache = jllama.decode_step(jparams, jcfg, jnp.asarray(tokens),
                                        jcache, rope_tables=jrope, flash=True)
        tl, tcache = llama.decode_step(tparams, tcfg,
                                       torch.from_numpy(tokens).long(),
                                       tcache, rope_tables=trope, flash=True)
        _logits_close(tl, jl, dtype, f"step {step}", gaps)
        tokens = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        if dtype == "float32":
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), tokens)
    np.testing.assert_array_equal(tcache.lengths.numpy(),
                                  np.asarray(jcache.lengths))


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_chunk_matches_jax(dtype):
    """A 16-token prompt as two chunks of 8 into slot 1 of a 3-slot
    int8 cache: logits at every chunk position, then the written codes."""
    jcfg, tcfg = _cfgs(dtype)
    jparams, tparams = _weights(dtype, False)
    prompt = np.random.default_rng(8).integers(0, 256, (1, 16))
    jrope = jllama.get_rope_tables(jcfg, SMAX)
    trope = llama.get_rope_tables(tcfg, SMAX, "cpu")
    jcache = jllama.init_cache(jcfg, 1, SMAX, dtype=jnp.int8)
    tcache = llama.init_cache(tcfg, 3, SMAX, dtype=torch.int8, device="cpu")
    for start in (0, 8):
        chunk = prompt[:, start:start + 8]
        jl, jcache = jllama.prefill_chunk(jparams, jcfg, jnp.asarray(chunk),
                                          jcache, start, rope_tables=jrope)
        tl, _ = llama.prefill_chunk(
            tparams, tcfg, torch.from_numpy(chunk), tcache,
            torch.tensor([start]), torch.tensor([1]), rope_tables=trope)
        _logits_close(tl, jl, dtype, f"chunk at {start}")
    if dtype == "float32":
        np.testing.assert_array_equal(tcache.k[:, 1, :16].numpy(),
                                      np.asarray(jcache.k[:, 0, :16]))
    assert not tcache.k[:, (0, 2)].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant", [False, True])
def test_verify_step_matches_jax(dtype, quant, monkeypatch):
    jcfg, tcfg = _cfgs(dtype, quant)
    jparams, tparams = _weights(dtype, quant)
    jcache, tcache, last = _prefilled(dtype, quant, quant)
    gaps = _Gaps(monkeypatch)
    window = np.random.default_rng(9).integers(0, 256, (3, 5))
    window[:, 0] = last
    jl, jcache = jllama.verify_step(jparams, jcfg, jnp.asarray(window),
                                    jcache)
    tl, tcache = llama.verify_step(tparams, tcfg, torch.from_numpy(window),
                                   tcache)
    _logits_close(tl, jl, dtype, "", gaps)
    np.testing.assert_array_equal(tcache.lengths.numpy(),
                                  np.asarray(jcache.lengths))
    if dtype == "float32" and quant:
        np.testing.assert_array_equal(tcache.k.numpy(), np.asarray(jcache.k))


def _paged_prefilled(dtype, quant):
    """Three prompts in a shuffled pool of 16-token blocks, in both
    packages: (JAX cache, port cache, table, last tokens)."""
    jcfg, tcfg = _cfgs(dtype, quant)
    jparams, tparams = _weights(dtype, quant)
    t, mb = 16, 4
    lengths = (20, 7, 33)
    table = np.asarray([[5, 9, 2, 2], [11, 11, 11, 11], [3, 8, 12, 4]],
                       np.int32)
    jcache = jpaged.init_paged_cache(jcfg, 3, n_blocks=13, block_size=t,
                                     dtype=jnp.int8 if quant else None)
    tcache = paged_llama.init_paged_cache(
        tcfg, 3, 13, t, dtype=torch.int8 if quant else None, device="cpu")
    rng = np.random.default_rng(10)
    last = []
    for b, n in enumerate(lengths):
        prompt = rng.integers(0, 256, (1, n))
        blocks = table[b, :-(-n // t)]
        _, jk, jv, _ = jllama.prefill_kv(jparams, jcfg, jnp.asarray(prompt),
                                         rope_max=mb * t)
        jcache = jpaged.write_prompt_blocks(jcache, jk, jv,
                                            jnp.asarray(blocks), n)
        jcache = jcache._replace(lengths=jcache.lengths.at[b].set(n))
        _, tk, tv, _ = llama.prefill_kv(tparams, tcfg,
                                        torch.from_numpy(prompt),
                                        rope_max=mb * t)
        paged_llama.write_prompt_blocks(tcache, tk, tv, blocks.tolist())
        tcache.lengths[b] = n
        last.append(int(prompt[0, -1]))
    return jcache, tcache, table, np.asarray(last, np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_steps_match_jax(dtype, quant, monkeypatch):
    jcfg, tcfg = _cfgs(dtype, quant)
    jparams, tparams = _weights(dtype, quant)
    jcache, tcache, table, tokens = _paged_prefilled(dtype, quant)
    gaps = _Gaps(monkeypatch)
    jrope = jllama.get_rope_tables(jcfg, 64)
    trope = llama.get_rope_tables(tcfg, 64, "cpu")
    for step in range(6):
        jl, jcache = jpaged.paged_decode_step(
            jparams, jcfg, jnp.asarray(tokens), jcache, jnp.asarray(table),
            rope_tables=jrope, flash=False)
        tl, tcache = paged_llama.paged_decode_step(
            tparams, tcfg, torch.from_numpy(tokens).long(), tcache,
            torch.from_numpy(table), rope_tables=trope)
        _logits_close(tl, jl, dtype, f"step {step}", gaps)
        tokens = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    np.testing.assert_array_equal(tcache.lengths.numpy(),
                                  np.asarray(jcache.lengths))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant", [False, True])
def test_paged_verify_step_matches_jax(dtype, quant, monkeypatch):
    jcfg, tcfg = _cfgs(dtype, quant)
    jparams, tparams = _weights(dtype, quant)
    jcache, tcache, table, last = _paged_prefilled(dtype, quant)
    gaps = _Gaps(monkeypatch)
    window = np.random.default_rng(11).integers(0, 256, (3, 4))
    window[:, 0] = last
    jrope = jllama.get_rope_tables(jcfg, 64)
    trope = llama.get_rope_tables(tcfg, 64, "cpu")
    jl, jcache = jpaged.paged_verify_step(
        jparams, jcfg, jnp.asarray(window), jcache, jnp.asarray(table),
        rope_tables=jrope, flash=False)
    tl, tcache = paged_llama.paged_verify_step(
        tparams, tcfg, torch.from_numpy(window), tcache,
        torch.from_numpy(table), rope_tables=trope)
    _logits_close(tl, jl, dtype, "", gaps)
    if dtype == "float32" and quant:
        np.testing.assert_array_equal(tcache.k.numpy(), np.asarray(jcache.k))


# -- weights -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_expert_stacks_equal_jax_s_codes(dtype):
    """The port's maybe_quantize of the carried weights: the 4-D expert
    stacks' codes bit-equal to JAX's, scales [L, E, out] within rtol
    1e-5; the router stays dense."""
    jq, _ = _weights(dtype, True)
    jparams, tparams = _weights(dtype, False)
    tq = checkpoint.maybe_quantize(tparams, True)
    for name in ("w_gate", "w_up", "w_down", "wq", "wo"):
        got, want = tq["layers"][name], jq["layers"][name]
        assert isinstance(got, QuantizedLinear), name
        np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                                   rtol=1e-5)
    L, E, D, Fd = tparams["layers"]["w_gate"].shape
    assert tq["layers"]["w_gate"].scale.shape == (L, E, Fd)
    assert tq["layers"]["w_down"].scale.shape == (L, E, D)
    assert isinstance(tq["layers"]["router"], torch.Tensor)


def test_4d_int8_leaves_carry_across_and_through_npz(tmp_path):
    jq, tq = _weights("float32", True)
    got = tq["layers"]["w_gate"]
    assert isinstance(got, QuantizedLinear) and got.w.dtype == torch.int8
    np.testing.assert_array_equal(got.w.numpy(),
                                  np.asarray(jq["layers"]["w_gate"].w))
    path = str(tmp_path / "moe.npz")
    jcheckpoint.save_npz(path, jq)
    loaded = checkpoint.load_npz(path, device="cpu")
    for name in ("w_gate", "w_up", "w_down"):
        for a, b in zip(loaded["layers"][name], tq["layers"][name]):
            assert torch.equal(a, b), name
    assert torch.equal(loaded["layers"]["router"], tq["layers"]["router"])


@pytest.mark.parametrize("name,dtype", [("tiny-moe", "float32"),
                                        ("tiny", "float32"),
                                        ("tiny-moe", "bfloat16")])
def test_quantize_as_drawn_is_maybe_quantize_of_init(name, dtype):
    """``init(..., quant=True)`` (the one-device TPU_QUANT=int8 build)
    gives the weights of ``maybe_quantize(init(...), True)`` bit for bit:
    the same draws, codes and scales, the dense leaves equal."""
    cfg = LLAMA_CONFIGS[name].with_(dtype=dtype)
    want = checkpoint.maybe_quantize(llama.init(cfg, 5, device="cpu"), True)
    got = llama.init(cfg, 5, device="cpu", quant=True)

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + "/")
            else:
                yield prefix + k, v

    want, got = dict(flat(want)), dict(flat(got))
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert type(g) is type(w), k
        if isinstance(w, QuantizedLinear):
            assert torch.equal(g.w, w.w) and torch.equal(g.scale, w.scale), k
        else:
            assert torch.equal(g, w) and g.dtype == w.dtype, k


def test_init_lays_the_tree_out_as_jax_does():
    jparams = jllama.init(JAX_CONFIGS["tiny-moe"], jax.random.PRNGKey(0))
    tparams = llama.init(LLAMA_CONFIGS["tiny-moe"], 0, device="cpu")
    assert list(tparams) == list(jparams)
    assert list(tparams["layers"]) == list(jparams["layers"])
    for k, v in jparams["layers"].items():
        t = tparams["layers"][k]
        assert tuple(t.shape) == v.shape and t.dtype == torch.float32, k
    # the dense Llama tree keeps its leaves and draws
    dense = llama.init(LLAMA_CONFIGS["tiny"], 0, device="cpu")
    assert "router" not in dense["layers"]


@pytest.mark.parametrize("quant", [False, True])
def test_the_model_fingerprint_equals_jax_s(quant):
    """An MoE tree (4-D int8 leaves with ``quant``) fingerprints as
    JAX's, so T2 frames and the P/D handshake agree across packages."""
    jparams, tparams = _weights("float32", quant)
    jcfg, tcfg = _cfgs()
    want = jkv.model_fingerprint(jcfg, jparams, extra="int8")
    assert pkv.model_fingerprint(tcfg, tparams, extra="int8") == want
    dense = JAX_CONFIGS["tiny"]
    assert want != jkv.model_fingerprint(dense, None, extra="int8")


# -- invariants (tests/test_moe.py's, on the port) -----------------------------

def test_identical_experts_reproduce_the_dense_model():
    dense_cfg = LLAMA_CONFIGS["tiny"]
    moe_cfg = LLAMA_CONFIGS["tiny-moe"]
    dense = llama.init(dense_cfg, 1, device="cpu")
    moe = llama.init(moe_cfg, 1, device="cpu")
    layers = dict(moe["layers"])
    for name in ("w_gate", "w_up", "w_down"):
        layers[name] = dense["layers"][name][:, None].expand(
            layers[name].shape).contiguous()
    for name in ("attn_norm", "wq", "wk", "wv", "wo", "ffn_norm"):
        layers[name] = dense["layers"][name]
    moe = {**dense, "layers": layers}
    tokens = torch.tensor([[5, 17, 42, 7, 9, 1]])
    np.testing.assert_allclose(llama.forward(moe, moe_cfg, tokens).numpy(),
                               llama.forward(dense, dense_cfg, tokens).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_padding_cannot_evict_real_tokens():
    """At capacity factor 1.0 a padded row first or last in the batch
    leaves the real row's logits the same: pads claim nothing."""
    _, cfg = _cfgs(moe_capacity_factor=1.0)
    _, tparams = _weights("float32", False)
    real = np.random.default_rng(9).integers(1, 256, (1, 16))
    pad = np.zeros((1, 16), np.int64)
    first = llama.forward(tparams, cfg,
                          torch.from_numpy(np.concatenate([pad, real])),
                          torch.tensor([1, 16]))
    last = llama.forward(tparams, cfg,
                         torch.from_numpy(np.concatenate([real, pad])),
                         torch.tensor([16, 1]))
    np.testing.assert_allclose(first[1].numpy(), last[0].numpy(), rtol=RTOL,
                               atol=ATOL)


def test_score_batches_preserve_request_isolation():
    _, cfg = _cfgs(moe_capacity_factor=1.0)
    serving = llama.multi_request_serving_config(cfg)
    assert serving.moe_capacity_factor == 0.0
    assert llama.multi_request_serving_config(LLAMA_CONFIGS["tiny-moe"]) \
        is LLAMA_CONFIGS["tiny-moe"]
    _, tparams = _weights("float32", False)
    pinned = torch.tensor([7, 42, 3, 9])
    base = None
    for other in (0, 7, 101, 200):
        toks = torch.stack([torch.full((4,), other), pinned])
        got = llama.score(tparams, serving, toks, torch.tensor([4, 4]))[1]
        if base is None:
            base = got
        np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("paged", [False, True])
def test_decode_slots_stay_isolated(paged):
    """decode_step and paged_decode_step force dense dispatch: slot 0's
    token cannot change slot 1's logits at capacity factor 1.0."""
    _, cfg = _cfgs(moe_capacity_factor=1.0)
    _, tparams = _weights("float32", False)
    base = None
    for other in (0, 7, 101, 200):
        toks = torch.tensor([other, 42])
        if paged:
            cache = paged_llama.init_paged_cache(cfg, 2, 5, 16, device="cpu")
            cache.lengths[:] = 4
            table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
            logits, _ = paged_llama.paged_decode_step(tparams, cfg, toks,
                                                      cache, table)
        else:
            cache = llama.init_cache(cfg, 2, 32, device="cpu")
            cache.lengths[:] = 4
            logits, _ = llama.decode_step(tparams, cfg, toks, cache)
        if base is None:
            base = logits[1]
        np.testing.assert_allclose(logits[1].numpy(), base.numpy(),
                                   rtol=1e-6, atol=1e-6)
