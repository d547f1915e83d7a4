"""A mixture of experts served over ranks (gofr_tpu_torch,
``TPU_SHARDING`` with ep and tp) against the JAX package on
``tiny-moe`` (4 experts, top 2, ffn 128), on the CPU.

Each rank runs its ep block of the experts [e_lo, e_hi), each expert's
F/tp hidden units, and the partial outputs join one float32 sum over ep
x tp. A batch split over ep (a split score batch, a decode block of the
rank's own slots) gathers the ep group's hidden states first; an
admission (a batch of one request, replicated on every data index) runs
its grouped dispatch with JAX's per-request capacity. The references
are tests/test_moe.py's: JAX's forward at ``ep=4,tp=2`` within 2e-5 of
the unsharded one, and the ``ep=2,tp=2,dp=2`` engine's greedy stream
equal to the unsharded engine's.
"""

import signal

import jax
import numpy as np
import pytest
import torch

from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.parallel import DATA_AXES as JDATA_AXES
from gofr_tpu.parallel import make_mesh
from gofr_tpu.parallel import shard_params as jshard_params
from gofr_tpu.tpu import GenerationEngine as JaxEngine
from gofr_tpu.tpu.checkpoint import maybe_quantize as jquantize
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.ops.quant import QuantizedLinear
from gofr_tpu_torch.parallel import MeshPlan
from gofr_tpu_torch.tpu import GenerationEngine, from_jax_params
from gofr_tpu_torch.tpu.checkpoint import rank_params

JCFG = JAX_CONFIGS["tiny-moe"]
CFG = LLAMA_CONFIGS["tiny-moe"]
# grouped dispatch at JAX's test capacity (no claim dropped), as
# tests/test_moe.py serves it
JGROUPED = JCFG.with_(moe_capacity_factor=float(JCFG.n_experts))
GROUPED = CFG.with_(moe_capacity_factor=float(CFG.n_experts))
PROMPT = [5, 17, 42, 7, 3]
PROMPTS = [PROMPT, [3, 1, 4, 1, 5, 9, 2, 6, 8, 8, 1],
           [(11 * i) % 200 + 1 for i in range(27)]]   # the last: a lattice
FORWARD_TOL = 2e-5
_LIMIT_S = 150


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(*_):
        raise TimeoutError(f"MoE mesh test ran past {_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, _LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JCFG, jax.random.PRNGKey(3))
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(**axes, devices=jax.devices()[:n])


def _gone(eng) -> bool:
    return all(p.poll() is not None for p in eng._tp.procs)


def test_ep4_tp2_forward_equals_jax_within_2e5(weights):
    """tests/test_moe.py:129's forward on the port's ep=4,tp=2 ranks: the
    engine's ``score`` over a batch of every (row, prefix length) of
    JAX's [4, 16] tokens -- 64 rows split over the 4 ep indices, each
    rank routing the ep group's gathered rows through its expert and
    hidden-unit shard -- holds JAX's unsharded and JAX's ep=4,tp=2
    forward logits at every position within 2e-5."""
    jparams, tparams = weights
    tokens = jax.random.randint(jax.random.PRNGKey(5), (4, 16), 0,
                                JGROUPED.vocab_size)
    want = np.asarray(jllama.forward(jparams, JGROUPED, tokens))
    mesh = _mesh(ep=4, tp=2)
    sharded = jshard_params(jparams, mesh)
    mesh_want = np.asarray(jax.jit(
        lambda p, t: jllama.forward(p, JGROUPED, t))(sharded, jax.device_put(
            tokens, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec(JDATA_AXES)))))
    rows = np.repeat(np.asarray(tokens), 16, axis=0)            # [64, 16]
    lengths = np.tile(np.arange(1, 17), 4)
    eng = GenerationEngine(GROUPED, tparams, mesh=MeshPlan(ep=4, tp=2),
                           slots=4, max_seq=32, prompt_buckets=(16,),
                           device="cpu")
    try:
        rope = tllama.get_rope_tables(CFG, 16, torch.device("cpu"))
        got = eng.tp_score(torch.from_numpy(rows).long(),
                           torch.from_numpy(lengths).long(), rope,
                           16).numpy()
        assert eng.stats()["mesh"]["axes"] == {"ep": 4, "tp": 2}
    finally:
        eng.close()
    got = got.reshape(4, 16, -1)
    np.testing.assert_allclose(got, want, rtol=FORWARD_TOL, atol=FORWARD_TOL)
    np.testing.assert_allclose(got, mesh_want, rtol=FORWARD_TOL,
                               atol=FORWARD_TOL)
    assert _gone(eng)


@pytest.mark.parametrize("slots", [2, 4])
def test_ep2_tp2_dp2_engine_stream_equals_jax(weights, slots):
    """tests/test_moe.py:150 on the port: grouped dispatch at prefill
    (per request), dense at decode. With 2 slots the batch is replicated
    on every data index (JAX's ``fit_spec``: 4 does not divide 2); with
    4 each data index decodes its own slot and an MoE layer gathers the
    ep group's rows. Greedy streams, alone and as a burst, equal JAX's
    unsharded engine's and JAX's mesh engine's."""
    jparams, tparams = weights
    kw = dict(slots=slots, max_seq=64, prompt_buckets=(8, 16))
    prompts = PROMPTS[:slots]
    want = []
    for mesh in (None, _mesh(ep=2, tp=2, dp=2)):
        jeng = JaxEngine(JGROUPED, jparams if mesh is None
                         else jshard_params(jparams, mesh), mesh=mesh, **kw)
        try:
            want.append([jeng.generate(p, max_new_tokens=8).tokens()
                         for p in prompts])
        finally:
            jeng.close()
    eng = GenerationEngine(GROUPED, tparams, device="cpu",
                           mesh=MeshPlan(ep=2, tp=2, dp=2), **kw)
    try:
        alone = [eng.generate(p, max_new_tokens=8).tokens() for p in prompts]
        burst = [s.tokens() for s in
                 [eng.generate(p, max_new_tokens=8) for p in prompts]]
        stats = eng.stats()
        w_gate = eng.params["layers"]["w_gate"]
    finally:
        eng.close()
    assert alone == burst == want[0] == want[1]
    assert stats["mesh"]["slots_per_rank"] == (1 if slots == 4 else 2)
    # rank 0's expert stack: E/ep experts of F/tp hidden units each
    assert tuple(w_gate.shape) == (CFG.n_layers, 2, CFG.dim, CFG.ffn_dim // 2)
    assert _gone(eng)


def test_int8_experts_under_ep_equal_jax(weights):
    """tests/test_moe.py:179's int8 experts, served at ep=2,tp=2: every
    rank holds the int8 codes of E/ep experts of F/tp hidden units, and
    the streams equal JAX's unsharded int8 engine's on the same quantized
    weights."""
    jq = jquantize(weights[0], True)
    tq = from_jax_params(jax.tree.map(
        lambda x: type(x)(*map(np.asarray, x)) if isinstance(x, tuple)
        else np.asarray(x), jq, is_leaf=lambda x: isinstance(x, tuple)),
        device="cpu")
    plan = MeshPlan(ep=2, tp=2)
    L, E, D, Fd = CFG.n_layers, CFG.n_experts, CFG.dim, CFG.ffn_dim
    for r in range(plan.n_ranks):
        layers = rank_params(CFG, tq, r, plan.tp, "cpu", plan=plan)["layers"]
        c = plan.coords(r)
        for name, shape in (("w_gate", (L, E // 2, D, Fd // 2)),
                            ("w_down", (L, E // 2, Fd // 2, D))):
            leaf = layers[name]
            assert isinstance(leaf, QuantizedLinear)
            assert tuple(leaf.w.shape) == shape and leaf.w.dtype == torch.int8
            e0, f0 = c["ep"] * E // 2, c["tp"] * Fd // 2
            whole = tq["layers"][name]
            # the scale [L, E, out] is cut on its output axis only, as
            # JAX's param_specs cut it: every expert's, on each ep index
            if name == "w_gate":
                want_w = whole.w[:, e0:e0 + E // 2, :, f0:f0 + Fd // 2]
                want_s = whole.scale[:, :, f0:f0 + Fd // 2]
            else:
                want_w = whole.w[:, e0:e0 + E // 2, f0:f0 + Fd // 2]
                want_s = whole.scale
            assert torch.equal(leaf.w, want_w)
            assert torch.equal(leaf.scale, want_s)
    kw = dict(slots=2, max_seq=64, prompt_buckets=(8, 16))
    jeng = JaxEngine(JCFG, jq, **kw)
    try:
        want = [jeng.generate(p, max_new_tokens=8).tokens()
                for p in PROMPTS]
    finally:
        jeng.close()
    eng = GenerationEngine(CFG, tq, device="cpu", mesh=plan, **kw)
    try:
        got = [eng.generate(p, max_new_tokens=8).tokens() for p in PROMPTS]
        probe = eng.tp_probe()
    finally:
        eng.close()
    assert got == want
    # each data index's tp pair holds the same carry and cursors
    assert (probe[1, :5] == probe[0, :5]).all()
    assert (probe[3, :5] == probe[2, :5]).all()
    assert _gone(eng)
