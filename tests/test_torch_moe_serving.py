"""The port's serving engine on a mixture of experts (``tiny-moe``,
float32) against the JAX package's GenerationEngine on the same weights
(carried across with ``from_jax_params``), on the CPU: greedy tokens
identical on every single-device serving path -- contiguous with a bf16
and an int8 KV cache, int8 weights, paged, paged with speculative
decoding, a prompt past the largest bucket (the chunk lattice), two LoRA
adapters -- and one POST /generate through each package's App built
from ``TPU_MODEL=tiny-moe`` with the same ``.npz``. Then the rows: an
MoE model builds on one device, and beside a ``TPU_SHARDING`` row it
does not take (an ep that does not divide its experts) it raises
ShardingConfigError naming both rows.
"""

import contextlib
import json
import threading
import urllib.request
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.serving import install_generate as jinstall_generate
from gofr_tpu.tpu import GenerationEngine as JaxEngine
from gofr_tpu.tpu.checkpoint import maybe_quantize as jquantize
from gofr_tpu.tpu.checkpoint import save_npz
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.errors import ShardingConfigError
from gofr_tpu_torch.models import LLAMA_CONFIGS, llama
from gofr_tpu_torch.ops.quant import QuantizedLinear
from gofr_tpu_torch.parallel.mesh import MeshPlan
from gofr_tpu_torch.parallel.sharding import check_plan
from gofr_tpu_torch.serving import install_generate
from gofr_tpu_torch.tpu import (GenerationEngine, from_jax_params,
                                new_engine_from_config)

JCFG = JAX_CONFIGS["tiny-moe"]
CFG = LLAMA_CONFIGS["tiny-moe"]
BUCKETS = (8, 16)
RNG = np.random.default_rng(12)
PROMPTS = [RNG.integers(1, 256, n).tolist() for n in (5, 13, 9)]
LONG = RNG.integers(1, 256, 40).tolist()        # past bucket 16: the lattice
REP = [7, 9, 11, 7, 9, 11, 7, 9, 11, 7, 9]      # prompt-lookup hits


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JCFG, jax.random.PRNGKey(3))
    return jparams, from_jax_params(_numpy(jparams), device="cpu")


@pytest.fixture(scope="module")
def int8_weights(weights):
    jq = jquantize(weights[0], True)
    tq = from_jax_params(jax.tree.map(
        lambda x: type(x)(*map(np.asarray, x)) if isinstance(x, tuple)
        else np.asarray(x), jq, is_leaf=lambda x: isinstance(x, tuple)),
        device="cpu")
    assert isinstance(tq["layers"]["w_gate"], QuantizedLinear)
    return jq, tq


def _serve(params, prompts, n, *, kv_dtype="int8", **kw):
    """Each package's engine on ``params`` (JAX tree, port tensors),
    the prompts submitted while its device lock is held (one admission
    pass takes them all), greedy: {side: token lists}."""
    out = {}
    for side in ("jax", "port"):
        common = dict(slots=3, max_seq=64, decode_pipeline=1,
                      prompt_buckets=BUCKETS, **kw)
        if side == "jax":
            eng = JaxEngine(JCFG, params[0], kv_dtype={
                "int8": jnp.int8, "bf16": jnp.bfloat16}[kv_dtype], **common)
        else:
            eng = GenerationEngine(CFG, params[1], device="cpu", kv_dtype={
                "int8": torch.int8, "bf16": torch.bfloat16}[kv_dtype],
                **common)
        try:
            with eng._device_lock:
                streams = [eng.generate(p, max_new_tokens=n) for p in prompts]
            out[side] = [s.tokens() for s in streams]
            if side == "port" and kw.get("spec_decode_k"):
                out["spec"] = eng.stats()["spec_decode"]
        finally:
            eng.close()
    assert [len(t) for t in out["port"]] == [n] * len(prompts)
    return out


def _cache_free_greedy(tparams, prompt, n):
    """Greedy tokens from the port's cache-free ``forward``."""
    toks = list(prompt)
    for _ in range(n):
        logits = llama.forward(tparams, CFG, torch.tensor([toks]))
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


@pytest.mark.parametrize("kv_dtype", ["int8", "bf16"])
def test_contiguous_streams_match_jax(weights, kv_dtype):
    out = _serve(weights, PROMPTS, 16, kv_dtype=kv_dtype)
    assert out["port"] == out["jax"]


def test_a_stream_equals_the_cache_free_forward(weights):
    """tests/test_moe.py's oracle on the port: a stream over a dense
    float32 cache equals greedy decoding by the cache-free forward."""
    eng = GenerationEngine(CFG, weights[1], slots=2, max_seq=64,
                           prompt_buckets=BUCKETS, device="cpu")
    try:
        got = eng.generate(PROMPTS[0], max_new_tokens=8).tokens()
    finally:
        eng.close()
    assert got == _cache_free_greedy(weights[1], PROMPTS[0], 8)


def test_int8_weight_streams_match_jax(int8_weights):
    out = _serve(int8_weights, PROMPTS, 16)
    assert out["port"] == out["jax"]


def test_paged_streams_match_jax(weights):
    out = _serve(weights, PROMPTS, 24, paged_blocks=25, paged_block_size=8)
    assert out["port"] == out["jax"]


def test_paged_spec_streams_match_jax(weights):
    """TPU_SPEC_DECODE=4 on a paged engine: the verify pass through the
    MoE layer; the streams equal JAX's spec engine's and the spec-less
    engine's."""
    out = _serve(weights, [REP, PROMPTS[1]], 20, paged_blocks=13,
                 paged_block_size=8, spec_decode_k=4)
    assert out["port"] == out["jax"]
    plain = _serve(weights, [REP, PROMPTS[1]], 20, paged_blocks=13,
                   paged_block_size=8)
    assert plain["port"] == out["port"]
    assert out["spec"]["windows"] > 0


def test_a_lattice_prompt_matches_jax(weights):
    """A 40-token prompt past bucket 16 runs the chunk lattice (no
    ``valid`` mask, as JAX's prefill_chunk) beside a bucket admission."""
    out = _serve(weights, [LONG, PROMPTS[0]], 12)
    assert out["port"] == out["jax"]


def _lora_tree(jparams):
    """``tiny-moe`` with 3 adapter slots of rank 4: adapter 1's B
    filled from a crc32-seeded normal * 0.05, adapter 2's -0.5 times
    it (tests/test_lora.py's stacks)."""
    layers = {**jparams["layers"],
              **jllama.init_lora(JCFG, 3, 4, jax.random.PRNGKey(2))}
    for name in jllama.LORA_TARGETS:
        b = layers[f"lora_b_{name}"]
        fill = jax.random.normal(
            jax.random.PRNGKey(zlib.crc32(name.encode()) % 1000),
            b.shape[:1] + b.shape[2:]) * 0.05
        b = b.at[:, 1].set(fill).at[:, 2].set(fill * -0.5)
        layers[f"lora_b_{name}"] = b
    return {**jparams, "layers": layers}


def test_two_lora_adapters_match_jax(weights):
    """Adapters 1 and 2 on the attention projections, decoding together
    with adapter 0: the streams equal JAX's and the merged-weights
    greedy reference."""
    jp = _lora_tree(weights[0])
    tp = from_jax_params(_numpy(jp), device="cpu")
    prompts = [PROMPTS[0], PROMPTS[1], LONG]
    adapters = [1, 2, 0]
    out = {}
    for side in ("jax", "port"):
        common = dict(slots=3, max_seq=64, decode_pipeline=1,
                      prompt_buckets=BUCKETS, lora_adapters=3)
        eng = (JaxEngine(JCFG, jp, **common) if side == "jax" else
               GenerationEngine(CFG, tp, device="cpu", **common))
        try:
            with eng._device_lock:
                streams = [eng.generate(p, max_new_tokens=8, adapter=a)
                           for p, a in zip(prompts, adapters)]
            out[side] = [s.tokens() for s in streams]
        finally:
            eng.close()
    assert out["port"] == out["jax"]
    for p, a, got in zip(prompts, adapters, out["port"]):
        merged = llama.merge_lora(tp, CFG, a)
        assert got == _cache_free_greedy(merged, p, 8)
    assert out["port"][0] != _cache_free_greedy(
        llama.merge_lora(tp, CFG, 0), prompts[0], 8)


# -- the App -------------------------------------------------------------------

ROWS = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR",
        "TPU_MODEL": "tiny-moe", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "64",
        "TPU_SEQ_BUCKETS": "8,16"}


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, [json.loads(line) for line in
                             resp.read().decode().splitlines() if line]


def test_post_generate_through_each_package_s_app(weights, tmp_path):
    """A gofr_tpu.App and a gofr_tpu_torch.App(device="cpu") built from
    TPU_MODEL=tiny-moe and the same .npz: equal lines for a bucket and a
    lattice prompt."""
    path = str(tmp_path / "tiny-moe.npz")
    save_npz(path, _numpy(weights[0]))
    rows = dict(ROWS, TPU_WEIGHTS=path)
    apps = {}
    with contextlib.ExitStack() as stack:
        for side in ("jax", "port"):
            if side == "jax":
                app = gofr_tpu.App(JMapConfig(dict(rows, APP_NAME="moe-j")))
                jinstall_generate(app)
            else:
                app = gofr_tpu_torch.App(
                    MapConfig(dict(rows, APP_NAME="moe-p")), device="cpu")
                install_generate(app)
            app.run(block=False)
            stack.callback(app.stop)
            apps[side] = app
        for prompt in (PROMPTS[1], LONG):
            got = {side: _post(app.http_port,
                               {"tokens": prompt, "max_new": 10})
                   for side, app in apps.items()}
            assert got["port"][0] == got["jax"][0] == 200
            assert got["port"][1] == got["jax"][1]
            assert len(got["port"][1]) == 10
        assert apps["port"].container.tpu.generator.cfg.n_experts == 4


# -- the rows ------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["", "int8"])
def test_tpu_model_tiny_moe_builds_and_serves(quant):
    eng = new_engine_from_config(MapConfig({
        "TPU_MODEL": "tiny-moe", "TPU_QUANT": quant, "TPU_SLOTS": "2",
        "TPU_MAX_SEQ": "64", "TPU_SEQ_BUCKETS": "8,16"}), device="cpu")
    try:
        gen = eng.generator
        assert gen.cfg.n_experts == 4
        w_gate = gen.params["layers"]["w_gate"]
        assert isinstance(w_gate, QuantizedLinear) == (quant == "int8")
        if quant:
            # quantized as drawn: the weights of maybe_quantize(init)
            want = llama.init(CFG, 0, device="cpu", quant=True)
            assert torch.equal(w_gate.w, want["layers"]["w_gate"].w)
        toks = eng.generate(PROMPTS[0], max_new_tokens=6).tokens()
        assert len(toks) == 6
        score = eng.predict("score", PROMPTS[0])
        assert int(np.argmax(score)) == toks[0]
    finally:
        eng.close()


@pytest.mark.parametrize("model", ["tiny-moe", "mixtral-8x7b"])
def test_tp_beside_an_moe_model_names_both_rows(model):
    """An MoE model is served under tp and ep (tests/test_torch_moe_mesh.py);
    an ep that does not divide its experts (4 and 8) is refused naming
    both rows, before any weight is drawn or worker started."""
    started = threading.active_count()
    with pytest.raises(ShardingConfigError) as err:
        new_engine_from_config(MapConfig({
            "TPU_MODEL": model, "TPU_SHARDING": "ep=3,tp=2"}), device="cpu")
    msg = str(err.value)
    assert "TPU_SHARDING='ep=3,tp=2'" in msg and f"TPU_MODEL={model!r}" in msg
    assert "n_experts" in msg
    assert err.value.sharding_row == "ep=3,tp=2"
    assert threading.active_count() == started
    with pytest.raises(ShardingConfigError, match="TPU_MODEL"):
        check_plan(LLAMA_CONFIGS[model], MeshPlan(ep=3, tp=2))
    for ok in (MeshPlan(tp=2), MeshPlan(ep=2, tp=2), MeshPlan(tp=1)):
        check_plan(LLAMA_CONFIGS[model], ok)


def test_a_tp_engine_refuses_an_moe_model(weights):
    """The engine's own sharded launch refuses an ep the mixture's
    experts do not take, before a worker starts."""
    from gofr_tpu_torch.parallel.mesh import parse_sharding

    started = threading.active_count()
    with pytest.raises(ShardingConfigError, match="mixture of experts"):
        GenerationEngine(CFG, weights[1], slots=2, max_seq=64, device="cpu",
                         mesh=parse_sharding("ep=3,tp=2"))
    assert threading.active_count() == started
