"""Serving over the data axes (gofr_tpu_torch, ``TPU_SHARDING`` over dp,
fsdp and ep beside tp) against the JAX package's engines on `tiny`, on
the CPU.

The port runs one rank a device of the JAX mesh (rank r at JAX's device
r, tp innermost): this process is rank 0 and the others are worker
processes that follow its dispatches over gloo. A contiguous cache holds
the rank's data index's share of the slots (JAX's ``kv_cache_specs``), a
paged pool is whole on every data index, and each rank stores its JAX
block of every weight, gathered over fsdp at each dispatch. JAX's
references, from the same weights (``from_jax_params``): its unsharded
engine and its mesh engine over the same axes on the eight virtual CPU
devices (tests/test_sharded_serving.py's way).

Each 8-rank engine is built once a module (its start-up is most of a
test's time); every test runs under its own time limit and leaves no
worker process behind.
"""

import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.parallel import kv_cache_specs as jkv_cache_specs
from gofr_tpu.parallel import make_mesh
from gofr_tpu.parallel import shard_params as jshard_params
from gofr_tpu.tpu import new_engine_from_config as jnew_engine
from gofr_tpu.tpu.checkpoint import maybe_quantize as jquantize
from gofr_tpu.tpu.checkpoint import save_npz
from gofr_tpu.tpu.generator import GenerationEngine as JaxEngine
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.errors import ShardingConfigError
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.parallel import (MeshPlan, parse_mesh_row,
                                     parse_sharding, slot_range)
from gofr_tpu_torch.tpu import (GenerationEngine, from_jax_params,
                                maybe_quantize, new_engine_from_config)
from gofr_tpu_torch.tpu.checkpoint import WeightSource, load_npz, rank_params

TINY = LLAMA_CONFIGS["tiny"]
JTINY = JAX_CONFIGS["tiny"]
PROMPTS = [[5, 17, 42, 7], [3, 1, 4, 1, 5, 9, 2, 6],
           [(7 * i) % 97 + 1 for i in range(30)]]   # the last: a lattice
REP = [7, 9, 7, 9, 7, 9, 7, 9, 7, 9]   # repetitive: spec windows accept
N_NEW = 12
SEEDS = (5, 6, 7)
# score logits against JAX's: two f32 factorizations of the same sums
SCORE_ATOL = 1e-4
_LIMIT_S = 150
AXES = ("dp", "pp", "fsdp", "ep", "sp", "tp")
ROWS = {"tp=2,dp=2,fsdp=2": {"tp": 2, "dp": 2, "fsdp": 2},
        "dp=2": {"dp": 2},
        "tp=2,ep=2,dp=2": {"tp": 2, "ep": 2, "dp": 2}}


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(*_):
        raise TimeoutError(f"data-axes test ran past {_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, _LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JTINY, jax.random.PRNGKey(1))
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _kw(int8: bool, jax_side: bool, **extra) -> dict:
    kw = dict(slots=4, max_seq=64, prompt_buckets=(8, 16), **extra)
    if int8:
        kw["kv_dtype"] = jnp.int8 if jax_side else torch.int8
    return kw


def _run(eng, prompts=PROMPTS, sampled=False):
    """Greedy streams one at a time, the same prompts as one burst, and
    (``sampled``) seeded sampled streams as a burst."""
    greedy = [eng.generate(p, max_new_tokens=N_NEW).tokens()
              for p in prompts]
    burst = [s.tokens() for s in
             [eng.generate(p, max_new_tokens=N_NEW) for p in prompts]]
    drawn = None
    if sampled:
        drawn = [s.tokens() for s in
                 [eng.generate(p, max_new_tokens=N_NEW, temperature=0.8,
                               top_k=20, seed=s)
                  for p, s in zip(prompts, SEEDS)]]
    return greedy, burst, drawn


@pytest.fixture(scope="module")
def unsharded(weights):
    """JAX's unsharded engine's greedy and sampled streams, by KV dtype
    (one engine for every row's test)."""
    runs = {}

    def get(int8: bool):
        if int8 not in runs:
            eng = JaxEngine(JTINY, weights[0], **_kw(int8, True))
            try:
                runs[int8] = _run(eng, sampled=True)
            finally:
                eng.close()
        return runs[int8]
    return get


def _jax_mesh(jparams, axes, int8):
    """JAX's mesh engine's greedy streams over ``axes``."""
    mesh = _mesh(**axes)
    eng = JaxEngine(JTINY, jshard_params(jparams, mesh), mesh=mesh,
                    **_kw(int8, True))
    try:
        return [eng.generate(p, max_new_tokens=N_NEW).tokens()
                for p in PROMPTS]
    finally:
        eng.close()


def _mesh(**axes):
    """JAX's mesh over ``axes`` on the first of the virtual devices."""
    n = int(np.prod(list(axes.values())))
    return make_mesh(**axes, devices=jax.devices()[:n])


def _gone(eng) -> bool:
    return all(p.poll() is not None for p in eng._tp.procs)


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("row", list(ROWS))
def test_contiguous_streams_equal_jax_mesh_and_unsharded(weights, unsharded,
                                                         row, int8):
    """Greedy streams (alone and as a burst over the split slots) equal
    JAX's unsharded engine's and (dense KV) JAX's mesh engine's over the
    same axes; seeded sampled streams equal JAX's. Each rank's cache
    holds B / (dp·fsdp·ep) slots and its carry is the same on its tp
    ranks."""
    jparams, tparams = weights
    axes = ROWS[row]
    plan = MeshPlan(**axes)
    want, want_burst, want_drawn = unsharded(int8)
    # JAX's mesh engine streams its unsharded engine's tokens on either
    # cache (tests/test_sharded_serving.py); one compile a row here
    mesh_want = want if int8 else _jax_mesh(jparams, axes, int8)
    eng = GenerationEngine(TINY, tparams, mesh=plan, device="cpu",
                           **_kw(int8, False))
    try:
        greedy, burst, drawn = _run(eng, sampled=True)
        probe = eng.tp_probe()
        stats = eng.stats()
    finally:
        eng.close()
    assert greedy == want == mesh_want
    assert burst == want_burst == want
    assert drawn == want_drawn
    assert drawn != want
    own = 4 // plan.data
    mesh = stats["mesh"]
    assert (mesh["devices"], mesh["data"], mesh["slots_per_rank"]) == (
        plan.n_ranks, plan.data, own)
    assert mesh["axes"] == axes
    # carry (4 x own) and cursors (own): equal within a data index
    for r in range(plan.n_ranks):
        head = r - plan.coords(r)["tp"]
        assert (probe[r, :5 * own] == probe[head, :5 * own]).all()
    assert _gone(eng)


@pytest.fixture(scope="module")
def npz(weights, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "tiny.npz")
    save_npz(path, jax.tree.map(np.asarray, weights[0]))
    return path


def test_engine_from_config_end_to_end_equals_jax(npz):
    """tests/test_sharded_serving.py's end-to-end rows on both packages
    (TPU_SHARDING=tp=2,dp=2,fsdp=2, each rank reading its blocks of the
    .npz): health's mesh is JAX's six-axis dict, the streams equal,
    ``score`` (split over the data axes for a batch of 4, replicated for
    one) within SCORE_ATOL of JAX's, its argmax the first token."""
    rows = {"TPU_MODEL": "tiny", "TPU_WEIGHTS": npz,
            "TPU_SHARDING": "tp=2,dp=2,fsdp=2", "TPU_MAX_SEQ": "64",
            "TPU_SLOTS": "4", "TPU_SEQ_BUCKETS": "8,16",
            "TPU_BATCH_BUCKETS": "1,2,4"}
    items = [np.asarray(p[:8], np.int32) for p in PROMPTS] + [
        np.asarray([3, 1, 4], np.int32)]
    jeng = jnew_engine(JMapConfig(rows))
    try:
        jhealth = jeng.health_check().details["mesh"]
        jtoks = jeng.generate([3, 1, 4], max_new_tokens=5).tokens()
        want = [jeng.predict("score", it) for it in items]
    finally:
        jeng.close()
    eng = new_engine_from_config(MapConfig(rows), device="cpu")
    gen = eng.generator
    try:
        health = eng.health_check()
        toks = eng.generate([3, 1, 4], max_new_tokens=5).tokens()
        one = eng.predict("score", items[-1])
        got = [None] * len(items)

        def client(i):
            got[i] = eng.predict("score", items[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(items))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        eng.close()
    mesh = health.details["mesh"]
    assert {k: mesh[k] for k in AXES} == jhealth == {
        "dp": 2, "pp": 1, "fsdp": 2, "ep": 1, "sp": 1, "tp": 2}
    assert health.status == "UP"
    assert toks == jtoks and len(toks) == 5
    assert int(np.argmax(one)) == toks[0]
    for g, w in zip(got + [one], want + [want[-1]]):
        np.testing.assert_allclose(g, w, rtol=0, atol=SCORE_ATOL)
    assert _gone(gen)


def test_paged_tp2_dp4_with_spec_decode_equals_jax(weights):
    """tests/test_multichip_serving.py's paged tp=2,dp=4 engine, with
    TPU_SPEC_DECODE: every data index holds the whole pool and runs every
    slot (JAX's ``paged_cache_specs``), so the streams are JAX's and each
    rank's carry, cursors and pool rows are rank 0's."""
    jparams, tparams = weights
    extra = dict(paged_blocks=25, paged_block_size=8, spec_decode_k=4)
    prompts = [REP, PROMPTS[0], PROMPTS[1]]
    jeng = JaxEngine(JTINY, jparams, **_kw(False, True, **extra))
    try:
        want = _run(jeng, prompts)[:2]
    finally:
        jeng.close()
    mesh = make_mesh(tp=2, dp=4)
    jeng = JaxEngine(JTINY, jshard_params(jparams, mesh), mesh=mesh,
                     **_kw(False, True, paged_blocks=25, paged_block_size=8))
    try:
        mesh_want = [jeng.generate(p, max_new_tokens=N_NEW).tokens()
                     for p in prompts]
    finally:
        jeng.close()
    eng = GenerationEngine(TINY, tparams, mesh=MeshPlan(tp=2, dp=4),
                           device="cpu", **_kw(False, False, **extra))
    try:
        got = _run(eng, prompts)[:2]
        probe = eng.tp_probe()
        stats = eng.stats()
    finally:
        eng.close()
    assert got == want and got[0] == mesh_want
    assert stats["spec_decode"]["windows"] > 0
    assert stats["mesh"]["slots_per_rank"] == 4
    assert (probe[:, :5 * 4 + 1] == probe[0, :5 * 4 + 1]).all()
    assert _gone(eng)


@pytest.mark.parametrize("slots", [4, 6, 8])
@pytest.mark.parametrize("row", ["tp=2,dp=4", "tp=2,dp=2,fsdp=2",
                                 "ep=2,tp=2,dp=2", "dp=2"])
def test_slot_map_equals_jax_cache_sharding(row, slots):
    """Each rank's slots [lo, hi) are the batch rows JAX's contiguous
    cache puts on the same device (``kv_cache_specs``: the batch over
    (dp, fsdp, ep), replicated where their product does not divide
    it)."""
    plan = parse_sharding(row)
    mesh = _mesh(**plan.shape())
    cache = jax.eval_shape(lambda: jllama.init_cache(JTINY, slots, 16))
    k = jkv_cache_specs(mesh, cache).k
    index = k.devices_indices_map(cache.k.shape)
    for r, dev in enumerate(mesh.devices.flat):
        rows = index[dev][1]
        assert slot_range(plan, plan.coords(r), slots) == \
            (rows.start or 0, slots if rows.stop is None else rows.stop)


def _boxes(arr, dev):
    """The index JAX's sharded ``arr`` keeps on device ``dev``."""
    return arr.sharding.devices_indices_map(arr.shape)[dev]


@pytest.mark.parametrize("row", ["tp=2,dp=2,fsdp=2", "fsdp=4,tp=2",
                                 "ep=2,tp=2,dp=2"])
def test_each_rank_s_blocks_are_jax_s_addressable_shards(weights, npz, row):
    """Every leaf a rank stores (``rank_params`` of the whole tree, and
    of the .npz each rank reads) is JAX's shard of the same leaf on the
    same device; with TPU_QUANT=int8 each rank's codes are the whole
    leaf's codes at JAX's shard of the quantized leaf (sliced first,
    then quantized with the whole leaf's scales), and its scale is cut
    on the output axis only."""
    jparams, tparams = weights
    plan = parse_sharding(row)
    mesh = _mesh(**plan.shape())
    sharded = jshard_params(jparams, mesh)
    jq = jshard_params(jquantize(jparams, True), mesh)
    whole_q = maybe_quantize(load_npz(npz, device="cpu"), True)
    devs = list(mesh.devices.flat)

    def leaves(tree):
        out = {k: v for k, v in tree.items() if k != "layers"}
        out.update({f"layers/{k}": v for k, v in tree["layers"].items()})
        return out

    for r, dev in enumerate(devs):
        dense = leaves(rank_params(TINY, tparams, r, plan.tp, "cpu",
                                   plan=plan))
        quant = leaves(rank_params(
            TINY, WeightSource("npz", path=npz, quant=True), r, plan.tp,
            "cpu", plan=plan))
        jdense, jquant, whole = (leaves(t) for t in (sharded, jq, whole_q))
        for path, arr in jdense.items():
            np.testing.assert_array_equal(
                dense[path].numpy(), np.asarray(arr)[_boxes(arr, dev)],
                err_msg=f"rank {r} {path}")
        for path, arr in jquant.items():
            got = quant[path]
            if hasattr(arr, "scale"):
                wbox, sbox = _boxes(arr.w, dev), _boxes(arr.scale, dev)
                assert got.w.dtype == torch.int8
                np.testing.assert_array_equal(
                    got.w.numpy(), whole[path].w.numpy()[wbox],
                    err_msg=f"rank {r} {path} codes")
                np.testing.assert_array_equal(
                    got.scale.numpy(), whole[path].scale.numpy()[sbox],
                    err_msg=f"rank {r} {path} scale")
                # the scale is split on its output axis only
                assert all(s == slice(None) for s in sbox[1:-1])
            else:
                np.testing.assert_array_equal(
                    got.numpy(), np.asarray(arr)[_boxes(arr, dev)],
                    err_msg=f"rank {r} {path}")


def test_a_kv_head_split_beside_data_axes_is_jax_s_refusal(weights):
    """tp=4 over tiny's 2 KV heads beside dp=2: both packages refuse it
    with ShardingConfigError naming the row, before any rank starts."""
    jparams, tparams = weights
    mesh = make_mesh(tp=4, dp=2)
    with pytest.raises(Exception, match="splits a KV head") as jerr:
        JaxEngine(JTINY, jshard_params(jparams, mesh), mesh=mesh,
                  **_kw(False, True))
    started = threading.active_count()
    with pytest.raises(ShardingConfigError, match="splits a KV head") as err:
        GenerationEngine(TINY, tparams, mesh=parse_sharding("tp=4,dp=2"),
                         device="cpu", **_kw(False, False))
    assert err.value.sharding_row == jerr.value.sharding_row == "dp=2,tp=4"
    assert threading.active_count() == started
    # the same tp beside no data axis replicates each KV head: served
    assert parse_sharding("tp=4").data == 1


REFUSED = {
    "pp": ({"TPU_SHARDING": "tp=2,pp=2"}, "pp=2 .pp is a training axis"),
    "sp": ({"TPU_SHARDING": "sp=2"}, "sp=2 .sp .*ROADMAP item 12"),
    "prefix-cache": ({"TPU_SHARDING": "dp=2", "TPU_PREFIX_CACHE": "2"},
                     "TPU_PREFIX_CACHE cannot run with TPU_SHARDING='dp=2'"),
    "paged-prefix": ({"TPU_SHARDING": "tp=2,dp=2", "TPU_PREFIX_CACHE": "2",
                      "TPU_PAGED_BLOCKS": "25", "TPU_PAGED_BLOCK": "8"},
                     "TPU_PREFIX_CACHE cannot run with TPU_SHARDING="),
    "lora": ({"TPU_SHARDING": "fsdp=2", "TPU_LORA_ADAPTERS": "2"},
             "TPU_LORA_ADAPTERS cannot run with TPU_SHARDING='fsdp=2'"),
    "tenancy": ({"TPU_SHARDING": "ep=2", "TPU_TENANTS_INLINE":
                 '{"tenants": {"a": {}}}'},
                "TPU_TENANTS_INLINE cannot run with TPU_SHARDING='ep=2'"),
    "prefill-role": ({"TPU_SHARDING": "dp=2", "TPU_SERVING_ROLE": "prefill",
                      "TPU_PD_PEER": "127.0.0.1:1"},
                     "TPU_SERVING_ROLE=prefill cannot run with"),
    "bert": ({"TPU_SHARDING": "tp=4,dp=2", "TPU_MODEL": "bert-tiny"},
             "sharded bert models"),
    "vit": ({"TPU_SHARDING": "dp=2", "TPU_MODEL": "vit-tiny"},
            "sharded vit models"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_serving_over_the_data_axes_refuses_is_named(case, monkeypatch):
    """pp and sp, the prefix tiers, the paged prefix index, LoRA and
    tenancy beside a data axis (ROADMAP 11b step 3d), the P/D roles and
    the encoder families raise ShardingConfigError naming the rows,
    before any weight is made or any rank starts."""
    import gofr_tpu_torch.tpu as ptpu
    from gofr_tpu_torch.tpu import generator as pgen

    monkeypatch.setattr(ptpu.llama, "init", lambda *a, **k: pytest.fail(
        "weights made for a refused config"))
    monkeypatch.setattr(pgen, "TPRanks", lambda *a, **k: pytest.fail(
        "a rank started for a refused config"))
    rows, match = REFUSED[case]
    with pytest.raises(ShardingConfigError, match=match) as err:
        new_engine_from_config(MapConfig({"TPU_MODEL": "tiny", **rows}),
                               device="cpu")
    raw = rows["TPU_SHARDING"]
    assert err.value.sharding_row in (raw, parse_mesh_row(raw).row())


def test_the_engine_refuses_the_3d_rows_beside_data_axes(weights):
    """GenerationEngine's own launch refuses the prefix tiers and LoRA
    beside a data axis before a rank starts; a tenancy plane is refused
    when it is installed. Under tp alone all three are served."""
    _, tparams = weights
    started = threading.active_count()
    for kw, name in (({"prefix_cache_slots": 2}, "TPU_PREFIX_CACHE"),
                     ({"lora_adapters": 2}, "TPU_LORA_ADAPTERS")):
        with pytest.raises(ShardingConfigError, match=name):
            GenerationEngine(TINY, tparams, mesh=MeshPlan(dp=2),
                             device="cpu", **_kw(False, False, **kw))
    assert threading.active_count() == started
    eng = GenerationEngine(TINY, tparams, mesh=MeshPlan(dp=2), device="cpu",
                           **_kw(False, False))
    try:
        with pytest.raises(ShardingConfigError, match="TPU_TENANTS"):
            eng.install_tenancy(object())
        assert eng.tenancy is None
    finally:
        eng.close()
    assert _gone(eng)


def test_an_app_serves_over_the_data_axes_and_stops_its_ranks(npz):
    """gofr_tpu_torch.App with TPU_SHARDING=tp=2,dp=2: POST /generate
    streams JAX's unsharded engine's tokens over HTTP, /metrics and the
    health answer, and stop() ends every worker."""
    import json
    import urllib.request

    import gofr_tpu_torch
    from gofr_tpu_torch.serving import install_generate

    rows = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR",
            "TPU_MODEL": "tiny", "TPU_WEIGHTS": npz, "TPU_SLOTS": "4",
            "TPU_MAX_SEQ": "64", "TPU_SEQ_BUCKETS": "8,16",
            "TPU_KV_DTYPE": "bf16", "TPU_SHARDING": "tp=2,dp=2"}
    # JAX's unsharded engine on the same rows (its 4-device mesh would
    # need exactly 4 of the 8 virtual devices)
    jeng = jnew_engine(JMapConfig({k: v for k, v in rows.items()
                                   if k != "TPU_SHARDING"}))
    try:
        want = jeng.generate(PROMPTS[1], max_new_tokens=6).tokens()
    finally:
        jeng.close()
    app = gofr_tpu_torch.App(MapConfig(rows), device="cpu")
    install_generate(app)
    gen = app.container.tpu.generator
    try:
        app.run(block=False)
        req = urllib.request.Request(
            f"http://127.0.0.1:{app.http_port}/generate",
            data=json.dumps({"tokens": PROMPTS[1], "max_new": 6}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = resp.read().decode()
        lines = [json.loads(ln) for ln in body.splitlines() if ln]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{app.metrics_port}/metrics",
                timeout=30) as resp:
            metrics = resp.read().decode()
        health = app.container.tpu.health_check()
    finally:
        app.stop()
    assert [ln["token"] for ln in lines] == want
    assert "app_tpu" in metrics
    assert health.status == "UP"
    assert {ax: health.details["mesh"][ax] for ax in AXES} == {
        "dp": 2, "pp": 1, "fsdp": 1, "ep": 1, "sp": 1, "tp": 2}
    assert _gone(gen)
