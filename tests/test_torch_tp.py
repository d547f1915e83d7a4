"""Tensor-parallel serving (gofr_tpu_torch.parallel) against the JAX
package's engines on `tiny`, on the CPU.

The port runs ``TPU_SHARDING=tp=N`` as N ranks: this process is rank 0
and N - 1 worker processes follow its dispatches over gloo, each on its
head shard (tiny: 4 query heads over 2 KV heads; tp=2 splits both, tp=4
replicates each KV head on two ranks). The ranks meet at rank 0's
TCPStore on localhost, on a port the kernel picks, so no two test
processes share one.
JAX's references, from the same JAX weights carried across with
``from_jax_params``: its unsharded engine and its tp=2 mesh engine (two
of the eight virtual CPU devices; GSPMD, its jnp attention).

Greedy streams are single-stream probes, as tests/test_mesh_kernels.py
takes them: the f32 sums of two factorizations may part at a borderline
argmax when unrelated streams share a batch. Every test runs under its
own time limit (``_LIMIT_S``), and each leaves no worker process behind.
"""

import contextlib
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.parallel import make_mesh
from gofr_tpu.parallel import shard_params as jshard_params
from gofr_tpu.tpu import new_engine_from_config as jnew_engine
from gofr_tpu.tpu.checkpoint import save_npz
from gofr_tpu.tpu.generator import GenerationEngine as JaxEngine
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.parallel import MeshPlan, kv_head_shards, shard_params
from gofr_tpu_torch.tpu import (GenerationEngine, GenerationError, hbm,
                                from_jax_params, new_engine_from_config)

TINY = LLAMA_CONFIGS["tiny"]
JTINY = JAX_CONFIGS["tiny"]
PROMPTS = [[5, 17, 42, 7], [3, 1, 4, 1, 5, 9, 2, 6],
           [(7 * i) % 97 + 1 for i in range(30)]]   # the last: a lattice
REP = [7, 9, 7, 9, 7, 9, 7, 9, 7, 9]   # repetitive: spec windows accept
N_NEW = 20
# a test's own limit: well past its time on a loaded host, well inside
# the suite's
_LIMIT_S = 120
# score logits against JAX's: two f32 factorizations of the same sums
SCORE_ATOL = 1e-4

CASES = {
    "dense": {},
    "int8": {"kv_dtype": "int8"},
    "paged": {"paged_blocks": 25, "paged_block_size": 8},
    "spec": {"spec_decode_k": 4},
    "paged-spec": {"paged_blocks": 25, "paged_block_size": 8,
                   "spec_decode_k": 4},
}


@pytest.fixture(autouse=True)
def _time_limit():
    """Fail a test that runs past _LIMIT_S (a hang shows as a failure,
    not a stuck run); every collective also has its own timeout."""
    def expire(*_):
        raise TimeoutError(f"tensor-parallel test ran past {_LIMIT_S} s")

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


def _kw(case: dict, jax_side: bool) -> dict:
    kw = dict(case)
    if kw.get("kv_dtype") == "int8":
        kw["kv_dtype"] = jnp.int8 if jax_side else torch.int8
    return dict(slots=4, max_seq=64, prompt_buckets=(8, 16), **kw)


def _tokens(eng, prompts, n=N_NEW):
    try:
        return [eng.generate(p, max_new_tokens=n).tokens() for p in prompts]
    finally:
        eng.close()


def _port(params, tp=2, **kw):
    return GenerationEngine(TINY, params, mesh=MeshPlan(tp=tp),
                            device="cpu", **kw)


def _gone(eng) -> bool:
    return all(p.poll() is not None for p in eng._tp.procs)


@pytest.mark.parametrize("case", list(CASES))
def test_tp2_greedy_streams_equal_both_jax_references(weights, case):
    """The port's tp=2 streams equal JAX's unsharded engine and JAX's
    tp=2 mesh engine, token for token; every worker's carry and cursors
    are rank 0's; close() leaves no worker process."""
    jparams, tparams = weights
    prompts = [REP, PROMPTS[0]] if "spec" in case else PROMPTS
    want = _tokens(JaxEngine(JTINY, jparams, **_kw(CASES[case], True)),
                   prompts)
    mesh = make_mesh(tp=2, devices=jax.devices()[:2])
    mesh_want = _tokens(JaxEngine(JTINY, jshard_params(jparams, mesh),
                                  mesh=mesh, **_kw(CASES[case], True)),
                        prompts)
    eng = _port(tparams, **_kw(CASES[case], False))
    try:
        got = [eng.generate(p, max_new_tokens=N_NEW).tokens()
               for p in prompts]
        probe = eng.tp_probe()
        stats = eng.stats()
    finally:
        eng.close()
    assert got == want == mesh_want
    B = 4
    # carry (4 x B) and cursors (B): the same on every rank
    assert (probe[:, :5 * B] == probe[0, :5 * B]).all()
    assert stats["mesh"]["kv_shards"] == kv_head_shards(2, TINY.n_kv_heads)
    assert stats["mesh"]["backend"] == "gloo"
    assert stats["mesh"]["graphs"] is False
    if "spec" in case:
        assert stats["spec_decode"]["windows"] > 0
    assert _gone(eng)


def test_score_batches_while_tp2_streams_are_live_leave_them_exact(
        weights):
    """``score`` batches while tp=2 streams run: one between every upload
    of the pack or the admission inputs and the dispatch that carries it
    (sent from the serving thread itself), and more from a client thread
    throughout. The streams equal JAX's unsharded engine, every worker's
    carry and cursors are rank 0's, and every score equals the port's
    tp=1 logits within SCORE_ATOL."""
    import threading

    from gofr_tpu_torch.models import llama as tllama

    jparams, tparams = weights
    case = {"kv_dtype": "int8"}
    want = _tokens(JaxEngine(JTINY, jparams, **_kw(case, True)), PROMPTS)
    batch = [[3, 1, 4, 0, 0, 0, 0, 0], [5, 17, 42, 7, 9, 11, 2, 8]]
    tokens = torch.tensor(batch, dtype=torch.long)
    lengths = torch.tensor([3, 8], dtype=torch.long)
    rope = tllama.get_rope_tables(TINY, 8, torch.device("cpu"))
    ref = tllama.score(tparams, TINY, tokens, lengths, rope_tables=rope,
                       flash=True).numpy()
    eng = _port(tparams, **_kw(case, False))
    scores, stop = [], threading.Event()

    def score():
        scores.append(eng.tp_score(tokens, lengths, rope, 8).numpy())

    def interleave(staged):
        upload = staged.upload

        def then_score():
            upload()
            score()   # lands before the dispatch that carries the image
        staged.upload = then_score

    def client():
        while not stop.is_set():
            score()

    interleave(eng._pack_up)
    interleave(eng._adm_up)
    scorer = threading.Thread(target=client, daemon=True)
    try:
        scorer.start()
        got = [eng.generate(p, max_new_tokens=N_NEW).tokens()
               for p in PROMPTS]
        stop.set()
        scorer.join(_LIMIT_S)
        probe = eng.tp_probe()
    finally:
        stop.set()
        eng.close()
    assert got == want
    assert (probe[:, :20] == probe[0, :20]).all()
    assert eng._pack_up.uploads > 0 and eng._adm_up.uploads > 0
    assert len(scores) > eng._pack_up.uploads + eng._adm_up.uploads
    for s in scores:
        np.testing.assert_allclose(s, ref, rtol=0, atol=SCORE_ATOL)
    assert _gone(eng)


def test_tp4_with_replicated_kv_heads_equals_tp1(weights):
    """tp=4 over tiny's 2 KV heads: each KV head lives on two ranks. The
    streams equal the port's tp=1 engine and JAX's, contiguous int8."""
    jparams, tparams = weights
    case = {"kv_dtype": "int8"}
    want = _tokens(JaxEngine(JTINY, jparams, **_kw(case, True)),
                   PROMPTS[:2])
    tp1 = _tokens(GenerationEngine(TINY, tparams, device="cpu",
                                   **_kw(case, False)), PROMPTS[:2])
    eng = _port(tparams, tp=4, **_kw(case, False))
    try:
        got = [eng.generate(p, max_new_tokens=N_NEW).tokens()
               for p in PROMPTS[:2]]
        probe = eng.tp_probe()
        stats = eng.stats()
    finally:
        eng.close()
    assert got == tp1 == want
    assert (probe[:, :20] == probe[0, :20]).all()
    assert stats["mesh"]["kv_shards"] == 2 and len(stats["mesh"]["ranks"]) == 4
    assert _gone(eng)


def test_without_a_card_a_tp_engine_raises_before_any_rank_starts(
        weights, monkeypatch):
    """The entry point runs on the card unless asked for the CPU: with no
    card a TP engine raises before it starts a rank."""
    from gofr_tpu_torch.tpu import generator as pgen

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pgen, "TPRanks", lambda *a, **k: pytest.fail(
        "a rank started"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine(TINY, weights[1], mesh=MeshPlan(tp=2), slots=2,
                         max_seq=32)


def test_shards_slice_the_whole_model(weights):
    """shard_params: column leaves split on the output dim, row leaves
    on the input dim, the embedding over vocab rows, norms whole; the
    shards of tp=2 put back together are the whole model."""
    _, tparams = weights
    s0, s1 = (shard_params(tparams, TINY, r, 2) for r in (0, 1))
    lay0, lay1, full = s0["layers"], s1["layers"], tparams["layers"]
    for name in ("wq", "wk", "wv", "w_gate", "w_up"):
        assert torch.equal(torch.cat([lay0[name], lay1[name]], -1),
                           full[name])
    for name in ("wo", "w_down"):
        assert torch.equal(torch.cat([lay0[name], lay1[name]], -2),
                           full[name])
    assert torch.equal(torch.cat([s0["embedding"], s1["embedding"]], 0),
                       tparams["embedding"])
    assert torch.equal(torch.cat([s0["lm_head"], s1["lm_head"]], -1),
                       tparams["lm_head"])
    assert torch.equal(lay0["attn_norm"], full["attn_norm"])
    # tp=4 over 2 KV heads: ranks 0, 1 hold KV head 0; ranks 2, 3 head 1
    hd = TINY.head_dim
    for r in range(4):
        wk = shard_params(tparams, TINY, r, 4)["layers"]["wk"]
        head = r // 2
        assert torch.equal(wk, full["wk"][..., head * hd:(head + 1) * hd])


@contextlib.contextmanager
def _tp_engine(rows):
    """A port engine from rows with TPU_SHARDING."""
    eng = new_engine_from_config(MapConfig(rows), device="cpu")
    try:
        yield eng
    finally:
        eng.close()


def test_score_and_generate_from_the_rows_match_jax(weights, tmp_path):
    """new_engine_from_config with TPU_SHARDING=tp=2 and a JAX .npz that
    each rank slices as it reads: ``score`` (K1's plain version on every
    rank) within SCORE_ATOL of JAX's logits, the first generated token
    its argmax, health's mesh, and each rank's leases in the arbiter,
    one row a rank with its device."""
    jparams, _ = weights
    path = str(tmp_path / "tiny.npz")
    save_npz(path, jax.tree.map(np.asarray, jparams))
    rows = {"TPU_MODEL": "tiny", "TPU_WEIGHTS": path, "TPU_SLOTS": "4",
            "TPU_MAX_SEQ": "64", "TPU_SEQ_BUCKETS": "8,16",
            "TPU_BATCH_BUCKETS": "1,2", "TPU_HBM_DEVICE_BUDGET_MB": "64"}
    jeng = jnew_engine(JMapConfig(rows))
    items = [np.asarray([3, 1, 4], np.int32),
             np.asarray([5, 17, 42, 7, 9, 11, 2, 8, 1, 6], np.int32)]
    try:
        want = [jeng.predict("score", it) for it in items]
        jtok = jeng.generate([3, 1, 4], max_new_tokens=5).tokens()
    finally:
        jeng.close()
    hbm.reset()
    with _tp_engine(dict(rows, TPU_SHARDING="tp=2")) as eng:
        got = [eng.predict("score", it) for it in items]
        toks = eng.generate([3, 1, 4], max_new_tokens=5).tokens()
        health = eng.health_check()
        leases = [r for r in hbm.arbiter_stats()["leases"]
                  if r["subsystem"] == "engine"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=SCORE_ATOL)
    assert toks == jtok and int(np.argmax(got[0])) == toks[0]
    assert health.status == "UP"
    mesh = health.details["mesh"]
    assert {k: mesh[k] for k in ("dp", "pp", "fsdp", "ep", "sp", "tp")} == \
        {"dp": 1, "pp": 1, "fsdp": 1, "ep": 1, "sp": 1, "tp": 2}
    assert (mesh["backend"], mesh["graphs"]) == ("gloo", False)
    assert sorted(r["rank"] for r in leases) == [0, 1]
    assert {r["device"] for r in leases} == {"cpu"}
    assert len({r["bytes"] for r in leases}) == 1   # equal shards
    hbm.reset()


def test_a_per_device_budget_too_small_for_the_ranks_is_refused():
    """TPU_HBM_DEVICE_BUDGET_MB bounds the ranks sharing a device
    together: two tp=2 shards of 48 slots x 128 positions do not fit
    1 MiB of one device, and construction raises HBMExhausted before
    serving; no worker is left behind."""
    rows = {"TPU_MODEL": "tiny", "TPU_SLOTS": "48", "TPU_MAX_SEQ": "128",
            "TPU_KV_DTYPE": "float32", "TPU_SHARDING": "tp=2",
            "TPU_HBM_DEVICE_BUDGET_MB": "1"}
    hbm.reset()
    try:
        with pytest.raises(hbm.HBMExhausted, match="cpu"):
            new_engine_from_config(MapConfig(rows), device="cpu")
        assert hbm.arbiter_stats()["in_use_bytes"] == 0
    finally:
        hbm.reset()


def test_a_killed_worker_fails_the_live_streams_and_health_goes_down():
    """A worker rank killed mid-stream: the live stream fails with
    GenerationError at once (the worker's sockets close), the engine is
    down (health DOWN, generate refused), and close() leaves no
    process."""
    import time

    rows = {"TPU_MODEL": "tiny", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "128",
            "TPU_SEQ_BUCKETS": "8,16", "TPU_SHARDING": "tp=2"}
    with _tp_engine(rows) as eng:
        stream = iter(eng.generate([5, 17, 42, 7], max_new_tokens=100))
        assert next(stream) is not None
        t0 = time.monotonic()
        eng.generator._tp.procs[0].kill()
        with pytest.raises(GenerationError):
            for _ in stream:
                pass
        assert time.monotonic() - t0 < 10.0
        assert eng.generator.down is not None
        assert eng.health_check().status == "DOWN"
        with pytest.raises(GenerationError, match="down"):
            eng.generate([1, 2, 3], max_new_tokens=2)
    assert _gone(eng.generator)


def test_a_hung_worker_fails_the_live_streams_within_the_timeout(
        weights):
    """A worker rank stopped mid-stream (SIGSTOP: alive, silent): the
    next collective times out after ``tp_timeout_s``, the live stream
    fails with GenerationError, the engine is down, and close() kills
    the stopped worker."""
    import time

    eng = _port(weights[1], slots=2, max_seq=128,
                prompt_buckets=(8, 16), tp_timeout_s=3)
    try:
        stream = iter(eng.generate([5, 17, 42, 7], max_new_tokens=100))
        assert next(stream) is not None
        t0 = time.monotonic()
        os.kill(eng._tp.procs[0].pid, signal.SIGSTOP)
        with pytest.raises(GenerationError):
            for _ in stream:
                pass
        # the collective that waits on the stopped rank gives up after
        # tp_timeout_s; nothing waits past it
        assert time.monotonic() - t0 < 15.0
        assert eng.down is not None
    finally:
        eng.close()
    assert _gone(eng)


def test_an_app_serves_tp2_and_its_graceful_stop_closes_the_workers():
    """gofr_tpu_torch.App with TPU_SHARDING=tp=2: the App's engine
    streams, its health carries the mesh, and stop() ends every
    worker."""
    import gofr_tpu_torch

    rows = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR",
            "TPU_MODEL": "tiny", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "64",
            "TPU_SEQ_BUCKETS": "8,16", "TPU_SHARDING": "tp=2"}
    app = gofr_tpu_torch.App(MapConfig(rows), device="cpu")
    gen = app.container.tpu.generator
    try:
        assert len(gen.generate([1, 2, 3], max_new_tokens=4).tokens()) == 4
        assert gen.stats()["mesh"]["alive"] is True
    finally:
        app.stop()
    assert _gone(gen)
    assert not [p for p in gen._tp.procs if p.returncode is None]
    assert os.getpid() not in [p.pid for p in gen._tp.procs]
