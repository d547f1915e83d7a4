"""The port's predict path (gofr_tpu_torch.tpu.TorchEngine's programs
behind its coalescing batchers) against the JAX engine's, on the CPU:
both engines are built by their package's ``new_engine_from_config``
from the same rows and the same ``.npz`` (written by JAX's
``save_npz``), and the JAX engine's predict cases run on both -- embed
against a direct call, classify and ``predict_batch``, an unknown
program, health, concurrent predicts equal to solo ones -- as do the
gate's shedding, a deadline expiring in the queue and
``ProgramNotFound``. The port's ``embed``, ``classify`` and ``score``
equal JAX's within 2e-5 (unit-scale embeddings and probabilities, float32)
and 1e-4 (``score``'s logits, float32 through two layers).
"""

import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import gofr_tpu.errors as jerrors
import gofr_tpu.resilience as jres
from gofr_tpu import chaos as jchaos
from gofr_tpu import metrics as jmetrics
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.models import BERT_CONFIGS as JBERT
from gofr_tpu.models import LLAMA_CONFIGS as JLLAMA
from gofr_tpu.models import VIT_CONFIGS as JVIT
from gofr_tpu.models import bert as jbert
from gofr_tpu.models import llama as jllama
from gofr_tpu.models import vit as jvit
from gofr_tpu.pd import wire_role as jwire_role
from gofr_tpu.tpu import new_engine_from_config as jnew_engine
from gofr_tpu.tpu.checkpoint import save_npz
from gofr_tpu.tpu.engine import TPUEngine
import gofr_tpu_torch.errors as perrors
import gofr_tpu_torch.resilience as pres
from gofr_tpu_torch import chaos as pchaos
from gofr_tpu_torch import metrics as pmetrics
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.models import bert
from gofr_tpu_torch.observe import RequestRegistry
from gofr_tpu_torch.tpu import (UNPORTED_ROWS, TorchEngine,
                                new_engine_from_config)

EMBED_ATOL = 2e-5
LOGIT_ATOL = 1e-4
ROWS = {"TPU_SEQ_BUCKETS": "8,16,32", "TPU_BATCH_BUCKETS": "1,2,4",
        "TPU_SLOTS": "4", "TPU_MAX_SEQ": "64"}
MODELS = {"bert-tiny": (jbert, JBERT["tiny"]), "vit-tiny": (jvit, JVIT["tiny"]),
          "tiny": (jllama, JLLAMA["tiny"])}


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """One ``.npz`` a model, written by JAX's ``save_npz``."""
    out = {}
    for name, (mod, jcfg) in MODELS.items():
        path = tmp_path_factory.mktemp("w") / f"{name}.npz"
        save_npz(str(path), jax.tree.map(
            np.asarray, mod.init(jcfg, jax.random.PRNGKey(2))))
        out[name] = str(path)
    return out


def _metrics(mod):
    m = mod.Manager()
    mod.register_framework_metrics(m)
    return m


def _build(side, npz, model, metrics=None, **rows):
    values = dict(ROWS, TPU_MODEL=model, TPU_WEIGHTS=npz[model],
                  **{k: str(v) for k, v in rows.items()})
    if side == "jax":
        return jnew_engine(JMapConfig(values), metrics=metrics)
    return new_engine_from_config(MapConfig(values), device="cpu",
                                  metrics=metrics)


SIDES = {
    "jax": SimpleNamespace(name="jax", errors=jerrors, res=jres,
                           chaos=jchaos, metrics=jmetrics),
    "port": SimpleNamespace(name="port", errors=perrors, res=pres,
                            chaos=pchaos, metrics=pmetrics),
}


@pytest.fixture(params=sorted(SIDES))
def side(request):
    return SIDES[request.param]


def _counter(m, name: str) -> float:
    return sum(float(line.rsplit(" ", 1)[1])
               for line in m.render_prometheus().splitlines()
               if line.startswith(name) and not line.startswith("#"))


def _image(seed=0):
    return np.random.default_rng(seed).normal(size=(28, 28, 3)).astype(
        np.float32)


# -- the JAX engine's predict cases (tests/test_tpu.py) on both engines --------

def test_engine_bert_embed_matches_direct_call(side, npz):
    eng = _build(side.name, npz, "bert-tiny")
    try:
        toks = np.arange(1, 11, dtype=np.int32)  # length 10 -> padded to 16
        got = eng.predict("embed", toks)
        params = eng._programs["embed"].params
        padded = np.zeros((1, 16), np.int32)
        padded[0, :10] = toks
        mask = np.arange(16)[None, :] < 10
        if side.name == "jax":
            want = np.asarray(jbert.embed(params, JBERT["tiny"], padded,
                                          mask))[0]
        else:
            from gofr_tpu_torch.models import BERT_CONFIGS

            want = bert.embed(params, BERT_CONFIGS["tiny"],
                              torch.from_numpy(padded),
                              torch.from_numpy(mask))[0].numpy()
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        assert abs(float(np.linalg.norm(got)) - 1.0) < 1e-4
    finally:
        eng.close()


def test_engine_vit_classify_and_batching(side, npz):
    eng = _build(side.name, npz, "vit-tiny")
    try:
        img = _image()
        probs = eng.predict("classify", img)
        assert probs.shape == (10,)
        assert abs(float(probs.sum()) - 1.0) < 1e-4
        batch = eng.predict_batch("classify", [img, img * 0.5, img * 2.0])
        assert len(batch) == 3
        np.testing.assert_allclose(batch[0], probs, rtol=1e-5, atol=1e-6)
        with pytest.raises(ValueError, match="item shapes"):
            eng.predict("classify", np.zeros((14, 14, 3), np.float32))
    finally:
        eng.close()


def test_engine_unknown_program_and_health(side, npz):
    eng = _build(side.name, npz, "bert-tiny")
    try:
        with pytest.raises(KeyError):
            eng.predict("nope", np.zeros(3, np.int32))
        h = eng.health_check()
        assert h.status == "UP"
        assert h.details["platform"] == "cpu"
        assert h.details["devices"] >= 1
        assert "embed" in h.details["programs"]
    finally:
        eng.close()
    assert eng.health_check().status == "DOWN"


def test_engine_concurrent_predicts_coalesce(side, npz):
    eng = _build(side.name, npz, "bert-tiny")
    sizes = []
    b = eng._batchers["embed"]
    hook = b.on_dispatch
    b.on_dispatch = lambda n, w: (sizes.append(n), hook and hook(n, w))
    try:
        toks = [np.arange(1, 4 + i, dtype=np.int32) for i in range(8)]
        out = [None] * 8

        def worker(i):
            out[i] = eng.predict("embed", toks[i])
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(o is not None and o.shape == (64,) for o in out)
        # the same input solo and coalesced agree: padding never leaks
        solo = eng.predict("embed", toks[0])
        np.testing.assert_allclose(out[0], solo, rtol=2e-5, atol=2e-5)
        assert sum(sizes) == 9 and all(n <= 4 for n in sizes)
    finally:
        eng.close()


# -- the port answers as JAX does --------------------------------------------

def _items(model):
    rng = np.random.default_rng(9)
    if model == "vit-tiny":
        return [_image(s) for s in range(5)]
    vocab = MODELS[model][1].vocab_size
    # lengths across three buckets, and a full one
    return [rng.integers(1, vocab, n).astype(np.int32)
            for n in (1, 5, 8, 9, 17, 32)]


@pytest.mark.parametrize("model,program,atol", [
    ("bert-tiny", "embed", EMBED_ATOL),
    ("vit-tiny", "classify", EMBED_ATOL),
    ("tiny", "score", LOGIT_ATOL),
])
def test_the_port_answers_as_the_jax_engine(npz, model, program, atol):
    """Solo predicts, concurrent predicts and ``predict_batch`` give the
    JAX engine's numbers; ``score`` is JAX's ``score_fn`` (the next-token
    logits at each prompt's end, float32)."""
    items = _items(model)
    out = {}
    for name in ("jax", "port"):
        eng = _build(name, npz, model)
        try:
            solo = [eng.predict(program, it) for it in items]
            together = [None] * len(items)

            def one(i, eng=eng, together=together):
                together[i] = eng.predict(program, items[i])
            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(len(items))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            out[name] = (solo, together,
                         eng.predict_batch(program, items))
        finally:
            eng.close()
    for want, got in zip(out["jax"], out["port"]):
        for w, g in zip(want, got):
            assert g.dtype == np.float32 and g.shape == np.shape(w)
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol)
    if program == "score":
        assert out["port"][0][0].shape == (JLLAMA["tiny"].vocab_size,)


def test_score_reads_each_prompts_last_row(npz):
    """``score`` is the full forward's row at length - 1, whatever the
    batch mates and the bucket."""
    from gofr_tpu_torch.models import LLAMA_CONFIGS, llama

    eng = _build("port", npz, "tiny")
    try:
        items = _items("tiny")[1:4]
        got = eng.predict_batch("score", items)
        params = eng._programs["score"].params
        for it, g in zip(items, got):
            full = llama.forward(params, LLAMA_CONFIGS["tiny"],
                                 torch.from_numpy(it[None].astype(np.int64)))
            np.testing.assert_allclose(g, full[0, -1].numpy(), rtol=0,
                                       atol=LOGIT_ATOL)
    finally:
        eng.close()


# -- warmup, health and the rows ----------------------------------------------

def test_warmup_runs_every_shape_and_health_lists_them(npz):
    want_bert = sorted([b, s] for b in (1, 2, 4) for s in (8, 16, 32))
    seen = {}
    for name in ("jax", "port"):
        for model in ("bert-tiny", "vit-tiny"):
            eng = _build(name, npz, model, TPU_WARMUP="1")
            try:
                h = eng.health_check().details["programs"]
            finally:
                eng.close()
            seen[name, model] = h
    assert seen["port", "bert-tiny"] == seen["jax", "bert-tiny"] == {
        "embed": {"kind": "tokens", "batch_buckets": [1, 2, 4],
                  "compiled_shapes": want_bert}}
    assert seen["port", "vit-tiny"] == seen["jax", "vit-tiny"] == {
        "classify": {"kind": "fixed", "batch_buckets": [1, 2, 4],
                     "compiled_shapes": [[1], [2], [4]]}}


def test_a_llama_engine_serves_score_beside_its_generator(npz):
    eng = _build("port", npz, "tiny", TPU_WARMUP="1")
    try:
        h = eng.health_check()
        prog = h.details["programs"]["score"]
        assert prog["compiled_shapes"] == sorted(
            [b, s] for b in (1, 2, 4) for s in (8, 16, 32))
        assert "generator" in h.details and h.status == "UP"
        toks = eng.generate([3, 4, 5], max_new_tokens=3).tokens()
        assert len(toks) == 3
        first = eng.predict("score", np.asarray([3, 4, 5], np.int32))
        assert int(np.argmax(first)) == toks[0]
    finally:
        eng.close()


def test_the_predict_rows_are_honoured_as_in_jax(npz):
    rows = {"TPU_BATCH_BUCKETS": "1,3,6", "TPU_MAX_BATCH_DELAY": "0.02",
            "TPU_SLO_BATCH_SHARE": "0.5", "TPU_SLO_BATCH_DELAY": "0.1"}
    assert not set(rows) & set(UNPORTED_ROWS)
    seen = {}
    for name in ("jax", "port"):
        eng = _build(name, npz, "bert-tiny", **rows)
        try:
            b = eng._batchers["embed"]
            pol = b.class_policy
            seen[name] = (eng._programs["embed"].batch_buckets, b.max_batch,
                          b.max_delay, pol.throughput_share,
                          pol.throughput_delay, b._thr_delay,
                          pol.reserve(b.max_batch))
        finally:
            eng.close()
    assert seen["port"] == seen["jax"] == ((1, 3, 6), 6, 0.02, 0.5, 0.1,
                                           0.1, 3)


@pytest.mark.parametrize("row", ["TPU_SHARDING", "TPU_TENANTS",
                                 "TPU_SERVING_ROLE",
                                 "TPU_HBM_DEVICE_BUDGET_MB",
                                 "TPU_TENANTS_INLINE"])
def test_every_other_row_still_raises_with_its_name(npz, row):
    """An unported row raises ValueError naming it; the two tenant rows,
    honoured since the tenancy slice, are refused by name when the
    registry cannot be read ("4" is no readable path and no registry
    document). The P/D roles, honoured since the P/D slice, need a
    decoder: ``TPU_SERVING_ROLE=prefill`` on BERT raises "requires a
    decoder model" on both packages (JAX's through its role wiring, as
    its ``new_engine_from_config`` would leave the engine running)."""
    if row == "TPU_SERVING_ROLE":
        rows = {"TPU_SERVING_ROLE": "prefill", "TPU_PD_PEER": "127.0.0.1:1"}
        jeng = _build("jax", npz, "bert-tiny")
        try:
            with pytest.raises(ValueError, match="requires a decoder model"):
                jwire_role(jeng, "prefill",
                           JMapConfig(dict(ROWS, TPU_MODEL="bert-tiny",
                                           **rows)))
        finally:
            jeng.close()
        with pytest.raises(ValueError, match="requires a decoder model"):
            _build("port", npz, "bert-tiny", **rows)
        return
    with pytest.raises(ValueError, match=row):
        _build("port", npz, "bert-tiny", **{row: "4"})


def test_a_card_model_k1_does_not_take_is_refused_before_it_is_built(
        monkeypatch):
    """On the card, a Llama model whose shapes flash_prefill does not take
    (here ``tiny``'s float32) is refused when the engine is built, before
    any weights are made: ``score`` would run K1 or raise, never the
    plain attention."""
    import gofr_tpu_torch.tpu as ptpu

    monkeypatch.setattr(ptpu, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(ptpu.llama, "init", lambda *a, **k: pytest.fail(
        "weights made for a refused model"))
    with pytest.raises(ValueError, match="tiny cannot be scored on cuda: "
                                         "flash_prefill kernel takes bf16"):
        new_engine_from_config(MapConfig({"TPU_MODEL": "tiny"}))


def test_model_names_and_aliases_follow_the_jax_package():
    from gofr_tpu_torch.tpu import _model_config

    for name, want in (("bert", JBERT["bert-base"]),
                       ("bert-base", JBERT["bert-base"]),
                       ("bert-tiny", JBERT["tiny"]),
                       ("vit", JVIT["vit-l-14"]), ("vit-l14", JVIT["vit-l-14"]),
                       ("vit-l-14", JVIT["vit-l-14"]),
                       ("vit-tiny", JVIT["tiny"]),
                       ("llama3-8b", JLLAMA["llama3-8b"])):
        _, mc = _model_config(name)
        assert mc.name == want.name and mc.dim == want.dim, name
    for bad in ("bert-large", "vit-h-14", "gpt2"):
        with pytest.raises(KeyError, match=bad):
            _model_config(bad)


# -- the gate, deadlines, ProgramNotFound (tests/test_resilience.py) -----------

def _echo_engine(side, metrics, gate=None):
    if side.name == "jax":
        eng = TPUEngine(metrics=metrics, max_delay=0.001, gate=gate)
    else:
        eng = TorchEngine(device="cpu", metrics=metrics, max_delay=0.001,
                          gate=gate)
    eng.register("echo", lambda p, t, lens: t, None, kind="tokens",
                 batch_buckets=(1, 2), seq_buckets=(8,))
    eng.warmup("echo")
    return eng


def test_engine_predict_sheds_with_gate(side):
    sched = side.chaos.ChaosSchedule(seed=7).on(
        side.chaos.BATCHER_DISPATCH, latency=0.05)
    m = _metrics(side.metrics)
    eng = _echo_engine(side, m, side.res.AdmissionGate(
        max_queue_depth=2, name="predict", metrics=m))
    item = np.arange(1, 4, dtype=np.int32)
    results = {"ok": 0, "shed": 0}
    lock = threading.Lock()

    def one():
        try:
            eng.predict("echo", item, timeout=10.0)
            with lock:
                results["ok"] += 1
        except side.errors.TooManyRequests:
            with lock:
                results["shed"] += 1

    try:
        with side.chaos.scope(sched):
            threads = [threading.Thread(target=one) for _ in range(12)]
            for t in threads:
                t.start()
                time.sleep(0.003)  # arrivals spread across ~one dispatch
            for t in threads:
                t.join(timeout=10.0)
        assert results["ok"] + results["shed"] == 12
        assert results["shed"] >= 2  # overload vs depth bound 2: sheds
        assert results["ok"] >= 2    # in-flight + queued still served
        assert _counter(m, "app_tpu_shed_total") == results["shed"]
        assert eng.health_check().details["admission"]["echo"]["sheds"] \
            == results["shed"]
    finally:
        eng.close()


def test_a_deadline_expires_in_the_queue_without_execution(side):
    m = _metrics(side.metrics)
    eng = _echo_engine(side, m)
    executed, release = [], threading.Event()
    b = eng._batchers["echo"]
    inner = b.runner

    def held(items):
        executed.append(len(items))
        release.wait(5.0)
        return inner(items)

    b.runner = held
    item = np.arange(1, 4, dtype=np.int32)
    try:
        occupier = threading.Thread(
            target=lambda: eng.predict("echo", item, timeout=10.0),
            daemon=True)
        occupier.start()
        end = time.monotonic() + 5.0
        while not executed and time.monotonic() < end:
            time.sleep(0.002)
        t0 = time.monotonic()
        with pytest.raises(side.errors.DeadlineExceeded):
            eng.predict("echo", item + 1,
                        deadline=side.res.Deadline.after(0.03))
        assert time.monotonic() - t0 < 1.0
        release.set()
        occupier.join(5.0)
        assert executed == [1]  # the expired item never ran
        assert _counter(m, "app_tpu_expired_dropped_total") == 1.0
        with pytest.raises(side.errors.DeadlineExceeded):
            eng.predict("echo", item,
                        deadline=side.res.Deadline(time.monotonic() - 1))
        assert _counter(m, "app_tpu_expired_dropped_total") == 2.0
    finally:
        release.set()
        eng.close()


def test_program_not_found_is_a_404_and_a_key_error(side):
    eng = _echo_engine(side, None)
    try:
        for call, known in (
                (lambda: eng.predict("nope", np.ones(3, np.int32)),
                 "; registered: ['echo']"),
                (lambda: eng.predict_batch("nope", []), "")):
            with pytest.raises(side.errors.ProgramNotFound) as ei:
                call()
            e = ei.value
            assert isinstance(e, KeyError) and e.status_code == 404
            assert e.program == "nope"
            assert str(e) == "no TPU program 'nope'" + known
    finally:
        eng.close()


def test_the_dispatch_metrics_and_the_inflight_entry():
    """The JAX engine's metric names, and a ``predict`` entry in the
    in-flight registry at stage ``batch-wait`` while it waits."""
    m = _metrics(pmetrics)
    reg = RequestRegistry()
    eng = TorchEngine(device="cpu", metrics=m, max_delay=0.001,
                      requests=reg)
    eng.register("echo", lambda p, t, lens: t, None, kind="tokens",
                 batch_buckets=(1, 2), seq_buckets=(8,))
    release = threading.Event()
    b = eng._batchers["echo"]
    inner = b.runner
    b.runner = lambda items: release.wait(5.0) and inner(items)
    try:
        t = threading.Thread(target=lambda: eng.predict(
            "echo", np.ones(3, np.int32), timeout=10.0))
        t.start()
        end = time.monotonic() + 5.0
        while not len(reg) and time.monotonic() < end:
            time.sleep(0.002)
        (entry,) = reg.snapshot()
        assert (entry["kind"], entry["name"], entry["stage"]) == (
            "predict", "echo", "batch-wait")
        release.set()
        t.join(5.0)
        assert len(reg) == 0
    finally:
        release.set()
        eng.close()
    text = m.render_prometheus()
    for name in ("app_tpu_queue_depth", "app_tpu_batch_wait_duration",
                 "app_tpu_batch_fill", "app_tpu_device_execute_duration",
                 "app_tpu_requests_total", "app_tpu_predict_duration"):
        assert f'{name}{{program="echo"' in text or \
            f'{name}_count{{program="echo"' in text, name
    assert eng._programs["echo"].dispatches == 1


def test_an_engine_without_programs_or_generator_is_degraded():
    eng = TorchEngine(device="cpu", model_name="none")
    try:
        assert eng.health_check().status == "DEGRADED"
        with pytest.raises(perrors.ServiceUnavailable):
            eng.generate([1, 2, 3])
    finally:
        eng.close()
    assert eng.health_check().status == "DOWN"
