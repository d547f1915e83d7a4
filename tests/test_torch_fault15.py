"""Fault 15: the four ``/metrics`` series the JAX package feeds and the
port once only registered, held against JAX's engine and arbiter on the
CPU.

- ``app_tpu_paged_evictions_total``: a ``tiny`` paged engine (4 slots,
  9 blocks of 16) with three 29-token prompts asking 60 tokens each
  starves two streams in both packages; each registry counts 2.
- ``app_tpu_devices``: set when an engine gets a registry, to the device
  count its health reports.
- ``app_tpu_hbm_device_budget_bytes`` and
  ``app_tpu_hbm_device_in_use_bytes{device}``: two leases (10 B on
  device "0", 20 B on "1") under a 64 MiB device budget render the
  budget and each device's bytes, and an explicit 0 for each device
  once its lease goes.
"""

import gc

import jax
import numpy as np
import pytest

from gofr_tpu import metrics as jmetrics
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.tpu import TPUEngine as JTPUEngine
from gofr_tpu.tpu import hbm as jhbm
from gofr_tpu.tpu.generator import GenerationEngine as JaxEngine
from gofr_tpu_torch import metrics as pmetrics
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.tpu import TorchEngine, from_jax_params
from gofr_tpu_torch.tpu import hbm as phbm
from gofr_tpu_torch.tpu.generator import GenerationEngine

SIDES = {"jax": (jmetrics, jhbm), "port": (pmetrics, phbm)}
MIB64 = 64 << 20


@pytest.fixture(autouse=True)
def _clean_arbiters():
    for h in (jhbm, phbm):
        h.reset()
    yield
    for h in (jhbm, phbm):
        h.reset()
        h.set_metrics(None)
    gc.collect()


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init(JAX_CONFIGS["tiny"], jax.random.PRNGKey(1))
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _registry(side: str):
    mod = SIDES[side][0]
    m = mod.Manager()
    mod.register_framework_metrics(m)
    return m


def _series(text: str, name: str) -> dict:
    """``{labels: value}`` of every sample of ``name`` in a rendering."""
    out = {}
    for ln in text.splitlines():
        head, _, val = ln.rpartition(" ")
        if head == name or head.startswith(name + "{"):
            out[head[len(name):]] = float(val)
    return out


def _engine(side: str, weights, m):
    rows = dict(slots=4, max_seq=128, prompt_buckets=(32,),
                paged_blocks=9, paged_block_size=16, metrics=m)
    if side == "jax":
        return JaxEngine(JAX_CONFIGS["tiny"], weights[0], **rows)
    return GenerationEngine(LLAMA_CONFIGS["tiny"], weights[1],
                            device="cpu", **rows)


def test_a_starved_paged_stream_counts_an_eviction_as_jax_s_does(weights):
    rng = np.random.default_rng(15)
    prompts = [rng.integers(1, 256, 29).tolist() for _ in range(3)]
    got = {}
    for side in SIDES:
        m = _registry(side)
        eng = _engine(side, weights, m)
        try:
            streams = [eng.generate(p, max_new_tokens=60) for p in prompts]
            lens = [len(s.tokens()) for s in streams]
            evictions = eng.stats()["paged"]["evictions"]
        finally:
            eng.close()
        got[side] = (lens, evictions, _series(
            m.render_prometheus(), "app_tpu_paged_evictions_total"))
    assert got["port"] == got["jax"]
    lens, evictions, series = got["port"]
    assert sorted(lens) == [1, 29, 60] and evictions == 2
    assert series == {"": 2.0}


def test_an_engine_with_a_registry_sets_app_tpu_devices():
    engines = {"jax": lambda m: JTPUEngine(metrics=m),
               "port": lambda m: TorchEngine(device="cpu", metrics=m)}
    for side, make in engines.items():
        m = _registry(side)
        eng = make(m)
        try:
            devices = eng.health_check().details["devices"]
        finally:
            eng.close()
        assert _series(m.render_prometheus(), "app_tpu_devices") == {
            "": float(devices)}, side
    assert devices == 1


def test_the_device_budget_and_each_device_s_bytes_render_as_jax_s():
    texts = {}
    for side, (_, hbm) in SIDES.items():
        m = _registry(side)
        hbm.set_metrics(m)
        hbm.set_device_budget(MIB64)
        owners = [object(), object()]
        for owner, dev, n in ((owners[0], "0", 10), (owners[1], "1", 20)):
            hbm.lease("kv", n, owner=owner, device=dev, tag=dev)
        held = m.render_prometheus()
        hbm.release("kv", owner=owners[0], tag="0")
        one = m.render_prometheus()
        hbm.release("kv", owner=owners[1], tag="1")
        texts[side] = [held, one, m.render_prometheus()]
    for name in ("app_tpu_hbm_device_budget_bytes",
                 "app_tpu_hbm_device_in_use_bytes"):
        got = [_series(t, name) for t in texts["port"]]
        assert got == [_series(t, name) for t in texts["jax"]], name
    budget, in_use = ([_series(t, name) for t in texts["port"]]
                      for name in ("app_tpu_hbm_device_budget_bytes",
                                   "app_tpu_hbm_device_in_use_bytes"))
    assert budget == [{"": float(MIB64)}] * 3
    assert in_use == [{'{device="0"}': 10.0, '{device="1"}': 20.0},
                      {'{device="0"}': 0.0, '{device="1"}': 20.0},
                      {'{device="0"}': 0.0, '{device="1"}': 0.0}]
