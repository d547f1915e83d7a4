"""Rows the port's App refuses by name before anything starts, held
against what the JAX App does with the same rows.

The JAX App turns ``TPU_SERVING_ROLE=gateway`` into the prefix-affinity
front door over ``TPU_GATEWAY_REPLICAS``, or raises when the replica
list is missing (gofr_tpu/app.py). The port has no gateway yet: its App
raises naming ``TPU_SERVING_ROLE``, with or without a ``TPU_MODEL`` row
(an App that built with no engine and no route would answer every
``POST /generate`` with 404). Every ``TPU_GATEWAY_*`` row, and the
fleet, timeline and multi-host rows the port reads nowhere, raise the
same way; ``fused``, the JAX default role, builds.
"""

import pytest

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu_torch.config import MapConfig

BASE = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR"}
REPLICAS = "127.0.0.1:1,127.0.0.1:2"


def _port_app(rows):
    return gofr_tpu_torch.App(MapConfig(dict(BASE, **rows)), device="cpu")


@pytest.mark.parametrize("model", [None, "tiny"])
def test_a_gateway_role_installs_the_jax_gateway_and_is_refused_by_the_port(
        model):
    rows = {"TPU_SERVING_ROLE": "gateway"}
    if model is not None:
        rows["TPU_MODEL"] = model
    # JAX: no replica list raises; with one, the gateway's route is up
    with pytest.raises(ValueError, match="TPU_GATEWAY_REPLICAS"):
        gofr_tpu.App(JMapConfig(dict(BASE, TPU_SERVING_ROLE="gateway")))
    japp = gofr_tpu.App(JMapConfig(dict(BASE, TPU_SERVING_ROLE="gateway",
                                        TPU_GATEWAY_REPLICAS=REPLICAS)))
    try:
        assert japp._gateway is not None and japp._http_registered
        assert japp._gateway.path == "/generate"
    finally:
        japp.stop()
    with pytest.raises(ValueError, match="TPU_SERVING_ROLE"):
        _port_app(rows)
    with pytest.raises(ValueError, match="TPU_SERVING_ROLE"):
        _port_app(dict(rows, TPU_GATEWAY_REPLICAS=REPLICAS))


@pytest.mark.parametrize("row,value", [
    ("TPU_GATEWAY_REPLICAS", REPLICAS),
    ("TPU_GATEWAY_PATH", "/v1/generate"),
    ("TPU_GATEWAY_BLOCK", "32"),
    ("TPU_GATEWAY_VNODES", "16"),
    ("TPU_SERVING_ROLE", "prefill"),
    ("TPU_OBS_PEERS", "a=http://127.0.0.1:1"),
    ("TPU_TIMELINE_EVENTS", "1024"),
    ("TPU_COORDINATOR", "127.0.0.1:1234"),
    ("TPU_NUM_PROCESSES", "2"),
])
@pytest.mark.parametrize("model", [None, "tiny"])
def test_the_port_refuses_each_row_it_reads_nowhere_by_name(row, value,
                                                            model):
    rows = {row: value}
    if model is not None:
        rows["TPU_MODEL"] = model
    with pytest.raises(ValueError, match=row):
        _port_app(rows)


@pytest.mark.parametrize("role", ["fused", "FUSED", ""])
def test_the_fused_role_builds_on_both(role):
    rows = dict(BASE, TPU_SERVING_ROLE=role)
    japp = gofr_tpu.App(JMapConfig(rows))
    papp = gofr_tpu_torch.App(MapConfig(rows), device="cpu")
    try:
        assert japp._gateway is None
        assert papp.container.tpu is None
    finally:
        japp.stop()
        papp.stop()
