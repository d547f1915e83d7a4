"""The serving-role and gateway rows on both packages' Apps, and the
rows the port's App refuses by name before anything starts.

``TPU_SERVING_ROLE=gateway`` turns either App into the prefix-affinity
front door over ``TPU_GATEWAY_REPLICAS`` (gofr_tpu/gateway,
gofr_tpu_torch/gateway), or raises when the replica list is missing;
each ``TPU_GATEWAY_*`` row reads the same on both. With a ``TPU_MODEL``
row beside the gateway role the JAX App logs the engine's "builds no
engine" error and serves the gateway without an engine, where the
port's raises it (the port's rule that nothing falls back on its own).
The fleet, timeline, flight-recorder and clock rows read the same on
both packages' Apps; the multi-host rows the port reads nowhere raise
by name; ``fused``, the JAX default role, builds. The SQL
rows and ``REMOTE_LOG_URL`` build on both packages; a SQL dialect whose
driver is not installed raises naming the row on the port, where JAX
logs it and serves without ``sql``. The ``prefill`` role
reads alike on both: with no model both Apps build without an engine,
and with one both raise for the missing ``TPU_PD_PEER`` (the port's
App; JAX's role wiring, which its App would log).
"""

import pytest

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.pd import wire_role as jwire_role
from gofr_tpu.tpu import new_engine_from_config as jnew_engine
from gofr_tpu_torch.config import MapConfig

BASE = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR"}
REPLICAS = "127.0.0.1:1,127.0.0.1:2"


def _port_app(rows):
    return gofr_tpu_torch.App(MapConfig(dict(BASE, **rows)), device="cpu")


def _jax_app(rows):
    return gofr_tpu.App(JMapConfig(dict(BASE, **rows)))


def _reading(app) -> dict:
    """What a gateway App made of its rows."""
    gw = app._gateway
    return {"path": gw.path, "block": gw.block,
            "long_prefix": gw.router.long_prefix,
            "vnodes": len(gw.router.ring._hashes) // len(gw.table),
            "replicas": [r.address for r in gw.table.replicas],
            "budget": (gw.budget.ratio, gw.budget.burst),
            "timeouts": (gw.connect_timeout_s, gw.stream_timeout_s),
            "resume": (gw.resume, gw.resume_max),
            "poll_s": gw.table.poll_interval_s,
            "routes": sorted((r.method, r.path)
                             for r in app.router.routes),
            "services": sorted(app.container.services)}


# The two tests below keep the names they had while the port refused
# the gateway role and its rows; their cases now hold the two packages'
# gateway Apps alike.

@pytest.mark.parametrize("model", [None, "tiny"])
def test_a_gateway_role_installs_the_jax_gateway_and_is_refused_by_the_port(
        model):
    rows = {"TPU_SERVING_ROLE": "gateway"}
    # no replica list raises on both
    with pytest.raises(ValueError, match="TPU_GATEWAY_REPLICAS"):
        _jax_app(rows)
    with pytest.raises(ValueError, match="TPU_GATEWAY_REPLICAS"):
        _port_app(rows)
    if model is not None:
        # a model row beside the role: the port raises the engine's
        # error, JAX logs it and serves the gateway with no engine
        with pytest.raises(ValueError, match="builds no engine"):
            _port_app(dict(rows, TPU_MODEL=model,
                           TPU_GATEWAY_REPLICAS=REPLICAS))
    japp = _jax_app(dict(rows, TPU_GATEWAY_REPLICAS=REPLICAS,
                         **({"TPU_MODEL": model} if model else {})))
    papp = _port_app(dict(rows, TPU_GATEWAY_REPLICAS=REPLICAS))
    try:
        for app in (japp, papp):
            assert app._gateway is not None and app._http_registered
            assert app._gateway.path == "/generate"
            assert app.container.tpu is None
        assert _reading(papp) == _reading(japp)
        assert _reading(papp)["replicas"] == REPLICAS.split(",")
        assert ("POST", "/generate") in _reading(papp)["routes"]
        assert ("GET", "/gateway/stats") in _reading(papp)["routes"]
        assert _reading(papp)["services"] == ["gateway-replica-0",
                                              "gateway-replica-1"]
    finally:
        japp.stop()
        papp.stop()


def _gateway_row_reads_alike(row, value, model):
    """A ``TPU_GATEWAY_*`` row reads the same on both gateway Apps; with
    a model row the port raises "builds no engine" where JAX logs it and
    builds its gateway with no engine."""
    rows = {"TPU_SERVING_ROLE": "gateway", "TPU_GATEWAY_REPLICAS": REPLICAS,
            row: value}
    if model is not None:
        with pytest.raises(ValueError, match="builds no engine"):
            _port_app(dict(rows, TPU_MODEL=model))
    japp = _jax_app(dict(rows, **({"TPU_MODEL": model} if model else {})))
    papp = _port_app(rows)
    try:
        assert japp.container.tpu is None and japp._gateway is not None
        key, want = {"TPU_GATEWAY_REPLICAS": ("replicas", value.split(",")),
                     "TPU_GATEWAY_PATH": ("path", value),
                     "TPU_GATEWAY_BLOCK": ("block", 32),
                     "TPU_GATEWAY_VNODES": ("vnodes", 16)}[row]
        assert _reading(papp)[key] == want
        assert _reading(papp) == _reading(japp)
    finally:
        japp.stop()
        papp.stop()


def _pd_role_reads_alike(value, model):
    """A P/D role on both packages: with a model row, both raise for the
    missing ``TPU_PD_PEER`` (JAX's role wiring on an engine the test
    closes, as JAX's ``new_engine_from_config`` would leave it running,
    and the port's App); with none, both Apps build without an engine."""
    rows = {"TPU_SERVING_ROLE": value}
    if model is not None:
        rows["TPU_MODEL"] = model
        jeng = jnew_engine(JMapConfig({"TPU_MODEL": model}))
        try:
            with pytest.raises(ValueError, match="TPU_PD_PEER"):
                jwire_role(jeng, value, JMapConfig(rows))
        finally:
            jeng.close()
        with pytest.raises(ValueError, match="TPU_PD_PEER"):
            _port_app(rows)
        return
    japp = _jax_app(rows)
    papp = _port_app(rows)
    try:
        assert japp.container.tpu is None and papp.container.tpu is None
    finally:
        japp.stop()
        papp.stop()


# The test below keeps the name it had while the port refused the
# gateway and prefill roles and the observability rows; those cases now
# hold the two packages alike.

OBS_ROWS = ("TPU_OBS_PEERS", "TPU_TIMELINE_EVENTS", "TPU_TIMELINE",
            "TPU_OBS_CLOCK_WINDOW", "TPU_OBS_FLEET_TIMEOUT_S",
            "DEBUG_EVENT_BUFFER")


def _fleet_timeouts(app, fleet, monkeypatch) -> list:
    """The timeout a ``/debug/request`` peer query of ``app`` passes to
    its package's ``fleet.fetch_json`` (the query then fails, typed)."""
    import json
    import urllib.request

    seen = []

    def fetch(url, path, timeout_s=2.0):
        seen.append(timeout_s)
        raise ConnectionRefusedError(url)

    monkeypatch.setattr(fleet, "fetch_json", fetch)
    app.run(block=False)
    with urllib.request.urlopen(
            f"http://127.0.0.1:{app.metrics_port}/debug/request?trace_id=t",
            timeout=10) as r:
        body = json.loads(r.read())
    assert body["partial"] and body["degraded"][0]["reason"] == "unreachable"
    return seen


def _obs_row_reads_alike(row, value, model, monkeypatch):
    """An observability row builds and reads the same on both packages'
    Apps: the Observe bundle's timeline, recorder and clock, the fleet's
    peer list, and the peer-query timeout. With a model row the port's
    engine holds the App's timeline (None when it is off); the JAX App
    is built without one (its reading of the row does not depend on
    it)."""
    from gofr_tpu.observe import fleet as jfleet
    from gofr_tpu_torch.observe import fleet as pfleet

    rows = {row: value}
    if row == "TPU_OBS_FLEET_TIMEOUT_S":
        rows["TPU_OBS_PEERS"] = "p=http://127.0.0.1:1"
    japp = _jax_app(rows)
    papp = _port_app(dict(rows, **({"TPU_MODEL": model, "TPU_SLOTS": "2"}
                                   if model else {})))
    try:
        readings = []
        for app, fleet in ((japp, jfleet), (papp, pfleet)):
            obs = app.container.observe
            reading = {
                "timeline": (obs.timeline.enabled, obs.timeline.capacity),
                "recorder": obs.recorder.capacity,
                "clock_window": obs.clock.window,
                "peers": [(t["name"], t["debug_url"], t["aligned"])
                          for t in fleet.peer_targets(obs, app.config)]}
            if row == "TPU_OBS_FLEET_TIMEOUT_S":
                reading["timeouts"] = _fleet_timeouts(app, fleet,
                                                      monkeypatch)
            readings.append(reading)
        assert readings[1] == readings[0]
        want = {"TPU_OBS_PEERS": ("peers",
                                  [("a", "http://127.0.0.1:1", False)]),
                "TPU_TIMELINE_EVENTS": ("timeline", (True, 1024)),
                "TPU_TIMELINE": ("timeline", (True, 65536)),
                "TPU_OBS_CLOCK_WINDOW": ("clock_window", 64),
                "TPU_OBS_FLEET_TIMEOUT_S": ("timeouts", [2.0]),
                "DEBUG_EVENT_BUFFER": ("recorder", 2048)}[row]
        assert readings[1][want[0]] == want[1]
        if model is not None:
            gen = papp.container.tpu.generator
            assert gen._observe is papp.container.observe
            assert gen._tl is papp.container.observe.timeline
    finally:
        japp.stop()
        papp.stop()


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
    ("TPU_TIMELINE", "1"),
    ("TPU_TIMELINE", "on"),
    ("TPU_OBS_CLOCK_WINDOW", "64"),
    ("TPU_OBS_FLEET_TIMEOUT_S", "2"),
    ("DEBUG_EVENT_BUFFER", "2048"),
    ("TPU_COORDINATOR_TIMEOUT_S", "60"),
])
@pytest.mark.parametrize("model", [None, "tiny"])
def test_the_port_refuses_each_row_it_reads_nowhere_by_name(row, value,
                                                            model,
                                                            monkeypatch):
    if row in OBS_ROWS:
        _obs_row_reads_alike(row, value, model, monkeypatch)
        return
    if row.startswith("TPU_GATEWAY_"):
        _gateway_row_reads_alike(row, value, model)
        return
    if row == "TPU_SERVING_ROLE":
        _pd_role_reads_alike(value, model)
        return
    rows = {row: value}
    if model is not None:
        rows["TPU_MODEL"] = model
    with pytest.raises(ValueError, match=row):
        _port_app(rows)


@pytest.mark.parametrize("value", ["0", "false", "OFF", "no", "disabled"])
def test_a_falsey_timeline_row_builds_on_both(value):
    """A falsey ``TPU_TIMELINE`` turns the timeline off on both packages'
    Apps: the ring reports its state, and the port's engine holds no
    timeline (one attribute test a hot-path site)."""
    rows = dict(BASE, TPU_TIMELINE=value)
    japp = gofr_tpu.App(JMapConfig(rows))
    papp = gofr_tpu_torch.App(MapConfig(rows), device="cpu")
    try:
        assert not japp.container.observe.timeline.enabled
        assert not papp.container.observe.timeline.enabled
        assert papp.container.tpu is None
    finally:
        japp.stop()
        papp.stop()
    papp = _port_app({"TPU_TIMELINE": value, "TPU_MODEL": "tiny",
                      "TPU_SLOTS": "2"})
    try:
        assert papp.container.tpu is not None
        assert papp.container.tpu.generator._tl is None
        assert papp.container.tpu._tl is None
    finally:
        papp.stop()


def test_the_multihost_rows_name_the_coordinator_timeout():
    from gofr_tpu_torch.container import UNPORTED_ROWS, unported_rows
    from gofr_tpu_torch.parallel.distributed import MULTIHOST_ROWS

    assert "TPU_COORDINATOR_TIMEOUT_S" in MULTIHOST_ROWS
    assert set(MULTIHOST_ROWS) <= set(UNPORTED_ROWS)
    assert unported_rows(MapConfig({"TPU_COORDINATOR_TIMEOUT_S": "1"})) \
        == ["TPU_COORDINATOR_TIMEOUT_S"]
    # the observability rows are read, as JAX reads them
    for row in ("TPU_TIMELINE", "TPU_OBS_CLOCK_WINDOW",
                "TPU_OBS_FLEET_TIMEOUT_S", "DEBUG_EVENT_BUFFER"):
        assert unported_rows(MapConfig({row: "1"})) == []
    assert unported_rows(MapConfig({"TPU_TIMELINE": "off"})) == []
    for row in ("DB_HOST", "DB_DIALECT", "REMOTE_LOG_URL"):
        assert unported_rows(MapConfig({row: "x"})) == []


@pytest.mark.parametrize("rows", [
    {"DB_DIALECT": "sqlite"},
    {"DB_DIALECT": "sqlite3", "DB_NAME": ":memory:"},
    {"DB_HOST": "localhost"},
    {"DB_HOST": "localhost", "DB_DIALECT": "SQLite"},
], ids=["dialect", "sqlite3", "host", "host-and-dialect"])
def test_the_sql_rows_build_a_sqlite_datasource_on_both(rows):
    japp = _jax_app(rows)
    papp = _port_app(rows)
    try:
        for app in (japp, papp):
            sql = app.container.sql
            assert sql is not None and sql.dialect == "sqlite"
            sql.execute("CREATE TABLE t (x INTEGER)")
            sql.execute("INSERT INTO t VALUES (?)", 7)
            assert sql.query_row("SELECT x FROM t") == {"x": 7}
        assert papp.container.health()["sql"] == japp.container.health()["sql"]
    finally:
        japp.stop()
        papp.stop()
    assert not papp.container.sql._open


@pytest.mark.parametrize("dialect,driver", [("mysql", "pymysql"),
                                            ("postgres", "psycopg2"),
                                            ("oracle", None)])
def test_a_sql_dialect_without_its_driver_raises_naming_the_row(dialect,
                                                                driver):
    """The drivers are not installed: the port raises at construction
    naming ``DB_DIALECT``; the JAX App logs the error and goes on with
    ``sql`` None."""
    import importlib.util

    if driver is not None:
        assert importlib.util.find_spec(driver) is None
    with pytest.raises(RuntimeError, match=f"DB_DIALECT={dialect}"):
        _port_app({"DB_DIALECT": dialect, "DB_HOST": "127.0.0.1"})
    japp = _jax_app({"DB_DIALECT": dialect, "DB_HOST": "127.0.0.1"})
    try:
        assert japp.container.sql is None
    finally:
        japp.stop()


@pytest.mark.parametrize("interval", [None, "3600"])
def test_the_remote_log_url_row_builds_a_poller_the_stop_ends(interval):
    rows = {"REMOTE_LOG_URL": "http://127.0.0.1:1/level"}
    if interval is not None:
        rows["REMOTE_LOG_FETCH_INTERVAL"] = interval
    japp = _jax_app(rows)
    papp = _port_app(rows)
    pollers = [app.container._remote_level_poller for app in (japp, papp)]
    try:
        for p in pollers:
            assert p is not None and p._thread.is_alive()
            assert p.url == rows["REMOTE_LOG_URL"]
        assert pollers[1].interval == pollers[0].interval == float(
            interval or 15.0)
    finally:
        japp.stop()
        papp.stop()
    for p in pollers:
        p._thread.join(timeout=10)
        assert not p._thread.is_alive()


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


def _pd_reading(engine) -> dict:
    """What an engine's P/D half made of its rows."""
    if engine.pd_prefill is not None:
        c = engine.pd_prefill
        return {"role": engine.serving_role, "peer": c.peer,
                "block": c.ship_block, "window": c.window_bytes,
                "resume": (c.resume, c.resume_max, c.resume_wait_s)}
    s = engine.pd_ingest
    return {"role": engine.serving_role, "listening": s.stats()["listening"],
            "host": s.host, "window": s.window_bytes}


@pytest.mark.parametrize("row,value,want", [
    ("TPU_PD_BLOCK", "32", {"block": 32}),
    ("TPU_PD_WINDOW_MB", "2", {"window": 2 << 20}),
    ("TPU_RESUME_PD", "false", {"resume": (False, 3, 5.0)}),
    ("TPU_RESUME_WAIT_S", "7.5", {"resume": (True, 3, 7.5)}),
    ("TPU_PD_LISTEN", "127.0.0.1:0", {"listening": True}),
])
def test_the_pd_rows_read_alike(row, value, want):
    """Each P/D row reads the same on both packages' coordinator (the
    ``prefill`` role, or the ``decode`` role's listener for
    ``TPU_PD_LISTEN``), built by each package's ``new_engine_from_config``
    on tiny."""
    from gofr_tpu_torch.tpu import new_engine_from_config

    role = "decode" if row == "TPU_PD_LISTEN" else "prefill"
    rows = {"TPU_MODEL": "tiny", "TPU_SLOTS": "2", "TPU_SERVING_ROLE": role,
            "TPU_PD_PEER": "127.0.0.1:1", row: value}
    jeng = jnew_engine(JMapConfig(rows))
    try:
        peng = new_engine_from_config(MapConfig(rows), device="cpu")
        try:
            got = _pd_reading(peng)
            assert got == _pd_reading(jeng)
            assert {k: got[k] for k in want} == want
            assert got["role"] == role
        finally:
            peng.close()
    finally:
        jeng.close()


# -- tensor parallelism: what TPU_SHARDING does not serve yet ------------------

@pytest.mark.parametrize("rows,name", [
    ({"TPU_SHARDING": "tp=2,dp=2"}, "TPU_SHARDING"),
    ({"TPU_SHARDING": "fsdp=2"}, "TPU_SHARDING"),
    ({"TPU_SHARDING": "tp=2,ep=2"}, "TPU_SHARDING"),
    ({"TPU_SHARDING": "tp"}, "TPU_SHARDING"),
    ({"TPU_SHARDING": "tp=3"}, "TPU_SHARDING"),     # tiny: 4 query heads
    ({"TPU_SHARDING": "tp=8"}, "TPU_SHARDING"),
    ({"TPU_SHARDING": "tp=2", "TPU_LORA_ADAPTERS": "2"}, "TPU_LORA_ADAPTERS"),
    ({"TPU_SHARDING": "tp=2", "TPU_PREFIX_CACHE": "2"}, "TPU_PREFIX_CACHE"),
    ({"TPU_SHARDING": "tp=2", "TPU_KVCACHE_HOST_MB": "4"},
     "TPU_KVCACHE_HOST_MB"),
    ({"TPU_SHARDING": "tp=2", "TPU_SERVING_ROLE": "prefill",
      "TPU_PD_PEER": "127.0.0.1:1"}, "TPU_SERVING_ROLE=prefill"),
    ({"TPU_SHARDING": "tp=2", "TPU_SERVING_ROLE": "decode"},
     "TPU_SERVING_ROLE=decode"),
    ({"TPU_SHARDING": "tp=2", "TPU_MODEL": "bert-tiny"}, "TPU_SHARDING"),
    ({"TPU_HBM_DEVICE_BUDGET_MB": "64"}, "TPU_HBM_DEVICE_BUDGET_MB"),
    ({"TPU_PROCESS_ID": "1"}, "TPU_PROCESS_ID"),
    ({"TPU_COORDINATOR_TIMEOUT_S": "60"}, "TPU_COORDINATOR_TIMEOUT_S"),
    ({"TPU_COORDINATOR": "127.0.0.1:1234", "TPU_SHARDING": "tp=2"},
     "TPU_COORDINATOR"),
    ({"TPU_NUM_PROCESSES": "2", "TPU_SHARDING": "tp=2"},
     "TPU_NUM_PROCESSES"),
])
def test_what_tensor_parallel_serving_does_not_take_is_refused_by_name(
        monkeypatch, rows, name):
    """Each row or pairing outside the tp slice raises ValueError (a
    ShardingConfigError where the plan is at fault) naming it, before any
    weights are made and before any rank starts."""
    import gofr_tpu_torch.tpu as ptpu
    from gofr_tpu_torch.tpu import generator as pgen

    monkeypatch.setattr(ptpu.llama, "init", lambda *a, **k: pytest.fail(
        "weights made for a refused config"))
    monkeypatch.setattr(pgen, "TPRanks", lambda *a, **k: pytest.fail(
        "a rank started for a refused config"))
    with pytest.raises(ValueError, match=name):
        ptpu.new_engine_from_config(
            MapConfig({"TPU_MODEL": "tiny", **rows}), device="cpu")


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_both_packages_refuse_a_pd_role_on_a_tensor_parallel_engine(role):
    """JAX refuses a P/D role on a mesh engine in its role wiring; the
    port refuses it from the rows before any engine (above) and in its
    role wiring too, naming TPU_SHARDING."""
    import types

    import jax

    from gofr_tpu.models import LLAMA_CONFIGS as JCONFIGS
    from gofr_tpu.models import llama as jllama
    from gofr_tpu.parallel import make_mesh, shard_params
    from gofr_tpu.tpu.generator import GenerationEngine as JEngine
    from gofr_tpu_torch.parallel import MeshPlan
    from gofr_tpu_torch.pd import wire_role

    rows = {"TPU_SHARDING": "tp=2", "TPU_PD_PEER": "127.0.0.1:1"}
    mesh = make_mesh(tp=2, devices=jax.devices()[:2])
    jcfg = JCONFIGS["tiny"]
    jgen = JEngine(jcfg, shard_params(jllama.init(jcfg, jax.random.PRNGKey(0)),
                                      mesh), slots=2, max_seq=32,
                   prompt_buckets=(8,), mesh=mesh)
    try:
        with pytest.raises(ValueError, match="TPU_SHARDING"):
            jwire_role(types.SimpleNamespace(generator=jgen), role,
                       JMapConfig(rows))
    finally:
        jgen.close()
    pgen = types.SimpleNamespace(mesh=MeshPlan(tp=2), params={},
                                 cfg=None, _paged=False)
    with pytest.raises(ValueError, match="TPU_SHARDING"):
        wire_role(types.SimpleNamespace(generator=pgen), role,
                  MapConfig(rows))
