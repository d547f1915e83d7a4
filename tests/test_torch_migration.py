"""Migrations in both packages (gofr_tpu/migration.py and the port's
gofr_tpu_torch/migration.py), each over its own Container: versions apply
in order and once, the same ``gofr_migrations`` ledger rows on sqlite and
the same hash on each package's Redis fake, a failing UP rolls its DDL
back, a failing ledger write rolls the migration back and leaves the
connection usable, a migration with no UP raises ``MigrationError``, the
pub/sub topic facade, ``register_model``'s entries, and ``App.migrate``
with its log events.
"""

import io
import json

import pytest

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu import glog as jglog
from gofr_tpu import migration as jmig
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.container import Container as JContainer
from gofr_tpu.datasource.pubsub import mem as jmem
from gofr_tpu.testutil.redisfake import FakeRedisServer as JFakeRedis
from gofr_tpu_torch import glog as pglog
from gofr_tpu_torch import migration as pmig
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.container import Container as PContainer
from gofr_tpu_torch.datasource.pubsub import mem as pmem
from gofr_tpu_torch.testutil.redisfake import FakeRedisServer as PFakeRedis

PACKAGES = {
    "jax": (jmig, JMapConfig, JContainer, jglog, jmem, JFakeRedis,
            gofr_tpu.App),
    "port": (pmig, MapConfig, PContainer, pglog, pmem, PFakeRedis,
             gofr_tpu_torch.App),
}
SQL_ROWS = {"DB_DIALECT": "sqlite", "DB_NAME": ":memory:",
            "PUBSUB_BACKEND": "MEM", "LOG_LEVEL": "ERROR"}


@pytest.fixture(autouse=True)
def clean_brokers():
    jmem.reset()
    pmem.reset()
    yield
    jmem.reset()
    pmem.reset()


@pytest.fixture(params=sorted(PACKAGES))
def pk(request):
    return request.param


def _container(pk, rows=SQL_ROWS):
    _, cfg, container, _, _, _, _ = PACKAGES[pk]
    return container(cfg(rows))


def _ledger(c) -> list:
    return [(r["version"], r["method"]) for r in c.sql.query(
        "SELECT version, method FROM gofr_migrations ORDER BY version")]


def _tables(c) -> list:
    return [r["name"] for r in c.sql.query(
        "SELECT name FROM sqlite_master WHERE type = 'table' "
        "ORDER BY name")]


def _order_run(pk) -> dict:
    mig = PACKAGES[pk][0]
    c = _container(pk)
    order = []
    try:
        ms = {20240102: mig.Migrate(up=lambda ds: order.append(2)),
              20240101: mig.Migrate(up=lambda ds: order.append(1))}
        mig.run(ms, c)
        first = list(order)
        mig.run(ms, c)                       # the ledger has both
        again = list(order)
        ms[20240103] = lambda ds: order.append(3)   # a plain callable
        ms[20231231] = lambda ds: order.append(0)   # older than the last
        mig.run(ms, c)
        return {"first": first, "again": again, "last": list(order),
                "ledger": _ledger(c),
                "columns": sorted(c.sql.query_row(
                    "SELECT * FROM gofr_migrations"))}
    finally:
        c.close()


def test_versions_apply_in_order_once_and_the_ledgers_are_equal():
    got = {pk: _order_run(pk) for pk in PACKAGES}
    assert got["port"] == got["jax"]
    assert got["port"]["first"] == [1, 2] == got["port"]["again"]
    # a version at or below the last applied one is skipped
    assert got["port"]["last"] == [1, 2, 3]
    assert got["port"]["ledger"] == [(20240101, "UP"), (20240102, "UP"),
                                     (20240103, "UP")]
    assert got["port"]["columns"] == ["duration_ms", "method", "start_time",
                                      "version"]


def test_no_migrations_touch_nothing(pk):
    mig = PACKAGES[pk][0]
    c = _container(pk)
    try:
        mig.run({}, c)
        assert _tables(c) == []
    finally:
        c.close()


def test_up_runs_inside_a_transaction_and_its_effects_stay(pk):
    mig = PACKAGES[pk][0]
    c = _container(pk)

    def up(ds):
        assert ds.sql is not c.sql and type(ds.sql).__name__ == "Tx"
        ds.sql.execute("CREATE TABLE t (x INTEGER)")
        ds.sql.execute("INSERT INTO t VALUES (?)", 42)
        assert ds.sql.query("SELECT x FROM t") == [{"x": 42}]

    try:
        mig.run({1: mig.Migrate(up=up)}, c)
        assert c.sql.query_row("SELECT x FROM t") == {"x": 42}
        assert _ledger(c) == [(1, "UP")]
    finally:
        c.close()


def _failing_up(pk) -> dict:
    mig = PACKAGES[pk][0]
    c = _container(pk)
    try:
        mig.run({1: lambda ds: ds.sql.execute("CREATE TABLE kept (x INT)")},
                c)

        def bad(ds):
            ds.sql.execute("CREATE TABLE doomed (x INTEGER)")
            ds.sql.execute("INSERT INTO kept VALUES (?)", 1)
            raise ValueError("boom")

        with pytest.raises(mig.MigrationError, match="migration 2 failed"):
            mig.run({2: mig.Migrate(up=bad)}, c)
        out = {"tables": _tables(c), "ledger": _ledger(c),
               "kept": c.sql.query("SELECT * FROM kept")}
        done = []
        mig.run({2: lambda ds: done.append(2)}, c)   # fixed, it re-runs
        out["rerun"] = (done, _ledger(c))
        return out
    finally:
        c.close()


def test_a_failing_up_rolls_its_ddl_back_alike():
    got = {pk: _failing_up(pk) for pk in PACKAGES}
    assert got["port"] == got["jax"]
    assert got["port"]["tables"] == ["gofr_migrations", "kept"]
    assert got["port"]["ledger"] == [(1, "UP")]
    assert got["port"]["kept"] == []
    assert got["port"]["rerun"] == ([2], [(1, "UP"), (2, "UP")])


def _failing_ledger_write(pk) -> dict:
    mig = PACKAGES[pk][0]
    c = _container(pk)
    try:
        def takes_its_own_version(ds):
            ds.sql.execute("CREATE TABLE side (x INTEGER)")
            # the ledger's INSERT of version 7 then hits its primary key
            ds.sql.execute("INSERT INTO gofr_migrations (version, method) "
                           "VALUES (?, ?)", 7, "X")

        with pytest.raises(mig.MigrationError, match="ledger write failed"):
            mig.run({7: takes_its_own_version}, c)
        out = {"tables": _tables(c), "ledger": _ledger(c)}
        # no transaction is left open on the shared connection
        c.sql.execute("CREATE TABLE after (x INTEGER)")
        c.sql.begin().rollback()
        out["after"] = _tables(c)
        return out
    finally:
        c.close()


def test_a_failing_ledger_write_rolls_the_migration_back_alike():
    got = {pk: _failing_ledger_write(pk) for pk in PACKAGES}
    assert got["port"] == got["jax"]
    assert got["port"]["tables"] == ["gofr_migrations"]
    assert got["port"]["ledger"] == []
    assert got["port"]["after"] == ["after", "gofr_migrations"]


@pytest.mark.parametrize("bad", [None, "not callable", 3])
def test_a_migration_with_no_up_raises(pk, bad):
    mig = PACKAGES[pk][0]
    c = _container(pk)
    ran = []
    try:
        with pytest.raises(mig.MigrationError, match="has no UP"):
            mig.run({1: lambda ds: ran.append(1),
                     2: mig.Migrate(up=bad)}, c)
        # validated before anything runs
        assert ran == [] and _tables(c) == []
    finally:
        c.close()


def _redis_run(pk) -> dict:
    mig, cfg, container, _, _, fake, _ = PACKAGES[pk]
    srv = fake()
    try:
        c = container(cfg({"REDIS_HOST": srv.host,
                           "REDIS_PORT": str(srv.port),
                           "LOG_LEVEL": "ERROR"}))
        try:
            order = []
            ms = {5: lambda ds: order.append(5),
                  3: lambda ds: ds.redis.set("touched", "yes")}
            mig.run(ms, c)
            mig.run(ms, c)   # no re-run
            ms[9] = lambda ds: order.append(9)
            mig.run(ms, c)
            ledger = c.redis.hgetall("gofr_migrations")
            return {"order": order, "touched": c.redis.get("touched"),
                    "versions": sorted(ledger),
                    "fields": {v: sorted(json.loads(e))
                               for v, e in ledger.items()},
                    "methods": {v: json.loads(e)["method"]
                                for v, e in ledger.items()}}
        finally:
            c.close()
    finally:
        srv.close()


def test_the_redis_hash_ledger_is_the_same_on_each_package_s_fake():
    got = {pk: _redis_run(pk) for pk in PACKAGES}
    assert got["port"] == got["jax"]
    assert got["port"]["order"] == [5, 9]
    assert got["port"]["versions"] == ["3", "5", "9"]
    assert got["port"]["fields"]["3"] == ["duration_ms", "method",
                                          "startTime"]
    assert got["port"]["touched"] == "yes"


def test_sql_and_redis_ledgers_together(pk):
    mig, cfg, container, _, _, fake, _ = PACKAGES[pk]
    srv = fake()
    try:
        c = container(cfg(dict(SQL_ROWS, REDIS_HOST=srv.host,
                               REDIS_PORT=str(srv.port))))
        try:
            mig.run({1: lambda ds: ds.sql.execute("CREATE TABLE a (x INT)"),
                     2: lambda ds: ds.redis.set("k", "v")}, c)
            assert _ledger(c) == [(1, "UP"), (2, "UP")]
            assert sorted(c.redis.hgetall("gofr_migrations")) == ["1", "2"]
            # the ledger that is further along wins
            c.redis.hset("gofr_migrations", "4", json.dumps({}))
            ran = []
            mig.run({3: lambda ds: ran.append(3),
                     5: lambda ds: ran.append(5)}, c)
            assert ran == [5]
        finally:
            c.close()
    finally:
        srv.close()


def test_the_pubsub_facade_creates_and_deletes_topics(pk):
    mig = PACKAGES[pk][0]
    c = _container(pk)
    try:
        mig.run({1: lambda ds: ds.pubsub.create_topic("orders"),
                 2: lambda ds: ds.pubsub.create_topic("audit")}, c)
        topics = c.pubsub.health_check().details["topics"]
        assert "orders" in topics and "audit" in topics
        mig.run({3: lambda ds: ds.pubsub.delete_topic("audit")}, c)
        assert "audit" not in c.pubsub.health_check().details["topics"]
        assert not hasattr(mig.Datasource(pubsub=c.pubsub).pubsub, "publish")
    finally:
        c.close()


class _Noting:
    def __init__(self):
        self.noted = []

    def note_model_version(self, **entry):
        self.noted.append(entry)


def _register_run(pk) -> dict:
    mig = PACKAGES[pk][0]
    c = _container(pk)
    seen = []
    try:
        def up(ds):
            ds.tpu.register_model("llama3-8b", weights_path="/w/v2",
                                  revision="v2")
            ds.tpu.register_model("tiny", revision="seed0")
            seen.append(list(ds.tpu.registered))

        mig.run({1: up}, c)       # no engine: still records
        engine = _Noting()
        tpu = mig._MigrationTPU(engine)
        tpu.register_model("bert-base", weights_path="/w/b")
        return {"seen": seen, "noted": engine.noted,
                "registered": tpu.registered, "ledger": _ledger(c)}
    finally:
        c.close()


def test_register_model_records_its_entries_alike():
    got = {pk: _register_run(pk) for pk in PACKAGES}
    assert got["port"] == got["jax"]
    assert got["port"]["seen"] == [[
        {"name": "llama3-8b", "weights_path": "/w/v2", "revision": "v2"},
        {"name": "tiny", "weights_path": "", "revision": "seed0"}]]
    assert got["port"]["noted"] == got["port"]["registered"] == [
        {"name": "bert-base", "weights_path": "/w/b", "revision": ""}]


def test_app_migrate_logs_each_applied_version(pk):
    mig, cfg, _, glog, _, _, app_cls = PACKAGES[pk]
    kw = {"device": "cpu"} if pk == "port" else {}
    app = app_cls(cfg({"DB_DIALECT": "sqlite", "HTTP_PORT": "0",
                       "METRICS_PORT": "0", "LOG_LEVEL": "INFO"}), **kw)
    out = io.StringIO()
    app.container.logger = glog.Logger(level=glog.LogLevel.INFO, out=out,
                                       err=out, pretty=False)
    try:
        app.migrate({1: mig.Migrate(up=lambda ds: ds.sql.execute(
            "CREATE TABLE via_app (x INTEGER)"))})
        with pytest.raises(mig.MigrationError):
            app.migrate({2: lambda ds: 1 / 0})
        assert "via_app" in _tables(app.container)
    finally:
        app.stop()
    events = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert [(e["level"], e["message"]["event"], e["message"]["version"])
            for e in events] == [("INFO", "migration applied", 1),
                                 ("ERROR", "migration failed", 2)]
