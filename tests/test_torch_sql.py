"""The SQL datasource of both packages on sqlite ``:memory:``
(gofr_tpu/datasource/sql.py and the port's gofr_tpu_torch/datasource/sql.py):
the same placeholder translation and snake-case mapping, the same results
for query, query_row, execute, select into a dataclass and a transaction's
commit or rollback (DDL included: sqlite runs with ``isolation_level =
None``), the same health dict, ``app_sql_stats`` recorded into each
package's metrics, the gated drivers, and ``ctx.sql`` on each App.
"""

import dataclasses
import io

import pytest

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu import glog as jglog
from gofr_tpu import metrics as jmetrics
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.context import Context as JContext
from gofr_tpu.datasource import sql as jsql
from gofr_tpu_torch import glog as pglog
from gofr_tpu_torch import metrics as pmetrics
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.context import Context as PContext
from gofr_tpu_torch.datasource import sql as psql

PACKAGES = {
    "jax": (jsql, jmetrics, JMapConfig, jglog, gofr_tpu.App, JContext),
    "port": (psql, pmetrics, MapConfig, pglog, gofr_tpu_torch.App, PContext),
}
BASE = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR"}

QUERIES = [
    "SELECT * FROM t WHERE a = ? AND b = ?",
    "SELECT '?' AS q, \"?\" AS r FROM t WHERE a = ?",
    "SELECT x FROM t WHERE name LIKE '50%' AND y = ?",
    "UPDATE t SET pct = pct % ? WHERE id = ?",
    "INSERT INTO t VALUES (?, ?, ?)",
    "SELECT 'it''s ?' FROM t",
    "SELECT 1",
]
NAMES = ["FullName", "userID", "already_snake", "HTTPServerPort", "a",
         "ID", "getHTTPResponseCode", "Version2Name", "snake_Case_mix"]


@pytest.fixture(params=sorted(PACKAGES))
def pk(request):
    return request.param


def _db(pk, metrics=None, logger=None):
    sql, _, cfg, _, _, _ = PACKAGES[pk]
    return sql.new_sql(cfg({}), logger, metrics)


def _users(db):
    db.execute("CREATE TABLE users (id INTEGER PRIMARY KEY, "
               "full_name TEXT, age INTEGER)")
    return db


@pytest.mark.parametrize("style", ["qmark", "format", "pyformat", "numeric"])
def test_placeholder_translation_is_the_same(style):
    for q in QUERIES:
        assert psql._translate_placeholders(q, style) == \
            jsql._translate_placeholders(q, style)
    assert psql._translate_placeholders(QUERIES[0], "numeric") == \
        "SELECT * FROM t WHERE a = :1 AND b = :2"
    assert psql._translate_placeholders(QUERIES[2], "format") == \
        "SELECT x FROM t WHERE name LIKE '50%%' AND y = %s"


def test_to_snake_case_is_the_same():
    assert [psql.to_snake_case(n) for n in NAMES] == \
        [jsql.to_snake_case(n) for n in NAMES]
    assert psql.to_snake_case("FullName") == "full_name"
    assert psql.to_snake_case("userID") == "user_id"


def _script(db) -> list:
    """One sequence of operations; what each returned."""
    out = [db.execute("INSERT INTO users (full_name, age) VALUES (?, ?)",
                      "ada", 36),
           db.execute("INSERT INTO users (full_name, age) VALUES (?, ?)",
                      "alan", 41),
           db.execute("INSERT INTO users (full_name, age) VALUES (?, ?)",
                      "grace", 85)]
    out.append(db.query("SELECT * FROM users ORDER BY id"))
    out.append(db.query_row("SELECT age FROM users WHERE full_name = ?",
                            "alan"))
    out.append(db.query_row("SELECT * FROM users WHERE id = 999"))
    out.append(db.execute("UPDATE users SET age = age + ? WHERE age > ?",
                          1, 40))
    out.append(db.query("SELECT full_name, age FROM users WHERE age > ? "
                        "ORDER BY age DESC", 40))
    out.append(db.execute("DELETE FROM users WHERE full_name = ?", "grace"))
    out.append(db.query_row("SELECT COUNT(*) AS n FROM users"))
    return out


def test_query_execute_and_query_row_give_the_same_results():
    got = {}
    for pk in PACKAGES:
        db = _users(_db(pk))
        try:
            got[pk] = _script(db)
        finally:
            db.close()
    assert got["port"] == got["jax"]
    assert got["port"][:3] == [1, 1, 1]
    assert got["port"][4] == {"age": 41} and got["port"][5] is None
    assert got["port"][-1] == {"n": 2}


@dataclasses.dataclass
class User:
    fullName: str = ""     # the column through the snake_case fallback
    age: int = 0


@dataclasses.dataclass
class Named:
    name: str = dataclasses.field(default="", metadata={"db": "full_name"})
    ID: int = 0            # exact name, case-insensitive


def test_select_into_a_dataclass_is_the_same():
    got = {}
    for pk in PACKAGES:
        db = _users(_db(pk))
        try:
            for name, age in (("ada", 36), ("alan", 41)):
                db.execute("INSERT INTO users (full_name, age) VALUES (?, ?)",
                           name, age)
            got[pk] = (db.select(User, "SELECT full_name, age FROM users "
                                       "ORDER BY id"),
                       db.select(Named, "SELECT id, full_name FROM users "
                                        "WHERE age > ?", 40))
            with pytest.raises(TypeError, match="dataclass"):
                db.select(dict, "SELECT 1")
        finally:
            db.close()
    assert got["port"] == ([User("ada", 36), User("alan", 41)],
                           [Named("alan", 2)])
    assert [[dataclasses.asdict(x) for x in part] for part in got["port"]] \
        == [[dataclasses.asdict(x) for x in part] for part in got["jax"]]


def test_a_transaction_commits_or_rolls_back_the_same(pk):
    db = _users(_db(pk))
    try:
        with db.begin() as tx:
            assert tx.execute("INSERT INTO users (full_name) VALUES (?)",
                              "kept") == 1
            assert tx.query("SELECT full_name FROM users") == [
                {"full_name": "kept"}]
        with pytest.raises(RuntimeError, match="boom"):
            with db.begin() as tx:
                tx.execute("INSERT INTO users (full_name) VALUES (?)",
                           "dropped")
                # DDL inside the transaction goes with it
                tx.execute("CREATE TABLE doomed (x INTEGER)")
                raise RuntimeError("boom")
        assert db.query("SELECT full_name FROM users") == [
            {"full_name": "kept"}]
        assert db.query("SELECT name FROM sqlite_master "
                        "WHERE name = 'doomed'") == []
        # an explicit rollback, then the connection is usable at once
        tx = db.begin()
        tx.execute("DELETE FROM users")
        tx.rollback()
        assert db.query_row("SELECT COUNT(*) AS n FROM users") == {"n": 1}
        tx = db.begin()
        tx.execute("DELETE FROM users")
        tx.commit()
        assert db.query_row("SELECT COUNT(*) AS n FROM users") == {"n": 0}
    finally:
        db.close()


def test_the_health_dict_is_the_same():
    health = {}
    for pk in PACKAGES:
        db = _db(pk)
        up = db.health_check().to_dict()
        db.close()
        down = db.health_check().to_dict()
        health[pk] = (up, down)
    assert health["port"][0] == health["jax"][0] == {
        "status": "UP", "details": {"dialect": "sqlite", "host": "local",
                                    "database": ":memory:",
                                    "open_connections": 1, "in_use": 0}}
    assert health["port"][1]["status"] == health["jax"][1]["status"] == \
        "DOWN"
    assert set(health["port"][1]["details"]) == \
        set(health["jax"][1]["details"])


def test_app_sql_stats_and_the_connection_gauges_are_recorded(pk):
    _, metrics, _, glog, _, _ = PACKAGES[pk]
    m = metrics.Manager()
    metrics.register_framework_metrics(m)
    out = io.StringIO()
    log = glog.Logger(level=glog.LogLevel.DEBUG, out=out, err=out,
                      pretty=False)
    db = _users(_db(pk, metrics=m, logger=log))
    try:
        db.execute("INSERT INTO users (full_name) VALUES (?)", "ada")
        db.query("SELECT * FROM users")
        text = m.render_prometheus()
    finally:
        db.close()
    for kind in ("CREATE", "INSERT", "SELECT"):
        assert f'app_sql_stats_count{{type="{kind}"}} 1' in text, kind
    assert "app_sql_open_connections 1" in text
    assert "app_sql_inUse_connections 0" in text   # after each op
    assert '"event": "sql query"' in out.getvalue()


def test_the_port_records_what_jax_records():
    names = {}
    for pk in PACKAGES:
        _, metrics, _, _, _, _ = PACKAGES[pk]
        m = metrics.Manager()
        metrics.register_framework_metrics(m)
        db = _users(_db(pk, metrics=m))
        db.query("SELECT * FROM users")
        db.close()
        names[pk] = sorted(ln for ln in m.render_prometheus().splitlines()
                           if ln.startswith("app_sql_") and "_bucket" not in ln
                           and "_sum" not in ln)
    assert names["port"] == names["jax"]


@pytest.mark.parametrize("dialect,error", [("oracle", ValueError),
                                           ("mysql", RuntimeError),
                                           ("postgres", RuntimeError)])
def test_new_sql_refuses_a_dialect_it_cannot_open_alike(pk, dialect, error):
    sql, _, cfg, _, _, _ = PACKAGES[pk]
    with pytest.raises(error):
        sql.new_sql(cfg({"DB_DIALECT": dialect, "DB_HOST": "127.0.0.1"}))


def test_a_file_database_is_shared_by_both_packages(tmp_path):
    """Both packages write one sqlite file the other reads."""
    path = str(tmp_path / "app.db")
    jdb = jsql.new_sql(JMapConfig({"DB_NAME": path}))
    pdb = psql.new_sql(MapConfig({"DB_NAME": path}))
    try:
        jdb.execute("CREATE TABLE t (x INTEGER)")
        pdb.execute("INSERT INTO t VALUES (?)", 1)
        jdb.execute("INSERT INTO t VALUES (?)", 2)
        assert pdb.query("SELECT x FROM t ORDER BY x") == \
            jdb.query("SELECT x FROM t ORDER BY x") == [{"x": 1}, {"x": 2}]
        assert pdb.health_check().details["database"] == path
    finally:
        jdb.close()
        pdb.close()


def test_ctx_sql_reaches_the_app_s_datasource(pk):
    _, _, cfg, _, app_cls, context = PACKAGES[pk]
    kw = {"device": "cpu"} if pk == "port" else {}
    app = app_cls(cfg(dict(BASE, DB_DIALECT="sqlite")), **kw)
    try:
        ctx = context(request=None, container=app.container)
        assert ctx.sql is app.container.sql
        ctx.sql.execute("CREATE TABLE t (x INTEGER)")
        ctx.sql.execute("INSERT INTO t VALUES (?)", 3)
        assert app.container.sql.query_row("SELECT x FROM t") == {"x": 3}
        health = app.container.health()
        assert health["sql"]["status"] == "UP" and health["status"] == "UP"
    finally:
        app.stop()
