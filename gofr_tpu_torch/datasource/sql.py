"""SQL datasource (the port's own copy of gofr_tpu/datasource/sql.py):
an observable DB-API wrapper with dataclass row mapping, carried on the
Container as ``sql`` and on a handler's Context as ``ctx.sql``.

Reference: pkg/gofr/datasource/sql/ --
  - DB wrapper logging every Query/Exec/Tx op with its duration in us into
    the ``app_sql_stats`` histogram (db.go:15-148, logQuery db.go:30)
  - reflection-based ``Select`` into struct/slice with snake-case field
    mapping (db.go:179-279)
  - dialect/connection handling (sql.go:29-92)
  - conn-pool gauges (sql.go:94-105) and health with pool stats
    (health.go:26-65)

Dialects: ``sqlite`` (stdlib, default: the hermetic seam, playing the
role go-sqlmock plays in the reference), ``mysql``/``postgres`` gated
behind optional driver imports (``pymysql``, ``psycopg2``), which raise
when the driver is missing. Queries use ``?`` placeholders; they are
translated to the driver's paramstyle.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
from typing import Any, Sequence

from . import Health, STATUS_DOWN, STATUS_UP


def to_snake_case(name: str) -> str:
    """CamelCase/mixedCase -> snake_case (reference db.go:279 ToSnakeCase)."""
    s = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", s).lower()


def _translate_placeholders(query: str, paramstyle: str) -> str:
    """Rewrite ``?`` placeholders for the driver's paramstyle, skipping
    string literals ('...', "...") so a '?' inside SQL text survives, and
    escaping literal '%' for format-style drivers (which would otherwise
    treat it as a directive)."""
    if paramstyle == "qmark":
        return query
    out: list[str] = []
    quote: str | None = None
    n = 0
    for ch in query:
        if quote is not None:
            if ch == "%" and paramstyle in ("format", "pyformat"):
                out.append("%%")
                continue
            out.append(ch)
            if ch == quote:
                quote = None
            continue
        if ch in ("'", '"'):
            quote = ch
            out.append(ch)
        elif ch == "?":
            n += 1
            out.append("%s" if paramstyle in ("format", "pyformat") else f":{n}")
        elif ch == "%" and paramstyle in ("format", "pyformat"):
            out.append("%%")
        else:
            out.append(ch)
    return "".join(out)


class Tx:
    """Transaction facade (reference db.go wraps sql.Tx the same way)."""

    def __init__(self, db: "DB"):
        self._db = db
        self._done = False
        if db._explicit_begin:
            # sqlite runs in autocommit (isolation_level=None) so DDL is
            # transactional too — we issue BEGIN/COMMIT ourselves
            db._execute_no_commit("BEGIN")

    def query(self, query: str, *args) -> list[dict[str, Any]]:
        return self._db.query(query, *args)

    def execute(self, query: str, *args) -> int:
        return self._db._execute_no_commit(query, *args)

    def commit(self) -> None:
        self._done = True
        self._db._observed("COMMIT", self._db._conn.commit)

    def rollback(self) -> None:
        self._done = True
        self._db._observed("ROLLBACK", self._db._conn.rollback)

    def __enter__(self) -> "Tx":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if self._done:
            return
        if exc_type is not None:
            self.rollback()
        else:
            self.commit()


class DB:
    """The SQL datasource carried on the container (``ctx.sql``)."""

    def __init__(self, conn, dialect: str, logger=None,
                 metrics=None, host: str = "", database: str = "",
                 paramstyle: str = "qmark"):
        self._conn = conn
        self.dialect = dialect
        self.logger = logger
        self.metrics = metrics
        self.host = host
        self.database = database
        self.paramstyle = paramstyle
        self._lock = threading.RLock()  # DB-API conns are not thread-safe
        self._open = True
        self._in_use = 0
        self._explicit_begin = dialect == "sqlite"

    # -- observation (reference db.go:30-49 logQuery + metrics) --------------
    def _record(self, query: str, dur_us: float) -> None:
        if self.metrics is not None:
            try:
                self.metrics.record_histogram(
                    "app_sql_stats", dur_us,
                    type=query.split(None, 1)[0].upper() if query else "")
                self.metrics.set_gauge("app_sql_open_connections",
                                       1.0 if self._open else 0.0)
                self.metrics.set_gauge("app_sql_inUse_connections",
                                       float(self._in_use))
            except Exception:
                pass
        if self.logger is not None:
            self.logger.debug({"event": "sql query", "query": query,
                               "duration_us": int(dur_us)})

    def _observed(self, label: str, fn, *args):
        start = time.perf_counter()
        self._in_use += 1
        try:
            return fn(*args)
        finally:
            self._in_use -= 1
            self._record(label, (time.perf_counter() - start) * 1e6)

    # -- core ops (reference db.go:51-148) -----------------------------------
    def _cursor_exec(self, query: str, args: Sequence):
        cur = self._conn.cursor()
        cur.execute(_translate_placeholders(query, self.paramstyle), tuple(args))
        return cur

    def query(self, query: str, *args) -> list[dict[str, Any]]:
        """Rows as dicts keyed by column name."""
        with self._lock:
            def run():
                cur = self._cursor_exec(query, args)
                cols = [d[0] for d in cur.description] if cur.description else []
                rows = [dict(zip(cols, r)) for r in cur.fetchall()]
                cur.close()
                return rows
            return self._observed(query, run)

    def query_row(self, query: str, *args) -> dict[str, Any] | None:
        rows = self.query(query, *args)
        return rows[0] if rows else None

    def execute(self, query: str, *args) -> int:
        """Run DML/DDL and commit; returns affected row count."""
        with self._lock:
            def run():
                cur = self._cursor_exec(query, args)
                n = cur.rowcount
                cur.close()
                self._conn.commit()
                return n
            return self._observed(query, run)

    def _execute_no_commit(self, query: str, *args) -> int:
        with self._lock:
            def run():
                cur = self._cursor_exec(query, args)
                n = cur.rowcount
                cur.close()
                return n
            return self._observed(query, run)

    def begin(self) -> Tx:
        """Start a transaction (reference db.go Begin); use as a context
        manager: commits on success, rolls back on exception."""
        return Tx(self)

    # -- select into dataclasses (reference db.go:179-279) -------------------
    def select(self, into: type, query: str, *args) -> list[Any]:
        """Map rows into dataclass instances. Column matching: exact field
        name, else the field's snake_case form (reference db tag / snake-case
        fallback, db.go:233-277)."""
        if not dataclasses.is_dataclass(into):
            raise TypeError(f"select target must be a dataclass, got {into!r}")
        rows = self.query(query, *args)
        fields = dataclasses.fields(into)
        out = []
        for row in rows:
            kw = {}
            lower_row = {k.lower(): v for k, v in row.items()}
            for f in fields:
                col = f.metadata.get("db") if f.metadata else None
                for candidate in (col, f.name, to_snake_case(f.name)):
                    if candidate and candidate.lower() in lower_row:
                        kw[f.name] = lower_row[candidate.lower()]
                        break
            out.append(into(**kw))
        return out

    # -- health (reference health.go:26-65) ----------------------------------
    def health_check(self) -> Health:
        try:
            with self._lock:
                cur = self._conn.cursor()
                cur.execute("SELECT 1")
                cur.fetchall()
                cur.close()
            return Health(status=STATUS_UP, details={
                "dialect": self.dialect, "host": self.host,
                "database": self.database, "open_connections": 1,
                "in_use": self._in_use})
        except Exception as e:
            return Health(status=STATUS_DOWN, details={
                "dialect": self.dialect, "host": self.host, "error": repr(e)})

    def close(self) -> None:
        with self._lock:
            self._open = False
            try:
                self._conn.close()
            except Exception:
                pass


def new_sql(cfg, logger=None, metrics=None) -> DB:
    """Wire a DB from config (reference sql.go:29-92).

    Keys: DB_DIALECT (sqlite|mysql|postgres, default sqlite), DB_HOST,
    DB_PORT, DB_USER, DB_PASSWORD, DB_NAME.
    """
    dialect = (cfg.get("DB_DIALECT") or "sqlite").lower()
    name = cfg.get_or_default("DB_NAME", ":memory:")
    host = cfg.get_or_default("DB_HOST", "localhost")

    if dialect in ("sqlite", "sqlite3"):
        import sqlite3

        conn = sqlite3.connect(name, check_same_thread=False)
        # autocommit mode: the DB layer controls transactions explicitly, so
        # DDL participates in Tx rollback (python sqlite3's legacy implicit
        # transactions autocommit DDL, which would leak half-applied
        # migrations)
        conn.isolation_level = None
        return DB(conn, "sqlite", logger, metrics, host="local",
                  database=name, paramstyle="qmark")

    if dialect == "mysql":
        try:
            import pymysql  # gated: not in the base image
        except ImportError as e:
            raise RuntimeError("mysql dialect requires the pymysql driver") from e
        conn = pymysql.connect(
            host=host, port=cfg.get_int("DB_PORT", 3306),
            user=cfg.get("DB_USER"), password=cfg.get("DB_PASSWORD"),
            database=name)
        return DB(conn, "mysql", logger, metrics, host=host, database=name,
                  paramstyle="format")

    if dialect in ("postgres", "postgresql"):
        try:
            import psycopg2  # gated: not in the base image
        except ImportError as e:
            raise RuntimeError("postgres dialect requires psycopg2") from e
        conn = psycopg2.connect(
            host=host, port=cfg.get_int("DB_PORT", 5432),
            user=cfg.get("DB_USER"), password=cfg.get("DB_PASSWORD"),
            dbname=name)
        return DB(conn, "postgres", logger, metrics, host=host, database=name,
                  paramstyle="format")

    raise ValueError(f"unsupported DB_DIALECT {dialect!r}")
