"""Migrations: ordered run-once schema/data/model changes with a version
ledger (the port's own copy of gofr_tpu/migration.py).

Reference: pkg/gofr/migration/ --
  - ``Run(map[int64]Migrate, c)`` (migration.go:23-108): validate UP funcs,
    sort versions, read last applied from SQL/Redis, run each pending
    migration inside a transaction, record version + duration
  - SQL ledger table ``gofr_migrations`` (sql.go:142-158), rollback on
    failure (sql.go:102-112)
  - Redis hash ledger ``gofr_migrations`` (redis.go:53-67)
  - tx-scoped Datasource facade {SQL, Redis, PubSub} (datasource.go:3-9);
    pubsub exposes Create/DeleteTopic only (pubsub.go:5-24)

Migrations are also the model/weight version ledger:
``ds.tpu.register_model(...)`` records which model+weights revision the
app serves, so rollouts are ordered and auditable the same way schema
changes are.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

LEDGER_TABLE = "gofr_migrations"
LEDGER_HASH = "gofr_migrations"


@dataclasses.dataclass
class Migrate:
    """One migration: an UP function receiving the tx-scoped Datasource
    (reference migration.go:14-18; no DOWN — same as the reference)."""

    up: Callable[["Datasource"], None]


class _MigrationPubSub:
    """Topic admin only (reference pubsub.go:5-24)."""

    def __init__(self, client):
        self._client = client

    def create_topic(self, name: str) -> None:
        self._client.create_topic(name)

    def delete_topic(self, name: str) -> None:
        self._client.delete_topic(name)


class _MigrationTPU:
    """Model-version ledger facade: records weight/program revisions the
    way SQL migrations record schema revisions."""

    def __init__(self, engine):
        self._engine = engine
        self.registered: list[dict[str, Any]] = []

    def register_model(self, name: str, weights_path: str = "",
                       revision: str = "") -> None:
        entry = {"name": name, "weights_path": weights_path,
                 "revision": revision}
        self.registered.append(entry)
        if self._engine is not None and hasattr(self._engine, "note_model_version"):
            self._engine.note_model_version(**entry)


class Datasource:
    """What an UP function sees (reference datasource.go:3-9)."""

    def __init__(self, sql=None, redis=None, pubsub=None, tpu=None, logger=None):
        self.sql = sql
        self.redis = redis
        self.pubsub = _MigrationPubSub(pubsub) if pubsub is not None else None
        self.tpu = _MigrationTPU(tpu)
        self.logger = logger


class MigrationError(Exception):
    pass


def _ensure_sql_ledger(sql) -> None:
    """DDL per reference sql.go:142-158 (dialect-neutral subset)."""
    sql.execute(
        f"CREATE TABLE IF NOT EXISTS {LEDGER_TABLE} ("
        "version INTEGER PRIMARY KEY, "
        "method TEXT, "
        "start_time TEXT, "
        "duration_ms INTEGER)")


def _last_sql_version(sql) -> int:
    row = sql.query_row(f"SELECT MAX(version) AS v FROM {LEDGER_TABLE}")
    return int(row["v"]) if row and row["v"] is not None else 0


def _last_redis_version(redis) -> int:
    data = redis.hgetall(LEDGER_HASH)
    return max((int(v) for v in data.keys()), default=0)


def run(migrations: dict[int, Migrate | Callable], container) -> None:
    """Apply pending migrations in version order (reference migration.go:23-108)."""
    if not migrations:
        return
    log = container.logger

    normalized: dict[int, Migrate] = {}
    for version, m in migrations.items():
        if callable(m) and not isinstance(m, Migrate):
            m = Migrate(up=m)
        if m.up is None or not callable(m.up):
            raise MigrationError(f"migration {version} has no UP function")
        normalized[int(version)] = m

    sql, redis, pubsub, tpu = (container.sql, container.redis,
                               container.pubsub, container.tpu)

    last = 0
    if sql is not None:
        _ensure_sql_ledger(sql)
        last = max(last, _last_sql_version(sql))
    if redis is not None:
        last = max(last, _last_redis_version(redis))

    for version in sorted(normalized):
        if version <= last:
            continue
        m = normalized[version]
        start = time.time()
        ds = Datasource(sql=sql, redis=redis, pubsub=pubsub, tpu=tpu, logger=log)

        tx = sql.begin() if sql is not None else None
        if tx is not None:
            ds.sql = tx  # UP runs inside the transaction (migration.go:77-93)
        try:
            m.up(ds)
        except Exception as e:
            if tx is not None:
                tx.rollback()
            log.error({"event": "migration failed", "version": version,
                       "error": repr(e)})
            raise MigrationError(f"migration {version} failed: {e!r}") from e

        duration_ms = int((time.time() - start) * 1000)
        if tx is not None:
            # version row inside the same tx (reference sql.go:114-139); a
            # failing ledger write must roll the whole migration back — a
            # dangling open tx would swallow the NEXT statement on the shared
            # connection
            try:
                tx.execute(
                    f"INSERT INTO {LEDGER_TABLE} "
                    "(version, method, start_time, duration_ms) VALUES (?, ?, ?, ?)",
                    version, "UP",
                    time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(start)),
                    duration_ms)
                tx.commit()
            except Exception as e:
                try:
                    tx.rollback()
                except Exception:
                    pass
                log.error({"event": "migration ledger write failed",
                           "version": version, "error": repr(e)})
                raise MigrationError(
                    f"migration {version} ledger write failed: {e!r}") from e
        if redis is not None:
            # hash entry per reference redis.go:53-67
            import json as _json

            redis.hset(LEDGER_HASH, str(version), _json.dumps({
                "method": "UP",
                "startTime": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(start)),
                "duration_ms": duration_ms}))
        log.info({"event": "migration applied", "version": version,
                  "duration_ms": duration_ms})
