"""Dependency container: the one object carrying every shared resource
(the port's own copy of gofr_tpu/container.py): the logger, the metrics
registry, the tracer (with ``TRACER_HOST`` a Zipkin exporter behind the
tail sampler, shut down by ``close()``), the observability bundle
``observe`` (the in-flight request registry, the flight recorder of
``DEBUG_EVENT_BUFFER`` events, the serving timeline of ``TPU_TIMELINE``
and ``TPU_TIMELINE_EVENTS``, the fleet clock registry of
``TPU_OBS_CLOCK_WINDOW``; handed to the engine, the gateway, the P/D
roles and tenancy), the registered
outbound HTTP service clients (``register_service``/``get_http_service``,
listed under ``services`` in ``health()`` and closed first by
``close()``), the Redis client (``REDIS_HOST``/``REDIS_PORT``, as
``redis`` and ``ctx.redis``), the SQL datasource (``DB_DIALECT`` /
``DB_HOST``, with ``DB_NAME``, ``DB_PORT``, ``DB_USER`` and
``DB_PASSWORD``; as ``sql`` and ``ctx.sql``), the pub/sub client
(``PUBSUB_BACKEND``: MEM, KAFKA, GOOGLE or MQTT, behind
``get_publisher``/``get_subscriber``), the remote log level
(``REMOTE_LOG_URL`` polled every ``REMOTE_LOG_FETCH_INTERVAL`` seconds,
default 15) and the engine as ``tpu`` (a BERT, ViT or Llama engine from
the ``TPU_*`` rows), with ``health()`` and ``close()``.

Two differences from the JAX container are deliberate. There a failed
engine construction, or a Redis, SQL or pub/sub client that cannot be
built, is logged and the App goes on with ``tpu``, ``redis``, ``sql``
or ``pubsub`` None; here the error propagates (a client's naming its
row or backend), so an App asked for the card on a machine without
one, for a server it cannot reach or for a SQL dialect whose driver is
not installed, raises instead of serving without it (the port's rule
that nothing falls back on its own). The same holds for ``TPU_MODEL``
on a gateway App (``TPU_SERVING_ROLE=gateway``): the JAX container logs
the engine's "builds no engine" error and serves the gateway without
one; here it raises, and so does a P/D role the engine cannot take
(``prefill`` without ``TPU_PD_PEER`` or on a paged engine). The rows
the port does not serve yet raise with their names before anything is
built: a serving role other than ``fused``, ``gateway``, ``prefill``
and ``decode``, and the multi-host rows, whether or not the App builds
an engine. The kv-cache's shared tier (``TPU_KVCACHE_REDIS``) keeps a
Redis client of its own.
"""

from __future__ import annotations

from typing import Any

from . import metrics as gmetrics
from . import tracing
from .config import EnvConfig
from .datasource import STATUS_DOWN, STATUS_UP
from .glog import Logger, LogLevel, new_logger
from .observe import ClockRegistry, Observe, timeline_from_config
from .parallel.distributed import MULTIHOST_ROWS

# rows of the JAX App that wire features outside the port: the
# multi-host rows (ROADMAP item 11b), which the port reads nowhere
UNPORTED_ROWS = MULTIHOST_ROWS
# the serving roles the port serves: the fused replica, the gateway and
# the two P/D pools (gofr_tpu_torch/pd)
SERVING_ROLES = ("fused", "gateway", "prefill", "decode")


def serving_role(cfg) -> str:
    """``TPU_SERVING_ROLE``, lower-cased; unset is ``fused``."""
    return (cfg.get("TPU_SERVING_ROLE") or "").strip().lower() or "fused"


def unported_rows(cfg) -> list[str]:
    """The rows of ``cfg`` the port refuses, in a stable order:
    UNPORTED_ROWS, then ``TPU_SERVING_ROLE`` other than one of
    SERVING_ROLES."""
    out = [row for row in UNPORTED_ROWS
           if (cfg.get(row) or "").strip() != ""]
    if serving_role(cfg) not in SERVING_ROLES:
        out.append("TPU_SERVING_ROLE")
    return out


class Container:
    def __init__(self, config=None, logger: Logger | None = None,
                 device="cuda"):
        self.config = config if config is not None else EnvConfig()
        rejected = unported_rows(self.config)
        if rejected:
            raise ValueError(f"config rows not honoured by gofr_tpu_torch "
                             f"yet: {', '.join(rejected)}")
        # the device the engine is built on (and /debug/vars reports)
        self.device = device
        self.app_name = self.config.get("APP_NAME") or "gofr-app"
        self.app_version = self.config.get("APP_VERSION") or "dev"
        self.logger: Logger = logger if logger is not None else new_logger(
            LogLevel.parse(self.config.get("LOG_LEVEL")))
        self.metrics = gmetrics.Manager(logger=self.logger)
        gmetrics.register_framework_metrics(self.metrics)
        # tail-sampled when exporting (TPU_TRACE_SAMPLE); the metrics feed
        # app_tpu_spans_dropped_total from the bounded export buffer
        self.tracer = tracing.tracer_from_config(self.config, self.app_name,
                                                 metrics=self.metrics)
        # the in-flight registry (the HTTP middleware and the engines
        # fill it, the App's graceful stop waits for it to empty), the
        # flight recorder, the serving timeline and the fleet clock:
        # always on, rendered by the /debug pages on the metrics server
        self.observe = Observe(
            metrics=self.metrics, tracer=self.tracer,
            max_events=self.config.get_int("DEBUG_EVENT_BUFFER", 2048),
            timeline=timeline_from_config(self.config),
            clock=ClockRegistry(
                window=self.config.get_int("TPU_OBS_CLOCK_WINDOW", 64)))
        self.redis = None
        self.sql = None
        self.pubsub = None
        self.tpu = None
        self.services: dict[str, Any] = {}
        self._remote_level_poller = None
        cfg = self.config
        try:
            host = (cfg.get("REDIS_HOST") or "").strip()
            if host:
                from .datasource.redisclient import new_redis_client

                try:
                    self.redis = new_redis_client(cfg, self.logger,
                                                  self.metrics)
                except Exception as e:
                    raise RuntimeError(
                        f"REDIS_HOST={host}: the client could not be "
                        f"built: {e}") from e
            dialect = (cfg.get("DB_DIALECT") or "").strip()
            if dialect or (cfg.get("DB_HOST") or "").strip():
                from .datasource.sql import new_sql

                try:
                    self.sql = new_sql(cfg, self.logger, self.metrics)
                except Exception as e:
                    row = (f"DB_DIALECT={dialect}" if dialect
                           else f"DB_HOST={cfg.get('DB_HOST')}")
                    raise RuntimeError(f"{row}: the client could not be "
                                       f"built: {e}") from e
            backend = (cfg.get("PUBSUB_BACKEND") or "").strip().upper()
            if backend:
                from .datasource.pubsub import new_pubsub_client

                try:
                    self.pubsub = new_pubsub_client(backend, cfg,
                                                    self.logger, self.metrics)
                except Exception as e:
                    raise RuntimeError(f"PUBSUB_BACKEND={backend}: the "
                                       f"client could not be built: "
                                       f"{e}") from e
            if cfg.get("TPU_MODEL") or cfg.get_bool("TPU_ENABLED"):
                from .tpu import new_engine_from_config

                self.tpu = new_engine_from_config(
                    self.config, device=device, logger=self.logger,
                    metrics=self.metrics, observe=self.observe)
            url = (cfg.get("REMOTE_LOG_URL") or "").strip()
            if url:
                # logging/dynamicLevelLogger.go, wired at
                # container/container.go:64-67
                from .remote_level import RemoteLevelPoller

                self._remote_level_poller = RemoteLevelPoller(
                    self.logger, url,
                    cfg.get_float("REMOTE_LOG_FETCH_INTERVAL", 15.0))
        except BaseException:
            self.close()   # the clients built before the failure
            raise

    # -- outbound HTTP services (App.add_http_service, the gateway) ---------
    def register_service(self, name: str, svc: Any) -> None:
        self.services[name] = svc

    def get_http_service(self, name: str) -> Any:
        return self.services.get(name)

    def get_publisher(self):
        return self.pubsub

    def get_subscriber(self):
        return self.pubsub

    def health(self) -> dict[str, Any]:
        out: dict[str, Any] = {"name": self.app_name,
                               "version": self.app_version,
                               "status": STATUS_UP}
        for name, ds in (("redis", self.redis), ("sql", self.sql),
                         ("pubsub", self.pubsub), ("tpu", self.tpu)):
            if ds is None:
                continue
            try:
                h = ds.health_check()
                out[name] = h.to_dict()
                if h.status == STATUS_DOWN:
                    out["status"] = STATUS_DOWN
            except Exception as e:
                out[name] = {"status": STATUS_DOWN,
                             "details": {"error": repr(e)}}
                out["status"] = STATUS_DOWN
        # a service's health is listed, not folded into the App's own
        # status: a peer that is down does not make this process down
        services = {}
        for name, svc in self.services.items():
            try:
                services[name] = svc.health_check().to_dict()
            except Exception as e:
                services[name] = {"status": STATUS_DOWN,
                                  "details": {"error": repr(e)}}
        if services:
            out["services"] = services
        return out

    def close(self) -> None:
        # the service clients first: a circuit breaker whose peer is
        # already gone keeps its recovery-probe thread alive until its
        # close() stops it, which would otherwise outlive the App
        for svc in self.services.values():
            try:
                svc.close()
            except Exception:  # noqa: BLE001 — the rest still close
                pass
        for client in (self.redis, self.sql, self.pubsub):
            if client is not None:
                try:
                    client.close()
                except Exception:  # noqa: BLE001 — the engine still closes
                    pass
        if self._remote_level_poller is not None:
            self._remote_level_poller.stop()
        if self.tpu is not None:
            self.tpu.close()
        if self.tracer.exporter is not None:
            self.tracer.exporter.shutdown()   # the final span flush
