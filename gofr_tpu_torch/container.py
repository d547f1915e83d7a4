"""Dependency container: the one object carrying every shared resource
(the port's own copy of the part of gofr_tpu/container.py the App
uses): the logger, the metrics registry, the tracer, the in-flight
request registry, the pub/sub client (``PUBSUB_BACKEND``: MEM, KAFKA,
GOOGLE or MQTT, behind ``get_publisher``/``get_subscriber``) and the
engine as ``tpu`` (a BERT, ViT or Llama engine from the ``TPU_*`` rows),
with ``health()`` and ``close()``.

Two differences from the JAX container are deliberate. There a failed
engine construction, or a pub/sub client that cannot be built, is
logged and the App goes on with ``tpu = None`` or ``pubsub = None``;
here the error propagates (a pub/sub one naming the backend), so an App
asked for the card on a machine without one, or for a broker whose
client library is missing, raises instead of serving without it (the
port's rule that nothing falls back on its own). The rows the port
does not serve yet raise with their names before anything is built:
the datasources (Redis, SQL, the remote log level; ``REDIS_HOST`` is
read only as the address of the kv-cache's shared tier, with
``TPU_KVCACHE_REDIS`` set), a serving role other than ``fused`` and
the gateway's rows, and the multi-host and fleet rows, whether or not
the App builds an engine.
"""

from __future__ import annotations

from typing import Any

from . import metrics as gmetrics
from . import tracing
from .config import EnvConfig
from .datasource import STATUS_DOWN, STATUS_UP
from .glog import Logger, LogLevel, new_logger
from .observe import RequestRegistry

# rows of the JAX App that wire datasources or features outside the
# port: the datasources, and the fleet-observation, timeline and
# multi-host rows the port reads nowhere
UNPORTED_ROWS = ("REDIS_HOST", "DB_HOST", "DB_DIALECT", "REMOTE_LOG_URL",
                 "TPU_OBS_PEERS", "TPU_TIMELINE_EVENTS", "TPU_COORDINATOR",
                 "TPU_NUM_PROCESSES")
# the gateway serving role's rows (gofr_tpu/gateway), every one refused
GATEWAY_PREFIX = "TPU_GATEWAY_"


def unported_rows(cfg) -> list[str]:
    """The rows of ``cfg`` the port refuses, in a stable order:
    UNPORTED_ROWS (``REDIS_HOST`` allowed as the shared tier's address
    with ``TPU_KVCACHE_REDIS``), ``TPU_SERVING_ROLE`` other than
    ``fused``, then every ``TPU_GATEWAY_*`` row."""
    def is_set(row: str) -> bool:
        return (cfg.get(row) or "").strip() != ""

    tier_redis = cfg.get_bool("TPU_KVCACHE_REDIS")
    out = [row for row in UNPORTED_ROWS if is_set(row)
           and not (row == "REDIS_HOST" and tier_redis)]
    if is_set("TPU_SERVING_ROLE") and \
            cfg.get("TPU_SERVING_ROLE").strip().lower() != "fused":
        out.append("TPU_SERVING_ROLE")
    out += sorted(row for row in cfg.keys()
                  if row.startswith(GATEWAY_PREFIX) and is_set(row))
    return out


class Container:
    def __init__(self, config=None, logger: Logger | None = None,
                 device="cuda"):
        self.config = config if config is not None else EnvConfig()
        # REDIS_HOST as a datasource is not ported; the kv-cache's
        # shared tier (TPU_KVCACHE_REDIS) builds its own client from it
        rejected = unported_rows(self.config)
        if rejected:
            raise ValueError(f"config rows not honoured by gofr_tpu_torch "
                             f"yet: {', '.join(rejected)}")
        self.app_name = self.config.get("APP_NAME") or "gofr-app"
        self.app_version = self.config.get("APP_VERSION") or "dev"
        self.logger: Logger = logger if logger is not None else new_logger(
            LogLevel.parse(self.config.get("LOG_LEVEL")))
        self.metrics = gmetrics.Manager(logger=self.logger)
        gmetrics.register_framework_metrics(self.metrics)
        self.tracer = tracing.tracer_from_config(self.config, self.app_name)
        # the in-flight HTTP requests: the middleware fills it, the App's
        # graceful stop waits for it to empty
        self.requests = RequestRegistry()
        self.pubsub = None
        self.tpu = None
        cfg = self.config
        backend = (cfg.get("PUBSUB_BACKEND") or "").strip().upper()
        if backend:
            from .datasource.pubsub import new_pubsub_client

            try:
                self.pubsub = new_pubsub_client(backend, cfg, self.logger,
                                                self.metrics)
            except Exception as e:
                raise RuntimeError(f"PUBSUB_BACKEND={backend}: the client "
                                   f"could not be built: {e}") from e
        if cfg.get("TPU_MODEL") or cfg.get_bool("TPU_ENABLED"):
            from .tpu import new_engine_from_config

            try:
                self.tpu = new_engine_from_config(
                    self.config, device=device, logger=self.logger,
                    metrics=self.metrics, requests=self.requests)
            except BaseException:
                self.close()   # the broker client built above
                raise

    def get_publisher(self):
        return self.pubsub

    def get_subscriber(self):
        return self.pubsub

    def health(self) -> dict[str, Any]:
        out: dict[str, Any] = {"name": self.app_name,
                               "version": self.app_version,
                               "status": STATUS_UP}
        for name, ds in (("pubsub", self.pubsub), ("tpu", self.tpu)):
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
        return out

    def close(self) -> None:
        if self.pubsub is not None:
            try:
                self.pubsub.close()
            except Exception:  # noqa: BLE001 — the engine still closes
                pass
        if self.tpu is not None:
            self.tpu.close()
