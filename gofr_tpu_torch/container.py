"""Dependency container: the one object carrying every shared resource
(the port's own copy of the part of gofr_tpu/container.py the App
uses): the logger, the metrics registry, the tracer, the in-flight
request registry and the engine as ``tpu`` (a BERT, ViT or Llama engine
from the ``TPU_*`` rows), with ``health()`` and ``close()``.

One difference from the JAX container is deliberate. There a failed
engine construction is logged and the App goes on with ``tpu = None``;
here the error propagates, so an App asked for the card on a machine
without one raises instead of serving without its model (the port's
rule that nothing falls back on its own). The datasource rows the port
does not serve yet (Redis, SQL, pub/sub, the remote log level) raise
with their names; ``REDIS_HOST`` is read only as the address of the
kv-cache's shared tier, with ``TPU_KVCACHE_REDIS`` set.
"""

from __future__ import annotations

from typing import Any

from . import metrics as gmetrics
from . import tracing
from .config import EnvConfig
from .glog import Logger, LogLevel, new_logger
from .observe import RequestRegistry
from .tpu.engine import STATUS_DOWN, STATUS_UP

# rows of the JAX container that wire datasources outside the port
UNPORTED_ROWS = ("REDIS_HOST", "DB_HOST", "DB_DIALECT", "PUBSUB_BACKEND",
                 "REMOTE_LOG_URL")


class Container:
    def __init__(self, config=None, logger: Logger | None = None,
                 device="cuda"):
        self.config = config if config is not None else EnvConfig()
        # REDIS_HOST as a datasource is not ported; the kv-cache's
        # shared tier (TPU_KVCACHE_REDIS) builds its own client from it
        tier_redis = self.config.get_bool("TPU_KVCACHE_REDIS")
        rejected = [row for row in UNPORTED_ROWS
                    if (self.config.get(row) or "").strip()
                    and not (row == "REDIS_HOST" and tier_redis)]
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
        self.tpu = None
        cfg = self.config
        if cfg.get("TPU_MODEL") or cfg.get_bool("TPU_ENABLED"):
            from .tpu import new_engine_from_config

            self.tpu = new_engine_from_config(
                self.config, device=device, logger=self.logger,
                metrics=self.metrics, requests=self.requests)

    def health(self) -> dict[str, Any]:
        out: dict[str, Any] = {"name": self.app_name,
                               "version": self.app_version,
                               "status": STATUS_UP}
        if self.tpu is not None:
            try:
                h = self.tpu.health_check()
                out["tpu"] = h.to_dict()
                if h.status == STATUS_DOWN:
                    out["status"] = STATUS_DOWN
            except Exception as e:
                out["tpu"] = {"status": STATUS_DOWN,
                              "details": {"error": repr(e)}}
                out["status"] = STATUS_DOWN
        return out

    def close(self) -> None:
        if self.tpu is not None:
            self.tpu.close()
