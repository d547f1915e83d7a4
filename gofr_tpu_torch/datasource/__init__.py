"""The port's datasource layer: the health type every datasource
reports (the port's own copy of gofr_tpu/datasource/__init__.py's
``Health`` and status constants, which the engine's health check shares),
the Redis client the kv-cache's shared tier (T2) builds
(``redisclient``), and the pub/sub clients the App's subscribers and
publishers use (``pubsub``: the in-process broker, Kafka, Google Cloud
Pub/Sub, MQTT). ``REDIS_HOST`` as an App datasource and SQL are not
ported yet (ROADMAP queue 1 item 13)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

STATUS_UP = "UP"
STATUS_DOWN = "DOWN"
STATUS_DEGRADED = "DEGRADED"


@dataclass
class Health:
    status: str = STATUS_DOWN
    details: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        """The health check's wire form, as the App's
        ``/.well-known/health`` reads every datasource's."""
        return {"status": self.status, "details": self.details}
