"""Broker-agnostic pub/sub layer (the port's own copy of
gofr_tpu/datasource/pubsub/__init__.py).

Reference: pkg/gofr/datasource/pubsub/ —
  - ``Client/Publisher/Subscriber/Committer`` interfaces (interface.go:9-28)
  - ``Message`` implements the framework Request surface
    (Context/Param/PathParam/Bind/HostName — message.go:8-50) so pub/sub
    handlers reuse the HTTP handler shape
  - backend chosen by PUBSUB_BACKEND in the container
    (container/container.go:80-125)

Backends: MEM (in-process broker — the hermetic seam the reference covers
with mock Reader/Writer interfaces, kafka/interfaces.go:9-25), KAFKA /
GOOGLE / MQTT gated behind their optional client libraries.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Protocol, runtime_checkable

from .. import Health


@runtime_checkable
class Client(Protocol):
    """Publisher + Subscriber + topic admin + health
    (reference interface.go:9-28)."""

    def publish(self, topic: str, message: bytes) -> None: ...
    def subscribe(self, topic: str, timeout: float | None = None) -> "Message | None": ...
    def create_topic(self, name: str) -> None: ...
    def delete_topic(self, name: str) -> None: ...
    def health_check(self) -> Health: ...
    def close(self) -> None: ...


class Message:
    """A consumed message implementing the Request surface
    (reference message.go:8-50)."""

    def __init__(self, topic: str, value: bytes,
                 metadata: dict[str, str] | None = None,
                 committer: Callable[[], None] | None = None):
        self.topic = topic
        self.value = value
        self.metadata = dict(metadata or {})
        self._committer = committer
        self.committed = False

    # -- Request surface ----------------------------------------------------
    def param(self, key: str, default: str = "") -> str:
        return self.metadata.get(key, default)

    def path_param(self, key: str, default: str = "") -> str:
        return self.metadata.get(key, default)

    def header(self, key: str, default: str = "") -> str:
        return self.metadata.get(key, default)

    def host_name(self) -> str:
        return f"pubsub://{self.topic}"

    def bind(self, into: type | None = None) -> Any:
        """JSON-decode the payload, optionally into a dataclass — identical
        contract to the HTTP Request.bind."""
        import dataclasses

        from ...errors import BadRequest

        if not self.value:
            raise BadRequest("message body is empty")
        try:
            data = json.loads(self.value)
        except json.JSONDecodeError as e:
            raise BadRequest(f"invalid JSON message: {e}") from e
        if into is None:
            return data
        if dataclasses.is_dataclass(into):
            if not isinstance(data, dict):
                raise BadRequest("JSON message must be an object")
            names = {f.name for f in dataclasses.fields(into)}
            return into(**{k: v for k, v in data.items() if k in names})
        if callable(into):
            return into(data)
        raise BadRequest(f"cannot bind into {into!r}")

    # -- Committer (reference interface.go Committer) ------------------------
    def commit(self) -> None:
        if self._committer is not None and not self.committed:
            self._committer()
        self.committed = True


class ObservedClient:
    """Decorator adding the four pubsub counters + logs around any backend
    (reference: counters registered at container/container.go:160-165,
    incremented in the drivers, e.g. kafka.go:90-115)."""

    def __init__(self, inner: Client, logger=None, metrics=None):
        self.inner = inner
        self.logger = logger
        self.metrics = metrics

    def _count(self, name: str, topic: str) -> None:
        if self.metrics is not None:
            try:
                self.metrics.increment_counter(name, topic=topic)
            except Exception:
                pass

    def publish(self, topic: str, message: bytes | str | dict) -> None:
        if isinstance(message, dict):
            message = json.dumps(message, default=str).encode()
        elif isinstance(message, str):
            message = message.encode()
        self._count("app_pubsub_publish_total_count", topic)
        self.inner.publish(topic, message)
        self._count("app_pubsub_publish_success_count", topic)
        if self.logger is not None:
            self.logger.debug({"event": "published", "topic": topic,
                               "bytes": len(message)})

    def subscribe(self, topic: str, timeout: float | None = None) -> Message | None:
        return self.inner.subscribe(topic, timeout)

    def create_topic(self, name: str) -> None:
        self.inner.create_topic(name)

    def delete_topic(self, name: str) -> None:
        self.inner.delete_topic(name)

    def health_check(self) -> Health:
        return self.inner.health_check()

    def close(self) -> None:
        self.inner.close()


def new_pubsub_client(backend: str, cfg, logger=None, metrics=None) -> ObservedClient:
    """Backend factory (reference container/container.go:80-125 switch)."""
    backend = backend.upper()
    if backend in ("MEM", "MEMORY"):
        from .mem import MemBroker

        inner: Client = MemBroker(consumer_group=cfg.get_or_default("CONSUMER_ID", "gofr"))
    elif backend == "KAFKA":
        from .kafka import KafkaClient

        inner = KafkaClient(
            brokers=cfg.get_or_default("PUBSUB_BROKER", "localhost:9092"),
            consumer_group=cfg.get_or_default("CONSUMER_ID", "gofr"),
            partition_size=cfg.get_int("PARTITION_SIZE", 0),
            offset=cfg.get_or_default("PUBSUB_OFFSET", "latest"),
            logger=logger)
    elif backend == "GOOGLE":
        from .google import GooglePubSubClient

        inner = GooglePubSubClient(
            project_id=cfg.get("GOOGLE_PROJECT_ID"),
            subscription_name=cfg.get_or_default("GOOGLE_SUBSCRIPTION_NAME", "gofr-sub"),
            logger=logger)
    elif backend == "MQTT":
        from .mqtt import MQTTClient

        inner = MQTTClient(
            broker=cfg.get_or_default("MQTT_HOST", "broker.hivemq.com"),
            port=cfg.get_int("MQTT_PORT", 1883),
            client_id=cfg.get_or_default("MQTT_CLIENT_ID", "gofr-mqtt"),
            qos=cfg.get_int("MQTT_QOS", 0),
            logger=logger)
    else:
        raise ValueError(f"unsupported PUBSUB_BACKEND {backend!r}")
    return ObservedClient(inner, logger, metrics)
