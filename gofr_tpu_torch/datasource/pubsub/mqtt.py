"""MQTT driver (gated: requires ``paho-mqtt``; the port's own copy of
gofr_tpu/datasource/pubsub/mqtt.py).

Reference: pkg/gofr/datasource/pubsub/mqtt/mqtt.go —
  - per-topic buffered channel (size 10) fed by the subscription callback
    (mqtt.go:145-184)
  - QoS/retained config, default public broker fallback (:55-78)
  - extended ops: SubscribeWithFunction, Unsubscribe, Disconnect, Ping
    (:253-306)
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

from .. import Health, STATUS_DOWN, STATUS_UP
from . import Message


class MQTTClient:
    """Seam: ``client_factory(client_id)`` returns a paho-shaped client
    (connect, loop_start/stop, subscribe/unsubscribe, publish,
    message_callback_add, is_connected, disconnect, settable
    ``on_message``) — the reference's mqtt/interface.go mock seam. Default
    builds the real paho client (gated import)."""

    def __init__(self, broker: str = "broker.hivemq.com", port: int = 1883,
                 client_id: str = "gofr-mqtt", qos: int = 0,
                 retained: bool = False, logger=None, client_factory=None):
        if client_factory is None:
            try:
                import paho.mqtt.client as mqtt  # gated import
            except ImportError as e:
                raise RuntimeError(
                    "MQTT backend requires the paho-mqtt package") from e

            def client_factory(cid):
                return mqtt.Client(client_id=cid)
        self.broker = broker
        self.port = port
        self.qos = qos
        self.retained = retained
        self.logger = logger
        # reference mqtt.go:150-157: per-topic buffered channel, size 10
        self._queues: dict[str, queue.Queue] = {}
        self._lock = threading.Lock()
        self._client = client_factory(client_id)
        self._client.on_message = self._on_message
        self._client.connect(broker, port)
        self._client.loop_start()

    def _queue(self, topic: str) -> queue.Queue:
        with self._lock:
            if topic not in self._queues:
                self._queues[topic] = queue.Queue(maxsize=10)
            return self._queues[topic]

    def _on_message(self, client, userdata, msg) -> None:
        q = self._queue(msg.topic)
        try:
            q.put_nowait(msg)
        except queue.Full:
            if self.logger is not None:
                self.logger.warn({"event": "mqtt queue full, dropping",
                                  "topic": msg.topic})

    def publish(self, topic: str, message: bytes) -> None:
        info = self._client.publish(topic, message, qos=self.qos,
                                    retain=self.retained)
        info.wait_for_publish(timeout=30)

    def subscribe(self, topic: str, timeout: Optional[float] = None) -> Message | None:
        self._queue(topic)  # ensure the buffer exists before subscribing
        self._client.subscribe(topic, qos=self.qos)
        try:
            msg = self._queue(topic).get(
                timeout=timeout if timeout is not None else 30.0)
        except queue.Empty:
            return None
        # MQTT QoS handles delivery; commit is a no-op (reference mqtt
        # message.go Commit is empty)
        return Message(topic, msg.payload, metadata={"qos": str(msg.qos)})

    def subscribe_with_function(self, topic: str,
                                fn: Callable[[Message], None]) -> None:
        """reference mqtt.go:253 SubscribeWithFunction."""
        def on_msg(client, userdata, msg):
            fn(Message(msg.topic, msg.payload, metadata={"qos": str(msg.qos)}))

        self._client.message_callback_add(topic, on_msg)
        self._client.subscribe(topic, qos=self.qos)

    def unsubscribe(self, topic: str) -> None:
        self._client.unsubscribe(topic)
        with self._lock:
            self._queues.pop(topic, None)

    def create_topic(self, name: str) -> None:
        pass  # MQTT topics are implicit

    def delete_topic(self, name: str) -> None:
        self.unsubscribe(name)

    def ping(self) -> bool:
        return self._client.is_connected()

    def health_check(self) -> Health:
        up = False
        try:
            up = self._client.is_connected()
        except Exception:
            pass
        return Health(status=STATUS_UP if up else STATUS_DOWN,
                      details={"backend": "MQTT",
                               "broker": f"{self.broker}:{self.port}"})

    def close(self) -> None:
        try:
            self._client.loop_stop()
            self._client.disconnect()
        except Exception:
            pass
