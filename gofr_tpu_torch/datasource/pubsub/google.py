"""Google Cloud Pub/Sub driver (gated: requires ``google-cloud-pubsub``;
the port's own copy of gofr_tpu/datasource/pubsub/google.py).

Reference: pkg/gofr/datasource/pubsub/google/google.go —
  - auto-creates the topic and a ``<sub>-<topic>`` subscription
    (getTopic/getSubscription, google.go:135-172)
  - blocking single-message receive with cancel (google.go:93-133)
  - health lists topics/subscriptions (health.go:12-30)
"""

from __future__ import annotations

import queue
from typing import Optional

from .. import Health, STATUS_DOWN, STATUS_UP
from . import Message


class GooglePubSubClient:
    """Seam: ``publisher``/``subscriber`` are injectable objects exposing
    the narrow client surface this driver uses (topic_path, create_topic,
    publish, subscription_path, create_subscription, subscribe,
    delete_topic, list_topics, close) — the reference tests its google
    driver against exactly such mock clients (google/mock_interfaces.go).
    Default: the real google-cloud-pubsub clients (gated import)."""

    def __init__(self, project_id: str, subscription_name: str = "gofr-sub",
                 logger=None, publisher=None, subscriber=None):
        if not project_id:
            raise ValueError("GOOGLE_PROJECT_ID is required")
        if publisher is None or subscriber is None:
            try:
                from google.cloud import pubsub_v1  # gated import
            except ImportError as e:
                raise RuntimeError(
                    "GOOGLE backend requires the google-cloud-pubsub "
                    "package") from e
            publisher = publisher or pubsub_v1.PublisherClient()
            subscriber = subscriber or pubsub_v1.SubscriberClient()
        self.project_id = project_id
        self.subscription_name = subscription_name
        self.logger = logger
        self._publisher = publisher
        self._subscriber = subscriber
        self._known_topics: set[str] = set()
        self._known_subs: set[str] = set()

    def _topic_path(self, topic: str) -> str:
        return self._publisher.topic_path(self.project_id, topic)

    def _sub_path(self, topic: str) -> str:
        # reference google.go:155: subscription named "<sub>-<topic>"
        return self._subscriber.subscription_path(
            self.project_id, f"{self.subscription_name}-{topic}")

    @staticmethod
    def _is_already_exists(e: Exception) -> bool:
        try:
            from google.api_core.exceptions import AlreadyExists

            return isinstance(e, AlreadyExists)
        except ImportError:
            return "AlreadyExists" in type(e).__name__

    def _ensure_topic(self, topic: str) -> str:
        path = self._topic_path(topic)
        if topic not in self._known_topics:
            try:
                self._publisher.create_topic(name=path)
            except Exception as e:
                if not self._is_already_exists(e):
                    # permission/connectivity errors must surface — caching
                    # the topic as known would hide the real cause behind
                    # NotFound on every later publish
                    raise
            self._known_topics.add(topic)
        return path

    def _ensure_subscription(self, topic: str) -> str:
        sub = self._sub_path(topic)
        if sub not in self._known_subs:
            try:
                self._subscriber.create_subscription(
                    name=sub, topic=self._ensure_topic(topic))
            except Exception as e:
                if not self._is_already_exists(e):
                    raise
            self._known_subs.add(sub)
        return sub

    def publish(self, topic: str, message: bytes) -> None:
        self._publisher.publish(self._ensure_topic(topic), message).result(timeout=30)

    def subscribe(self, topic: str, timeout: Optional[float] = None) -> Message | None:
        """Blocking single-message receive then cancel
        (reference google.go:93-133)."""
        sub_path = self._ensure_subscription(topic)
        q: queue.Queue = queue.Queue(maxsize=1)

        def on_message(received):
            try:
                q.put_nowait(received)
            except queue.Full:
                received.nack()

        future = self._subscriber.subscribe(sub_path, callback=on_message)
        try:
            received = q.get(timeout=timeout if timeout is not None else 30.0)
        except queue.Empty:
            return None
        finally:
            future.cancel()
        return Message(topic, received.data,
                       metadata=dict(received.attributes or {}),
                       committer=received.ack)

    def create_topic(self, name: str) -> None:
        self._ensure_topic(name)

    def delete_topic(self, name: str) -> None:
        try:
            self._publisher.delete_topic(topic=self._topic_path(name))
        except Exception:
            pass
        self._known_topics.discard(name)

    def health_check(self) -> Health:
        try:
            project = f"projects/{self.project_id}"
            topics = [t.name for t in self._publisher.list_topics(
                project=project, timeout=0.5)]
            return Health(status=STATUS_UP,
                          details={"backend": "GOOGLE", "topics": topics})
        except Exception as e:
            return Health(status=STATUS_DOWN,
                          details={"backend": "GOOGLE", "error": repr(e)})

    def close(self) -> None:
        try:
            self._subscriber.close()
        except Exception:
            pass
