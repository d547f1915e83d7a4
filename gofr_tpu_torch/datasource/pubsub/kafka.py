"""Kafka driver (gated: requires the optional ``kafka-python`` client;
the port's own copy of gofr_tpu/datasource/pubsub/kafka.py).

Reference: pkg/gofr/datasource/pubsub/kafka/kafka.go —
  - lazy per-topic readers in a consumer group, guarded by a lock
    (kafka.go:117-153, getNewReader :166, RWMutex :33)
  - single shared producer (:41-76), publish :90-115
  - commit-on-success via the message committer (message.go:25)
  - create/delete topic via the admin client (:180-196)
  - health = broker reachability + reader/writer stats (health.go:9-53)

Seam: the driver talks to Kafka only through a ``KafkaFactory``
(producer/consumer/commit/admin) — the reference's
``Reader/Writer/Connection`` interfaces (kafka/interfaces.go:9-25) with
checked-in mocks — so driver logic (lazy readers, offset-precise commit,
health shape) is testable against a fake with no broker
(tests/test_torch_pubsub_drivers.py).
"""

from __future__ import annotations

import threading
from typing import Optional

from .. import Health, STATUS_DOWN, STATUS_UP
from . import Message


class KafkaFactory:
    """Default factory over kafka-python; replace with a fake in tests.

    The surface is exactly what the driver uses:
      producer() -> obj with send(topic, bytes).get(timeout),
                    bootstrap_connected(), close()
      consumer(topic, group, offset) -> obj with
                    poll(timeout_ms=, max_records=) -> {tp: [records]},
                    close(); records have topic/partition/offset/value
      commit(consumer, record) -> commit THAT record's offset
      create_topic(name) / delete_topic(name)
    """

    def __init__(self, brokers: list[str]):
        try:
            import kafka  # noqa: F401  (gated import)
        except ImportError as e:
            raise RuntimeError(
                "KAFKA backend requires the kafka-python package") from e
        self._kafka = kafka
        self.brokers = brokers

    def producer(self):
        return self._kafka.KafkaProducer(bootstrap_servers=self.brokers)

    def consumer(self, topic: str, group: str, offset: str):
        return self._kafka.KafkaConsumer(
            topic, bootstrap_servers=self.brokers, group_id=group,
            auto_offset_reset=offset, enable_auto_commit=False)

    def commit(self, consumer, rec) -> None:
        # commit THIS message's offset, not the consumer's current
        # position — committing the position would mark earlier
        # uncommitted (failed) messages as processed and break
        # at-least-once (reference kafka/message.go:25-30)
        from kafka import TopicPartition
        from kafka.structs import OffsetAndMetadata

        consumer.commit({TopicPartition(rec.topic, rec.partition):
                         OffsetAndMetadata(rec.offset + 1, None)})

    def create_topic(self, name: str) -> None:
        from kafka.admin import KafkaAdminClient, NewTopic

        admin = KafkaAdminClient(bootstrap_servers=self.brokers)
        try:
            admin.create_topics([NewTopic(name, num_partitions=1,
                                          replication_factor=1)])
        finally:
            admin.close()

    def delete_topic(self, name: str) -> None:
        from kafka.admin import KafkaAdminClient

        admin = KafkaAdminClient(bootstrap_servers=self.brokers)
        try:
            admin.delete_topics([name])
        finally:
            admin.close()


class KafkaClient:
    def __init__(self, brokers: str, consumer_group: str = "gofr",
                 partition_size: int = 0, offset: str = "latest", logger=None,
                 factory=None):
        self.brokers = brokers.split(",")
        self.consumer_group = consumer_group
        self.offset = ("earliest" if offset.lower() in ("earliest", "oldest")
                       else "latest")
        self.logger = logger
        self._factory = factory if factory is not None \
            else KafkaFactory(self.brokers)
        self._producer = self._factory.producer()
        self._consumers: dict[str, object] = {}
        self._lock = threading.Lock()

    def _consumer(self, topic: str):
        """Lazy per-topic consumer (reference kafka.go:166 getNewReader)."""
        with self._lock:
            if topic not in self._consumers:
                self._consumers[topic] = self._factory.consumer(
                    topic, self.consumer_group, self.offset)
            return self._consumers[topic]

    def publish(self, topic: str, message: bytes) -> None:
        self._producer.send(topic, message).get(timeout=30)

    def subscribe(self, topic: str, timeout: Optional[float] = None) -> Message | None:
        consumer = self._consumer(topic)
        ms = int((0.5 if timeout is None else timeout) * 1000)
        batch = consumer.poll(timeout_ms=ms, max_records=1)
        for records in batch.values():
            for rec in records:
                def commit(rec=rec):
                    self._factory.commit(consumer, rec)

                return Message(
                    topic, rec.value,
                    metadata={"offset": str(rec.offset),
                              "partition": str(rec.partition)},
                    committer=commit)
        return None

    def create_topic(self, name: str) -> None:
        self._factory.create_topic(name)

    def delete_topic(self, name: str) -> None:
        self._factory.delete_topic(name)

    def health_check(self) -> Health:
        try:
            ok = self._producer.bootstrap_connected()
            return Health(status=STATUS_UP if ok else STATUS_DOWN,
                          details={"backend": "KAFKA", "brokers": self.brokers,
                                   "readers": list(self._consumers)})
        except Exception as e:
            return Health(status=STATUS_DOWN,
                          details={"backend": "KAFKA", "error": repr(e)})

    def close(self) -> None:
        try:
            self._producer.close()
        except Exception:
            pass
        for c in self._consumers.values():
            try:
                c.close()
            except Exception:
                pass
