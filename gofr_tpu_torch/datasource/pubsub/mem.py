"""In-process broker with Kafka-like consumer-group offset semantics
(the port's own copy of gofr_tpu/datasource/pubsub/mem.py).

This is both the hermetic test seam (the reference mocks its broker behind
Reader/Writer interfaces, kafka/interfaces.go:9-25 + mock_interfaces.go) and
a real local-dev backend: messages are durable for the process lifetime,
consumer groups track a committed offset, and an uncommitted message is
redelivered when a fresh client (same group) attaches — at-least-once, like
Kafka consumer groups with commit-on-success (reference kafka/message.go:25).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from .. import Health, STATUS_UP
from . import Message

# process-global topic log so independent MemBroker instances (publisher app
# + subscriber app in one test) see the same broker, like a real out-of-
# process broker would behave
_GLOBAL_LOCK = threading.Lock()
_TOPICS: dict[str, list[bytes]] = {}
_COMMITTED: dict[tuple[str, str], int] = {}  # (group, topic) -> offset
_CONDS: dict[str, threading.Condition] = {}


def reset() -> None:
    """Test hook: wipe all topics and offsets."""
    with _GLOBAL_LOCK:
        _TOPICS.clear()
        _COMMITTED.clear()
        _CONDS.clear()


def _cond(topic: str) -> threading.Condition:
    with _GLOBAL_LOCK:
        if topic not in _CONDS:
            _CONDS[topic] = threading.Condition()
        return _CONDS[topic]


class MemBroker:
    def __init__(self, consumer_group: str = "gofr"):
        self.consumer_group = consumer_group
        # delivered-but-not-committed cursor, per topic, local to this client
        # (a restart constructs a new client, which resumes from committed —
        # that is what produces at-least-once redelivery)
        self._delivered: dict[str, int] = {}

    # -- admin (reference kafka.go:180-196 Create/DeleteTopic) ---------------
    def create_topic(self, name: str) -> None:
        with _GLOBAL_LOCK:
            _TOPICS.setdefault(name, [])

    def delete_topic(self, name: str) -> None:
        with _GLOBAL_LOCK:
            _TOPICS.pop(name, None)
            for key in [k for k in _COMMITTED if k[1] == name]:
                del _COMMITTED[key]

    def topics(self) -> list[str]:
        with _GLOBAL_LOCK:
            return list(_TOPICS)

    # -- produce/consume ----------------------------------------------------
    def publish(self, topic: str, message: bytes) -> None:
        cond = _cond(topic)
        with cond:
            with _GLOBAL_LOCK:
                _TOPICS.setdefault(topic, []).append(message)
            cond.notify_all()

    def subscribe(self, topic: str, timeout: Optional[float] = None) -> Message | None:
        """Next message for this consumer group; blocks up to ``timeout``."""
        cond = _cond(topic)
        deadline = None if timeout is None else time.monotonic() + timeout
        with cond:
            while True:
                with _GLOBAL_LOCK:
                    log = _TOPICS.setdefault(topic, [])
                    committed = _COMMITTED.get((self.consumer_group, topic), 0)
                    cursor = max(self._delivered.get(topic, 0), committed)
                    if cursor < len(log):
                        value = log[cursor]
                        self._delivered[topic] = cursor + 1
                        offset = cursor
                        return Message(
                            topic, value,
                            metadata={"offset": str(offset),
                                      "group": self.consumer_group},
                            committer=lambda o=offset: self._commit(topic, o))
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    cond.wait(remaining)
                else:
                    cond.wait()

    def _commit(self, topic: str, offset: int) -> None:
        with _GLOBAL_LOCK:
            key = (self.consumer_group, topic)
            _COMMITTED[key] = max(_COMMITTED.get(key, 0), offset + 1)

    # -- health -------------------------------------------------------------
    def health_check(self) -> Health:
        with _GLOBAL_LOCK:
            return Health(status=STATUS_UP, details={
                "backend": "MEM",
                "topics": {t: len(v) for t, v in _TOPICS.items()},
                "group": self.consumer_group})

    def close(self) -> None:
        pass
