"""Subscription manager: one worker per topic, commit-on-success (the
port's own copy of gofr_tpu/subscriber.py).

Reference: pkg/gofr/subscriber.go:11-46 — topic->handler map, one goroutine
per topic started from App.Run (gofr.go:154-161), infinite loop Subscribe ->
build Context from Message -> run handler -> Commit on nil error
(at-least-once). Here each topic gets a daemon thread with a stop event so
tests and graceful shutdown work. A handler's exception (an engine error
from ``ctx.tpu.predict_batch`` included) is logged with the topic and
leaves its message uncommitted, so the broker redelivers it.
"""

from __future__ import annotations

import threading
from typing import Callable

from .container import Container
from .context import Context


class SubscriptionManager:
    def __init__(self, container: Container):
        self.container = container
        self.subscriptions: dict[str, Callable] = {}
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()

    def register(self, topic: str, handler: Callable) -> None:
        self.subscriptions[topic] = handler

    def start(self) -> None:
        for topic, handler in self.subscriptions.items():
            t = threading.Thread(
                target=self._consume_loop, args=(topic, handler),
                daemon=True, name=f"subscriber-{topic}",
            )
            t.start()
            self._threads.append(t)

    def _consume_loop(self, topic: str, handler: Callable) -> None:
        c = self.container
        log = c.logger
        while not self._stop.is_set():
            sub = c.get_subscriber()
            if sub is None:
                log.error({"event": "no subscriber configured", "topic": topic})
                return
            try:
                msg = sub.subscribe(topic, timeout=0.5)
            except Exception as e:
                log.error({"event": "subscribe error", "topic": topic, "error": repr(e)})
                self._stop.wait(0.5)  # backoff: a down broker must not busy-loop
                continue
            if msg is None:  # timeout — loop to re-check stop flag
                continue
            c.metrics.increment_counter("app_pubsub_subscribe_total_count", topic=topic)
            ctx = Context(request=msg, container=c)
            try:
                handler(ctx)
            except Exception as e:
                log.error({"event": "subscriber handler error", "topic": topic, "error": repr(e)})
                continue  # no commit -> redelivery (at-least-once)
            try:
                msg.commit()
            except Exception as e:
                log.error({"event": "commit failed", "topic": topic, "error": repr(e)})
                continue
            c.metrics.increment_counter("app_pubsub_subscribe_success_count", topic=topic)

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads.clear()
