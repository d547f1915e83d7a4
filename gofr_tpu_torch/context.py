"""Per-request Context: the request and the container behind one facade
(the port's own copy of gofr_tpu/context.py, without a tenancy plane).

A handler receives exactly one of these: ``ctx.bind()``,
``ctx.param(...)``, ``ctx.header(...)`` read the request,
``ctx.stream(...)`` writes a live chunked response, ``ctx.trace(...)``
opens a span, ``ctx.tpu`` is the engine, ``ctx.get_publisher()`` the
pub/sub client (a subscriber's handler gets a Context whose request is
the consumed ``pubsub.Message``), and
``ctx.deadline``/``ctx.slo_class`` are the request's ambient budget and
class (which ``ctx.tpu.generate`` and ``ctx.tpu.predict`` read by
themselves).
"""

from __future__ import annotations

from typing import Any

from .container import Container
from .errors import InternalServerError
from .resilience import current_deadline, current_slo_class


class Context:
    def __init__(self, request: Any, container: Container,
                 responder: Any = None):
        self.request = request
        self.container = container
        self._responder = responder

    # -- container facade ---------------------------------------------------
    @property
    def logger(self):
        return self.container.logger

    @property
    def metrics(self):
        return self.container.metrics

    @property
    def config(self):
        return self.container.config

    def get_publisher(self):
        """The container's pub/sub client (``PUBSUB_BACKEND``), or None:
        ``ctx.get_publisher().publish(topic, payload)``."""
        return self.container.get_publisher()

    @property
    def tpu(self):
        """The engine: ``ctx.tpu.generate(...)``,
        ``ctx.tpu.predict(program, item)``."""
        return self.container.tpu

    # -- request facade -----------------------------------------------------
    def param(self, key: str, default: str = "") -> str:
        return self.request.param(key, default)

    def path_param(self, key: str, default: str = "") -> str:
        return self.request.path_param(key, default)

    def bind(self, into: type | None = None) -> Any:
        """Deserialize the request body."""
        return self.request.bind(into)

    def header(self, key: str, default: str = "") -> str:
        return self.request.header(key, default)

    @property
    def tenant(self) -> str:
        """The request's tenant id: its ``X-Tenant-Id`` header, or
        ``default`` when untagged. The port has no tenancy plane, so no
        quota or policy applies, as in a JAX App without one."""
        return self.header("X-Tenant-Id").strip() or "default"

    @property
    def deadline(self):
        """The request's resilience.Deadline (from ``X-Request-Timeout``),
        or None. Ambient: ``ctx.tpu.generate`` honours it without being
        passed it; read it here to budget your own work."""
        return current_deadline()

    @property
    def slo_class(self) -> str:
        """The request's serving class (``latency`` default /
        ``throughput``, from ``X-SLO-Class``). Ambient like the
        deadline."""
        return current_slo_class()

    # -- streaming ----------------------------------------------------------
    def stream(self, chunks, content_type: str = "application/x-ndjson"
               ) -> None:
        """Write an iterable of ``bytes`` chunks as a live chunked response.

            ctx.stream(json.dumps(x).encode() + b"\\n" for x in items)

        A push-capable source (one with ``set_sink``, as the generate
        route's line source) takes the zero-handoff path: each chunk is
        written by the producing thread (the serving loop) without
        waking this handler thread."""
        if self._responder is None:
            raise InternalServerError(
                "streaming is only available on HTTP requests")
        w = self._responder.writer
        w.set_header("Content-Type", content_type)
        if hasattr(chunks, "set_sink"):
            w.stream_from(chunks)
            return
        for chunk in chunks:
            w.write_chunk(chunk)

    # -- tracing ------------------------------------------------------------
    def trace(self, name: str):
        """Context manager opening a user span:

            with ctx.trace("expensive-work"):
                ...
        """
        return self.container.tracer.span(name)
