"""Per-request Context: the request and the container behind one facade
(the port's own copy of gofr_tpu/context.py).

A handler receives exactly one of these: ``ctx.bind()``,
``ctx.param(...)``, ``ctx.header(...)`` read the request,
``ctx.stream(...)`` writes a live chunked response, ``ctx.trace(...)``
opens a span, ``ctx.tpu`` is the engine,
``ctx.get_http_service(name)`` an outbound service client,
``ctx.get_publisher()`` the
pub/sub client (a subscriber's handler gets a Context whose request is
the consumed ``pubsub.Message``; a CLI sub-command's, the argv flags),
``ctx.redis`` the Redis client (``REDIS_HOST``), ``ctx.sql`` the SQL
datasource (``DB_DIALECT``/``DB_HOST``), and
``ctx.deadline``/``ctx.slo_class``/``ctx.tenant`` are the request's
ambient budget, class and tenant (which
``ctx.tpu.generate`` and ``ctx.tpu.predict`` read by themselves).
"""

from __future__ import annotations

from typing import Any

from .container import Container
from .errors import InternalServerError
from .resilience import current_deadline, current_slo_class
from .tenancy.registry import current_tenant


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

    def get_http_service(self, name: str):
        """The outbound service client registered under ``name``
        (``App.add_http_service``), or None:
        ``ctx.get_http_service("llm").post("/generate", body=...)``."""
        return self.container.get_http_service(name)

    def get_publisher(self):
        """The container's pub/sub client (``PUBSUB_BACKEND``), or None:
        ``ctx.get_publisher().publish(topic, payload)``."""
        return self.container.get_publisher()

    @property
    def tpu(self):
        """The engine: ``ctx.tpu.generate(...)``,
        ``ctx.tpu.predict(program, item)``."""
        return self.container.tpu

    @property
    def redis(self):
        """The container's Redis client (``REDIS_HOST``/``REDIS_PORT``),
        or None."""
        return self.container.redis

    @property
    def sql(self):
        """The container's SQL datasource (``DB_DIALECT``/``DB_HOST``), or
        None: ``ctx.sql.execute("INSERT ... VALUES (?)", x)``."""
        return self.container.sql

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
        """The request's tenant id (``default`` when untagged), from
        ``X-Tenant-Id`` / gRPC ``x-tenant-id``, canonicalised through the
        tenant registry when one is configured. Ambient like the
        deadline and class: ``ctx.tpu.generate``/``predict`` enforce the
        tenant's quota, weight and cache budget by themselves."""
        return current_tenant()

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
