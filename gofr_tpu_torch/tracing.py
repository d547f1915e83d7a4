"""Self-contained distributed tracing with W3C traceparent propagation
(the port's own copy of the part of gofr_tpu/tracing.py that the App,
its middleware, the gRPC transport and the generation engine use).

Spans are kept in a contextvar stack, trace context crosses process
boundaries through the ``traceparent`` header (W3C Trace Context), and
finished spans go to a pluggable exporter. The exporters of the JAX
package that ship spans off the process (Zipkin over HTTP, the tail
sampler in front of it) are not ported: their rows raise by name at
construction rather than being silently ignored.
"""

from __future__ import annotations

import contextlib
import contextvars
import secrets
import time
from dataclasses import dataclass, field
from typing import Any

_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "gofr_tpu_torch_current_span", default=None
)

# rows of the JAX package's tracer that name exporters outside the port
UNPORTED_ROWS = ("TRACER_HOST", "TRACER_PORT", "TPU_TRACE_SAMPLE",
                 "TPU_TRACE_TAIL_LINGER_S")


def _new_trace_id() -> str:
    return secrets.token_hex(16)


def _new_span_id() -> str:
    return secrets.token_hex(8)


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: str | None = None
    start_ns: int = field(default_factory=time.monotonic_ns)
    start_epoch_us: int = field(default_factory=lambda: int(time.time() * 1e6))
    end_ns: int | None = None
    attributes: dict[str, Any] = field(default_factory=dict)
    tracer: "Tracer | None" = None
    # the process-local root of its trace: the first span a request
    # opens in this process (the HTTP inbound middleware)
    root: bool = False
    _token: Any = None

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def end(self) -> None:
        if self.end_ns is None:
            self.end_ns = time.monotonic_ns()
            if self.tracer is not None:
                self.tracer._on_end(self)

    @property
    def duration_us(self) -> int:
        end = self.end_ns if self.end_ns is not None else time.monotonic_ns()
        return (end - self.start_ns) // 1000

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"


def current_span() -> Span | None:
    return _current.get()


def parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """Parse a W3C traceparent header -> (trace_id, parent_span_id)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    _, trace_id, span_id, _ = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        tid, sid = int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if tid == 0 or sid == 0:
        # W3C Trace Context: all-zero trace-id/parent-id are invalid
        # values; propagating them would stitch unrelated requests into
        # one trace. Treat as absent: start a fresh trace.
        return None
    return trace_id, span_id


class Tracer:
    """Creates spans and hands finished ones to the exporter."""

    def __init__(self, service_name: str = "gofr-app",
                 exporter: "SpanExporter | None" = None):
        self.service_name = service_name
        self.exporter = exporter

    def start_span(
        self,
        name: str,
        *,
        parent: Span | None = None,
        traceparent: str | None = None,
        attributes: dict[str, Any] | None = None,
    ) -> Span:
        if parent is None:
            parent = current_span()
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            ctx = parse_traceparent(traceparent)
            if ctx is not None:
                trace_id, parent_id = ctx
            else:
                trace_id, parent_id = _new_trace_id(), None
        span = Span(
            name=name,
            trace_id=trace_id,
            span_id=_new_span_id(),
            parent_id=parent_id,
            attributes=dict(attributes or {}),
            tracer=self,
            root=parent is None,
        )
        span._token = _current.set(span)
        return span

    def _on_end(self, span: Span) -> None:
        if span._token is not None:
            with contextlib.suppress(ValueError):
                _current.reset(span._token)
            span._token = None
        if self.exporter is not None:
            self.exporter.export(span, self.service_name)

    @contextlib.contextmanager
    def span(self, name: str, **kw: Any):
        s = self.start_span(name, **kw)
        try:
            yield s
        finally:
            s.end()

    def record_span(
        self,
        name: str,
        start_monotonic: float,
        end_monotonic: float,
        *,
        traceparent: str | None = None,
        trace_id: str | None = None,
        attributes: dict[str, Any] | None = None,
    ) -> Span:
        """Export a span for an interval measured elsewhere (the gRPC
        transport's first-send stages: handoff, HPACK encode, frame
        write). Unlike start_span this never touches the contextvar
        stack, since the interval was timed on another thread (the
        serving loop multiplexes every request), and the span arrives
        already finished.

        ``trace_id`` correlates spans without claiming a parent: when no
        valid ``traceparent`` exists, the span joins that trace as a
        root instead of pointing at a phantom parent span id."""
        ctx = parse_traceparent(traceparent)
        if ctx is not None:
            trace_id, parent_id = ctx
        else:
            trace_id, parent_id = trace_id or _new_trace_id(), None
        now_mono, now_epoch = time.monotonic(), time.time()
        span = Span(
            name=name,
            trace_id=trace_id,
            span_id=_new_span_id(),
            parent_id=parent_id,
            start_ns=int(start_monotonic * 1e9),
            start_epoch_us=int((now_epoch - (now_mono - start_monotonic)) * 1e6),
            attributes=dict(attributes or {}),
        )
        span.end_ns = int(end_monotonic * 1e9)
        if self.exporter is not None:
            self.exporter.export(span, self.service_name)
        return span


class SpanExporter:
    def export(self, span: Span, service_name: str) -> None:  # pragma: no cover
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class InMemoryExporter(SpanExporter):
    """Test exporter collecting finished spans."""

    def __init__(self) -> None:
        self.spans: list[Span] = []

    def export(self, span: Span, service_name: str) -> None:
        self.spans.append(span)


def tracer_from_config(config, service_name: str) -> Tracer:
    """A tracer without an exporter: spans still carry the trace
    context through the process (log lines, the response's correlation
    id, the generation stream's ``trace_id``). A row that asks for an
    exporter raises with its name."""
    rejected = [row for row in UNPORTED_ROWS
                if (config.get(row) or "").strip()]
    if rejected:
        raise ValueError(f"config rows not honoured by gofr_tpu_torch yet: "
                         f"{', '.join(rejected)}")
    return Tracer(service_name=service_name)
