"""Self-contained distributed tracing with W3C traceparent propagation
(the port's own copy of the part of gofr_tpu/tracing.py that the App,
its middleware, the gRPC transport and the generation engine use).

Spans are kept in a contextvar stack, trace context crosses process
boundaries through the ``traceparent`` header (W3C Trace Context), and
finished spans go to a pluggable exporter: with ``TRACER_HOST`` a
batched Zipkin v2 exporter behind a tail sampler (``TPU_TRACE_SAMPLE``,
``TPU_TRACE_TAIL_LINGER_S``), as in JAX.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import secrets
import threading
import time
import urllib.request
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any

_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "gofr_tpu_torch_current_span", default=None
)


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


class ZipkinExporter(SpanExporter):
    """Batched Zipkin v2 JSON exporter (reference: gofr.go:245-257 wires a
    zipkin batch exporter when TRACER_HOST is set; the port's own copy
    of gofr_tpu/tracing.py's).

    The pending buffer is BOUNDED (``max_pending``): with the collector
    down or stalled, fail-open export must cost bounded memory, not an
    unbounded list growing one dict per span for the outage's duration.
    On overflow the OLDEST pending spans drop (the newest are the ones
    an operator triages) and ``dropped`` / the
    ``app_tpu_spans_dropped_total`` counter record how many."""

    def __init__(self, host: str, port: int = 9411, batch_size: int = 64,
                 flush_interval: float = 2.0, max_pending: int = 4096,
                 metrics=None):
        self.url = f"http://{host}:{port}/api/v2/spans"
        self.batch_size = batch_size
        self.flush_interval = flush_interval
        self.max_pending = max(1, int(max_pending))
        self.metrics = metrics
        self.dropped = 0
        self._buf: deque[dict] = deque()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()  # full batch -> flush thread, now
        self._thread = threading.Thread(target=self._loop, daemon=True, name="zipkin-exporter")
        self._thread.start()

    def export(self, span: Span, service_name: str) -> None:
        z = {
            "traceId": span.trace_id,
            "id": span.span_id,
            "name": span.name,
            "timestamp": span.start_epoch_us,
            "duration": max(span.duration_us, 1),
            "localEndpoint": {"serviceName": service_name},
            "tags": {k: str(v) for k, v in span.attributes.items()},
        }
        if span.parent_id:
            z["parentId"] = span.parent_id
        flush_now = False
        n_dropped = 0
        with self._lock:
            self._buf.append(z)
            while len(self._buf) > self.max_pending:
                self._buf.popleft()
                self.dropped += 1
                n_dropped += 1
            if len(self._buf) >= self.batch_size:
                flush_now = True
        if n_dropped and self.metrics is not None:
            try:
                for _ in range(n_dropped):
                    self.metrics.increment_counter(
                        "app_tpu_spans_dropped_total")
            except Exception:
                pass  # tracing must never take the app down
        if flush_now:
            # hand the POST to the flush thread instead of doing it here:
            # export() is called from request handlers AND the generation
            # serving loop, and a slow collector must never block either
            # (a 2 s urlopen on the loop thread would stall every stream)
            self._wake.set()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.flush_interval)
            self._wake.clear()
            self._flush()

    def _flush(self) -> None:
        with self._lock:
            batch, self._buf = list(self._buf), deque()
        if not batch:
            return
        try:
            req = urllib.request.Request(
                self.url,
                data=json.dumps(batch).encode(),
                headers={"Content-Type": "application/json"},
            )
            urllib.request.urlopen(req, timeout=2).close()
        except Exception:
            pass  # tracing must never take the app down

    def shutdown(self) -> None:
        """Final flush on graceful shutdown. Joining the flush thread
        matters: without it a clean exit could tear the interpreter down
        mid-POST and silently drop the last batch of spans."""
        self._stop.set()
        self._wake.set()  # unblock the interval wait immediately
        self._thread.join(timeout=5.0)
        self._flush()


class TailSampler(SpanExporter):
    """Tail-based sampling: buffer each trace until its process-local
    ROOT span finishes, then judge the whole trace at once.

    Export-everything tracing drowns the spans that matter: at serving
    rates the collector stores millions of healthy request traces to
    keep the handful that shed, expired, errored, or landed in the
    latency tail. The verdict here keeps 100% of:

      - error traces — any span with an ``error`` attribute, a non-OK
        ``rpc.grpc.status_code``, or ``http.status_code`` >= 429 (429
        = shed, 504 = deadline exceeded, 5xx = failure);
      - shed/expired traces — the gate's zero-length ``tpu.shed``
        marker span, or an ``expired``/``shed`` outcome attribute;
      - slow-tail traces — root latency above a rolling per-class p99
        estimate (the last ``window`` roots of that ``slo_class``);

    and samples the healthy rest at ``sample_rate`` — DETERMINISTIC in
    the trace id (a hash-fraction compare), so every process in a fleet
    keeps or drops the same distributed trace. Traces whose root never
    arrives in this process (engine-direct ``generate()`` stage spans)
    are judged after ``linger_s`` by the same rules minus the root
    latency. Once judged, late spans of the same trace follow the
    recorded verdict instead of re-buffering."""

    def __init__(self, downstream: SpanExporter, sample_rate: float = 1.0,
                 max_traces: int = 512, max_spans_per_trace: int = 256,
                 linger_s: float = 5.0, window: int = 256,
                 min_samples: int = 20, metrics=None):
        self.downstream = downstream
        self.metrics = metrics
        self.sample_rate = min(1.0, max(0.0, float(sample_rate)))
        self.max_traces = int(max_traces)
        self.max_spans_per_trace = int(max_spans_per_trace)
        self.linger_s = float(linger_s)
        self.min_samples = int(min_samples)
        self._lock = threading.Lock()
        # trace_id -> [first_seen_monotonic, [spans], interesting, service]
        self._pending: "OrderedDict[str, list]" = OrderedDict()
        # decided traces (bounded LRU): late spans follow the verdict
        self._verdicts: "OrderedDict[str, bool]" = OrderedDict()
        self._lat: dict[str, deque] = {}
        self._lat_sorted: dict[str, list | None] = {}
        self._window = int(window)
        self.kept_traces = 0
        self.dropped_traces = 0
        self.spans_truncated = 0  # per-trace span-cap overflow (visible)
        # keep verdicts by WHY (the drop rate alone can't distinguish
        # "sampling works" from "nothing interesting ever fires")
        self.kept_by_reason = {"interesting": 0, "slow": 0, "sampled": 0}
        self.linger_sweeps = 0  # sweeps that judged >=1 rootless trace
        # idle flush: the sweep otherwise only runs inside export(), so
        # a process whose span traffic STOPS would strand its buffered
        # rootless traces (including error traces) forever. A daemon
        # timer sweeps on the linger cadence; started lazily on first
        # export so a sampler built in tests costs no thread until used.
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- verdict inputs ------------------------------------------------------
    @staticmethod
    def interesting(span: Span) -> bool:
        """Must-keep signal on a single span."""
        if span.name == "tpu.shed":
            return True
        attrs = span.attributes
        if "error" in attrs:
            return True
        if str(attrs.get("outcome", "")) in ("shed", "expired", "failed"):
            return True
        grpc = attrs.get("rpc.grpc.status_code")
        if grpc is not None:
            try:
                if int(grpc) != 0:
                    return True
            except (TypeError, ValueError):
                return True
        http = attrs.get("http.status_code")
        if http is not None:
            try:
                if int(http) >= 429:
                    return True
            except (TypeError, ValueError):
                pass
        return False

    def _sampled(self, trace_id: str) -> bool:
        """Deterministic hash-fraction sample on the trace id."""
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        try:
            frac = int(trace_id[:13], 16) / float(16 ** 13)
        except (TypeError, ValueError):
            return True  # unparseable id: fail open, keep
        return frac < self.sample_rate

    def _p99(self, slo_class: str) -> float | None:
        d = self._lat.get(slo_class)
        if d is None or len(d) < self.min_samples:
            return None  # estimator still warming: no slow-tail verdict
        s = self._lat_sorted.get(slo_class)
        if s is None:
            # sorted view cached until the next sample: every span
            # export serializes behind this lock, so an O(n log n)
            # sort per ROOT (not per read) is the budget
            s = self._lat_sorted[slo_class] = sorted(d)
        return s[min(len(s) - 1, int(0.99 * len(s)))]

    def _note_latency(self, slo_class: str, dur_s: float) -> None:
        d = self._lat.get(slo_class)
        if d is None:
            d = self._lat[slo_class] = deque(maxlen=self._window)
        d.append(dur_s)
        self._lat_sorted[slo_class] = None  # invalidate the cached sort

    # -- exporter protocol ---------------------------------------------------
    def _ensure_sweeper(self) -> None:
        """Start the idle-flush thread (once): without it, buffered
        rootless traces would only ever be judged by a LATER export —
        and a process whose traffic stops never makes one."""
        if self._thread is not None:
            return
        with self._lock:
            if self._thread is None and not self._stop.is_set():
                self._thread = threading.Thread(target=self._sweep_loop,
                                                daemon=True,
                                                name="tail-sampler")
                self._thread.start()

    def _sweep_loop(self) -> None:
        interval = max(0.25, self.linger_s or 1.0)
        while not self._stop.wait(interval):
            with self._lock:
                to_flush = self._sweep_locked()
            for s, svc in to_flush:
                try:
                    self.downstream.export(s, svc)
                except Exception:
                    pass  # tracing must never take the app down

    def export(self, span: Span, service_name: str) -> None:
        self._ensure_sweeper()
        to_flush: list[tuple[Span, str]] = []
        with self._lock:
            verdict = self._verdicts.get(span.trace_id)
            if verdict is not None:
                self._verdicts.move_to_end(span.trace_id)
                if not verdict and span.root and self._root_keeps(span):
                    # the linger sweep judged this trace from its
                    # buffered spans while the root was STILL OPEN (a
                    # request longer than linger_s), and the root now
                    # proves it error/slow. The swept spans are gone,
                    # but the root — the span carrying status, duration
                    # and slo_class — must not be: flip the verdict so
                    # it and any later spans export.
                    self._verdicts[span.trace_id] = verdict = True
                    self._note_kept("interesting" if self.interesting(span)
                                    else "slow")
                    self.dropped_traces -= 1
                if verdict:
                    to_flush.append((span, service_name))
            else:
                entry = self._pending.get(span.trace_id)
                if entry is None:
                    entry = [time.monotonic(), [], False, service_name]
                    self._pending[span.trace_id] = entry
                else:
                    # linger measures IDLE time: an active trace that
                    # keeps emitting spans is a live request, not an
                    # orphan to sweep
                    entry[0] = time.monotonic()
                if len(entry[1]) < self.max_spans_per_trace or span.root:
                    # the root always buffers (it may exceed the cap by
                    # one) — a kept trace without its root span would
                    # lose the status/duration the verdict hinged on
                    entry[1].append(span)
                else:
                    self.spans_truncated += 1
                entry[2] = entry[2] or self.interesting(span)
                if span.root:
                    to_flush.extend(self._decide_locked(span.trace_id, span))
                to_flush.extend(self._sweep_locked())
        for s, svc in to_flush:
            self.downstream.export(s, svc)

    def _root_keeps(self, root: Span) -> bool:
        """Late must-keep check for a root whose trace was already
        judged: interesting on its own, or slow-tail vs the rolling
        per-class estimate (which it also feeds)."""
        keep = self.interesting(root)
        dur_s = root.duration_us / 1e6
        cls = str(root.attributes.get("slo_class") or "latency")
        thresh = self._p99(cls)
        if not keep and thresh is not None and dur_s > thresh:
            keep = True
        self._note_latency(cls, dur_s)
        return keep

    def _decide_locked(self, trace_id: str,
                       root: Span | None) -> list[tuple[Span, str]]:
        entry = self._pending.pop(trace_id, None)
        if entry is None:
            return []
        _, spans, is_interesting, service = entry
        keep = is_interesting
        reason = "interesting" if keep else None
        if root is not None:
            dur_s = root.duration_us / 1e6
            cls = str(root.attributes.get("slo_class") or "latency")
            thresh = self._p99(cls)
            if not keep and thresh is not None and dur_s > thresh:
                keep = True  # slow tail: above the rolling per-class p99
                reason = "slow"
            # feed the estimator AFTER judging: a burst of slow roots
            # must not raise the bar fast enough to hide its own tail
            self._note_latency(cls, dur_s)
        if not keep:
            keep = self._sampled(trace_id)
            reason = "sampled" if keep else None
        self._verdicts[trace_id] = keep
        while len(self._verdicts) > 4096:
            self._verdicts.popitem(last=False)
        if keep:
            self._note_kept(reason or "interesting")
            return [(s, service) for s in spans]
        self.dropped_traces += 1
        self._count("app_tpu_trace_dropped_total")
        return []

    def _note_kept(self, reason: str) -> None:
        self.kept_traces += 1
        self.kept_by_reason[reason] = self.kept_by_reason.get(reason, 0) + 1
        self._count("app_tpu_trace_kept_total", reason=reason)

    def _count(self, name: str, **labels) -> None:
        if self.metrics is None:
            return
        try:
            self.metrics.increment_counter(name, **labels)
        except Exception:
            pass  # telemetry must never take the sampler down

    def _sweep_locked(self, force: bool = False) -> list[tuple[Span, str]]:
        """Judge rootless traces past the linger window (and evict by
        count): a trace whose root never reaches this process still
        gets a verdict from its buffered spans alone."""
        out: list[tuple[Span, str]] = []
        now = time.monotonic()
        judged = False
        while self._pending:
            oldest_id, entry = next(iter(self._pending.items()))
            stale = force or (now - entry[0]) >= self.linger_s \
                or len(self._pending) > self.max_traces
            if not stale:
                break
            out.extend(self._decide_locked(oldest_id, None))
            judged = True
        if judged:
            self.linger_sweeps += 1
            self._count("app_tpu_trace_sweeps_total")
        return out

    def flush_pending(self) -> None:
        """Judge every buffered trace now (tests, shutdown)."""
        with self._lock:
            to_flush = self._sweep_locked(force=True)
        for s, svc in to_flush:
            self.downstream.export(s, svc)

    def stats(self) -> dict:
        with self._lock:
            return {
                "sample_rate": self.sample_rate,
                "pending_traces": len(self._pending),
                "kept_traces": self.kept_traces,
                "kept_by_reason": dict(self.kept_by_reason),
                "dropped_traces": self.dropped_traces,
                "spans_truncated": self.spans_truncated,
                "linger_sweeps": self.linger_sweeps,
            }

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.flush_pending()
        self.downstream.shutdown()


def tracer_from_config(config, service_name: str, metrics=None) -> Tracer:
    """Reference: gofr.go:231-258 initTracer — exporter only when
    TRACER_HOST is set. The exporter is wrapped in a TailSampler:
    ``TPU_TRACE_SAMPLE`` is the keep rate for HEALTHY traces (default
    1.0 = keep everything; shed/expired/error/slow-tail traces are
    always kept regardless)."""
    host = config.get("TRACER_HOST")
    exporter: SpanExporter | None = None
    if host:
        port = int(config.get_or_default("TRACER_PORT", "9411"))
        exporter = ZipkinExporter(host, port, metrics=metrics)
        try:
            rate = float(config.get("TPU_TRACE_SAMPLE") or 1.0)
        except (TypeError, ValueError):
            rate = 1.0
        try:
            linger = float(config.get("TPU_TRACE_TAIL_LINGER_S") or 5.0)
        except (TypeError, ValueError):
            linger = 5.0
        exporter = TailSampler(exporter, sample_rate=rate, linger_s=linger,
                               metrics=metrics)
    return Tracer(service_name=service_name, exporter=exporter)
