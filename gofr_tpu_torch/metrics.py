"""Metrics: name-keyed registry of counter/up-down-counter/histogram/gauge
with Prometheus text exposition (the port's own copy of
gofr_tpu/metrics.py: the same registry, renderers and framework metric
names, so a ``/metrics`` scrape of the port's App exposes what the JAX
App's does; histogram series are always the locked Python form).

Reference surface: pkg/gofr/metrics/register.go:13-23 (``Manager`` iface with
NewCounter/NewUpDownCounter/NewHistogram/NewGauge + record methods), the typed
store with already-/not-registered errors (metrics/store.go:14-113,
metrics/errors.go:5-19), label validation and the >20 label-cardinality
warning (register.go:233), and the promhttp endpoint with per-scrape runtime
gauges (metrics/handler.go:11-34). The OTel+Prometheus exporter pair is
replaced by a direct text-format renderer — one fewer moving part, same wire
format.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Sequence


class MetricError(Exception):
    pass


class MetricAlreadyRegistered(MetricError):
    def __init__(self, name: str):
        super().__init__(f"metric {name!r} is already registered")


class MetricNotRegistered(MetricError):
    def __init__(self, name: str):
        super().__init__(f"metric {name!r} is not registered")


def _label_key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


@dataclass
class _Metric:
    name: str
    desc: str
    kind: str  # counter | updown | histogram | gauge
    buckets: Sequence[float] = ()
    # label-set key -> value. For histograms the value is
    # (bucket_counts: list[int], total_sum: float, count: int).
    series: dict[tuple, object] = field(default_factory=dict)
    lock: threading.Lock = field(default_factory=threading.Lock)
    # label-set key -> {bucket index -> (trace_id, value, unix_ts)}.
    # The OpenMetrics trace<->metric join: each histogram bucket keeps
    # its most recent exemplar (index len(buckets) = +Inf; -1 = the
    # counter-sample exemplar). Rendered ONLY by render_openmetrics —
    # the Prometheus 0.0.4 text format has no exemplar syntax.
    exemplars: dict[tuple, dict[int, tuple]] = field(default_factory=dict)


DEFAULT_HISTOGRAM_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10,
)


def _new_histogram_series(buckets: Sequence[float]):
    """The locked python representation [cumulative_counts, sum, count]."""
    return [[0] * len(buckets), 0.0, 0]


class Manager:
    """Thread-safe metrics registry + recorder.

    API matches the reference Manager (metrics/register.go:13-23) with
    snake_case naming; labels are keyword arguments:

        m.new_counter("app_reqs", "total requests")
        m.increment_counter("app_reqs", path="/a", method="GET")
    """

    def __init__(self, logger=None):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()
        self._logger = logger

    # -- registration (metrics/register.go:53-144) --------------------------
    def _register(self, name: str, desc: str, kind: str, buckets: Sequence[float] = ()) -> None:
        if not name:
            raise MetricError("metric name cannot be empty")
        with self._lock:
            if name in self._metrics:
                raise MetricAlreadyRegistered(name)
            self._metrics[name] = _Metric(name=name, desc=desc, kind=kind, buckets=tuple(buckets))

    def new_counter(self, name: str, desc: str = "") -> None:
        self._register(name, desc, "counter")

    def new_updown_counter(self, name: str, desc: str = "") -> None:
        self._register(name, desc, "updown")

    def new_histogram(self, name: str, desc: str = "",
                      buckets: Sequence[float] = DEFAULT_HISTOGRAM_BUCKETS,
                      ) -> None:
        self._register(name, desc, "histogram", sorted(buckets))

    def new_gauge(self, name: str, desc: str = "") -> None:
        self._register(name, desc, "gauge")

    # -- recording (metrics/register.go:147-231) ----------------------------
    def _get(self, name: str, kind: str) -> _Metric:
        m = self._metrics.get(name)
        if m is None or m.kind != kind:
            raise MetricNotRegistered(name)
        return m

    def _check_cardinality(self, m: _Metric, labels: dict[str, str]) -> None:
        # reference register.go:233 getAttributes warns past 20 label values
        if len(labels) > 20 and self._logger is not None:
            self._logger.warn(
                {"event": "high metric label cardinality", "metric": m.name, "labels": len(labels)}
            )

    def increment_counter(self, name: str, exemplar: str | None = None,
                          **labels: str) -> None:
        """``exemplar``: optional trace id attached to this series'
        OpenMetrics ``_total`` sample (shed/error counters pass the
        ambient span so a dashboard count links to an exact trace)."""
        m = self._get(name, "counter")
        self._check_cardinality(m, labels)
        key = _label_key(labels)
        with m.lock:
            m.series[key] = float(m.series.get(key, 0.0)) + 1.0
            if exemplar:
                m.exemplars.setdefault(key, {})[-1] = (
                    str(exemplar), 1.0, time.time())

    def delta_updown_counter(self, name: str, delta: float, **labels: str) -> None:
        m = self._get(name, "updown")
        key = _label_key(labels)
        with m.lock:
            m.series[key] = float(m.series.get(key, 0.0)) + delta

    def record_histogram(self, name: str, value: float,
                         exemplar: str | None = None, **labels: str) -> None:
        """``exemplar``: optional trace id for the bucket this value
        lands in — the OpenMetrics bucket->trace link (a p99 TTFT
        bucket resolves to the exact trace that put it there). Costs
        one locked dict write, paid only when passed."""
        m = self._get(name, "histogram")
        key = _label_key(labels)
        entry = m.series.get(key)
        if entry is None:
            with m.lock:
                entry = m.series.get(key)
                if entry is None:
                    entry = _new_histogram_series(m.buckets)
                    m.series[key] = entry
        if exemplar:
            idx = len(m.buckets)
            for i, b in enumerate(m.buckets):
                if value <= b:
                    idx = i
                    break
            with m.lock:
                m.exemplars.setdefault(key, {})[idx] = (
                    str(exemplar), float(value), time.time())
        with m.lock:
            counts, _, _ = entry
            for i, b in enumerate(m.buckets):
                if value <= b:
                    counts[i] += 1
            entry[1] += value
            entry[2] += 1

    def set_gauge(self, name: str, value: float, **labels: str) -> None:
        m = self._get(name, "gauge")
        key = _label_key(labels)
        with m.lock:
            m.series[key] = float(value)

    # -- exposition ---------------------------------------------------------
    def render_prometheus(self) -> str:
        """Render all metrics in Prometheus text exposition format 0.0.4."""
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in sorted(metrics, key=lambda x: x.name):
            ptype = {"counter": "counter", "updown": "gauge",
                     "gauge": "gauge", "histogram": "histogram"}[m.kind]
            if m.desc:
                lines.append(f"# HELP {m.name} {m.desc}")
            lines.append(f"# TYPE {m.name} {ptype}")
            with m.lock:
                series = dict(m.series)
            for key, val in sorted(series.items()):
                label_str = _fmt_labels(key)
                if m.kind == "histogram":
                    counts, total, count = _hist_snapshot(val)
                    cum = 0
                    for b, c in zip(m.buckets, counts):
                        cum = c
                        lines.append(
                            f'{m.name}_bucket{_fmt_labels(key, extra=("le", _fmt_float(b)))} {cum}'
                        )
                    lines.append(f'{m.name}_bucket{_fmt_labels(key, extra=("le", "+Inf"))} {count}')
                    lines.append(f"{m.name}_sum{label_str} {total}")
                    lines.append(f"{m.name}_count{label_str} {count}")
                else:
                    lines.append(f"{m.name}{label_str} {val}")
        return "\n".join(lines) + "\n"

    def render_openmetrics(self) -> str:
        """Render all metrics in the OpenMetrics 1.0 text exposition,
        with exemplars. Sample lines are identical to the Prometheus
        renderer's except for the exemplar suffix on histogram bucket
        (and counter ``_total``) lines; the additions are the metric-
        family naming (a counter family drops its ``_total`` suffix on
        the TYPE/HELP lines) and the mandatory ``# EOF`` terminator.
        Served content-negotiated from ``/metrics`` — scrapers that do
        not send ``Accept: application/openmetrics-text`` keep getting
        the 0.0.4 text format byte-identically."""
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in sorted(metrics, key=lambda x: x.name):
            if m.kind == "counter":
                # OpenMetrics counters expose family X with sample
                # X_total; a counter registered WITHOUT the suffix has
                # no conformant counter rendering — expose it as
                # `unknown` (bare samples allowed) instead of minting a
                # renamed series dashboards have never seen
                if m.name.endswith("_total"):
                    family, ptype = m.name[: -len("_total")], "counter"
                else:
                    family, ptype = m.name, "unknown"
            elif m.kind == "histogram":
                family, ptype = m.name, "histogram"
            else:
                family, ptype = m.name, "gauge"
            if m.desc:
                lines.append(f"# HELP {family} {m.desc}")
            lines.append(f"# TYPE {family} {ptype}")
            with m.lock:
                series = dict(m.series)
                exemplars = {k: dict(v) for k, v in m.exemplars.items()}
            for key, val in sorted(series.items()):
                label_str = _fmt_labels(key)
                ex = exemplars.get(key, {})
                if m.kind == "histogram":
                    counts, total, count = _hist_snapshot(val)
                    cum = 0
                    for i, (b, c) in enumerate(zip(m.buckets, counts)):
                        cum = c
                        lines.append(
                            f'{m.name}_bucket{_fmt_labels(key, extra=("le", _fmt_float(b)))} {cum}'
                            + _fmt_exemplar(ex.get(i)))
                    lines.append(
                        f'{m.name}_bucket{_fmt_labels(key, extra=("le", "+Inf"))} {count}'
                        + _fmt_exemplar(ex.get(len(m.buckets))))
                    # exemplars attach to bucket lines ONLY: _sum/_count
                    # (and every non-counter sample) stay bare per spec
                    lines.append(f"{m.name}_sum{label_str} {total}")
                    lines.append(f"{m.name}_count{label_str} {count}")
                elif m.kind == "counter" and m.name.endswith("_total"):
                    lines.append(f"{m.name}{label_str} {val}"
                                 + _fmt_exemplar(ex.get(-1)))
                else:
                    lines.append(f"{m.name}{label_str} {val}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


def _hist_snapshot(val) -> tuple[list, float, int]:
    """One histogram series -> (cumulative bucket counts, sum, count),
    shared by both exposition renderers so they can never disagree."""
    counts, total, count = val
    return counts, total, count


def _fmt_exemplar(ex: tuple | None) -> str:
    """OpenMetrics exemplar suffix: `` # {trace_id="…"} value ts``.
    Empty when the bucket has never seen an exemplar."""
    if not ex:
        return ""
    trace_id, value, ts = ex
    tid = str(trace_id).replace(chr(92), chr(92) * 2).replace(
        chr(34), chr(92) + chr(34))
    return f' # {{trace_id="{tid}"}} {_fmt_float(value)} {ts:.3f}'


def _fmt_float(v: float) -> str:
    return repr(float(v)) if v != int(v) else str(int(v))


def _fmt_labels(key: tuple, extra: tuple[str, str] | None = None) -> str:
    items = list(key)
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    def esc(v):
        return str(v).replace(chr(92), chr(92) * 2).replace(
            chr(34), chr(92) + chr(34))

    inner = ",".join(f'{k}="{esc(v)}"' for k, v in items)
    return "{" + inner + "}"


# -- framework metrics ------------------------------------------------------

# Bucket priors from the reference (container/container.go:147-157):
HTTP_BUCKETS = (0.001, 0.003, 0.005, 0.01, 0.02, 0.03, 0.05, 0.1, 0.2, 0.3,
                0.5, 0.75, 1, 2, 3, 5, 10, 30)
SQL_BUCKETS_US = (50, 75, 100, 125, 150, 200, 300, 500, 750, 1000, 2000, 3000,
                  4000, 5000, 7500, 10000)
REDIS_BUCKETS_US = (50, 75, 100, 125, 150, 200, 300, 500, 750, 1000, 2000, 3000)
# TPU device-op latency priors (new; microsecond-scale host ops up to
# second-scale sharded executions):
TPU_BUCKETS = (0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.15, 0.2,
               0.3, 0.5, 0.75, 1, 2, 5, 10, 30)
# TTFT spans admission wait + one prefill dispatch: ms-scale when a slot
# is free and the shape is warm, seconds under queueing or a first-shape
# compile — so the range is wide with extra resolution in 10ms-1s where
# the serving SLO lives:
TTFT_BUCKETS = (0.002, 0.005, 0.01, 0.02, 0.035, 0.05, 0.075, 0.1, 0.15,
                0.25, 0.4, 0.6, 1, 1.5, 2.5, 5, 10, 30, 60)
# Inter-token gaps cluster at decode-step cadence (sub-ms to tens of ms
# on hardware; hundreds of ms on the CPU backend) and spike when a chunk
# lattice or compile interleaves — fine buckets below 100ms, coarse above:
ITL_BUCKETS = (0.0005, 0.001, 0.002, 0.004, 0.008, 0.015, 0.03, 0.05, 0.1,
               0.2, 0.4, 0.8, 1.5, 3, 10)
# Inter-block dispatch gaps: 0 when pipelined (a successor block was
# already queued at reap), else the reap+delivery+admission+dispatch
# host window — sub-ms through a few hundred ms (CPU backend / compile
# interleaves). The first bucket splits "pipelined" from "not":
GAP_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.002, 0.004, 0.008, 0.015,
               0.03, 0.06, 0.12, 0.25, 0.5, 1, 3)
# Resume recompute cost is measured in TOKENS re-prefilled, not
# seconds: powers-of-two up through a long context's worth
RECOMPUTE_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
                     2048, 4096, 8192)


def register_framework_metrics(m: Manager) -> None:
    """Built-in metrics (reference container/container.go:138-166 registers 16;
    we add the ``app_tpu_*`` family for the TPU datasource)."""
    # system gauges — refreshed per scrape by system_metrics()
    m.new_gauge("app_go_routines", "number of live threads")
    m.new_gauge("app_sys_memory_alloc", "resident set size in bytes")
    m.new_gauge("app_sys_total_alloc", "peak resident set size in bytes")
    m.new_gauge("app_go_numGC", "number of completed GC collections")
    m.new_gauge("app_go_sys", "virtual memory size in bytes")

    m.new_histogram("app_http_response", "response time of http requests in seconds", HTTP_BUCKETS)
    m.new_histogram("app_http_service_response",
                    "response time of http service requests in seconds",
                    HTTP_BUCKETS)
    m.new_histogram("app_sql_stats", "response time of sql queries in microseconds", SQL_BUCKETS_US)
    m.new_gauge("app_sql_open_connections", "open sql connections")
    m.new_gauge("app_sql_inUse_connections", "in-use sql connections")
    m.new_histogram("app_redis_stats",
                    "response time of redis commands in microseconds",
                    REDIS_BUCKETS_US)

    m.new_counter("app_pubsub_publish_total_count", "total publish attempts")
    m.new_counter("app_pubsub_publish_success_count", "successful publishes")
    m.new_counter("app_pubsub_subscribe_total_count", "total subscribe receives")
    m.new_counter("app_pubsub_subscribe_success_count", "successful subscribe receives")

    # TPU datasource family (no reference equivalent; BASELINE.json north star)
    m.new_histogram("app_tpu_predict_duration",
                    "end-to-end predict latency in seconds", TPU_BUCKETS)
    m.new_histogram("app_tpu_device_execute_duration",
                    "on-device execution time in seconds", TPU_BUCKETS)
    m.new_histogram("app_tpu_batch_wait_duration",
                    "time a request waits for a batch in seconds",
                    TPU_BUCKETS)
    m.new_gauge("app_tpu_batch_fill", "fraction of batch slots occupied at dispatch")
    m.new_counter("app_tpu_requests_total", "total TPU predict requests")
    m.new_counter("app_tpu_tokens_generated_total", "total generated tokens")
    m.new_counter("app_tpu_prefix_cache_hits_total",
                  "generation admissions that restored a cached prompt-prefix KV row")
    # hierarchical kv cache (tpu/kvcache: t0=HBM pool, t1=host DRAM,
    # t2=Redis-shared — docs/advanced-guide/kv-cache.md). Counters are
    # labeled by tier; a lookup that falls through t0 to hit t1 counts
    # a t0 miss AND a t1 hit, so per-tier hit ratios read directly.
    m.new_counter("app_tpu_kvcache_hits_total",
                  "prefix-cache lookups served, by tier")
    m.new_counter("app_tpu_kvcache_misses_total",
                  "prefix-cache lookups a consulted tier failed to serve")
    m.new_counter("app_tpu_kvcache_evictions_total",
                  "prefix entries evicted, by tier (t0 evictions spill "
                  "to t1 when the host tier is enabled)")
    m.new_gauge("app_tpu_kvcache_entries", "live prefix entries, by tier")
    m.new_gauge("app_tpu_kvcache_bytes",
                "bytes held by the host offload tier")
    m.new_histogram("app_tpu_kvcache_restore_duration",
                    "host-side prefix-restore path time in seconds, by "
                    "tier (row copy dispatch; +device_put for t1; "
                    "+Redis fetch for t2)", TPU_BUCKETS)
    m.new_gauge("app_tpu_devices", "number of visible TPU devices")
    m.new_counter("app_tpu_paged_evictions_total",
                  "streams truncated early by paged KV pool exhaustion")
    # device-memory accounting (gofr_tpu/tpu/hbm.py): bytes each
    # serving subsystem DECLARES it holds on device — the arbiter's
    # visibility substrate; pushed by the registry on every change
    m.new_gauge("app_tpu_device_bytes",
                "declared live device bytes, by serving subsystem "
                "(engine, kvcache-t0, lora, spec-decode, batcher)")
    # the HBM arbiter (docs/advanced-guide/memory.md): one budget the
    # subsystems lease from, with demand-driven reclaim and an
    # OOM-shed path instead of process death
    m.new_gauge("app_tpu_hbm_budget_bytes",
                "the arbiter's device-memory budget (0 = arbitration "
                "off; TPU_HBM_BUDGET_MB or device limit minus "
                "headroom)")
    m.new_counter("app_tpu_hbm_reclaims_total",
                  "arbiter reclaim callbacks that freed bytes, by the "
                  "RECLAIMED subsystem (T0 pool shrink-to-host-tier, "
                  "cold paged block release, scratch drops)")
    m.new_counter("app_tpu_hbm_shed_total",
                  "requests degraded to 429/RESOURCE_EXHAUSTED because "
                  "an HBM lease could not be covered after reclaim, by "
                  "requesting subsystem")
    # per-shard arbitration (multi-chip tensor-parallel serving,
    # docs/advanced-guide/multichip-serving.md): mesh engines settle
    # one lease entry per device, so in-use/headroom break out per chip
    m.new_gauge("app_tpu_hbm_device_in_use_bytes",
                "leased device bytes per mesh device (device label; "
                "series exist only when sharded leases are live)")
    m.new_gauge("app_tpu_hbm_device_budget_bytes",
                "the arbiter's PER-DEVICE budget (0 = per-device "
                "arbitration off; TPU_HBM_DEVICE_BUDGET_MB or device "
                "limit minus headroom)")

    # overload-safety family (gofr_tpu/resilience: deadlines, admission
    # control, brownout — see docs/advanced-guide/resilience.md)
    m.new_counter("app_tpu_expired_dropped_total",
                  "queued requests dropped at dispatch because the caller's "
                  "deadline expired (never executed)")
    m.new_counter("app_tpu_shed_total",
                  "requests rejected early by the admission gate "
                  "(429/RESOURCE_EXHAUSTED with Retry-After), by "
                  "slo_class — throughput-class sheds first under "
                  "class degradation")
    m.new_counter("app_tpu_prefill_chunks_total",
                  "mid-chunk dispatches of chunked prefills (each one "
                  "is a bounded slice of a long prompt interleaved "
                  "with decode/admission; serving-scheduler.md)")
    m.new_counter("app_tpu_brownout_capped_total",
                  "generation requests whose max_new_tokens was capped by "
                  "the brownout band")
    m.new_gauge("app_tpu_brownout_active",
                "1 while the admission gate's brownout band is engaged")

    # disaggregated prefill/decode serving (gofr_tpu/pd/ — see
    # docs/advanced-guide/disaggregated-serving.md): the KV-ship path
    # between dedicated prefill and decode pools
    m.new_counter("app_tpu_pd_requests_total",
                  "P/D-split requests, by role (prefill = relayed to "
                  "the decode pool, decode = ingested from a prefill "
                  "worker)")
    m.new_counter("app_tpu_pd_ingests_total",
                  "shipped-KV row installs admitted into decode slots "
                  "(zero prefill FLOPs on the decode pool)")
    m.new_counter("app_tpu_pd_kv_frames_total",
                  "checksummed KV block frames crossing the pool "
                  "boundary, by direction (byte totals live on the "
                  "role's health/stats surface)")
    m.new_counter("app_tpu_pd_frame_rejects_total",
                  "KV frames rejected at the transfer boundary "
                  "(checksum/truncation/layout) — each one failed a "
                  "single request typed, never a pool row")
    m.new_counter("app_tpu_pd_peer_losses_total",
                  "decode-peer connection losses that shed in-flight "
                  "relayed streams (503 + Retry-After)")
    m.new_histogram("app_tpu_pd_ship_duration",
                    "KV-ship wall time per relayed request in seconds: "
                    "first block encode to the shipper's final windowed "
                    "send returning (the wire segment of the critical "
                    "path)", TPU_BUCKETS)
    m.new_gauge("app_tpu_wire_backlog_bytes",
                "bytes parked in a wire outbox behind a slow socket, by "
                "role — the flow-control signal SocketWriter already "
                "tracks, exported")

    # prefix-affinity gateway (gofr_tpu/gateway,
    # docs/advanced-guide/gateway.md): the front door over N serving
    # replicas — routing decisions, failover spend, and the replica
    # table's aggregate view
    m.new_counter("app_tpu_gateway_requests_total",
                  "requests through the gateway, by terminal outcome "
                  "(ok / shed / failed)")
    m.new_counter("app_tpu_gateway_affinity_total",
                  "routing decisions, by result (hit = routed to the "
                  "prefix-affinity owner, spill = owner unroutable or "
                  "pressure-biased away, short = prompt below one "
                  "affinity block, balanced by pressure)")
    m.new_counter("app_tpu_gateway_failovers_total",
                  "pre-first-token retries on another replica, by "
                  "reason (transport / drain / shed)")
    m.new_counter("app_tpu_gateway_midstream_total",
                  "committed (already-200) relays terminated by a "
                  "mid-stream replica loss with the typed error line "
                  "— these requests also counted ok at commit, so "
                  "this is a loss-rate numerator, not an outcome")
    m.new_counter("app_tpu_gateway_retry_exhausted_total",
                  "requests answered a typed 503 because the failover "
                  "retry budget was empty (storm brake) or every "
                  "replica was tried")
    m.new_gauge("app_tpu_gateway_replicas",
                "replica table population, by state (ready / draining "
                "/ down)")
    m.new_gauge("app_tpu_gateway_pressure",
                "per-replica memory-pressure score (decaying; fed by "
                "429 X-Shed-Reason: hbm responses)")
    # durable streams (docs/advanced-guide/durable-streams.md): how
    # often replica death forced a token-exact continuation, and what
    # each one cost in re-prefilled tokens
    m.new_counter("app_tpu_gateway_resumes_total",
                  "committed relays continued on another replica after "
                  "mid-stream loss (the durable-streams save; pairs "
                  "with app_tpu_gateway_midstream_total as the "
                  "could-not-resume remainder)")
    m.new_histogram("app_tpu_resume_recompute_tokens",
                    "tokens re-prefilled to rebuild generation state "
                    "for one resumed stream", RECOMPUTE_BUCKETS)
    m.new_counter("app_tpu_pd_resumes_total",
                  "decode streams resumed by the P/D coordinator after "
                  "a decode-replica loss (KV re-shipped, stream "
                  "continued token-exact)")

    # tracing export health (tracing.ZipkinExporter): spans dropped
    # because the pending buffer hit its bound while the collector was
    # down/stalled — fail-open export must cost bounded memory, and
    # this counter is how a silent collector outage stays visible
    m.new_counter("app_tpu_spans_dropped_total",
                  "finished spans dropped by the bounded trace-export "
                  "buffer (collector down or stalled)")
    # tail-sampler visibility (tracing.TailSampler): the keep/drop
    # verdicts and linger sweeps that decide which traces survive
    m.new_counter("app_tpu_trace_kept_total",
                  "traces the tail sampler forwarded downstream, by "
                  "keep reason (interesting / slow / sampled)")
    m.new_counter("app_tpu_trace_dropped_total",
                  "traces the tail sampler discarded after buffering")
    m.new_counter("app_tpu_trace_sweeps_total",
                  "linger sweeps that judged rootless buffered traces")

    # serving-path telemetry (gofr_tpu/observe: the inference flight
    # recorder's metric face)
    m.new_histogram("app_tpu_ttft_duration",
                    "time from generate() submit to first token in seconds "
                    "(labeled by slo_class: the latency-class series is "
                    "the TTFT SLO)",
                    TTFT_BUCKETS)
    m.new_histogram("app_tpu_inter_token_duration",
                    "gap between consecutive delivered tokens in seconds",
                    ITL_BUCKETS)
    m.new_gauge("app_tpu_tokens_per_second",
                "decode throughput of the most recently finished stream")
    m.new_gauge("app_tpu_queue_depth",
                "requests waiting for a generation slot or a coalesced "
                "batch (generate also exports per-slo_class series for "
                "the split wait lines)")
    m.new_gauge("app_tpu_active_sequences",
                "generation slots currently holding a live stream")
    m.new_histogram("app_tpu_dispatch_gap_duration",
                    "inter-block host-dispatch gap in seconds: how long "
                    "the device stream sat idle between one fused decode "
                    "block's outputs coming ready and the next dispatch "
                    "(pipelined reaps with a successor already queued "
                    "record 0; exemplar-capable like every histogram)",
                    GAP_BUCKETS)
    m.new_gauge("app_tpu_pipeline_depth",
                "fused decode blocks in flight on the device stream "
                "after the last pipeline top-up")
    m.new_histogram("app_tpu_request_segment_duration",
                    "per-request critical-path segment time in seconds, "
                    "by segment (queue_wait / prefill / handoff / "
                    "decode on engines; pick / connect / ttfb on the "
                    "gateway; kv_transfer on decode ingest) — the "
                    "histogram face of the wide event's breakdown, "
                    "exemplar-linked to the trace",
                    TTFT_BUCKETS)
    # multi-tenant serving plane (gofr_tpu/tenancy,
    # docs/advanced-guide/multi-tenancy.md): per-tenant admission and
    # cache-footprint faces; shed/TTFT/queue-depth/cache-hit series
    # additionally grow a tenant label when a plane is installed
    m.new_gauge("app_tpu_tenant_admitted",
                "requests admitted through the tenant quota book, "
                "by tenant (cumulative)")
    m.new_gauge("app_tpu_tenant_shed",
                "requests shed with reason=tenant_quota, by tenant "
                "(cumulative)")
    m.new_gauge("app_tpu_tenant_cache_bytes",
                "prefix-cache T0 bytes resident per tenant (the "
                "cache-share arbiter lease evicts the over-budget "
                "tenant's rows first)")
    m.new_counter("app_tpu_async_jobs_total",
                  "async inference lane jobs by outcome (done / dedup "
                  "/ interrupted / backpressured)")


def update_system_metrics(m: Manager) -> None:
    """Per-scrape runtime stats (reference metrics/handler.go:20-34 refreshes
    goroutines/heap/GC per scrape; Python equivalents via /proc + gc)."""
    try:
        m.set_gauge("app_go_routines", float(threading.active_count()))
        counts = gc.get_stats()
        m.set_gauge("app_go_numGC", float(sum(s.get("collections", 0) for s in counts)))
        rss, peak, vsize = _read_proc_mem()
        m.set_gauge("app_sys_memory_alloc", rss)
        m.set_gauge("app_sys_total_alloc", peak)
        m.set_gauge("app_go_sys", vsize)
    except MetricNotRegistered:
        pass


def _read_proc_mem() -> tuple[float, float, float]:
    rss = peak = vsize = 0.0
    try:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = float(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    peak = float(line.split()[1]) * 1024
                elif line.startswith("VmSize:"):
                    vsize = float(line.split()[1]) * 1024
    except OSError:
        pass
    return rss, peak, vsize

