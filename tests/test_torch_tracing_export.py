"""The span exporters on the port (gofr_tpu_torch/tracing.py's
``ZipkinExporter``, ``TailSampler`` and ``tracer_from_config``) against
the JAX package's, on the CPU.

- tests/test_tracing.py's cases on the port's copy;
- the Zipkin v2 bodies a collector on localhost receives from each
  package's exporter for the same spans are equal;
- the tail sampler's keep and drop decisions, the spans it passes on
  and its ``stats()`` are equal for one scripted span sequence;
- ``tracer_from_config`` reads ``TRACER_HOST``, ``TRACER_PORT``,
  ``TPU_TRACE_SAMPLE`` and ``TPU_TRACE_TAIL_LINGER_S`` as JAX does, and
  an App's Container flushes the exporter at close;
- the gate's ``tpu.shed`` marker span and the engine's stage spans
  (``tpu.admit-wait``, ``tpu.prefill``, ``tpu.decode``) carry JAX's
  names, attributes and trace context.
"""

from __future__ import annotations

import http.server
import json
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import gofr_tpu.resilience as jres
import gofr_tpu.tracing as jtracing
import gofr_tpu_torch
import gofr_tpu_torch.resilience as pres
import gofr_tpu_torch.tracing as ptracing
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.models import LLAMA_CONFIGS as JLLAMA
from gofr_tpu.models import llama as jllama
from gofr_tpu.observe import Observe as JObserve
from gofr_tpu.tpu.generator import GenerationEngine as JaxEngine
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.observe import Observe
from gofr_tpu_torch.tpu import GenerationEngine, from_jax_params
from _torch_port_copy import port_copy


P = port_copy("test_tracing.py")
for _name in dir(P):
    if _name.startswith("test_"):
        globals()[_name] = getattr(P, _name)
del _name

PACKAGES = {"jax": jtracing, "port": ptracing}


# -- a Zipkin collector on localhost -----------------------------------------

class Collector:
    """``POST /api/v2/spans`` on 127.0.0.1: every body, parsed."""

    def __init__(self):
        bodies = self.bodies = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                bodies.append((self.path, json.loads(self.rfile.read(n))))
                self.send_response(202)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def spans(self) -> list:
        return [z for _, body in self.bodies for z in body]

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture
def collector():
    c = Collector()
    yield c
    c.close()


def _scripted_spans(mod) -> list:
    """Finished spans with fixed ids, times and attributes."""
    out = []
    for i in range(7):
        s = mod.Span(name=f"stage-{i}", trace_id="%032x" % (i // 3 + 1),
                     span_id="%016x" % (i + 1),
                     parent_id=None if i % 3 == 0 else "%016x" % i,
                     start_ns=1_000_000 * i, start_epoch_us=1_700_000_000 + i,
                     attributes={"slot": i, "slo_class": "latency",
                                 "ok": i % 2 == 0})
        s.end_ns = s.start_ns + (0 if i == 4 else 250_000 * i)
        out.append(s)
    return out


def test_zipkin_bodies_equal_jax_s(collector):
    """The same spans through each package's exporter reach a localhost
    collector as the same Zipkin v2 JSON, in one batch each (a full
    batch wakes the flush thread), and shutdown flushes the rest."""
    got = {}
    for name, mod in PACKAGES.items():
        collector.bodies.clear()
        exp = mod.ZipkinExporter("127.0.0.1", collector.port, batch_size=5,
                                 flush_interval=3600.0)
        spans = _scripted_spans(mod)
        for s in spans[:5]:
            exp.export(s, "svc")
        end = time.monotonic() + 10.0
        while not collector.bodies and time.monotonic() < end:
            time.sleep(0.01)
        for s in spans[5:]:
            exp.export(s, "svc")
        exp.shutdown()
        assert not exp._thread.is_alive()
        got[name] = list(collector.bodies)
    assert got["port"] == got["jax"]
    assert [len(b) for _, b in got["port"]] == [5, 2]
    assert {p for p, _ in got["port"]} == {"/api/v2/spans"}
    first = got["port"][0][1][1]
    assert first["parentId"] == "%016x" % 1 and first["tags"]["ok"] == "False"


# -- the tail sampler on one script ------------------------------------------

class _Sink:
    def __init__(self):
        self.spans = []

    def export(self, span, service):
        self.spans.append((span.trace_id, span.name, service))

    def shutdown(self):
        pass


def _sampler_script(mod, monkeypatch) -> dict:
    """Roots healthy, slow, erroring, shed and expired; rootless traces
    swept after the linger; a late root after a drop verdict; the span
    cap. The monotonic clock is pinned through the module's ``time``."""
    now = [1000.0]
    monkeypatch.setattr(mod, "time", SimpleNamespace(
        monotonic=lambda: now[0], time=lambda: 1.7e9 + now[0],
        monotonic_ns=lambda: int(now[0] * 1e9)))
    sink = _Sink()
    ts = mod.TailSampler(sink, sample_rate=0.5, linger_s=2.0, window=64,
                         min_samples=5, max_spans_per_trace=3)
    ts._ensure_sweeper = lambda: None     # the script sweeps, not a thread
    rng = np.random.default_rng(31)

    def span(tid, name, root=False, dur_s=0.01, **attrs):
        s = mod.Span(name=name, trace_id=tid, span_id="%016x" % int(
            rng.integers(1, 2 ** 40)), attributes=attrs,
            start_ns=int(now[0] * 1e9), root=root)
        s.end_ns = s.start_ns + int(dur_s * 1e9)
        return s

    tids = [rng.bytes(16).hex() for _ in range(40)]
    for i, tid in enumerate(tids[:30]):
        for stage in ("tpu.admit-wait", "tpu.prefill", "tpu.decode"):
            ts.export(span(tid, stage, slot=i % 4), "svc")
        attrs = {"slo_class": "latency" if i % 2 else "throughput"}
        dur = float(rng.uniform(0.05, 0.2))
        if i == 12:
            attrs["http.status_code"] = 504
        elif i == 17:
            attrs["error"] = "boom"
        elif i in (20, 25):
            dur = 5.0                                   # the slow tail
        ts.export(span(tid, "http", root=True, dur_s=dur, **attrs), "svc")
        now[0] += 0.1
    ts.export(span(tids[30], "tpu.shed", reason="hbm"), "svc")
    for tid in tids[31:36]:                             # rootless
        ts.export(span(tid, "tpu.decode"), "svc")
    for i in range(5):                                  # past the span cap
        ts.export(span(tids[36], f"s{i}"), "svc")
    now[0] += 3.0
    ts.export(span(tids[37], "tpu.prefill"), "svc")     # sweeps the rest
    dropped_rootless = next(t for t in tids[31:36]
                            if not ts._verdicts.get(t, True))
    ts.export(span(dropped_rootless, "http", root=True, dur_s=0.01,
                   **{"rpc.grpc.status_code": 14}), "svc")
    ts.flush_pending()
    out = {"spans": sink.spans, "stats": ts.stats(),
           "verdicts": dict(ts._verdicts)}
    monkeypatch.undo()
    return out


def test_the_tail_sampler_decides_as_jax_s(monkeypatch):
    outs = {name: _sampler_script(mod, monkeypatch)
            for name, mod in PACKAGES.items()}
    assert outs["port"] == outs["jax"]
    stats = outs["port"]["stats"]
    assert stats["kept_by_reason"]["interesting"] >= 4   # 504, error,
    assert stats["kept_by_reason"]["slow"] >= 1          # shed, late root
    assert stats["dropped_traces"] > 0 and stats["linger_sweeps"] >= 1
    assert stats["spans_truncated"] == 2


@pytest.mark.parametrize("rows", [
    {}, {"TRACER_HOST": "127.0.0.1"},
    {"TRACER_HOST": "127.0.0.1", "TRACER_PORT": "9412",
     "TPU_TRACE_SAMPLE": "0.25", "TPU_TRACE_TAIL_LINGER_S": "1.5"},
    {"TRACER_HOST": "127.0.0.1", "TPU_TRACE_SAMPLE": "junk",
     "TPU_TRACE_TAIL_LINGER_S": "nope"},
    {"TRACER_PORT": "1", "TPU_TRACE_SAMPLE": "0.5"}],
    ids=["none", "host", "all", "junk", "no-host"])
def test_tracer_from_config_reads_the_rows_as_jax(rows):
    def reading(tracer):
        ts = tracer.exporter
        if ts is None:
            return None
        z = ts.downstream
        try:
            return (type(ts).__name__, ts.sample_rate, ts.linger_s,
                    type(z).__name__, z.url, z.max_pending, z.batch_size)
        finally:
            ts.shutdown()

    j = reading(jtracing.tracer_from_config(JMapConfig(rows), "svc"))
    p = reading(ptracing.tracer_from_config(MapConfig(rows), "svc"))
    assert p == j


def test_an_app_exports_through_the_sampler_and_flushes_at_close(collector):
    """A port App with ``TRACER_HOST``/``TRACER_PORT`` on the collector:
    a handled request's spans arrive by the Container's close, and the
    metrics carry the sampler's counters."""
    import urllib.request

    app = gofr_tpu_torch.App(MapConfig({
        "HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR",
        "APP_NAME": "traced", "TRACER_HOST": "127.0.0.1",
        "TRACER_PORT": str(collector.port), "TPU_TRACE_SAMPLE": "1"}),
        device="cpu")

    @app.get("/hello")
    def hello(ctx):
        return "hi"

    app.run(block=False)
    tp = "00-" + "c" * 32 + "-" + "d" * 16 + "-01"
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{app.http_port}"
                                     "/hello", headers={"traceparent": tp})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200
        stats = app.container.tracer.exporter.stats()
    finally:
        app.stop()
    spans = collector.spans()
    assert stats["kept_traces"] == 1 and stats["kept_by_reason"] == {
        "interesting": 0, "slow": 0, "sampled": 1}
    assert {z["traceId"] for z in spans} == {"c" * 32}
    assert {z["localEndpoint"]["serviceName"] for z in spans} == {"traced"}
    assert any(z.get("parentId") == "d" * 16 for z in spans)


# -- the spans of the gate and the engine ------------------------------------

@pytest.mark.parametrize("kind", ["queue", "memory", "tenant"])
def test_the_gate_s_shed_span_matches_jax_s(kind):
    spans = {}
    for name, res, tr in (("jax", jres, jtracing), ("port", pres, ptracing)):
        exp = tr.InMemoryExporter()
        tracer = tr.Tracer("svc", exporter=exp)
        gate = res.AdmissionGate(max_queue_depth=2, name="generate",
                                 tracer=tracer)
        with tracer.span("http") as root:
            if kind == "queue":
                with pytest.raises(Exception):
                    gate.admit(5, program="generate",
                               slo_class=res.SLO_THROUGHPUT)
            elif kind == "memory":
                gate.shed_memory(program="generate", trace_id="e" * 32)
            else:
                quotas = SimpleNamespace(check=lambda spec: ("rps", 0.5))
                with pytest.raises(Exception):
                    gate.admit_tenant(SimpleNamespace(tenant_id="acme"),
                                      quotas, program="generate")
        sheds = [s for s in exp.spans if s.name == "tpu.shed"]
        assert len(sheds) == 1
        s = sheds[0]
        spans[name] = (s.attributes, s.trace_id == root.trace_id,
                       s.trace_id, s.duration_us, s.parent_id)
        if kind == "memory":
            spans[name] = spans[name][:1] + spans[name][2:]
        else:
            spans[name] = spans[name][:2] + spans[name][3:]
    assert spans["port"] == spans["jax"]


def test_the_engines_stage_spans_match_jax_s():
    """One traced stream on each engine (tiny, the same weights): the
    same stage spans, in order, with JAX's attributes, each a child of
    the request's traceparent."""
    jparams = jllama.init(JLLAMA["tiny"], jax.random.PRNGKey(2))
    pparams = from_jax_params(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    args = dict(slots=2, max_seq=128, prompt_buckets=(16, 32),
                decode_block=2)
    tp = "00-" + "1" * 32 + "-" + "2" * 16 + "-01"
    got = {}
    for name, tr, make in (
            ("jax", jtracing, lambda obs: JaxEngine(
                JLLAMA["tiny"], jparams, observe=obs, **args)),
            ("port", ptracing, lambda obs: GenerationEngine(
                LLAMA_CONFIGS["tiny"], pparams, observe=obs, device="cpu",
                **args))):
        exp = tr.InMemoryExporter()
        obs = (JObserve if name == "jax" else Observe)(
            tracer=tr.Tracer("svc", exporter=exp))
        eng = make(obs)
        try:
            toks = eng.generate(list(range(3, 23)), max_new_tokens=6,
                                traceparent=tp).tokens()
        finally:
            eng.close()
        got[name] = (toks, [(s.name, s.trace_id, s.parent_id, s.attributes)
                            for s in exp.spans])
    assert got["port"] == got["jax"]
    assert [n for n, *_ in got["port"][1]] == [
        "tpu.admit-wait", "tpu.prefill", "tpu.decode"]
    assert {(t, p) for _, t, p, _ in got["port"][1]} == {("1" * 32,
                                                          "2" * 16)}
