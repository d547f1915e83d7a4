"""The ``/debug`` introspection router, mounted on the metrics server
(the port's own copy of gofr_tpu/observe/debug.py; the device topology
comes from ``torch.cuda``, or names the CPU for an App built with
``device="cpu"``).

The Python/TPU-native take on Go's ``net/http/pprof`` +
``golang.org/x/net/trace`` pages, answering "what is this server doing
right now?" without attaching a debugger:

  /debug                      index
  /debug/requests             in-flight request table (x/net/trace style;
                              ?format=json for machines)
  /debug/events               flight-recorder ring buffer (JSON;
                              ?n= ?event= ?request_id=)
  /debug/vars                 config + device topology + engine/batcher
                              state as JSON (expvar style)
  /debug/timeline?fleet=1     clock-aligned merge of every reachable
                              peer's timeline (observe/fleet.py)
  /debug/request?trace_id=..  one request's cross-process wide-event
                              story, peers queried live
  /debug/pprof/profile        wall-clock sampling profile, collapsed-stack
                              output (?seconds=N&hz=H, flamegraph-ready)

Mounted on the METRICS port, not the app port, for the same reason the
reference keeps /metrics there: debug surfaces stay off the public
listener and inherit whatever network policy already protects scrapes.
"""

from __future__ import annotations

import html
import json
import math
import sys
import threading

import torch

from ..tpu import hbm
from . import profiler

# keys whose values never leave the process (config dumps are one of the
# classic credential-leak vectors; match generously)
_REDACT_MARKERS = ("PASSWORD", "SECRET", "TOKEN", "KEY", "CREDENTIAL", "AUTH")

MAX_PROFILE_SECONDS = 30.0
MAX_PROFILE_HZ = 1000.0

# Single-flight: one profile at a time per process. N concurrent
# samplers would multiply GIL contention against the serving loop N-fold
# for up to 30 s each — concurrent callers get 409, not a pile-up.
_profile_lock = threading.Lock()


def _redact_config(cfg) -> dict:
    """Best-effort dump of the app's config view, secrets masked.

    Config is a two-method protocol, not an enumerable store — dump the
    sources we know how to see (MapConfig.values, EnvConfig's .env file
    vars) rather than the whole process environment. For keys that ARE
    known, report the value the app actually resolves (EnvConfig lets
    the process env override the file — the page must show the live
    value, not the shadowed one)."""
    raw: dict[str, str] = {}
    raw.update(getattr(cfg, "_file_vars", None) or {})
    raw.update(getattr(cfg, "values", None) or {})
    for k in raw:
        try:
            live = cfg.get(k)
        except Exception:
            continue
        if live is not None:
            raw[k] = live
    out = {}
    for k, v in sorted(raw.items()):
        if any(m in k.upper() for m in _REDACT_MARKERS):
            out[k] = "<redacted>"
        else:
            out[k] = v
    return out


def _device_topology(device) -> dict:
    """JAX's keys for the device the App was built on: ``platform``
    ("gpu" for a CUDA card, "cpu"), ``device_kind`` (the card's name),
    ``devices``, ``process_count`` and, on a card, the allocator's
    ``hbm_bytes_in_use`` and the card's ``hbm_bytes_limit``. A card
    that cannot be read is an ``error`` entry, as JAX's backend
    failure is."""
    try:
        dev = torch.device(device)
        if dev.type != "cuda":
            return {"platform": dev.type, "device_kind": dev.type,
                    "devices": 1, "process_count": 1}
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        out: dict = {
            "platform": "gpu",
            "device_kind": torch.cuda.get_device_name(idx),
            "devices": torch.cuda.device_count(),
            "process_count": 1,
        }
        try:
            out["hbm_bytes_in_use"] = torch.cuda.memory_allocated(idx)
            out["hbm_bytes_limit"] = torch.cuda.mem_get_info(idx)[1]
        except Exception:
            pass
        return out
    except Exception as e:  # no card, or CUDA cannot be reached
        return {"error": repr(e)}


def _json(w, payload, status: int = 200) -> None:
    w.status = status
    w.set_header("Content-Type", "application/json")
    w.write(json.dumps(payload, default=str).encode())


def _html(w, title: str, body: str) -> None:
    w.set_header("Content-Type", "text/html; charset=utf-8")
    w.write((
        "<!doctype html><html><head><title>" + html.escape(title)
        + "</title><style>body{font-family:monospace;margin:1.5em}"
        "table{border-collapse:collapse}td,th{border:1px solid #999;"
        "padding:2px 8px;text-align:left}th{background:#eee}</style>"
        "</head><body>" + body + "</body></html>").encode())


def install_debug_routes(router, app) -> None:
    """Register the /debug pages on ``router`` (the metrics router).

    ``app`` is the App: config, container, and (via the container) the
    observe state and TPU engine are all reachable from it."""
    observe = app.container.observe

    def index(req, w) -> None:
        _html(w, "debug", (
            "<h2>gofr_tpu_torch debug</h2><ul>"
            '<li><a href="/debug/requests">/debug/requests</a>'
            " — in-flight requests</li>"
            '<li><a href="/debug/events">/debug/events</a>'
            " — flight recorder</li>"
            '<li><a href="/debug/timeline?last_ms=2000">'
            "/debug/timeline</a> — serving timeline "
            "(Chrome-trace JSON; load in Perfetto)</li>"
            '<li><a href="/debug/timeline?fleet=1">'
            "/debug/timeline?fleet=1</a> — clock-aligned merge of "
            "every reachable peer's timeline</li>"
            '<li><a href="/debug/request">/debug/request?trace_id=...'
            "</a> — one request's cross-process story</li>"
            '<li><a href="/debug/vars">/debug/vars</a>'
            " — config, topology, engine state</li>"
            '<li><a href="/debug/cache">/debug/cache</a>'
            " — prefix KV cache tiers</li>"
            '<li><a href="/debug/pprof/profile?seconds=1">'
            "/debug/pprof/profile</a> — wall-clock sampling profile</li>"
            '<li><a href="/metrics">/metrics</a> — Prometheus</li></ul>'))

    def requests_page(req, w) -> None:
        snap = observe.requests.snapshot()
        if req.param("format") == "json":
            _json(w, {"active": snap, "count": len(snap),
                      "total_started": observe.requests.total_started})
            return
        rows = "".join(
            "<tr><td>{id}</td><td>{kind}</td><td>{name}</td>"
            "<td>{stage}</td><td>{age:.3f}s</td><td>{tokens}</td>"
            "<td>{trace}</td></tr>".format(
                id=e["id"], kind=html.escape(e["kind"]),
                name=html.escape(e["name"]), stage=html.escape(e["stage"]),
                age=e["age_s"], tokens=e["tokens"],
                trace=html.escape(e["trace_id"] or "-"))
            for e in snap)
        _html(w, "in-flight requests", (
            f"<h2>{len(snap)} in-flight request(s)</h2>"
            "<table><tr><th>id</th><th>kind</th><th>name</th><th>stage</th>"
            "<th>age</th><th>tokens</th><th>trace id</th></tr>"
            + rows + "</table>"))

    def events_page(req, w) -> None:
        try:
            limit = int(req.param("n", "256"))
        except ValueError:
            limit = 256
        request_id: "int | None" = None
        if req.param("request_id"):
            try:
                request_id = int(req.param("request_id"))
            except ValueError:
                return _json(w, {"error": "request_id must be an int"}, 400)
        events = observe.recorder.events(
            limit=limit, event=req.param("event") or None,
            request_id=request_id)
        if req.param("format") != "html":
            return _json(w, {"events": events, **observe.recorder.stats()})
        # HTML view: seq + trace_id columns up front so recorder rows
        # join by eye against exported traces and the wide events
        head = ("seq", "ts", "event", "request_id", "trace_id", "fields")
        rows = "".join(
            "<tr><td>{seq}</td><td>{ts:.3f}</td><td>{ev}</td>"
            "<td>{rid}</td><td>{tid}</td><td>{rest}</td></tr>".format(
                seq=e["seq"], ts=e["ts"], ev=html.escape(e["event"]),
                rid=e.get("request_id", "-"),
                tid=html.escape(str(e.get("trace_id", "-"))),
                rest=html.escape(json.dumps(
                    {k: v for k, v in e.items()
                     if k not in ("seq", "ts", "event", "request_id",
                                  "trace_id")}, default=str)))
            for e in events)
        _html(w, "flight recorder", (
            f"<h2>{len(events)} event(s)</h2>"
            "<table><tr>" + "".join(f"<th>{c}</th>" for c in head)
            + "</tr>" + rows + "</table>"
            '<p><a href="/debug/events">json</a></p>'))

    def timeline_page(req, w) -> None:
        """The serving timeline as Chrome-trace JSON (Perfetto /
        chrome://tracing load it directly). ``?last_ms=N`` restricts to
        the trailing window; ``?format=stats`` returns ring state
        only."""
        tl = getattr(observe, "timeline", None)
        if tl is None:
            return _json(w, {"enabled": False})
        if req.param("format") == "stats":
            out = tl.stats()
            # the decode-pipeline figures the timeline's "device
            # stream" track visualizes (dispatch-gap p50, overlapped
            # reaps, live depth) ride along so the stats page answers
            # "is the pipeline actually overlapping" without a trace
            # download
            gen = getattr(getattr(app.container, "tpu", None),
                          "generator", None)
            if gen is not None:
                try:
                    out["pipeline"] = \
                        gen.stats()["scheduler"]["pipeline"]
                except Exception:
                    pass  # a down engine must not break the page
            return _json(w, out)
        last_ms = None
        if req.param("last_ms"):
            try:
                last_ms = float(req.param("last_ms"))
            except ValueError:
                last_ms = float("nan")
            if not math.isfinite(last_ms) or last_ms < 0:
                # float() happily parses "nan"/"inf", which would make
                # every window comparison False and return an empty
                # trace instead of the 400 this branch exists for
                return _json(w, {"error": "last_ms must be a "
                                          "non-negative finite number"}, 400)
        if req.param("fleet"):
            return _json(w, _fleet_trace(last_ms))
        _json(w, tl.chrome_trace(last_ms=last_ms))

    def _fleet_timeout() -> float:
        try:
            return float(app.config.get("TPU_OBS_FLEET_TIMEOUT_S") or 2.0)
        except (TypeError, ValueError):
            return 2.0

    def _fleet_trace(last_ms) -> dict:
        """``?fleet=1``: pull every known peer's timeline + wide
        events, re-base onto the local clock, merge. A down peer is a
        typed degraded marker in the output, never a failure."""
        from . import fleet as fleet_mod

        timeout = _fleet_timeout()
        q = f"?last_ms={last_ms}" if last_ms is not None else ""
        peers = []
        for t in fleet_mod.peer_targets(observe, app.config):
            entry: dict = {"name": t["name"], "offset_s": t["offset_s"],
                           "uncertainty_s": t["uncertainty_s"]}
            url = t.get("debug_url")
            if not url:
                entry["error"] = "no debug url learned yet"
            else:
                try:
                    entry["trace"] = fleet_mod.fetch_json(
                        url, "/debug/timeline" + q, timeout_s=timeout)
                    entry["wide"] = fleet_mod.fetch_json(
                        url, "/debug/events?event=request&n=2048",
                        timeout_s=timeout).get("events", [])
                except Exception as e:  # noqa: BLE001 — degraded, typed
                    entry.pop("trace", None)
                    entry["error"] = repr(e)
            peers.append(entry)
        local_wide = observe.recorder.events(limit=2048, event="request")
        return fleet_mod.merge_traces(
            app.container.app_name,
            observe.timeline.chrome_trace(last_ms=last_ms),
            local_wide, peers)

    def request_page(req, w) -> None:
        """``/debug/request?trace_id=...``: one request's cross-process
        story — the local wide-event buffer plus every reachable
        peer's, with the clock estimates that relate their timestamps.
        Partial on peer failure (typed ``degraded`` entries), never a
        500."""
        trace_id = req.param("trace_id")
        if not trace_id:
            return _json(w, {"error": "trace_id is required"}, 400)
        from . import fleet as fleet_mod

        peers = fleet_mod.peer_targets(observe, app.config)
        payload = fleet_mod.assemble_request(
            trace_id, app.container.app_name, observe.recorder, peers,
            timeout_s=_fleet_timeout())
        clock = getattr(observe, "clock", None)
        if clock is not None:
            payload["clock"] = clock.stats()
        _json(w, payload)

    def vars_page(req, w) -> None:
        payload: dict = {
            "app": {
                "name": app.container.app_name,
                "version": app.container.app_version,
                "http_port": app.http_port,
                "metrics_port": app.metrics_port,
                "threads": threading.active_count(),
                "python": sys.version.split()[0],
            },
            "config": _redact_config(app.config),
            "devices": _device_topology(app.container.device),
            "inflight": len(observe.requests),
            "recorder": observe.recorder.stats(),
        }
        tl = getattr(observe, "timeline", None)
        if tl is not None:
            payload["timeline"] = tl.stats()
        # tail-sampler visibility: buffered/kept/dropped by reason +
        # linger sweeps — only present when tracing exports through one
        sampler = getattr(getattr(observe, "tracer", None), "exporter",
                          None)
        if sampler is not None and hasattr(sampler, "stats"):
            try:
                payload["trace_sampler"] = sampler.stats()
            except Exception:
                pass
        clock = getattr(observe, "clock", None)
        if clock is not None:
            cs = clock.stats()
            if cs:
                payload["fleet_clock"] = cs
        # per-subsystem declared device bytes (hbm accounting — the
        # same figures the app_tpu_device_bytes gauges export)
        try:
            payload["device_memory"] = hbm.live_bytes()
            # the arbiter's live lease/reclaim table (budget, per-lease
            # priority class + reclaimability, shed and reclaim
            # counters) — empty when no budget is set and nothing has
            # leased
            arb = hbm.arbiter_stats()
            if arb["budget_bytes"] or arb["leases"]:
                payload["hbm_arbiter"] = arb
        except Exception:
            pass
        tpu = app.container.tpu
        if tpu is not None:
            engine: dict = {
                "model": tpu.model_name,
                "programs": sorted(getattr(tpu, "_programs", {})),
                "batchers": {
                    name: {"queue_depth": b.queue_depth(),
                           "max_batch": b.max_batch,
                           "max_delay": b.max_delay}
                    for name, b in getattr(tpu, "_batchers", {}).items()},
            }
            if tpu.generator is not None:
                engine["generator"] = tpu.generator.stats()
            payload["tpu"] = engine
        _json(w, payload)

    def cache_page(req, w) -> None:
        """Prefix-KV-cache introspection: per-tier entries/bytes/hits/
        misses/evictions and the aggregate hit ratio (the TTFT lever —
        every hit replaces a prefill dispatch with a row copy)."""
        tpu = app.container.tpu
        gen = getattr(tpu, "generator", None) if tpu is not None else None
        stats = gen.kvcache_stats() if gen is not None else None
        payload = {"enabled": stats is not None, "cache": stats}
        if req.param("format") == "json" or stats is None:
            return _json(w, payload)
        tiers = stats.get("tiers", {})
        cols = ("entries", "hits", "misses", "evictions", "bytes",
                "blocks_put", "blocks_got", "errors")
        rows = "".join(
            "<tr><td>{t}</td>{cells}</tr>".format(
                t=html.escape(t),
                cells="".join(f"<td>{html.escape(str(d.get(c, '-')))}</td>"
                              for c in cols))
            for t, d in tiers.items())
        ratio = stats.get("hit_ratio")
        _html(w, "prefix kv cache", (
            "<h2>prefix KV cache ({kind})</h2>"
            "<p>entries={entries} hits={hits} misses={misses} "
            "hit_ratio={ratio}</p>"
            "<table><tr><th>tier</th>{heads}</tr>{rows}</table>"
            '<p><a href="/debug/cache?format=json">json</a></p>').format(
                kind=html.escape(str(stats.get("kind", "?"))),
                entries=stats.get("entries"), hits=stats.get("hits"),
                misses=stats.get("misses"),
                ratio="-" if ratio is None else f"{ratio:.3f}",
                heads="".join(f"<th>{c}</th>" for c in cols), rows=rows))

    def profile_page(req, w) -> None:
        try:
            seconds = float(req.param("seconds", "1"))
            hz = float(req.param("hz", "100"))
        except ValueError:
            return _json(w, {"error": "seconds/hz must be numbers"}, 400)
        if seconds < 0 or seconds > MAX_PROFILE_SECONDS:
            return _json(
                w, {"error": f"seconds must be in [0, {MAX_PROFILE_SECONDS}]"},
                400)
        if not 0 < hz <= MAX_PROFILE_HZ:
            # an unbounded rate would turn the sampler's sleep into a
            # busy-spin that holds the GIL for the whole window
            return _json(w, {"error": f"hz must be in (0, {MAX_PROFILE_HZ}]"},
                         400)
        if not _profile_lock.acquire(blocking=False):
            return _json(w, {"error": "a profile is already running"}, 409)
        try:
            counts = profiler.collect_profile(seconds=seconds, hz=hz)
        finally:
            _profile_lock.release()
        w.set_header("Content-Type", "text/plain; charset=utf-8")
        w.set_header("X-Profile-Samples", str(sum(counts.values())))
        w.write(profiler.render_collapsed(counts).encode())

    router.add("GET", "/debug", index)
    router.add("GET", "/debug/requests", requests_page)
    router.add("GET", "/debug/events", events_page)
    router.add("GET", "/debug/timeline", timeline_page)
    router.add("GET", "/debug/request", request_page)
    router.add("GET", "/debug/vars", vars_page)
    router.add("GET", "/debug/cache", cache_page)
    router.add("GET", "/debug/pprof/profile", profile_page)
