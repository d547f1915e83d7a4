"""The App's ``/debug`` pages on the metrics server (the port's
counterpart of gofr_tpu/observe/debug.py, reduced to ``/debug/cache``:
the prefix KV cache's stats as JSON, or as an HTML table by default;
and ``/debug/vars``, reduced to the memory arbiter's sections:
``device_memory``, the declared device bytes by subsystem, and
``hbm_arbiter``, its budget and lease table).
"""

from __future__ import annotations

import html
import json

from ..tpu import hbm


def _json(w, payload) -> None:
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
    """Register the /debug pages on ``router`` (the metrics router);
    ``app`` is the App, whose container holds the engine."""

    def cache_page(req, w) -> None:
        """Prefix-KV-cache introspection: entries/hits/misses/evictions
        by tier and the aggregate hit ratio (the TTFT lever: every hit
        skips the prefill of its shared blocks)."""
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

    router.add("GET", "/debug/cache", cache_page)

    def vars_page(req, w) -> None:
        """The memory arbiter's live state: the per-subsystem declared
        bytes (the figures the app_tpu_device_bytes gauges export) and
        the lease/reclaim table (budget, per-lease priority class and
        reclaimability, shed and reclaim counters), present once a
        budget is set or anything has leased."""
        payload: dict = {"device_memory": hbm.live_bytes()}
        arb = hbm.arbiter_stats()
        if arb["budget_bytes"] or arb["leases"]:
            payload["hbm_arbiter"] = arb
        _json(w, payload)

    router.add("GET", "/debug/vars", vars_page)
