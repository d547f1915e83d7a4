"""Fleet timeline merge + cross-process request assembly.

The port's own copy of gofr_tpu/observe/fleet.py (the port imports
nothing of the JAX package).

The per-process observability surfaces (``/debug/timeline``,
``/debug/events``, the wide events) each tell one process's story. This
module stitches them: it re-bases every peer's chrome-trace export onto
the LOCAL clock axis using the :mod:`~gofr_tpu_torch.observe.clock` offset
estimates, groups each process under its own Perfetto track group
(pid), and draws flow arrows between the hop points of any trace id
that appears in more than one process — so one Perfetto load answers
"where did this request's 300 ms go" across the gateway, the prefill
pool, and the decode pool.

Degradation contract: a peer that is down, slow, or unaligned NEVER
breaks the merge — its absence (or unaligned placement) is reported as
a typed entry in ``otherData.fleet.degraded`` and everything reachable
still renders. The same contract holds for ``/debug/request``:
:func:`assemble_request` returns a partial story plus degraded markers,
never an error.
"""

from __future__ import annotations

import json
import urllib.request

__all__ = ["assemble_request", "fetch_json", "merge_traces",
           "parse_obs_peers", "peer_targets"]

#: the per-process track the merged view draws request slices + flow
#: arrows on (the per-process timelines keep 1=scheduler, 2=device,
#: 10+=slots; 3 is free in every exporter in-tree)
_TID_HOPS = 3

#: merged-view pid of the local process; peers get 2, 3, ...
_PID_LOCAL = 1


def fetch_json(base_url: str, path: str, timeout_s: float = 2.0):
    """GET ``base_url + path`` and parse JSON. Raises on any transport
    or parse failure — callers convert to typed degraded markers."""
    url = base_url.rstrip("/") + path
    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return json.loads(r.read())


def parse_obs_peers(spec: str | None) -> list[tuple[str, str]]:
    """``TPU_OBS_PEERS`` -> [(name, debug_base_url)]. Entries are
    ``name=http://host:port`` (or a bare URL, named by its authority);
    malformed entries raise — a typo'd observability peer list should
    fail loudly at the first fleet query, not silently merge less."""
    out: list[tuple[str, str]] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, url = part.partition("=")
        if not eq:
            name, url = "", part
        url = url.strip()
        if not url.startswith("http://") and not url.startswith("https://"):
            url = "http://" + url
        if not name:
            name = url.split("//", 1)[1].rstrip("/")
        out.append((name.strip(), url.rstrip("/")))
    return out


def peer_targets(observe, cfg=None) -> list[dict]:
    """The fleet's peer list as the merge/assembly layers consume it:
    every clock-registry peer (discovered from the pd handshake and the
    gateway health poll) plus any explicit ``TPU_OBS_PEERS`` rows."""
    clock = getattr(observe, "clock", None)
    if clock is None:
        return []
    if cfg is not None:
        spec = cfg.get("TPU_OBS_PEERS")
        if spec:
            for name, url in parse_obs_peers(spec):
                clock.note_peer(name, debug_url=url)
    out = []
    for name, pc in sorted(clock.peers().items()):
        out.append({"name": name, "debug_url": pc.debug_url,
                    "offset_s": pc.offset_s(),
                    "uncertainty_s": pc.uncertainty_s(),
                    "aligned": pc.aligned})
    return out


# -- the merge ---------------------------------------------------------------

def _epochs(trace: dict) -> tuple[float, float] | None:
    other = trace.get("otherData") or {}
    wall = other.get("epoch_wall_s")
    mono = other.get("epoch_mono_s")
    if wall is None or mono is None:
        return None
    return float(wall), float(mono)


def _wall_to_local_us(wall_s: float, offset_s: float,
                      local_epochs: tuple[float, float]) -> float:
    """A (peer) wall timestamp -> microseconds on the local monotonic
    axis every local trace event already uses."""
    lw, lm = local_epochs
    return (lm + (wall_s - offset_s - lw)) * 1e6


def merge_traces(local_name: str, local_trace: dict,
                 local_wide: list[dict], peers: list[dict]) -> dict:
    """Merge the local chrome trace with each peer's into one Perfetto
    file on the LOCAL clock axis.

    ``peers`` entries: ``{"name", "offset_s", "uncertainty_s",
    "trace": chrome_trace | None, "wide": [wide request events],
    "error": str | None}`` — an entry with ``trace=None`` (peer down)
    or ``offset_s=None`` (no clock samples yet) contributes a typed
    degraded marker instead of events.
    """
    local_epochs = _epochs(local_trace)
    events: list[dict] = []
    degraded: list[dict] = []
    processes: list[dict] = []

    def add_process(pid: int, name: str, trace: dict,
                    offset_s: float) -> None:
        epochs = _epochs(trace)
        for e in trace.get("traceEvents", []):
            e = dict(e)
            e["pid"] = pid
            if e.get("ph") == "M" and e.get("name") == "process_name":
                e["args"] = {"name": name}
            elif pid != _PID_LOCAL and epochs is not None \
                    and local_epochs is not None and "ts" in e:
                # peer mono ts -> peer wall -> local axis
                wall = epochs[0] + (e["ts"] / 1e6 - epochs[1])
                e["ts"] = _wall_to_local_us(wall, offset_s, local_epochs)
            events.append(e)

    add_process(_PID_LOCAL, local_name, local_trace, 0.0)
    processes.append({"name": local_name, "pid": _PID_LOCAL,
                      "offset_s": 0.0, "uncertainty_s": 0.0})

    # hop points: (trace_id, local ts_us, pid, wide event) per process
    hops: dict[str, list[tuple[float, int, dict]]] = {}

    def add_hops(pid: int, offset_s: float, wide: list[dict]) -> None:
        if local_epochs is None:
            return
        for ev in wide or []:
            tid = ev.get("trace_id")
            wall = ev.get("submit_wall_s")
            if not tid or wall is None:
                continue
            ts = _wall_to_local_us(float(wall), offset_s, local_epochs)
            hops.setdefault(tid, []).append((ts, pid, ev))

    add_hops(_PID_LOCAL, 0.0, local_wide)

    next_pid = _PID_LOCAL + 1
    for peer in peers:
        name = peer.get("name", "?")
        if peer.get("error"):
            degraded.append({"peer": name, "reason": "unreachable",
                             "error": peer["error"]})
            continue
        trace = peer.get("trace")
        if not trace:
            degraded.append({"peer": name, "reason": "no-trace"})
            continue
        offset = peer.get("offset_s")
        if offset is None:
            # no clock samples: merge on the raw wall clock and SAY so
            # — unaligned beats invisible, but only when labeled
            degraded.append({"peer": name, "reason": "unaligned"})
            offset = 0.0
        pid = next_pid
        next_pid += 1
        add_process(pid, name, trace, float(offset))
        add_hops(pid, float(offset), peer.get("wide") or [])
        processes.append({"name": name, "pid": pid,
                          "offset_s": peer.get("offset_s"),
                          "uncertainty_s": peer.get("uncertainty_s")})

    # request slices on each process's hops track + flow arrows joining
    # the SAME trace id across processes (s -> t ... -> f)
    named_hop_tracks: set[int] = set()
    flows = 0
    for tid, points in sorted(hops.items()):
        points.sort(key=lambda p: p[0])
        multi = len({pid for _, pid, _ in points}) > 1
        for i, (ts, pid, ev) in enumerate(points):
            if pid not in named_hop_tracks:
                named_hop_tracks.add(pid)
                events.append({"ph": "M", "pid": pid, "tid": _TID_HOPS,
                               "name": "thread_name",
                               "args": {"name": "requests"}})
                events.append({"ph": "M", "pid": pid, "tid": _TID_HOPS,
                               "name": "thread_sort_index",
                               "args": {"sort_index": 2}})
            dur_s = ev.get("duration_s") or 0.0
            events.append({
                "ph": "X", "pid": pid, "tid": _TID_HOPS,
                "name": f"req {tid[:8]}", "cat": "request", "ts": ts,
                "dur": max(float(dur_s), 1e-4) * 1e6,
                "args": {"trace_id": tid,
                         "outcome": ev.get("outcome"),
                         "breakdown": ev.get("breakdown")}})
            if multi:
                ph = "s" if i == 0 else ("f" if i == len(points) - 1
                                         else "t")
                flow: dict = {"ph": ph, "pid": pid, "tid": _TID_HOPS,
                              "name": "request-hop", "cat": "request",
                              "id": abs(hash(tid)) & 0x7FFFFFFF,
                              "ts": ts + 1}
                if ph == "f":
                    flow["bp"] = "e"
                events.append(flow)
                flows += 1

    meta = [e for e in events if e.get("ph") == "M"]
    body = sorted((e for e in events if e.get("ph") != "M"),
                  key=lambda e: e.get("ts", 0))
    return {"traceEvents": meta + body, "displayTimeUnit": "ms",
            "otherData": {"clock": "local-monotonic",
                          "fleet": {"processes": processes,
                                    "degraded": degraded,
                                    "flow_events": flows,
                                    "traces_joined": sum(
                                        1 for pts in hops.values()
                                        if len({p for _, p, _ in pts})
                                        > 1)}}}


# -- single-request assembly (/debug/request) --------------------------------

def _request_events(events: list[dict], trace_id: str) -> list[dict]:
    return [e for e in events
            if e.get("event") == "request" and e.get("trace_id") == trace_id]


def assemble_request(trace_id: str, local_name: str, recorder,
                     peers: list[dict], timeout_s: float = 2.0) -> dict:
    """The cross-process story of ONE trace id: the local wide-event
    buffer plus every reachable peer's, joined with the clock estimate
    that places each process's timestamps on the local axis. Peers that
    fail contribute typed ``degraded`` entries — the answer is partial,
    never a 500."""
    stories = [{"process": local_name, "source": "local",
                "events": _request_events(
                    recorder.events(event="request"), trace_id)}]
    degraded: list[dict] = []
    for peer in peers:
        name = peer.get("name", "?")
        url = peer.get("debug_url")
        if not url:
            degraded.append({"peer": name, "reason": "no-debug-url"})
            continue
        try:
            payload = fetch_json(url, "/debug/events?event=request&n=2048",
                                 timeout_s=timeout_s)
            evs = _request_events(payload.get("events", []), trace_id)
        except Exception as e:  # noqa: BLE001 — typed degraded, never a 500
            degraded.append({"peer": name, "reason": "unreachable",
                             "error": repr(e)})
            continue
        if not peer.get("aligned"):
            degraded.append({"peer": name, "reason": "unaligned"})
        stories.append({"process": name, "source": "peer",
                        "events": evs,
                        "clock": {"offset_s": peer.get("offset_s"),
                                  "uncertainty_s":
                                      peer.get("uncertainty_s")}})
    found = sum(len(s["events"]) for s in stories)
    return {"trace_id": trace_id, "found": found, "stories": stories,
            "degraded": degraded, "partial": bool(degraded)}
