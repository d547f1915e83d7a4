"""Serving timeline profiler: an always-on, bounded ring of schedule
events with a Chrome-trace/Perfetto exporter.

The port's own copy of gofr_tpu/observe/timeline.py (the port imports
nothing of the JAX package).

The scheduler PRs ahead of this one (unified HBM arbiter, disaggregated
prefill/decode, prefix-affinity gateway) are all debugged by looking at
ONE serving window and asking "which slot ran which chunk when, and why
did that latency probe wait?". Metrics aggregate that answer away and
spans cost a dict + an export per interval — too heavy for per-block
hot-path emission. This module is the step-level timeline the
vLLM/SGLang-class schedulers became debuggable with:

  - A preallocated ring of fixed-shape event tuples. Appending is one
    ``itertools.count`` tick plus one slot assignment — no allocation
    beyond the tuple, no lock (the counter and the slot write are each
    atomic under the GIL; a torn *pair* only means one event lands in a
    slot a concurrent writer also claimed, and the exporter's
    seq-ordering pass tolerates that). Target: well under a
    microsecond per event; ``TPU_TIMELINE=0`` turns emission off
    entirely (hot paths hold a ``None`` handle, one attribute test).
  - Event kinds cover the serving schedule end to end: per-slot decode
    blocks, speculative verify passes, prefill dispatches and
    chunk-lattice slices (chunk index + length), predict batch
    dispatches, admission / shed / expiry decisions, kvcache tier
    hits, and ``app_tpu_device_bytes`` counter samples fanned out by
    ``tpu/hbm.py``.
  - ``chrome_trace()`` renders the ring as Chrome-trace JSON ("JSON
    Array Format" with ``traceEvents``) that Perfetto / chrome://tracing
    load directly: one track per decode slot, a scheduler track for
    instant decisions, a predict track per program, and one counter
    track per HBM subsystem. ``/debug/timeline?last_ms=N`` serves it
    from the metrics port; ``tools/timeline_dump.py`` fetches or
    self-hosts it.

Event tuple layout (fixed 8-slot, index-stable for the exporter):

    (seq, ts_monotonic_s, dur_s | None, kind, a, b, c, d)

``dur_s`` is None for instant and counter events. The per-kind payload
conventions live in ``_EXPANDERS`` below; emitters outside this module
go through the typed helpers (``decode_block``, ``chunk`` …) so the
conventions have one writer.
"""

from __future__ import annotations

import itertools
import os
import time

__all__ = ["Timeline", "timeline_from_config"]

# track ids inside the single "serving" process of the exported trace
_TID_SCHED = 1          # admission / shed / expiry decisions
_TID_DEVICE = 2         # device-stream dispatch gaps (idle windows)
_TID_SLOT0 = 10         # decode slot i -> tid 10 + i
_TID_PREDICT0 = 1000    # predict program tracks, assigned in export order

_FALSEY = {"0", "false", "off", "no", "disabled"}


def _enabled_from_env() -> bool:
    return os.environ.get("TPU_TIMELINE", "").strip().lower() not in _FALSEY


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class Timeline:
    """Bounded ring of serving-schedule events.

    ``capacity`` rounds up to a power of two (the append indexes with a
    mask, not a modulo). ``enabled=False`` turns every append into an
    immediate return — but hot paths should hold ``None`` instead of a
    disabled timeline so the off cost is one attribute test at the
    call site (see ``GenerationEngine.__init__``)."""

    # __weakref__: tpu/hbm.py holds attached timelines in a WeakSet
    __slots__ = ("capacity", "enabled", "_buf", "_mask", "_seq",
                 "_epoch_mono", "_epoch_wall", "__weakref__")

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        if capacity < 2:
            raise ValueError("capacity must be >= 2")
        self.capacity = _pow2_at_least(int(capacity))
        self.enabled = bool(enabled)
        # a DISABLED timeline never touches its ring (append returns
        # first), so don't preallocate 64k slots for a feature that is
        # off; the 2-slot stub keeps a stray post-construction
        # enabled=True flip degraded-but-safe instead of crashing
        n = self.capacity if self.enabled else 2
        self._mask = n - 1
        self._buf: list = [None] * n
        self._seq = itertools.count()
        # monotonic<->wall anchor so exported events can be joined
        # against exemplar timestamps and log lines
        self._epoch_mono = time.monotonic()
        self._epoch_wall = time.time()

    # -- the hot append ------------------------------------------------------
    def append(self, kind: str, ts: float, dur, a=None, b=None, c=None,
               d=None) -> None:
        if not self.enabled:
            return
        i = next(self._seq)
        self._buf[i & self._mask] = (i, ts, dur, kind, a, b, c, d)

    # -- typed emitters (one writer for the payload conventions) -------------
    def decode_block(self, t0: float, t1: float, slots, steps: int) -> None:
        """One fused decode dispatch->reap: ``slots`` is the tuple of
        active slot indices as dispatched, ``steps`` the block size."""
        self.append("decode", t0, t1 - t0, slots, steps)

    def verify_block(self, t0: float, t1: float, slots, window: int) -> None:
        self.append("verify", t0, t1 - t0, slots, window)

    def prefill(self, t0: float, t1: float, slot: int, prompt_len: int,
                request_id, trace_id: str) -> None:
        self.append("prefill", t0, t1 - t0, slot, prompt_len, request_id,
                    trace_id)

    def chunk(self, t0: float, t1: float, slot: int, index: int,
              length: int, request_id) -> None:
        """One mid-chunk dispatch of a chunk-lattice admission (host
        dispatch slice; the device work runs async behind it)."""
        self.append("chunk", t0, t1 - t0, slot, index, length, request_id)

    def predict(self, t0: float, t1: float, program: str, size: int) -> None:
        self.append("predict", t0, t1 - t0, program, size)

    def dispatch_gap(self, t0: float, t1: float) -> None:
        """One inter-block host-dispatch gap: the device stream ran dry
        at ``t0`` (a fused block's outputs came ready with no successor
        queued) and the next dispatch landed at ``t1``. The pipelined
        loop's whole job is keeping this track EMPTY during steady
        decode — a Perfetto window makes the overlap (or its absence)
        visible at a glance."""
        self.append("gap", t0, t1 - t0)

    def pipeline_depth(self, depth: int) -> None:
        """Counter sample: fused decode blocks in flight after a
        pipeline top-up (the Perfetto twin of app_tpu_pipeline_depth)."""
        self.append("depth", time.monotonic(), None, depth)

    def admit(self, slot: int, slo_class: str, wait_s: float,
              request_id, trace_id: str = "") -> None:
        self.append("admit", time.monotonic(), None, slot, slo_class,
                    (request_id, round(wait_s, 6)), trace_id)

    def shed(self, program: str, slo_class: str, trace_id: str = "") -> None:
        self.append("shed", time.monotonic(), None, program, slo_class,
                    trace_id)

    def expired(self, where: str, request_id=None, count: int = 1) -> None:
        self.append("expired", time.monotonic(), None, where, request_id,
                    count)

    def kvcache(self, tier: str, tokens: int, slot: int) -> None:
        self.append("kvcache", time.monotonic(), None, tier, tokens, slot)

    def hbm(self, subsystem: str, nbytes: float) -> None:
        self.append("hbm", time.monotonic(), None, subsystem, nbytes)

    def hbm_event(self, subsystem: str, what: str,
                  nbytes: float = 0.0) -> None:
        """Arbiter decision instant (reclaim/shed) alongside the
        subsystem's ``hbm:*`` counter track — a Perfetto window shows
        WHY a counter stepped down (reclaim) or a request 429'd
        (shed) at that timestamp."""
        self.append("hbm_event", time.monotonic(), None, subsystem, what,
                    nbytes)

    # -- read side -----------------------------------------------------------
    def events(self, last_ms: float | None = None) -> list[tuple]:
        """Seq-ordered snapshot of the live ring (oldest first),
        optionally restricted to the trailing ``last_ms`` window.
        Concurrent appends may race the snapshot; per-slot entries are
        immutable tuples, so a racer only replaces whole entries —
        sorting by seq and dropping Nones always yields a consistent
        (if slightly stale) view."""
        snap = [e for e in list(self._buf) if e is not None]
        snap.sort(key=lambda e: e[0])
        if last_ms is not None:
            cut = time.monotonic() - last_ms / 1e3
            snap = [e for e in snap if e[1] >= cut]
        return snap

    def stats(self) -> dict:
        # itertools.count has no non-consuming peek: derive the total
        # from the newest live seq instead of burning a counter tick
        live = sum(1 for e in self._buf if e is not None)
        newest = max((e[0] for e in self._buf if e is not None), default=-1)
        return {
            "enabled": self.enabled,
            "capacity": self.capacity,
            "buffered": live,
            "total_recorded": newest + 1,
            "dropped": max(0, newest + 1 - live),
        }

    def wall_time(self, ts_mono: float) -> float:
        """Map a ring timestamp (monotonic) to wall-clock seconds."""
        return self._epoch_wall + (ts_mono - self._epoch_mono)

    # -- Chrome-trace / Perfetto export --------------------------------------
    def chrome_trace(self, last_ms: float | None = None) -> dict:
        """Render the ring as Chrome-trace JSON. Load the result in
        Perfetto (ui.perfetto.dev) or chrome://tracing: decode slots
        are threads, scheduler decisions are instants, HBM subsystems
        are counter tracks. Timestamps are microseconds on the
        process-monotonic clock."""
        events = self.events(last_ms=last_ms)
        out: list[dict] = [
            {"ph": "M", "pid": 1, "name": "process_name",
             "args": {"name": "gofr-tpu serving"}},
            {"ph": "M", "pid": 1, "tid": _TID_SCHED, "name": "thread_name",
             "args": {"name": "scheduler"}},
            {"ph": "M", "pid": 1, "tid": _TID_SCHED,
             "name": "thread_sort_index", "args": {"sort_index": 0}},
            {"ph": "M", "pid": 1, "tid": _TID_DEVICE, "name": "thread_name",
             "args": {"name": "device stream"}},
            {"ph": "M", "pid": 1, "tid": _TID_DEVICE,
             "name": "thread_sort_index", "args": {"sort_index": 1}},
        ]
        named_slots: set[int] = set()
        predict_tids: dict[str, int] = {}

        def slot_tid(slot: int) -> int:
            tid = _TID_SLOT0 + int(slot)
            if slot not in named_slots:
                named_slots.add(slot)
                out.append({"ph": "M", "pid": 1, "tid": tid,
                            "name": "thread_name",
                            "args": {"name": f"slot {int(slot)}"}})
                out.append({"ph": "M", "pid": 1, "tid": tid,
                            "name": "thread_sort_index",
                            "args": {"sort_index": 10 + int(slot)}})
            return tid

        def program_tid(program: str) -> int:
            tid = predict_tids.get(program)
            if tid is None:
                tid = _TID_PREDICT0 + len(predict_tids)
                predict_tids[program] = tid
                out.append({"ph": "M", "pid": 1, "tid": tid,
                            "name": "thread_name",
                            "args": {"name": f"predict:{program}"}})
            return tid

        body: list[dict] = []
        for seq, ts, dur, kind, a, b, c, d in events:
            us = ts * 1e6
            if kind in ("decode", "verify"):
                # fan one dispatch out to a slice per active slot — the
                # per-slot view is what makes slot occupancy readable
                label = (f"decode x{b}" if kind == "decode"
                         else f"verify w{b}")
                for slot in (a or ()):
                    body.append({"ph": "X", "pid": 1, "tid": slot_tid(slot),
                                 "name": label, "cat": kind, "ts": us,
                                 "dur": max(dur, 0.0) * 1e6,
                                 "args": {"slots": len(a or ()),
                                          "steps": b, "seq": seq}})
            elif kind == "prefill":
                body.append({"ph": "X", "pid": 1, "tid": slot_tid(a),
                             "name": f"prefill L={b}", "cat": "prefill",
                             "ts": us, "dur": max(dur, 0.0) * 1e6,
                             "args": {"prompt_len": b, "request_id": c,
                                      "trace_id": d, "seq": seq}})
            elif kind == "chunk":
                body.append({"ph": "X", "pid": 1, "tid": slot_tid(a),
                             "name": f"chunk {b} ({c} tok)", "cat": "chunk",
                             "ts": us, "dur": max(dur, 0.0) * 1e6,
                             "args": {"chunk_index": b, "chunk_len": c,
                                      "request_id": d, "seq": seq}})
            elif kind == "predict":
                body.append({"ph": "X", "pid": 1, "tid": program_tid(a),
                             "name": f"{a} B={b}", "cat": "predict",
                             "ts": us, "dur": max(dur, 0.0) * 1e6,
                             "args": {"batch": b, "seq": seq}})
            elif kind == "admit":
                rid, wait_s = c if isinstance(c, tuple) else (c, None)
                body.append({"ph": "i", "s": "t", "pid": 1,
                             "tid": slot_tid(a), "name": "admit",
                             "cat": "sched", "ts": us,
                             "args": {"slo_class": b, "request_id": rid,
                                      "wait_s": wait_s, "trace_id": d,
                                      "seq": seq}})
            elif kind == "shed":
                body.append({"ph": "i", "s": "t", "pid": 1,
                             "tid": _TID_SCHED, "name": f"shed {a}",
                             "cat": "sched", "ts": us,
                             "args": {"program": a, "slo_class": b,
                                      "trace_id": c, "seq": seq}})
            elif kind == "expired":
                body.append({"ph": "i", "s": "t", "pid": 1,
                             "tid": _TID_SCHED, "name": f"expired {a}",
                             "cat": "sched", "ts": us,
                             "args": {"where": a, "request_id": b,
                                      "count": c, "seq": seq}})
            elif kind == "kvcache":
                body.append({"ph": "i", "s": "t", "pid": 1,
                             "tid": slot_tid(c), "name": f"kvcache {a}",
                             "cat": "kvcache", "ts": us,
                             "args": {"tier": a, "tokens": b, "seq": seq}})
            elif kind == "gap":
                body.append({"ph": "X", "pid": 1, "tid": _TID_DEVICE,
                             "name": "dispatch gap", "cat": "gap",
                             "ts": us, "dur": max(dur, 0.0) * 1e6,
                             "args": {"seq": seq}})
            elif kind == "depth":
                body.append({"ph": "C", "pid": 1, "name": "pipeline_depth",
                             "ts": us, "args": {"depth": a}})
            elif kind == "hbm":
                body.append({"ph": "C", "pid": 1, "name": f"hbm:{a}",
                             "ts": us, "args": {"bytes": b}})
            elif kind == "hbm_event":
                body.append({"ph": "i", "s": "t", "pid": 1,
                             "tid": _TID_SCHED, "name": f"hbm:{a} {b}",
                             "cat": "hbm", "ts": us,
                             "args": {"subsystem": a, "what": b,
                                      "bytes": c, "seq": seq}})
            else:  # unknown kind: surface, never drop silently
                body.append({"ph": "i", "s": "t", "pid": 1,
                             "tid": _TID_SCHED, "name": str(kind),
                             "cat": "other", "ts": us,
                             "args": {"a": a, "b": b, "c": c, "d": d,
                                      "seq": seq}})
        body.sort(key=lambda e: e["ts"])
        return {"traceEvents": out + body, "displayTimeUnit": "ms",
                "otherData": {"clock": "monotonic",
                              "epoch_wall_s": self._epoch_wall,
                              "epoch_mono_s": self._epoch_mono,
                              **self.stats()}}


def timeline_from_config(cfg) -> Timeline:
    """Build the container's timeline from config: ``TPU_TIMELINE``
    (default on; 0/false/off disables emission — the ring still exists
    so ``/debug/timeline`` reports its state) and
    ``TPU_TIMELINE_EVENTS`` (ring capacity, default 65536, rounded up
    to a power of two)."""
    raw = cfg.get("TPU_TIMELINE")
    enabled = (raw or "").strip().lower() not in _FALSEY if raw \
        else _enabled_from_env()
    try:
        capacity = int(cfg.get("TPU_TIMELINE_EVENTS") or 65536)
    except (TypeError, ValueError):
        capacity = 65536
    return Timeline(capacity=max(2, capacity), enabled=enabled)
