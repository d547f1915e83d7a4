"""Prefill-side coordinator: the client half of disaggregated serving
(the port's own copy of gofr_tpu/pd/prefill.py).

A prefill worker (``TPU_SERVING_ROLE=prefill``) runs ONLY prefill
compute: each ``generate`` call admits through the local engine's
normal gate/deadline/SLO machinery in KV-only mode (the chunk lattice
runs, the first token samples, no decode slot is held past the
prefill), ships the slot's KV to the decode peer as checksummed int8
block frames — streamed per ship block as prefill chunks complete, so
the peer's host-side assembly overlaps this worker's compute — and
relays the decode worker's token stream back to the client through a
``RelayStream`` (a ``PushStream``: the transports' zero-handoff sink
protocol works unchanged).

The failure contract mirrors the gate's shed discipline: a down or
mid-stream-lost decode peer surfaces as ``DecodePeerUnavailable``
(503 + Retry-After) — a SHED, not a failure — while this worker keeps
serving prefills and the reconnect backoff re-arms the path; decode-
side sheds (429), deadline expiries (504) and transfer faults (502)
arrive typed through the ERR relay and re-raise as themselves.
"""

from __future__ import annotations

import itertools
import json
import random
import socket
import threading
import time

import numpy as np

from .. import tracing
from ..errors import ConnectionLost, DeadlineExceeded, GofrError
from ..resilience import current_deadline, current_slo_class
from ..service.reconnect import ReconnectBackoff
from ..tpu.kvcache import KVLayout
from ..tpu.kvcache.quant import concat_blocks, encode_block
from ..wire import PushStream, observe_backlog
from . import protocol as p

_BACKOFF_S = 0.5
_BACKOFF_CAP_S = 15.0


class RelayStream(PushStream):
    """The client-facing stream of a P/D-split request: tokens pushed
    by the peer reader thread (or straight into a transport sink),
    terminals follow GenStream's convention (error then None). Carries
    the attribute surface transports read off GenStream (``trace``,
    ``prompt_len``, ``request_id``, ``cancel``, and the durable-stream
    fields ``seed`` / ``cursor_base`` / ``cache_tokens``).

    The stream OUTLIVES any one wire request: a decode-peer loss
    re-submits the same RelayStream under a fresh ``_wire_id`` (the
    re-handoff), so the client keeps reading one queue while the
    request changes wire identity underneath."""

    def __init__(self, request_id: int, owner: "PDPrefill",
                 logprobs: bool = False):
        super().__init__()
        self.request_id = request_id
        self._wire_id = request_id  # current wire req_id (re-handoffs bump)
        self.logprobs = logprobs
        self.prompt_len = 0
        self.trace: dict[str, float] = {}
        self.cancelled = threading.Event()
        self.failed: str | None = None
        self.seed: int | None = None
        self.cursor_base = 0       # client-replayed tokens before this stream
        self.cache_tokens = 0      # copied from the local prefill's stream
        self.emitted: list[int] = []  # tokens THIS stream delivered
        self.resumes = 0
        self.resume_info: dict | None = None  # everything a re-submit needs
        self._owner = owner
        self._local = None  # the prefill-side GenStream while it runs
        self._done = False

    def tokens(self) -> list[int]:
        return [t[0] if isinstance(t, tuple) else t for t in self]

    def cancel(self) -> None:
        self.cancelled.set()
        local = self._local
        if local is not None:
            local.cancel()
        self._owner._cancel(self._wire_id)


class _Shipper:
    """Accumulates the generator's KV-sink ranges and emits checksummed
    block frames (``quant.encode_block`` — the Redis tier's codec) in
    token order through the connection's windowed send path. Raises out
    of the sink on ship failure; the generator converts that into a
    per-request failure, never loop recovery."""

    def __init__(self, conn: p.Conn, req_id: int, block: int,
                 deadline=None, metrics=None):
        self.conn = conn
        self.req_id = req_id
        self.block = max(1, int(block))
        self.deadline = deadline
        self.metrics = metrics
        self.parts: list = []
        self.buffered = 0
        self.sent = 0
        self.frames = 0
        self.t_first: float | None = None  # first frame on the wire
        self.error: BaseException | None = None

    def _window_deadline(self) -> float:
        if self.deadline is not None:
            return max(0.05, min(30.0, self.deadline.remaining()))
        return 30.0

    def _emit(self, kv) -> None:
        if self.t_first is None:
            self.t_first = time.monotonic()
        frame = encode_block(kv)
        self.conn.send_windowed(p.pack_kv(self.req_id, self.sent, frame),
                                deadline_s=self._window_deadline())
        self.sent += kv.plen
        self.frames += 1
        observe_backlog(self.metrics, self.conn.pending_bytes(),
                        role="pd-prefill")
        if self.metrics is not None:
            try:
                self.metrics.increment_counter("app_tpu_pd_kv_frames_total",
                                               direction="out")
            except Exception:
                pass

    def ship(self, kv, start: int, total: int) -> None:
        """The generator's kv_sink: one host KV slab covering prompt
        positions [start, start+kv.plen) — called per prefill chunk,
        in order. Frames cut at ship-block boundaries; the trailing
        partial flushes in finish()."""
        try:
            if start != self.sent + self.buffered:
                raise p.KVTransferError(
                    f"kv ship discontinuity: range starts at {start}, "
                    f"expected {self.sent + self.buffered}")
            self.parts.append(kv)
            self.buffered += kv.plen
            if self.buffered < self.block:
                return
            merged = (self.parts[0] if len(self.parts) == 1
                      else concat_blocks(self.parts))
            off = 0
            while self.buffered - off >= self.block:
                self._emit(merged.slice_tokens(off, off + self.block))
                off += self.block
            self.parts = [merged.slice_tokens(off, self.buffered)] \
                if self.buffered > off else []
            self.buffered -= off
        except BaseException as e:
            self.error = e
            raise

    def finish(self) -> None:
        try:
            if self.parts:
                merged = (self.parts[0] if len(self.parts) == 1
                          else concat_blocks(self.parts))
                self._emit(merged)
                self.parts = []
                self.buffered = 0
        except BaseException as e:
            self.error = e
            raise
        # the wire segment of the critical path: first frame enqueue to
        # the final windowed send returning (histogram face of the
        # timeline's ship window)
        if self.metrics is not None and self.t_first is not None:
            try:
                self.metrics.record_histogram(
                    "app_tpu_pd_ship_duration",
                    time.monotonic() - self.t_first)
            except Exception:
                pass


class PDPrefill:
    """Coordinates KV-only prefill + ship + token relay against one
    decode peer. Thread model: ``generate`` runs on transport handler
    threads; the KV sink runs on the serving loop thread; one reader
    thread per connection dispatches TOK/END/ERR to RelayStreams; one
    finisher thread per request observes the local prefill's outcome
    and sends KV_EOF."""

    def __init__(self, generator, fingerprint: str, peer_host: str,
                 peer_port: int, *, logger=None, metrics=None,
                 ship_block: int = 16, window_bytes: int = 8 << 20,
                 connect_timeout_s: float = 3.0, resume: bool = True,
                 resume_max: int = 3, resume_wait_s: float = 5.0):
        self.gen = generator
        self.fingerprint = fingerprint
        self.peer = (peer_host, int(peer_port))
        self.logger = logger
        self.metrics = metrics
        self.ship_block = int(ship_block)
        self.window_bytes = int(window_bytes)
        self.connect_timeout_s = float(connect_timeout_s)
        self.resume = bool(resume)
        self.resume_max = max(0, int(resume_max))
        self.resume_wait_s = float(resume_wait_s)
        cache = generator.cache
        self.layout = KVLayout(
            generator.cfg.n_layers, generator.cfg.n_kv_heads,
            generator.cfg.head_dim, cache.k_scale is not None,
            cache.k.dtype, generator.max_seq)
        self._hello = p.hello_payload(fingerprint, self.layout)
        self._ids = itertools.count(1)
        self._conn: p.Conn | None = None
        self._conn_lock = threading.Lock()
        self._streams: dict[int, RelayStream] = {}
        self._streams_lock = threading.Lock()
        # one reconnect convention (service/reconnect.py): shared by
        # the connect path here and the reader-thread loss path
        self._reconnect = ReconnectBackoff(_BACKOFF_S, _BACKOFF_CAP_S)
        self._closed = False
        self._threads: list[threading.Thread] = []
        self._threads_lock = threading.Lock()
        self._peer_debug_url: str | None = None  # learned from HELLO_OK
        self.relayed = 0
        self.reconnects = 0
        self.peer_losses = 0
        self.resumed = 0

    def _note_peer_clock(self, t0, t1, t2, t3, debug_port=None) -> None:
        """Feed one NTP sample for the decode peer into the Observe
        bundle's clock registry — the handshake and every REQ->END round
        trip are free carriers. A no-op for an engine built without a
        bundle; the stamps still cross the wire both ways. Never raises
        into the serving path."""
        clock = getattr(getattr(self.gen, "_observe", None), "clock", None)
        if clock is None:
            return
        try:
            name = f"pd:{self.peer[0]}:{self.peer[1]}"
            if debug_port:
                self._peer_debug_url = \
                    f"http://{self.peer[0]}:{int(debug_port)}"
            if t0 is None or t1 is None or t2 is None:
                clock.note_peer(name, debug_url=self._peer_debug_url)
            else:
                clock.observe(name, float(t0), float(t1), float(t2),
                              float(t3), debug_url=self._peer_debug_url)
        except Exception:
            pass  # telemetry must never take the serving path down

    # -- connection management ----------------------------------------------
    @property
    def connected(self) -> bool:
        return self._conn is not None

    def _ensure_conn(self) -> p.Conn:
        conn = self._conn
        if conn is not None and not conn.closed:
            return conn
        if self._closed:
            raise p.DecodePeerUnavailable("pd prefill coordinator closed")
        blocked = self._reconnect.blocked()
        if blocked > 0:
            raise p.DecodePeerUnavailable(
                f"decode peer {self.peer[0]}:{self.peer[1]} in reconnect "
                "backoff", retry_after=blocked)
        with self._conn_lock:
            conn = self._conn
            if conn is not None and not conn.closed:
                return conn
            sock = None
            conn = None
            try:
                sock = socket.create_connection(
                    self.peer, timeout=self.connect_timeout_s)
                # the handshake stays under the SAME timeout: a peer
                # that accepts but never answers hello (stopped
                # process, wrong service) must not wedge this
                # generate() — and everyone behind _conn_lock — forever
                sock.settimeout(self.connect_timeout_s)
                conn = p.Conn(sock, window_bytes=self.window_bytes)
                t0 = time.time()
                conn.send(p.pack_json(p.HELLO, 0, self._hello), block=True)
                msg = p.read_msg(sock)
                t3 = time.time()
                if msg is None:
                    raise ConnectionLost("peer closed during hello")
                mtype, _, payload = msg
                if mtype == p.ERR:
                    err = p.error_from_wire(json.loads(bytes(payload)))
                    raise GofrError(f"decode peer refused hello: {err}")
                if mtype != p.HELLO_OK:
                    raise GofrError("unexpected hello reply")
                sock.settimeout(None)
                try:
                    reply = json.loads(bytes(payload)) if payload else {}
                except ValueError:
                    reply = {}  # pre-clock peer: HELLO_OK alone is fine
                # clock piggyback: the handshake IS an NTP exchange when
                # the peer stamped its receive/send times into HELLO_OK
                self._note_peer_clock(t0, reply.get("clock_t1"),
                                      reply.get("clock_t2"), t3,
                                      debug_port=reply.get("debug_port"))
            except GofrError:
                # a REFUSED hello is a configuration error (wrong model/
                # weights behind the address): no silent retry loop —
                # surface it and back off long. Close what we opened:
                # every failed attempt must cost zero fds.
                self._close_handshake(conn, sock)
                self._reconnect.hold()
                raise
            except Exception as e:  # noqa: BLE001 — down peer = shed
                self._close_handshake(conn, sock)
                retry = self._reconnect.failure()
                raise p.DecodePeerUnavailable(
                    f"decode peer {self.peer[0]}:{self.peer[1]} "
                    f"unreachable: {e!r}", retry_after=retry) from e
            self._reconnect.success()
            self._conn = conn
            self.reconnects += 1
            self._spawn(self._read_loop, (conn,), "gofr-pd-relay")
            if self.logger is not None:
                self.logger.info({"event": "pd decode peer connected",
                                  "peer": f"{self.peer[0]}:{self.peer[1]}"})
            return conn

    def _spawn(self, target, args: tuple, name: str) -> None:
        """Start one of the coordinator's threads (the reader, a
        finisher, a re-handoff waiter); ``close`` joins them, bounded."""
        t = threading.Thread(target=target, args=args, name=name,
                             daemon=True)
        with self._threads_lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()

    @staticmethod
    def _close_handshake(conn, sock) -> None:
        try:
            if conn is not None:
                conn.close()
            elif sock is not None:
                sock.close()
        except OSError:
            pass

    def _read_loop(self, conn: p.Conn) -> None:
        while True:
            msg = p.read_msg(conn.sock)
            if msg is None:
                break
            mtype, req_id, payload = msg
            with self._streams_lock:
                rs = self._streams.get(req_id)
            if rs is None:
                continue
            if mtype == p.TOK:
                tok, cursor, lp = p.unpack_tok(payload)
                # the resume contract's splice check: a token the
                # client already has (a re-handoff over-replaying)
                # is swallowed, never double-delivered
                if cursor < rs.cursor_base + len(rs.emitted):
                    continue
                if not rs.trace.get("first_put"):
                    rs.trace["first_put"] = time.monotonic()
                rs.emitted.append(int(tok))
                rs._push((tok, lp) if rs.logprobs else tok)
            elif mtype == p.END:
                t3 = time.time()
                try:
                    endp = json.loads(bytes(payload)) if payload else {}
                except ValueError:
                    endp = {}
                # per-request clock sample: REQ carried sent_wall, END
                # echoes it with the peer's receive/send stamps — the
                # NTP hold-time term (t2-t1) subtracts the whole decode,
                # so a busy pair converges one sample per request
                if endp.get("req_recv_wall") is not None:
                    self._note_peer_clock(
                        endp.get("req_sent_wall"),
                        endp.get("req_recv_wall"),
                        endp.get("end_sent_wall"), t3)
                if endp.get("breakdown"):
                    # the decode worker's segment view of this request,
                    # surfaced beside the local trace for /debug pages
                    rs.trace["peer_breakdown"] = endp["breakdown"]
                with self._streams_lock:
                    self._streams.pop(req_id, None)
                rs._done = True
                rs._push(None)
            elif mtype == p.ERR:
                err = p.error_from_wire(json.loads(bytes(payload)))
                with self._streams_lock:
                    self._streams.pop(req_id, None)
                rs.failed = str(err)
                rs._done = True
                rs._q.put(err)
                rs._q.put(None)
        self._on_conn_lost(conn)

    def _fail_stream(self, rs: RelayStream, err: BaseException) -> None:
        if rs._done:
            return
        rs.failed = str(err)
        rs._done = True
        rs._q.put(err)
        rs._q.put(None)

    def _on_conn_lost(self, conn: p.Conn) -> None:
        """The decode peer vanished (crash, kill, network). Relays with
        >= 1 delivered token RESUME (durable streams): a bounded waiter
        re-handshakes the peer — its restart, or a replacement behind
        the same address — and re-submits prompt+emitted as a
        continuation; the client's stream splices token-exact and never
        sees the loss. Relays with NOTHING delivered are SHED typed
        (503 + Retry-After) as before: the gateway's pre-commit
        failover owns those. The path enters reconnect backoff either
        way; this worker's engine is untouched."""
        with self._conn_lock:
            if self._conn is conn:
                self._conn = None
                self._reconnect.failure()
        conn.close()
        with self._streams_lock:
            orphans = list(self._streams.items())
            self._streams.clear()
        if orphans:
            self.peer_losses += 1
            if self.logger is not None:
                self.logger.warn({"event": "pd decode peer lost",
                                  "in_flight": len(orphans)})
        shed: list[RelayStream] = []
        for req_id, rs in orphans:
            if (self.resume and rs.emitted and not rs._done
                    and not rs.cancelled.is_set()
                    and rs.resumes < self.resume_max
                    and rs.resume_info is not None):
                rs.resumes += 1
                self._spawn(self._resume_relay, (rs,),
                            f"gofr-pd-resume-{req_id}")
            else:
                shed.append(rs)
        err = p.DecodePeerUnavailable(
            "decode peer lost mid-stream",
            retry_after=self._reconnect.retry_after())
        for rs in shed:
            self._fail_stream(rs, err)
        if self.metrics is not None and orphans:
            try:
                self.metrics.increment_counter(
                    "app_tpu_pd_peer_losses_total")
            except Exception:
                pass

    def _resume_relay(self, rs: RelayStream) -> None:
        """The re-handoff waiter: retry the handshake (bounded by
        ``TPU_RESUME_WAIT_S`` and the request deadline — a restarting
        decode worker needs a moment to bind) and re-submit the SAME
        RelayStream as a continuation under a fresh wire req_id.
        Exhaustion falls back to the legacy typed shed; the typed
        line's resume token still lets the CLIENT continue."""
        info = rs.resume_info or {}
        deadline = info.get("deadline")
        t_end = time.monotonic() + self.resume_wait_s
        while not rs.cancelled.is_set() and not rs._done:
            if self._closed:
                self._fail_stream(rs, GofrError(
                    "pd prefill coordinator closed"))
                return
            if deadline is not None and deadline.remaining() <= 0:
                self._fail_stream(rs, DeadlineExceeded(
                    "deadline expired while resuming after decode "
                    "peer loss"))
                return
            try:
                emitted = list(info.get("emitted0") or []) \
                    + list(rs.emitted)
                self._submit(rs, emitted)
            except p.DecodePeerUnavailable as e:
                if time.monotonic() < t_end:
                    time.sleep(min(0.25, self.resume_wait_s))
                    continue
                self._fail_stream(rs, e)
                return
            except BaseException as e:  # noqa: BLE001 — typed fallback
                self._fail_stream(rs, e)
                return
            self.resumed += 1
            if self.metrics is not None:
                try:
                    self.metrics.increment_counter(
                        "app_tpu_pd_resumes_total")
                except Exception:
                    pass
            if self.logger is not None:
                self.logger.info({"event": "pd stream resumed",
                                  "emitted": len(emitted),
                                  "attempt": rs.resumes})
            return

    def _cancel(self, req_id: int) -> None:
        with self._streams_lock:
            self._streams.pop(req_id, None)
        conn = self._conn
        if conn is not None and not conn.closed:
            try:
                conn.send(p.pack_msg(p.CANCEL, req_id), block=True)
            except Exception:
                pass

    # -- the serving path ----------------------------------------------------
    def generate(self, prompt, max_new_tokens: int = 128,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_id=None, adapter: int = 0, logprobs: bool = False,
                 deadline=None, slo_class: str | None = None,
                 seed: int | None = None,
                 continue_from=None) -> RelayStream:
        """The prefill worker's ``generate``: same signature and same
        ambient deadline/SLO pickup as the fused engine's, returning a
        RelayStream of the decode peer's tokens. ``seed`` /
        ``continue_from`` follow the generator's durable-streams
        contract; a sampled request's seed is pinned HERE and crosses
        the wire in REQ, so a decode-peer re-handoff — and a
        client-side resume — redraw the exact same sample stream."""
        if deadline is None:
            deadline = current_deadline()
        if slo_class is None:
            slo_class = current_slo_class()
        emitted0: list[int] = []
        if continue_from is not None:
            base, em = continue_from
            prompt = np.asarray(base, np.int64).reshape(-1)
            emitted0 = [int(t) for t in em]
        else:
            prompt = np.asarray(prompt, np.int64).reshape(-1)
        if temperature > 0 and seed is None:
            seed = random.getrandbits(31)
        traceparent = None
        span = tracing.current_span()
        if span is not None:
            traceparent = span.traceparent()
        if isinstance(eos_id, (set, frozenset, list, tuple)):
            eos_wire: object = sorted(int(t) for t in eos_id)
        else:
            eos_wire = int(eos_id) if eos_id is not None else None
        rs = RelayStream(0, self, logprobs=logprobs)
        rs.prompt_len = int(len(prompt)) + len(emitted0)
        rs.cursor_base = len(emitted0)
        rs.seed = seed
        rs.trace["submit"] = time.monotonic()
        rs.resume_info = {
            "prompt": prompt, "emitted0": emitted0,
            "max_new": int(max_new_tokens),
            "temperature": float(temperature), "top_k": int(top_k),
            "eos_id": eos_id, "eos_wire": eos_wire,
            "adapter": int(adapter), "slo_class": slo_class,
            "deadline": deadline, "traceparent": traceparent,
            "seed": seed}
        self._submit(rs, emitted0)
        self.relayed += 1
        if self.metrics is not None:
            try:
                self.metrics.increment_counter("app_tpu_pd_requests_total",
                                               role="prefill")
            except Exception:
                pass
        return rs

    def _submit(self, rs: RelayStream, emitted: list) -> None:
        """Submit — or RE-submit after a decode-peer loss — one relay
        under a fresh wire req_id. The local KV-only prefill admits
        prompt+emitted as a continuation when tokens were already
        delivered: a warm re-handoff recomputes only the un-cached
        tail, and the shipped KV covers the whole concat (the decode
        side's plen check holds)."""
        info = rs.resume_info or {}
        conn = self._ensure_conn()
        req_id = next(self._ids)
        rs._wire_id = req_id
        if not rs.request_id:
            rs.request_id = req_id
        prompt = info["prompt"]
        deadline = info["deadline"]
        meta = {"prompt": prompt.tolist(),
                "plen": int(len(prompt)) + len(emitted),
                "max_new": info["max_new"],
                "temperature": info["temperature"],
                "top_k": info["top_k"], "eos": info["eos_wire"],
                "adapter": info["adapter"],
                "slo_class": info["slo_class"],
                "deadline_s": (round(deadline.remaining(), 6)
                               if deadline is not None else None),
                "traceparent": info["traceparent"],
                "seed": info["seed"],
                # hop stamp: echoed back in END so every relayed request
                # doubles as a clock sample (observe/clock.py)
                "sent_wall": time.time()}
        if emitted:
            meta["resume_emitted"] = [int(t) for t in emitted]
        with self._streams_lock:
            self._streams[req_id] = rs
        shipper = _Shipper(conn, req_id, self.ship_block,
                           deadline=deadline, metrics=self.metrics)
        try:
            # REQ leaves BEFORE the local submit: the serving loop may
            # admit and ship the first KV frame before this thread runs
            # again, and the peer must already know the request
            conn.send(p.pack_json(p.REQ, req_id, meta), block=True)
            local = self.gen.generate(
                prompt, max_new_tokens=info["max_new"],
                temperature=info["temperature"], top_k=info["top_k"],
                eos_id=info["eos_id"], adapter=info["adapter"],
                logprobs=True, deadline=deadline,
                slo_class=info["slo_class"], kv_sink=shipper.ship,
                seed=info["seed"],
                continue_from=((prompt, emitted) if emitted else None))
        except (EOFError, OSError) as e:
            # the peer died under the REQ send: a SHED, not a 500 —
            # the typed-503 contract holds at every loss site
            self._cancel(req_id)
            raise p.DecodePeerUnavailable(
                f"decode peer lost during submit: {e!r}",
                retry_after=self._reconnect.retry_after()) from e
        except BaseException:
            self._cancel(req_id)
            raise
        rs._local = local
        self._spawn(self._finish, (conn, req_id, rs, local, shipper),
                    f"gofr-pd-finish-{req_id}")

    def _finish(self, conn: p.Conn, req_id: int, rs: RelayStream,
                local, shipper: _Shipper) -> None:
        """Wait out the local KV-only prefill (its single delivered
        token IS the first token), flush the trailing partial frame,
        then hand the stream off with KV_EOF. A local failure (shed,
        deadline, ship fault, device recovery) cancels the peer's
        assembly and fails the relay with the TYPED local error."""
        try:
            toks = list(local)  # [ (first_token, first_lp) ] or raises
            if not toks:
                raise GofrError("kv-only prefill delivered no first token")
            first, first_lp = toks[0]
            shipper.finish()
            rs.trace["prefill_done"] = time.monotonic()
            # durable-stream surface: how warm THIS prefill ran (the
            # resume contract's recompute report) and the engine's
            # pinned auto-seed, for resume tokens
            rs.cache_tokens = int(getattr(local, "cache_tokens", 0) or 0)
            if getattr(local, "seed", None) is not None:
                rs.seed = int(local.seed)
            # FIRST TOKEN LEAVES HERE, from the prefill pool: TTFT is
            # the prefill worker's latency alone — no handoff, no
            # decode-slot wait on its critical path (the decode worker
            # knows not to re-relay it; tokens 2+ are its stream). The
            # push precedes KV_EOF, so wire tokens can only follow it.
            if not rs._done:
                rs.trace.setdefault("first_put", time.monotonic())
                rs.emitted.append(int(first))
                rs._push((int(first), float(first_lp)) if rs.logprobs
                         else int(first))
            conn.send(p.pack_json(p.KV_EOF, req_id, {
                "first_token": int(first), "first_lp": float(first_lp),
                # THIS submit's prefill length (a re-handoff's concat
                # is longer than the original rs.prompt_len)
                "plen": int(getattr(local, "prompt_len", rs.prompt_len)),
                "blocks": shipper.frames}),
                block=True)
        except BaseException as e:  # noqa: BLE001 — typed per-request fail
            err: BaseException = shipper.error or e
            if isinstance(err, (EOFError, OSError)):
                err = p.DecodePeerUnavailable(
                    "decode peer lost during kv ship",
                    retry_after=self._reconnect.retry_after())
            self._cancel(req_id)
            # a re-handoff may have re-submitted this stream under a
            # NEW wire id while this (old) finisher was dying on the
            # old connection — never fail a stream someone else owns
            if not rs._done and rs._wire_id == req_id:
                rs.failed = str(err)
                rs._done = True
                rs._q.put(err)
                rs._q.put(None)

    def stats(self) -> dict:
        with self._streams_lock:
            in_flight = len(self._streams)
        return {"peer": f"{self.peer[0]}:{self.peer[1]}",
                "connected": self.connected, "in_flight": in_flight,
                "relayed": self.relayed, "reconnects": self.reconnects,
                "peer_losses": self.peer_losses,
                "resumed": self.resumed,
                "ship_block": self.ship_block,
                "window_bytes": self.window_bytes}

    def close(self) -> None:
        self._closed = True
        conn = self._conn
        if conn is not None:
            conn.close()
        with self._streams_lock:
            orphans = list(self._streams.values())
            self._streams.clear()
        for rs in orphans:
            if not rs._done:
                rs._done = True
                rs._q.put(GofrError("pd prefill coordinator closed"))
                rs._q.put(None)
        with self._threads_lock:
            threads = list(self._threads)
        # bounded: the reader ends at its socket's close, a finisher with
        # its local prefill, a re-handoff waiter at its next check
        for t in threads:
            if t is not threading.current_thread():
                t.join(timeout=2.0)
