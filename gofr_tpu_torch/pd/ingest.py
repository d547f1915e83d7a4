"""Decode-side KV ingest: the server half of disaggregated serving (the
port's own copy of gofr_tpu/pd/ingest.py).

A decode worker (``TPU_SERVING_ROLE=decode``) owns the slot lattice and
the token stream; this listener is its admission path for prefill
workers' shipped KV. Per connection: a handshake (model fingerprint +
attention geometry must match — see ``protocol.hello_mismatch``), then
a reader loop that assembles each request's checksummed block frames
host-side as they land (overlapping the peer's prefill compute and the
wire transfer), validates EVERY frame with ``quant.decode_block``
before any byte approaches the device, and at ``KV_EOF`` submits the
assembled prompt KV to the generation engine's ingest path
(``generate(ingest=...)``) — which installs the rows under an
``hbm`` stage lease (copies into the serving cache's row, or through
the scratch row and the write-back graph on a paged engine) and enters
the normal decode loop with zero prefill FLOPs on this worker.

Failure contract (docs/advanced-guide/disaggregated-serving.md):

  - a truncated / checksum-failing / mis-shaped frame fails the ONE
    request with a typed 502 (``KVTransferError``) — the assembly is
    dropped host-side, no pool row was touched, the ingest loop and
    every other request keep going;
  - decode-side ``HBMExhausted`` (the arbiter cannot cover the ingest
    stage lease or the admission checkpoint) surfaces as the same
    429 + Retry-After shed every local request gets, relayed typed to
    the prefill worker and on to the client;
  - deadline expiry after the handoff fails the request with 504 and a
    ``where=post-handoff`` wide event on THIS worker;
  - a dying connection cancels that connection's streams (slots free
    within a reap) and nothing else — prefill workers reconnect and
    resume; a decode-side DeviceLost recovery fails in-flight streams
    typed through the same ERR path while the listener stays up.
"""

from __future__ import annotations

import socket
import threading
import time

import json

import numpy as np

from .. import chaos
from ..resilience import Deadline
from ..tpu.kvcache import KVLayout
from ..tpu.kvcache.quant import concat_blocks, decode_block
from ..wire import observe_backlog
from . import protocol as p


class _Assembly:
    """One request's frames between REQ and KV_EOF — host numpy only;
    nothing touches the engine until the last frame validated."""

    __slots__ = ("meta", "deadline", "parts", "next_start", "t0",
                 "recv_wall")

    def __init__(self, meta: dict):
        self.meta = meta
        # the transfer burns the caller's budget: the deadline starts
        # at REQ receipt, so a slow ship expires HERE (post-handoff),
        # not after wasting a decode slot
        d = meta.get("deadline_s")
        self.deadline = Deadline.after(float(d)) if d else None
        self.parts: list = []
        self.next_start = 0
        self.t0 = time.monotonic()
        # wall stamp of REQ receipt: echoed in END beside the peer's
        # sent_wall so every relayed request is a clock sample
        self.recv_wall = time.time()


class KVIngestServer:
    """Listens on ``TPU_PD_LISTEN``; one reader thread per prefill-peer
    connection, one waiter thread per live ingest stream (the token
    sink itself runs zero-handoff on the serving loop thread via
    ``PushStream.set_sink``)."""

    def __init__(self, generator, fingerprint: str, host: str, port: int,
                 *, logger=None, metrics=None,
                 window_bytes: int = 8 << 20):
        self.gen = generator
        self.fingerprint = fingerprint
        self.logger = logger
        self.metrics = metrics
        self.window_bytes = int(window_bytes)
        cache = generator.cache
        self.layout = KVLayout(
            generator.cfg.n_layers, generator.cfg.n_kv_heads,
            generator.cfg.head_dim, cache.k_scale is not None,
            cache.k.dtype, generator.max_seq)
        self._hello = p.hello_payload(fingerprint, self.layout)
        # metrics/debug port of THIS process, advertised in HELLO_OK so
        # prefill peers learn where the /debug surface lives (set by
        # App.run once the metrics server binds; None when standalone)
        self.debug_port: int | None = None
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()[:2]
        self._closed = False
        self._conns: set = set()
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        self.ingests = 0
        self.frame_rejects = 0
        self.refused_hellos = 0
        self.errors = 0
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="gofr-pd-ingest", daemon=True)
        self._accept_thread.start()

    # -- lifecycle -----------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, addr = self._sock.accept()
            except OSError:
                return  # listener closed
            conn = p.Conn(sock, window_bytes=self.window_bytes)
            t = threading.Thread(target=self._serve_conn,
                                 args=(conn, addr),
                                 name=f"gofr-pd-conn-{addr[1]}",
                                 daemon=True)
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._conns.add(conn)
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
            t.start()

    def close(self) -> None:
        self._closed = True
        try:
            # wake a blocked accept(): close alone doesn't on Linux
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        try:
            # poke for platforms where shutdown on a listener no-ops
            poke = socket.create_connection((self.host, self.port),
                                            timeout=0.2)
            poke.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
            threads = list(self._threads)
        for c in conns:
            c.close()
        self._accept_thread.join(timeout=2.0)
        # bounded: a reader ends at its socket's EOF, a relay at its
        # stream's end (the teardown cancels them)
        for t in threads:
            t.join(timeout=2.0)

    def stats(self) -> dict:
        with self._lock:
            n = len(self._conns)
        return {"listening": not self._closed, "port": self.port,
                "connections": n, "ingests": self.ingests,
                "frame_rejects": self.frame_rejects,
                "refused_hellos": self.refused_hellos,
                "errors": self.errors}

    # -- per-connection reader ----------------------------------------------
    def _serve_conn(self, conn: p.Conn, addr) -> None:
        pending: dict[int, _Assembly] = {}
        streams: dict[int, object] = {}
        try:
            msg = p.read_msg(conn.sock)
            t1 = time.time()  # HELLO receipt: the NTP sample's t1
            if msg is None or msg[0] != p.HELLO:
                return
            theirs = json.loads(bytes(msg[2]))
            reason = p.hello_mismatch(self._hello, theirs)
            if reason is not None:
                self.refused_hellos += 1
                if self.logger is not None:
                    self.logger.warn({"event": "pd ingest hello refused",
                                      "peer": str(addr), "reason": reason})
                conn.send(p.pack_json(p.ERR, 0, {
                    "code": 400, "message": f"hello refused: {reason}"}),
                    block=True)
                return
            # clock piggyback: HELLO_OK carries this side's receive/send
            # stamps (hello_mismatch checks only identity keys, so old
            # peers ignore the extras) plus the debug-surface port
            conn.send(p.pack_json(p.HELLO_OK, 0, dict(
                self._hello, clock_t1=t1, clock_t2=time.time(),
                debug_port=self.debug_port)), block=True)
            if self.logger is not None:
                self.logger.info({"event": "pd ingest peer connected",
                                  "peer": str(addr)})
            while not self._closed:
                msg = p.read_msg(conn.sock)
                if msg is None:
                    return
                mtype, req_id, payload = msg
                if mtype == p.REQ:
                    pending[req_id] = _Assembly(json.loads(bytes(payload)))
                elif mtype == p.KV:
                    self._on_kv(conn, req_id, payload, pending)
                elif mtype == p.KV_EOF:
                    self._on_eof(conn, req_id, json.loads(bytes(payload)),
                                 pending, streams)
                elif mtype == p.CANCEL:
                    pending.pop(req_id, None)
                    st = streams.pop(req_id, None)
                    if st is not None:
                        st.cancel()
                # anything else: ignore (forward compatibility)
        except Exception as e:  # noqa: BLE001 — one conn must never kill
            # the listener; its requests are failed below
            self.errors += 1
            if self.logger is not None:
                self.logger.warn({"event": "pd ingest connection failed",
                                  "peer": str(addr), "error": repr(e)})
        finally:
            # the prefill peer is gone: every live stream it owned is
            # cancelled (slots free within a reap); queued assemblies
            # are garbage — nothing touched the device for them
            for st in streams.values():
                try:
                    st.cancel()
                except Exception:
                    pass
            conn.close()
            with self._lock:
                self._conns.discard(conn)

    def _reject(self, conn: p.Conn, req_id: int, pending: dict,
                message: str) -> None:
        """Fail ONE request at the transfer boundary: typed 502, the
        assembly dropped host-side — no pool row was written, the
        reader loop continues with every other request intact."""
        self.frame_rejects += 1
        pending.pop(req_id, None)
        if self.metrics is not None:
            try:
                self.metrics.increment_counter(
                    "app_tpu_pd_frame_rejects_total")
            except Exception:
                pass
        if self.logger is not None:
            self.logger.warn({"event": "pd kv frame rejected",
                              "req_id": req_id, "reason": message})
        try:
            conn.send(p.pack_json(p.ERR, req_id, p.error_to_wire(
                p.KVTransferError(message))), block=True)
        except Exception:
            pass

    def _on_kv(self, conn: p.Conn, req_id: int, payload,
               pending: dict) -> None:
        asm = pending.get(req_id)
        if asm is None:
            return  # already failed/cancelled: drain silently
        try:
            chaos.fire(chaos.PD_INGEST)
        except Exception as e:
            # an injected fault is THIS transfer's fault: typed 502 to
            # the prefill peer, the reader loop keeps serving
            self._reject(conn, req_id, pending,
                         f"injected ingest fault: {e}")
            return
        start, frame = p.unpack_kv(payload)
        kv = decode_block(frame, self.layout)
        if kv is None:
            self._reject(conn, req_id, pending,
                         "kv frame failed validation (checksum/layout/"
                         "truncation)")
            return
        if start != asm.next_start:
            self._reject(conn, req_id, pending,
                         f"kv frame out of order: start {start} != "
                         f"expected {asm.next_start}")
            return
        asm.parts.append(kv)
        asm.next_start += kv.plen
        if self.metrics is not None:
            try:
                self.metrics.increment_counter("app_tpu_pd_kv_frames_total",
                                               direction="in")
            except Exception:
                pass

    def _on_eof(self, conn: p.Conn, req_id: int, eof: dict,
                pending: dict, streams: dict) -> None:
        asm = pending.pop(req_id, None)
        if asm is None:
            return
        meta = asm.meta
        plen = int(meta.get("plen", 0))
        if not asm.parts or asm.next_start != plen:
            self._reject(conn, req_id, pending,
                         f"kv transfer incomplete: {asm.next_start}/{plen} "
                         "tokens received")
            return
        prompt = np.asarray(meta["prompt"], np.int64)
        # durable streams: a re-handoff REQ carries the already-
        # delivered tokens — the engine admits prompt+emitted as ONE
        # continuation prompt (the shipped KV covers the concat), and
        # the REQ's pinned seed keeps sampled continuations resume-
        # exact (the PRNG re-keys on absolute token position)
        emitted = [int(t) for t in (meta.get("resume_emitted") or [])]
        seed = meta.get("seed")
        try:
            kv = concat_blocks(asm.parts)
            eos = meta.get("eos")
            stream = self.gen.generate(
                prompt,
                max_new_tokens=int(meta.get("max_new", 128)),
                temperature=float(meta.get("temperature", 0.0)),
                top_k=int(meta.get("top_k", 0)),
                eos_id=eos if eos is None or isinstance(eos, int) else
                frozenset(int(t) for t in eos),
                adapter=int(meta.get("adapter", 0)),
                logprobs=True,
                deadline=asm.deadline,
                slo_class=meta.get("slo_class"),
                seed=int(seed) if seed is not None else None,
                continue_from=(prompt, emitted) if emitted else None,
                ingest=(kv, int(eof["first_token"]),
                        float(eof.get("first_lp") or 0.0)),
                traceparent=meta.get("traceparent"))
        except BaseException as e:  # noqa: BLE001 — typed relay: sheds
            # stay 429, deadline stays 504, the engine stays alive
            self.errors += 1
            try:
                conn.send(p.pack_json(p.ERR, req_id, p.error_to_wire(e)),
                          block=True)
            except Exception:
                pass
            return
        self.ingests += 1
        try:
            # the wire+assembly segment of the critical path: REQ
            # receipt to the engine accepting the installed rows. It
            # PRECEDES the stream's submit stamp, so the wide event
            # carries it beside the breakdown, not inside it.
            stream.trace["kv_transfer_s"] = round(
                time.monotonic() - asm.t0, 6)
        except Exception:
            pass  # telemetry must never fail the ingest
        if self.metrics is not None:
            try:
                self.metrics.increment_counter("app_tpu_pd_requests_total",
                                               role="decode")
            except Exception:
                pass
        streams[req_id] = stream
        t = threading.Thread(target=self._relay_stream,
                             args=(conn, req_id, stream, streams, asm),
                             name=f"gofr-pd-stream-{req_id}", daemon=True)
        with self._lock:
            self._threads.append(t)
        t.start()

    def _end_payload(self, sent: int, stream, asm) -> dict:
        """The END frame doubles as the return leg of a per-request
        clock sample (sent_wall echoed beside this side's REQ-receipt
        and END-send stamps) and carries the decode worker's segment
        view so the prefill side can tell the whole story."""
        endp: dict = {"tokens": sent}
        try:
            endp["req_sent_wall"] = asm.meta.get("sent_wall")
            endp["req_recv_wall"] = asm.recv_wall
            endp["end_sent_wall"] = time.time()
            tr = getattr(stream, "trace", None) or {}
            bd: dict = {}
            now = time.monotonic()
            for seg, a, b in (("queue_wait", tr.get("submit"),
                               tr.get("admit")),
                              ("prefill", tr.get("admit"),
                               tr.get("prefill_done")),
                              ("handoff", tr.get("prefill_done"),
                               tr.get("first_put")),
                              ("decode", tr.get("first_put"), now)):
                if a is not None and b is not None:
                    bd[seg + "_s"] = round(max(0.0, b - a), 6)
            if tr.get("kv_transfer_s") is not None:
                bd["kv_transfer_s"] = tr["kv_transfer_s"]
            if bd:
                endp["breakdown"] = bd
        except Exception:
            pass  # a bare {"tokens": n} END is always valid
        return endp

    def _relay_stream(self, conn: p.Conn, req_id: int, stream,
                      streams: dict, asm: _Assembly | None = None) -> None:
        """Token relay for one ingested stream: tokens leave zero-
        handoff on the serving loop thread (PushStream sink -> Outbox,
        nonblocking); this waiter only observes the terminal outcome
        and sends END/ERR with a blocking flush."""
        # the FIRST delivered token is skipped: the prefill worker
        # sampled it and already delivered it to the client (TTFT is
        # the prefill pool's latency); this stream owns tokens 2+.
        # Each TOK carries the resume contract's monotone cursor — the
        # absolute generated-token index of the ORIGINAL request
        # (stream.cursor_base counts the continuation's replayed
        # tokens; +1 skips the prefill-delivered first token)
        base = int(getattr(stream, "cursor_base", 0) or 0) + 1
        sent = [0]
        skipped = [False]

        def sink(item) -> bool:
            if not skipped[0]:
                skipped[0] = True
                return True
            tok, lp = item if isinstance(item, tuple) else (item, None)
            conn.send(p.pack_tok(req_id, tok, base + sent[0], lp))
            sent[0] += 1
            if sent[0] % 32 == 0:
                # sampled, not per-token: the gauge is a trend line
                observe_backlog(self.metrics, conn.pending_bytes(),
                                role="pd-decode")
            return True

        stream.set_sink(sink)
        try:
            for item in stream:
                # only reached if the sink was dropped (conn hiccup):
                # forward through the blocking path
                if not skipped[0]:
                    skipped[0] = True
                    continue
                tok, lp = item if isinstance(item, tuple) else (item, None)
                conn.send(p.pack_tok(req_id, tok, base + sent[0], lp),
                          block=True)
                sent[0] += 1
            conn.send(p.pack_json(p.END, req_id,
                                  self._end_payload(sent[0], stream, asm)
                                  if asm is not None
                                  else {"tokens": sent[0]}),
                      block=True)
        except BaseException as e:  # noqa: BLE001 — relay the typed error
            try:
                conn.send(p.pack_json(p.ERR, req_id, p.error_to_wire(e)),
                          block=True)
            except Exception:
                pass
            # the relay is dead either way: CANCEL the stream so the
            # decode slot (and its paged blocks) free within a reap
            # instead of generating the rest of the budget into an
            # unread queue (_serve_conn's teardown only covers streams
            # still registered when the READER exits)
            try:
                stream.cancel()
            except Exception:
                pass
        finally:
            streams.pop(req_id, None)
