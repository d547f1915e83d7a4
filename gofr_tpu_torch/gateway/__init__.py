"""Prefix-affinity gateway: the gofr-native front door over N replicas
(the port's own copy of gofr_tpu/gateway/, which imports no JAX).

``TPU_SERVING_ROLE=gateway`` turns an App into the cluster's router
(no engine, no device, no tensor work — the replicas serve; this
process makes them robust AS A UNIT):

  - **replica table** (table.py): health polled through ``service/``
    clients wrapped in the framework circuit breaker; typed sheds
    (429 + ``X-Shed-Reason: hbm``) feed a decaying per-replica
    memory-pressure score;
  - **prefix-affinity routing** (router.py): consistent hash on the
    request's first KV block chain hash (the same block hashing the
    radix index and T2 fingerprint keys use), so multi-turn sessions
    land where their T0/T1 cache is warm — spilling to least-pressure
    on an unroutable or memory-held owner;
  - **failover with a retry budget**: a replica lost BEFORE the first
    token is retried transparently on another replica (nothing was
    delivered — safe), bounded by a token-bucket budget so a dying
    fleet can't amplify into a retry storm;
  - **durable streams**: the commit point moved from "first
    token" to "stream end" — a replica lost AFTER the first token is
    auto-resumed on a ring successor (whose T2 namespace covers the
    prompt+emitted block chain warm) by replaying the request as a
    ``continue_from`` continuation, spliced token-exact into the
    client's stream; the legacy typed 503 + Retry-After line only
    goes out when the retry budget / deadline / attempt cap is
    exhausted — and then it carries a resume token so the CLIENT can
    continue where the gateway could not;
  - **zero-loss rolling drain**: the moment a replica's readiness
    flips (its ``App.stop(grace_s)`` drain window), health polls and
    inline drain-503s stop NEW routing there while in-flight relays
    finish on the old process — a rolling restart of every replica
    loses nothing.

Chaos seams ``GATEWAY_PICK`` / ``GATEWAY_RELAY`` / ``GATEWAY_MIDSTREAM``
make pick starvation, attempt-N replica loss and a loss after N relayed
tokens deterministically injectable.

The wide ``request`` event of each terminal goes to the logger
(``Logger.wide``) and the flight recorder, and the clock sample of each
health poll to the clock registry, of the App's ``observe`` bundle.

Config (read by :func:`gateway_from_config`):

  TPU_GATEWAY_REPLICAS           host:port,host:port,...   (required)
  TPU_GATEWAY_PATH               forwarded route (default /generate)
  TPU_GATEWAY_BLOCK              affinity block tokens (default 16 —
                                 MUST match the replicas'
                                 TPU_KVCACHE_BLOCK)
  TPU_GATEWAY_LONG_PREFIX        cache-heavy threshold in tokens
                                 (default 4x block)
  TPU_GATEWAY_VNODES             ring virtual nodes/replica (64)
  TPU_GATEWAY_RETRY_RATIO        failover tokens earned per request
                                 (default 0.1 = retries <= 10% of
                                 traffic in steady state)
  TPU_GATEWAY_RETRY_BURST        failover token bucket cap (10)
  TPU_GATEWAY_HEALTH_INTERVAL_S  health poll cadence (1.0)
  TPU_GATEWAY_CONNECT_TIMEOUT_S  per-attempt connect budget (2.0)
  TPU_GATEWAY_STREAM_TIMEOUT_S   mid-stream stall bound (120)
  TPU_GATEWAY_BREAKER_THRESHOLD  health-client breaker threshold (3)
  TPU_GATEWAY_BREAKER_INTERVAL_S breaker recovery probe interval (2.0)
  TPU_RESUME                     post-commit auto-resume (default true)
  TPU_RESUME_MAX                 resume attempts per stream (default 3)
"""

from __future__ import annotations

import json
import random
import threading
import time
import uuid

from .. import chaos, tracing
from ..errors import BadRequest, DeadlineExceeded, HTTPError, TooManyRequests
from ..resilience import current_deadline, current_slo_class
from ..service.wrap import hop_context, set_header_default
from .relay import (ReplicaResponse, TransportLoss, error_line,
                    first_line, forward, relay_lines)
from .router import (AffinityRouter, GatewayUnavailable, HashRing,
                     RetryBudget)
from .table import Replica, ReplicaTable

__all__ = ["AffinityRouter", "Gateway", "GatewayUnavailable", "HashRing",
           "Replica", "ReplicaTable", "RetryBudget", "ROLE_GATEWAY",
           "gateway_from_config", "install_gateway", "parse_replicas"]

ROLE_GATEWAY = "gateway"

#: headers the gateway OWNS on the replica hop — hop-by-hop framing the
#: relay rewrites itself, plus the context headers it re-derives from
#: the ambient request (trace / SLO class / remaining deadline). Every
#: OTHER client header passes through verbatim.
_HOP_OWNED_HEADERS = frozenset({
    "host", "connection", "content-length", "transfer-encoding",
    "keep-alive", "te", "upgrade", "proxy-authorization",
    "proxy-connection", "accept-encoding", "traceparent", "tracestate",
    "x-request-timeout", "x-slo-class", "x-obs-hop",
})


def parse_replicas(spec: str | None) -> list[str]:
    """``TPU_GATEWAY_REPLICAS`` -> addresses. Accepts bare host:port
    and http://host:port forms; a malformed entry fails startup loudly
    (a front door with a typo'd replica list is a misdeployed
    cluster, the failure class that must never serve silently)."""
    out: list[str] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if part.startswith("http://"):
            part = part[len("http://"):].rstrip("/")
        host, _, port = part.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"TPU_GATEWAY_REPLICAS entry {part!r}: "
                             "expected host:port")
        out.append(f"{host}:{int(port)}")
    if not out:
        raise ValueError("TPU_SERVING_ROLE=gateway requires "
                         "TPU_GATEWAY_REPLICAS=host:port,...")
    return out


class _ResumeCtx:
    """Everything the post-commit auto-resume loop needs about one
    request: the stamped forward payload, the affinity key, and the
    client headers to re-derive hop context from on each continuation.
    The request id and sampling seed are chosen HERE, before the first
    forward — a SIGKILLed replica emits nothing, so anything a resume
    needs must already be in the first attempt's body."""

    __slots__ = ("payload", "key", "plen", "rid",
                 "client_headers", "resumable")

    def __init__(self, payload: dict, key, plen: int,
                 client_headers: dict):
        self.payload = payload
        self.key = key
        self.plen = plen
        self.rid = payload.get("request_id")
        self.client_headers = client_headers
        # flips False the moment the stream breaks the cursor contract
        # (a cursor-less legacy replica, a splice gap): from then on
        # the gateway is the plain transparent relay again
        self.resumable = True

    def body(self) -> bytes:
        return json.dumps(self.payload).encode()

    def resume_body(self, emitted: list) -> bytes:
        p = dict(self.payload)
        p["resume_from"] = len(emitted)
        p["emitted"] = list(emitted)
        return json.dumps(p).encode()


class Gateway:
    """The router + failover engine behind the gateway App's routes."""

    def __init__(self, table: ReplicaTable, *, path: str = "/generate",
                 block: int = 16, long_prefix: int | None = None,
                 vnodes: int = 64, retry_ratio: float = 0.1,
                 retry_burst: float = 10.0,
                 connect_timeout_s: float = 2.0,
                 stream_timeout_s: float = 120.0,
                 resume: bool = True, resume_max: int = 3,
                 logger=None, metrics=None, observe=None):
        self.table = table
        self.path = path
        self.block = max(1, int(block))
        self.router = AffinityRouter(table, block=self.block,
                                     long_prefix=long_prefix,
                                     vnodes=vnodes, metrics=metrics)
        self.budget = RetryBudget(ratio=retry_ratio, burst=retry_burst)
        self.connect_timeout_s = float(connect_timeout_s)
        self.stream_timeout_s = float(stream_timeout_s)
        self.resume = bool(resume)
        self.resume_max = max(0, int(resume_max))
        self.logger = logger
        self.metrics = metrics
        self.observe = observe  # wide-event recorder + clock registry
        self._lock = threading.Lock()
        self.outcomes = {"ok": 0, "shed": 0, "failed": 0, "midstream": 0}
        self.failovers = {"transport": 0, "drain": 0, "shed": 0}
        self.resumes = 0

    # -- bookkeeping ----------------------------------------------------------
    def _outcome(self, kind: str) -> None:
        with self._lock:
            self.outcomes[kind] += 1
        if self.metrics is not None:
            try:
                self.metrics.increment_counter(
                    "app_tpu_gateway_requests_total", outcome=kind)
            except Exception:
                pass

    def _failover(self, reason: str, replica: Replica) -> None:
        with self._lock:
            self.failovers[reason] += 1
        if self.metrics is not None:
            try:
                self.metrics.increment_counter(
                    "app_tpu_gateway_failovers_total", reason=reason)
            except Exception:
                pass
        if self.logger is not None:
            self.logger.info({"event": "gateway failover",
                              "reason": reason,
                              "replica": replica.address})

    def _exhausted(self) -> None:
        if self.metrics is not None:
            try:
                self.metrics.increment_counter(
                    "app_tpu_gateway_retry_exhausted_total")
            except Exception:
                pass

    # -- the forwarded-request context ---------------------------------------
    def _affinity_key(self, body: bytes,
                      tenant: str = "") -> tuple[bytes | None, int]:
        try:
            payload = json.loads(body)
            tokens = payload["tokens"]
            plen = len(tokens)
            adapter = int(payload.get("adapter", 0) or 0)
        except Exception as e:  # noqa: BLE001 — client error, typed 400
            raise BadRequest("gateway: body must be JSON with a "
                             "'tokens' array") from e
        if plen < self.block:
            return None, plen  # sub-block: affinity-less by design
        from ..tpu.kvcache import first_block_hash

        try:
            key = first_block_hash(tokens, self.block, adapter)
        except Exception as e:  # noqa: BLE001 — non-numeric tokens
            raise BadRequest("gateway: 'tokens' must be an array of "
                             "integers") from e
        if tenant:
            # tenants partition the fleet's prefix caches: the same
            # prompt prefix from two tenants lands on (usually)
            # different replicas, so one tenant's working set never
            # thrashes another's T0 rows fleet-wide
            key = key + b"|" + tenant.encode("utf-8", "replace")
        return key, plen

    def _forward_headers(self, client_headers: dict) -> tuple[dict, float]:
        """The replica-hop headers + the tightened read timeout. Client
        headers pass through (an authenticated cluster stays usable
        behind the front door: Authorization / API keys / custom
        headers reach the replica) EXCEPT the ones the gateway owns on
        this hop — connection framing, and the context headers it
        re-derives: W3C trace (the gateway's span continues the
        client's trace, so cross-process traces join through BOTH
        hops), SLO class, and the remaining deadline (the budget
        covers the WHOLE request, not each hop)."""
        hdrs = {k: v for k, v in client_headers.items()
                if k.lower() not in _HOP_OWNED_HEADERS}
        set_header_default(hdrs, "Content-Type", "application/json")
        span = tracing.current_span()
        if span is not None:
            hdrs["traceparent"] = span.traceparent()
        timeout = hop_context(hdrs, self.stream_timeout_s)
        return hdrs, timeout

    # -- the serving path -----------------------------------------------------
    def handle_generate(self, ctx):
        """The gateway's /generate: pick -> forward -> commit at first
        token -> relay; pre-commit failures fail over under the retry
        budget; post-commit failures terminate typed.

        Every terminal emits the gateway's own wide ``request`` event —
        a request shed HERE never reached an engine, so without this
        record it would vanish from every wide-event surface."""
        st = {"t0": time.monotonic(), "submit_wall": time.time(),
              "bd": {}, "replica": None, "route": None, "tried": 0,
              "shed_reason": None}
        try:
            out = self._relay_attempts(ctx, st)
        except TooManyRequests as e:
            self._wide_request("shed", st, error=repr(e))
            raise
        except GatewayUnavailable as e:
            self._wide_request("shed", st, error=repr(e))
            raise
        except BaseException as e:
            self._wide_request("failed", st, error=repr(e))
            raise
        self._wide_request("ok", st)
        return out

    def _wide_request(self, outcome: str, st: dict,
                      error: str | None = None) -> None:
        """The gateway's terminal wide event: same skeleton as the
        engine's (event/outcome/trace_id/slo_class lead), with the
        routing story — picked replica, affinity label, failover spend
        — and the gateway's critical-path segments (pick / connect /
        ttfb). Telemetry only: never raises into the relay."""
        try:
            now = time.monotonic()
            span = tracing.current_span()
            trace_id = span.trace_id if span is not None else ""
            wide: dict = {"event": "request", "outcome": outcome,
                          "trace_id": trace_id,
                          "slo_class": current_slo_class(),
                          "gateway": True, "replica": st["replica"],
                          "route": st["route"], "tried": st["tried"],
                          "failovers": max(0, st["tried"] - 1),
                          "duration_s": round(now - st["t0"], 6),
                          "submit_wall_s": round(st["submit_wall"], 6)}
            if st.get("resumes"):
                # a stream that died mid-relay and was spliced back is
                # its own terminal outcome — dashboards count resumes
                # without joining on fields
                wide["outcome"] = "resumed"
                wide["resume_count"] = st["resumes"]
                wide["resumed_at_cursor"] = st.get("resumed_at_cursor")
                if st.get("recompute_tokens") is not None:
                    wide["recompute_tokens"] = st["recompute_tokens"]
            bd = {k: round(v, 6) for k, v in st["bd"].items()}
            if bd:
                wide["breakdown"] = bd
            if st.get("shed_reason"):
                wide["shed_reason"] = st["shed_reason"]
            if error is not None:
                wide["error"] = error
            if self.metrics is not None and bd:
                for i, (seg, v) in enumerate(sorted(bd.items())):
                    try:
                        self.metrics.record_histogram(
                            "app_tpu_request_segment_duration", v,
                            exemplar=((trace_id or None) if i == 0
                                      else None),
                            segment=seg[:-2], program="gateway")
                    except Exception:
                        pass
            recorder = getattr(self.observe, "recorder", None)
            if recorder is not None:
                recorder.record(
                    "request", trace_id=trace_id,
                    **{k: v for k, v in wide.items()
                       if k not in ("event", "trace_id")})
            wide_log = getattr(self.logger, "wide", None)
            if wide_log is not None:
                wide_log(wide)
        except Exception:
            pass  # telemetry must never take the relay down

    def _resume_ctx(self, ctx, body: bytes, key, plen) -> _ResumeCtx | None:
        """Stamp the forward body for durability: a request id (the
        dedup identity a resumed replay carries) and, for sampled
        requests, a pinned seed (resume-exact sampling re-keys on
        (seed, absolute position) — the continuation must draw from
        the same stream the dead replica did). None when resume is off
        or the body isn't the generate contract (the gateway stays a
        transparent relay for anything else)."""
        if not self.resume or self.resume_max <= 0:
            return None
        try:
            payload = json.loads(body)
        except Exception:  # noqa: BLE001 — unreachable after key parse
            return None
        if not isinstance(payload, dict) or not isinstance(
                payload.get("tokens"), list):
            return None
        if not payload.get("request_id"):
            payload["request_id"] = f"gw-{uuid.uuid4().hex[:16]}"
        if (payload.get("temperature") or 0) \
                and payload.get("seed") is None:
            payload["seed"] = random.getrandbits(31)
        return _ResumeCtx(payload, key, plen, dict(ctx.request.headers))

    def _relay_attempts(self, ctx, st: dict):
        body = ctx.request.body or b""
        key, plen = self._affinity_key(
            body, tenant=ctx.header("X-Tenant-Id").strip())
        rctx = self._resume_ctx(ctx, body, key, plen)
        if rctx is not None:
            body = rctx.body()
        headers, read_timeout = self._forward_headers(ctx.request.headers)
        # hop stamp: when THIS hop forwarded, on the gateway's wall
        # clock (a JAX replica's /debug/request places the hop with it)
        headers["X-Obs-Hop"] = repr(time.time())
        bd = st["bd"]
        self.budget.deposit()
        tried: set[int] = set()
        last_shed: ReplicaResponse | None = None
        n = len(self.table)
        while len(tried) < n:
            t_pick = time.monotonic()
            try:
                replica, label = self.router.pick(key, plen,
                                                  exclude=tried)
            except GatewayUnavailable:
                break
            except Exception as e:  # noqa: BLE001 — injected at the seam
                # a GATEWAY_PICK chaos error fails THIS decision typed,
                # never the gateway process
                self._outcome("shed")
                raise GatewayUnavailable(
                    f"gateway pick failed: {e!r}",
                    retry_after=self.table.retry_after_hint()) from e
            finally:
                bd["pick_s"] = bd.get("pick_s", 0.0) \
                    + (time.monotonic() - t_pick)
            tried.add(replica.idx)
            st["tried"] = len(tried)
            st["replica"], st["route"] = replica.address, label
            try:
                chaos.fire(chaos.GATEWAY_RELAY)
                t_conn = time.monotonic()
                kind, payload = forward(
                    replica, self.path, body, headers,
                    connect_timeout_s=self.connect_timeout_s,
                    read_timeout_s=read_timeout)
                bd["connect_s"] = bd.get("connect_s", 0.0) \
                    + (time.monotonic() - t_conn)
                if kind == "stream":
                    t_ttfb = time.monotonic()
                    try:
                        first = first_line(payload)
                    except BaseException:
                        payload.close()
                        raise
                    finally:
                        bd["ttfb_s"] = bd.get("ttfb_s", 0.0) \
                            + (time.monotonic() - t_ttfb)
            except Exception as e:  # noqa: BLE001 — attempt loss
                dl = current_deadline()
                if dl is not None and dl.remaining() <= 0:
                    # the CALLER's budget expired mid-attempt (the
                    # relay's read timeout tightens to it): a 504 on
                    # THIS request, never evidence against the replica
                    # — one impatient client must not mark a healthy
                    # fleet down or drain the shared failover budget
                    self._outcome("failed")
                    raise DeadlineExceeded(
                        "gateway: caller deadline expired during the "
                        f"attempt on {replica.address}") from e
                # TransportLoss or an injected GATEWAY_RELAY error:
                # nothing delivered, the replica is suspect
                replica.mark_down()
                if len(tried) >= n or not self.budget.withdraw():
                    self._exhausted()
                    self._outcome("shed")
                    raise GatewayUnavailable(
                        f"replica {replica.address} lost before first "
                        "token and the failover budget is spent",
                        retry_after=self.table.retry_after_hint()) from e
                self._failover("transport", replica)
                continue
            if kind == "stream":
                # the first token is in hand: requests_total counts
                # here, but with durable streams this is no longer the
                # commit point — the resume relay keeps the request
                # recoverable until the terminal chunk
                replica.mark_up()
                with replica._lock:
                    replica.relayed += 1
                self._outcome("ok")
                if rctx is not None:
                    ctx.stream(self._relay_resume(
                        st, first, payload, replica, rctx))
                else:
                    ctx.stream(relay_lines(
                        first, payload, replica,
                        retry_after=replica.reconnect.retry_after(),
                        on_loss=self._on_midstream_loss))
                return None
            r: ReplicaResponse = payload
            if r.status == 429:
                reason = r.header("X-Shed-Reason")
                replica.note_shed(reason, r.retry_after())
                st["shed_reason"] = reason or "queue"
                last_shed = r
                # a shed elsewhere may still serve — but a shedding
                # FLEET must not be retried into a storm: budget-gated
                if len(tried) < n:
                    if self.budget.withdraw():
                        self._failover("shed", replica)
                        continue
                    self._exhausted()
                break
            if r.status == 503:
                # the drain_middleware readiness contract: re-pick,
                # budget-FREE (a rolling deploy is an orderly event,
                # not a failure storm)
                replica.mark_drain(r.retry_after())
                self._failover("drain", replica)
                continue
            # any other status: the gateway is transparent
            self._outcome("failed")
            err = HTTPError(r.message(), status_code=r.status)
            err.headers = {k: v for k, v in r.headers.items()
                           if k in ("retry-after", "x-shed-reason")}
            raise err
        if last_shed is not None:
            # every failover avenue closed on a shed: relay it honestly
            # (the replica's Retry-After + reason survive the hop)
            self._outcome("shed")
            raise TooManyRequests(
                last_shed.message(),
                retry_after=last_shed.retry_after() or 1.0,
                reason=last_shed.header("X-Shed-Reason") or None)
        self._outcome("shed")
        raise GatewayUnavailable(
            "no replica could serve (all down, draining, or tried)",
            retry_after=self.table.retry_after_hint())

    # -- durable streams: the post-commit auto-resume relay -------------------
    def _relay_resume(self, st: dict, first: bytes, stream,
                      replica: Replica, rctx: _ResumeCtx):
        """``relay_lines``' durable twin: the commit point moves from
        "first token" to "stream end". Cursor-carrying lines are
        tracked as the client's authoritative emitted list; on a
        mid-stream loss (transport truncation, OR a typed error line
        carrying a resume token — the replica's engine declared the
        death itself) the loop re-picks via the ring, replays
        prompt+emitted as a ``continue_from`` continuation, validates
        the splice cursor, and keeps relaying: zero duplicate, zero
        missing tokens. Replayed-duplicate lines (cursor below the
        client's position) are swallowed, so even an over-replaying
        replica can't double-deliver. Only when resume is exhausted
        does the typed error line go out — carrying the resume token
        so the client can continue on its own."""
        emitted: list = [int(t) for t in
                         (rctx.payload.get("emitted") or [])]
        cur = (first, stream, replica)
        while True:
            line, strm, rep = cur
            loss: BaseException | None = None
            transport = False
            with rep._lock:
                rep.inflight += 1
            try:
                while line is not None:
                    try:
                        obj = json.loads(line)
                    except Exception:  # noqa: BLE001 — non-JSON payload
                        obj = None
                    if isinstance(obj, dict) and "token" in obj \
                            and "cursor" in obj:
                        cursor = int(obj["cursor"])
                        if cursor == len(emitted):
                            emitted.append(int(obj["token"]))
                            yield line
                        elif cursor < len(emitted):
                            pass  # replayed duplicate: client has it
                        else:
                            # cursor gap: the contract broke — stop
                            # trusting resume, stay a transparent relay
                            rctx.resumable = False
                            yield line
                    elif isinstance(obj, dict) and "error" in obj:
                        err = (obj["error"]
                               if isinstance(obj["error"], dict) else {})
                        if err.get("resume") is not None and \
                                int(err.get("status", 0)) in (429, 503):
                            # the replica PROCESS is alive (it spoke) —
                            # one engine stream died; resume without
                            # marking the replica down
                            loss = TransportLoss(
                                "replica ended mid-stream: "
                                + str(err.get("message", ""))[:200])
                            break
                        yield line
                        return  # terminal typed line: relay + end
                    else:
                        rctx.resumable = False  # cursor-less replica
                        yield line
                    try:
                        chaos.fire(chaos.GATEWAY_MIDSTREAM)
                        line = strm.next_line()
                    except (TransportLoss, OSError) as e:
                        loss, transport = e, True
                        break
                    except Exception as e:  # noqa: BLE001 — chaos seam
                        loss, transport = e, True
                        break
            finally:
                with rep._lock:
                    rep.inflight -= 1
                strm.close()
            if loss is None:
                return  # clean terminal chunk: the durable commit
            if transport:
                rep.mark_down()
            nxt = self._resume_attempt(st, rep, rctx, emitted,
                                       exclude_dead=transport)
            if nxt is None:
                self._on_midstream_loss(rep, loss)
                yield self._resume_error_line(rep, rctx, emitted)
                return
            cur = nxt

    def _resume_attempt(self, st: dict, dead: Replica,
                        rctx: _ResumeCtx, emitted: list, *,
                        exclude_dead: bool = True):
        """One auto-resume: budget + deadline + attempt-cap gated
        re-pick and continuation forward. Routing prefers the ring
        successor for the SAME affinity key — the replica whose T2
        namespace covers the prompt+emitted chain warm. Returns the
        next ``(first_line, stream, replica)`` or None when the typed
        line must go out after all. A replica whose engine killed one
        stream (typed loss) stays eligible — it is alive and has the
        warmest cache of anyone."""
        if not rctx.resumable or not emitted:
            return None
        if st.get("resumes", 0) >= self.resume_max:
            return None
        dl = current_deadline()
        if dl is not None and dl.remaining() <= 0:
            return None
        t0 = time.monotonic()
        try:
            headers, read_timeout = self._forward_headers(
                rctx.client_headers)
            headers["X-Obs-Hop"] = repr(time.time())
            body = rctx.resume_body(emitted)
            tried: set[int] = {dead.idx} if exclude_dead else set()
            n = len(self.table)
            attempts = 0
            while attempts < n:
                attempts += 1
                if not self.budget.withdraw():
                    self._exhausted()
                    return None
                try:
                    rep, label = self.router.pick(
                        rctx.key, rctx.plen + len(emitted),
                        exclude=tried)
                except Exception:  # noqa: BLE001 — nobody pickable
                    return None
                tried.add(rep.idx)
                st["tried"] = st.get("tried", 0) + 1
                try:
                    kind, payload = forward(
                        rep, self.path, body, headers,
                        connect_timeout_s=self.connect_timeout_s,
                        read_timeout_s=read_timeout)
                except Exception:  # noqa: BLE001 — attempt loss
                    rep.mark_down()
                    continue
                if kind != "stream":
                    r: ReplicaResponse = payload
                    if r.status == 429:
                        rep.note_shed(r.header("X-Shed-Reason"),
                                      r.retry_after())
                        continue
                    if r.status == 503:
                        rep.mark_drain(r.retry_after())
                        continue
                    return None  # non-retriable: typed line goes out
                try:
                    nfirst = first_line(payload)
                    obj = json.loads(nfirst)
                    if int(obj["cursor"]) > len(emitted):
                        raise ValueError("splice cursor gap")
                except Exception:  # noqa: BLE001 — broken splice
                    # 200 but not the resume contract (legacy replica
                    # regenerating from scratch): relaying would
                    # duplicate tokens — drop the attempt, not resume
                    payload.close()
                    continue
                rep.mark_up()
                with rep._lock:
                    rep.relayed += 1
                st["resumes"] = st.get("resumes", 0) + 1
                st["resumed_at_cursor"] = len(emitted)
                if isinstance(obj, dict) and "recompute" in obj:
                    st["recompute_tokens"] = int(obj["recompute"])
                st["replica"], st["route"] = rep.address, label
                self._note_resume(dead, rep, st.get("recompute_tokens"))
                return nfirst, payload, rep
            return None
        finally:
            st["bd"]["resume_s"] = st["bd"].get("resume_s", 0.0) \
                + (time.monotonic() - t0)

    def _note_resume(self, lost: Replica, to: Replica,
                     recompute) -> None:
        with self._lock:
            self.resumes += 1
        if self.metrics is not None:
            try:
                self.metrics.increment_counter(
                    "app_tpu_gateway_resumes_total")
                if recompute is not None:
                    span = tracing.current_span()
                    self.metrics.record_histogram(
                        "app_tpu_resume_recompute_tokens",
                        float(recompute),
                        exemplar=(span.trace_id if span is not None
                                  else None))
            except Exception:
                pass
        if self.logger is not None:
            self.logger.info({"event": "gateway stream resumed",
                              "from": lost.address, "to": to.address,
                              "recompute_tokens": recompute})

    def _resume_error_line(self, rep: Replica, rctx: _ResumeCtx,
                           emitted: list) -> bytes:
        """The exhausted-resume terminal: the legacy typed 503 line,
        plus the resume token when the stream is still continuable —
        the client (service/client.py) can pick up where the gateway's
        budget ran out."""
        retry_after = rep.reconnect.retry_after()
        if not rctx.resumable or not emitted:
            return error_line(f"replica {rep.address} lost mid-stream",
                              status=503, retry_after=retry_after)
        detail: dict = {
            "message": f"replica {rep.address} lost mid-stream and "
                       "auto-resume is exhausted",
            "status": 503, "retry_after": round(float(retry_after), 3)}
        resume: dict = {"request_id": rctx.rid, "cursor": len(emitted)}
        seed = rctx.payload.get("seed")
        if seed is not None:
            resume["seed"] = int(seed)
        try:
            from ..serving import resume_chain
            resume["chain"] = resume_chain(
                rctx.payload["tokens"], emitted, self.block,
                int(rctx.payload.get("adapter", 0) or 0))
        except Exception:
            pass  # fingerprint is advisory; the token works without it
        detail["resume"] = resume
        return (json.dumps({"error": detail}) + "\n").encode()

    def _on_midstream_loss(self, replica: Replica, err) -> None:
        replica.mark_down()
        # NOT an _outcome: this request already counted "ok" at its
        # commit point — requests_total stays one count per request
        # ("by terminal outcome"); mid-relay terminations get their
        # own counter (the stats dict keeps the key for /gateway/stats)
        with self._lock:
            self.outcomes["midstream"] += 1
        if self.metrics is not None:
            try:
                self.metrics.increment_counter(
                    "app_tpu_gateway_midstream_total")
            except Exception:
                pass
        if self.logger is not None:
            self.logger.warn({"event": "gateway replica lost mid-stream",
                              "replica": replica.address,
                              "error": repr(err)})

    # -- surfaces -------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            outcomes = dict(self.outcomes)
            failovers = dict(self.failovers)
            resumes = self.resumes
        return {"path": self.path, "outcomes": outcomes,
                "failovers": failovers, "resumes": resumes,
                "budget": self.budget.stats(),
                "router": self.router.stats(),
                "table": self.table.stats()}

    def close(self) -> None:
        self.table.close()


def gateway_from_config(cfg, *, logger=None, metrics=None,
                        tracer=None, observe=None) -> Gateway:
    addresses = parse_replicas(cfg.get("TPU_GATEWAY_REPLICAS"))
    table = ReplicaTable(
        addresses, logger=logger, metrics=metrics, tracer=tracer,
        observe=observe,
        poll_interval_s=cfg.get_float("TPU_GATEWAY_HEALTH_INTERVAL_S", 1.0),
        breaker_threshold=cfg.get_int("TPU_GATEWAY_BREAKER_THRESHOLD", 3),
        breaker_interval_s=cfg.get_float("TPU_GATEWAY_BREAKER_INTERVAL_S",
                                         2.0),
        health_timeout_s=cfg.get_float("TPU_GATEWAY_CONNECT_TIMEOUT_S",
                                       2.0))
    block = cfg.get_int("TPU_GATEWAY_BLOCK", 16)
    long_prefix = cfg.get_int("TPU_GATEWAY_LONG_PREFIX", 0) or None
    return Gateway(
        table,
        path=cfg.get_or_default("TPU_GATEWAY_PATH", "/generate"),
        block=block, long_prefix=long_prefix,
        vnodes=cfg.get_int("TPU_GATEWAY_VNODES", 64),
        retry_ratio=cfg.get_float("TPU_GATEWAY_RETRY_RATIO", 0.1),
        retry_burst=cfg.get_float("TPU_GATEWAY_RETRY_BURST", 10.0),
        connect_timeout_s=cfg.get_float("TPU_GATEWAY_CONNECT_TIMEOUT_S",
                                        2.0),
        stream_timeout_s=cfg.get_float("TPU_GATEWAY_STREAM_TIMEOUT_S",
                                       120.0),
        resume=cfg.get_bool("TPU_RESUME", True),
        resume_max=cfg.get_int("TPU_RESUME_MAX", 3),
        logger=logger, metrics=metrics, observe=observe)


def install_gateway(app) -> Gateway:
    """Wire the gateway role into an App: build from config, register
    the forwarded route + the stats page, register each replica's
    health client in the container (the aggregated
    ``/.well-known/health`` lists them like any other dependency),
    and start the health poller when the app runs."""
    gw = gateway_from_config(app.config, logger=app.logger,
                             metrics=app.container.metrics,
                             tracer=app.container.tracer,
                             observe=getattr(app.container, "observe",
                                             None))
    for r in gw.table.replicas:
        app.container.register_service(f"gateway-replica-{r.idx}",
                                       r.client)

    def generate(ctx):
        return gw.handle_generate(ctx)

    def stats(ctx):
        return gw.stats()

    app.post(gw.path, generate)
    app.get("/gateway/stats", stats)
    # the health poller starts in App.run (a constructed-but-never-run
    # gateway App must not poll replicas in the background)
    if app.logger is not None:
        app.logger.info({
            "event": "gateway role wired", "path": gw.path,
            "replicas": [r.address for r in gw.table.replicas]})
    return gw
