"""Framework-owned replica serving routes (the port's own copy of
gofr_tpu/serving.py's generate and embeddings halves): POST /generate
with the durable-streams resume contract, and POST /v1/embeddings over
a BERT engine's ``embed`` program (``install_embeddings``, at the end
of this module). ``install_generate(app)`` registers a
POST handler over ``ctx.tpu.generate`` that speaks it:

  - every ndjson token line carries a monotone **cursor** — the
    absolute generated-token index of the ORIGINAL request (a resumed
    continuation keeps counting where the dead replica stopped);
  - a mid-stream engine failure after >= 1 delivered token ends the
    (already-200) stream with ONE typed error line whose ``resume``
    object is a complete resume token: request id, next cursor, the
    block-chain fingerprint of prompt+emitted (``tpu.kvcache``'s chain
    hashes, bit-equal to the JAX package's), and the request's
    sampling seed;
  - a repeated ``request_id`` is IDEMPOTENT at admission: the route
    cancels the zombie stream it may still hold before admitting the
    retry, so a client/gateway retry never double-generates;
  - a request with ``resume_from``/``emitted`` admits as a
    continuation (``generate(continue_from=...)``), and the first line
    of the continuation reports ``recompute`` — how many prompt
    positions the replica actually had to prefill.

The request's deadline (``X-Request-Timeout``), class (``X-SLO-Class``)
and trace context reach ``generate`` through the App's middleware
scopes, not through the body.

Request body (JSON)::

    {"tokens": [...],                 # prompt token ids (required)
     "max_new": 16, "temperature": 0.0, "top_k": 0,
     "eos": 2 | [2, 7], "adapter": 0,
     "seed": 123,                     # sampling seed (optional)
     "request_id": "r-...",          # dedup + resume identity
     "resume_from": 5,                # cursor to continue from
     "emitted": [...]}                # the 5 tokens already delivered

Failures BEFORE the first token stay buffered typed responses (400 /
429 + Retry-After / 503 / 504) — the gateway's pre-commit failover
path handles those; only post-commit failures use the typed line.
"""

from __future__ import annotations

import json
import threading

from .errors import BadRequest, HTTPError, status_from_error
from .wire import WAKE

__all__ = ["EmbeddingsRoute", "GenerateRoute", "install_embeddings",
           "install_generate", "resume_chain"]


def resume_chain(tokens, emitted, block: int = 16, adapter: int = 0) -> str:
    """The resume token's block-chain fingerprint: the LAST chain hash
    of prompt+emitted under the same salt/chaining the radix index and
    T2 fingerprint keys use — a successor replica whose cache namespace
    can produce this hash can cover the whole chain warm."""
    import numpy as np

    from .tpu.kvcache import chain_hashes, first_block_hash

    toks = np.concatenate([np.asarray(tokens, np.int32).reshape(-1),
                           np.asarray(emitted, np.int32).reshape(-1)]) \
        if len(emitted) else np.asarray(tokens, np.int32).reshape(-1)
    last = None
    for h in chain_hashes(toks, block, adapter):
        last = h
    if last is None:  # sub-block: same fallback the affinity key uses
        last = first_block_hash(toks, block, adapter)
    return last.hex()[:32]


class _ResumableLines:
    """The ndjson source handed to ``ctx.stream``: tokens map to
    cursor-carrying lines on the transport's zero-handoff sink path
    (the map runs on the producing thread), and terminal engine
    errors — which always ride the queue, never the sink — convert in
    ``__iter__``:

      - failure with ZERO tokens delivered re-raises, so the transport
        returns a buffered typed response (the gateway fails over
        pre-commit, nothing was delivered);
      - failure after >= 1 token yields ONE typed error line carrying
        the resume token, then ends the stream.
    """

    def __init__(self, route: "GenerateRoute", rid: str | None, stream,
                 prompt, emitted, adapter: int):
        self._route = route
        self._rid = rid
        self._stream = stream
        self._prompt = list(int(t) for t in prompt)
        self._emitted = list(int(t) for t in emitted)
        self._adapter = int(adapter)
        self._base = len(self._emitted)
        self._sent = 0

    # -- the per-token transform (sink path AND iterator path) ---------------
    def _line(self, item) -> bytes:
        tok = int(item[0] if isinstance(item, tuple) else item)
        cursor = self._base + self._sent
        obj = {"token": tok, "cursor": cursor}
        if self._sent == 0 and self._base:
            # first line of a continuation: how much prefix this
            # replica actually recomputed (a T1/T2-warm resume covers
            # most of prompt+emitted and recomputes only the tail)
            obj["recompute"] = max(
                0, getattr(self._stream, "prompt_len", 0)
                - getattr(self._stream, "cache_tokens", 0))
        self._sent += 1
        self._emitted.append(tok)
        return (json.dumps(obj) + "\n").encode()

    def resume_token(self) -> dict:
        token: dict = {"cursor": self._base + self._sent,
                       "emitted": self._sent,
                       "chain": resume_chain(self._prompt, self._emitted,
                                             self._route.block,
                                             self._adapter)}
        if self._rid is not None:
            token["request_id"] = self._rid
        seed = getattr(self._stream, "seed", None)
        if seed is not None:
            token["seed"] = int(seed)
        return token

    # -- PushStream protocol passthrough -------------------------------------
    def set_sink(self, sink) -> None:
        self._stream.set_sink(lambda item: sink(self._line(item)))

    def clear_sink(self) -> None:
        cs = getattr(self._stream, "clear_sink", None)
        if cs is not None:
            cs()

    def wake(self) -> None:
        w = getattr(self._stream, "wake", None)
        if w is not None:
            w()

    def cancel(self) -> None:
        c = getattr(self._stream, "cancel", None)
        if c is not None:
            c()

    @property
    def trace(self):
        return getattr(self._stream, "trace", None)

    def __iter__(self):
        try:
            for item in self._stream:
                yield item if item is WAKE else self._line(item)
        except Exception as e:  # noqa: BLE001 — typed-line conversion
            if self._sent == 0:
                raise  # pre-commit: buffered typed response instead
            detail: dict = {
                "message": str(e) or repr(e),
                "status": (status_from_error(e)
                           if isinstance(e, HTTPError) else 503)}
            if detail["status"] in (429, 503):
                detail["retry_after"] = self._route.retry_after_s
                detail["resume"] = self.resume_token()
            yield (json.dumps({"error": detail}) + "\n").encode()
        finally:
            self._route._drop(self._rid, self._stream)


class GenerateRoute:
    """The route's server half: admission (with request-id dedup) +
    the per-request line source. One instance per App; the live-stream
    registry is bounded by in-flight requests (entries drop at each
    stream's terminal, whatever it is)."""

    def __init__(self, engine, *, block: int = 16,
                 retry_after_s: float = 1.0, logger=None):
        self.engine = engine
        self.block = max(1, int(block))
        self.retry_after_s = float(retry_after_s)
        self.logger = logger
        self._live: dict[str, object] = {}
        self._lock = threading.Lock()

    def _drop(self, rid: str | None, stream) -> None:
        if rid is None:
            return
        with self._lock:
            if self._live.get(rid) is stream:
                del self._live[rid]

    def _dedup(self, rid: str | None) -> None:
        """Idempotent replay: a repeated request id cancels the zombie
        stream a previous attempt may still be generating into (its
        client is gone — the retry IS the client now), so a gateway
        retry never runs two generations for one request."""
        if rid is None:
            return
        with self._lock:
            prev = self._live.pop(rid, None)
        if prev is not None:
            try:
                prev.cancel()
            except Exception:
                pass
            if self.logger is not None:
                self.logger.info({"event": "generate replay dedup",
                                  "request_id": rid})

    def handle(self, ctx):
        body = ctx.bind()
        if not isinstance(body, dict) or not isinstance(
                body.get("tokens"), list):
            raise BadRequest("generate: body must be JSON with a "
                             "'tokens' array")
        try:
            tokens = [int(t) for t in body["tokens"]]
            max_new = int(body.get("max_new",
                                   body.get("max_new_tokens", 16)))
            temperature = float(body.get("temperature", 0.0) or 0.0)
            top_k = int(body.get("top_k", 0) or 0)
            adapter = int(body.get("adapter", 0) or 0)
            eos = body.get("eos", body.get("eos_id"))
            if isinstance(eos, list):
                eos = frozenset(int(t) for t in eos)
            elif eos is not None:
                eos = int(eos)
            seed = body.get("seed")
            seed = int(seed) if seed is not None else None
            rid = body.get("request_id")
            rid = str(rid) if rid is not None else None
            resume_from = body.get("resume_from")
            emitted = [int(t) for t in (body.get("emitted") or [])]
        except (TypeError, ValueError) as e:
            raise BadRequest(f"generate: malformed field: {e}") from e
        continue_from = None
        if resume_from is not None:
            if int(resume_from) != len(emitted):
                raise BadRequest(
                    f"generate: resume_from={resume_from} but "
                    f"{len(emitted)} emitted tokens were replayed — "
                    "the cursor must equal the replay length")
            continue_from = (tokens, emitted)
        self._dedup(rid)
        stream = self.engine.generate(
            tokens, max_new_tokens=max_new, temperature=temperature,
            top_k=top_k, eos_id=eos, adapter=adapter, seed=seed,
            continue_from=continue_from)
        if rid is not None:
            with self._lock:
                self._live[rid] = stream
        ctx.stream(_ResumableLines(self, rid, stream, tokens, emitted,
                                   adapter))
        return None

    def stats(self) -> dict:
        with self._lock:
            return {"live": len(self._live)}


def install_generate(app, path: str = "/generate") -> GenerateRoute:
    """Register the canonical streaming /generate on an App. Reads
    ``TPU_KVCACHE_BLOCK`` so the resume token's chain fingerprint uses
    the same block size the replica's radix index hashes by."""
    route = GenerateRoute(
        app.container.tpu,
        block=app.config.get_int("TPU_KVCACHE_BLOCK", 16),
        retry_after_s=app.config.get_float("TPU_RESUME_RETRY_AFTER_S",
                                           1.0),
        logger=app.logger)
    app.post(path, route.handle)
    return route


class EmbeddingsRoute:
    """POST /v1/embeddings over the BERT family's ``embed`` program. The
    wire shape follows the OpenAI embeddings response, except that the
    input is token ids (the framework serves tokens, not text)::

        {"input": [[101, 2023, ...], ...]}   # or one flat id list

    Each input is one ``predict`` call, so concurrent requests coalesce
    in the program's batcher; the request's deadline and class reach it
    through the App's middleware scopes."""

    def __init__(self, engine, *, logger=None):
        self.engine = engine
        self.logger = logger

    def handle(self, ctx):
        body = ctx.bind()
        if not isinstance(body, dict):
            raise BadRequest("embeddings: body must be a JSON object "
                             "with an 'input' array")
        raw = body.get("input")
        if not isinstance(raw, list) or not raw:
            raise BadRequest("embeddings: 'input' must be a non-empty "
                             "array of token-id lists")
        if "embed" not in getattr(self.engine, "_programs", {}):
            raise BadRequest(
                "embeddings: this replica serves no 'embed' program — "
                "run a bert-family model (TPU_MODEL=bert)")
        try:
            items = ([[int(t) for t in raw]]
                     if not isinstance(raw[0], list)
                     else [[int(t) for t in row] for row in raw])
        except (TypeError, ValueError) as e:
            raise BadRequest(
                f"embeddings: malformed token id: {e}") from e
        data = []
        for i, tokens in enumerate(items):
            if not tokens:
                raise BadRequest(f"embeddings: input[{i}] is empty")
            vec = self.engine.predict("embed", tokens)
            data.append({"object": "embedding", "index": i,
                         "embedding": [float(x) for x in vec]})
        return {"object": "list", "data": data,
                "model": getattr(self.engine, "model_name", "bert"),
                "meta": {"tenant": ctx.tenant,
                         "slo_class": ctx.slo_class}}


def install_embeddings(app, path: str = "/v1/embeddings") -> EmbeddingsRoute:
    """Register the canonical /v1/embeddings on an App (BERT family)."""
    route = EmbeddingsRoute(app.container.tpu, logger=app.logger)
    app.post(path, route.handle)
    return route
