"""The pub/sub async inference lane: bulk generation jobs as
throughput-class traffic (the port's own copy of
gofr_tpu/tenancy/lane.py).

Jobs are published to a topic (``{"job_id": ..., "tokens": [...],
"tenant": ..., ...}``); the subscriber's worker drains them through the
same engine -- the same admission gate, pending line and memory arbiter
-- as throughput-class traffic of the job's tenant, and writes tokens
and resume checkpoints to Redis under ``async:{job_id}``.

Backpressure is admission, not memory: when the gate sheds (queue
depth, device memory, tenant quota) the handler sleeps ``Retry-After``
and re-raises, the subscriber skips the commit, and the broker
redelivers: at-least-once delivery is the retry loop.

Checkpoints make redelivery exact: every ``checkpoint_every`` tokens
the handler stores ``{"status": "running", "tokens": [...]}``; a
redelivered job resumes through ``generate(continue_from=(prompt,
emitted))``, and greedy or seeded sampling makes the continuation
token for token the uninterrupted stream. A job already ``done``
commits at once: results are idempotent.
"""

from __future__ import annotations

import json
import time

from ..errors import BadRequest, TooManyRequests
from ..resilience import SLO_THROUGHPUT, slo_scope
from ..wire import WAKE
from .registry import tenant_scope

__all__ = ["AsyncLane", "install_async_lane"]

DEFAULT_TOPIC = "inference-jobs"


class AsyncLane:
    """The subscriber-side consumer. One an App; register its ``handle``
    with ``app.subscribe(topic, lane.handle)`` (or use
    :func:`install_async_lane`)."""

    def __init__(self, engine=None, *, store=None, checkpoint_every: int = 8,
                 retry_sleep_cap_s: float = 2.0, logger=None, metrics=None):
        self.engine = engine          # None: ctx.tpu at handle time
        self.store = store            # None: ctx.redis at handle time
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.retry_sleep_cap_s = max(0.0, float(retry_sleep_cap_s))
        self.logger = logger
        self.metrics = metrics
        self.jobs_done = 0
        self.jobs_resumed = 0
        self.jobs_backpressured = 0

    # -- checkpoint store ----------------------------------------------------
    @staticmethod
    def _key(job_id: str) -> str:
        return f"async:{job_id}"

    def _load(self, store, job_id: str) -> dict | None:
        raw = store.get(self._key(job_id))
        if raw is None:
            return None
        if isinstance(raw, (bytes, bytearray)):
            raw = raw.decode("utf-8", "replace")
        try:
            doc = json.loads(raw)
        except ValueError:
            return None
        return doc if isinstance(doc, dict) else None

    def _save(self, store, job_id: str, status: str, tokens: list,
              tenant: str) -> None:
        store.set(self._key(job_id), json.dumps(
            {"status": status, "tokens": tokens, "tenant": tenant}))

    def _count(self, outcome: str) -> None:
        if self.metrics is None:
            return
        try:
            self.metrics.increment_counter("app_tpu_async_jobs_total",
                                           outcome=outcome)
        except Exception:  # noqa: BLE001 — telemetry never takes the lane down
            pass

    # -- the handler ---------------------------------------------------------
    def handle(self, ctx) -> None:
        job = ctx.bind()
        if not isinstance(job, dict) or not job.get("job_id") \
                or not isinstance(job.get("tokens"), list):
            raise BadRequest("async job must be JSON with 'job_id' and "
                             "a 'tokens' array")
        try:
            job_id = str(job["job_id"])
            tokens = [int(t) for t in job["tokens"]]
            tenant = str(job.get("tenant") or "") or None
            max_new = int(job.get("max_new", 16))
            temperature = float(job.get("temperature", 0.0) or 0.0)
            top_k = int(job.get("top_k", 0) or 0)
            adapter = int(job.get("adapter", 0) or 0)
            eos = job.get("eos")
            if isinstance(eos, list):
                eos = frozenset(int(t) for t in eos)
            elif eos is not None:
                eos = int(eos)
            seed = job.get("seed")
            seed = int(seed) if seed is not None else None
        except (TypeError, ValueError) as e:
            raise BadRequest(f"async job: malformed field: {e}") from e

        store = self.store if self.store is not None else ctx.redis
        if store is None:
            raise BadRequest(f"async job {job_id!r}: no result store "
                             "(Redis) configured")
        prior = self._load(store, job_id)
        if prior is not None and prior.get("status") == "done":
            self._count("dedup")
            return   # an idempotent replay: commit without regenerating
        engine = self.engine if self.engine is not None else ctx.tpu
        if engine is None:
            raise BadRequest(f"async job {job_id!r}: no engine configured")
        emitted = [int(t) for t in (prior or {}).get("tokens", ())]
        continue_from = (tokens, emitted) if emitted else None
        if continue_from is not None:
            self.jobs_resumed += 1

        # jobs run as the job's tenant in the throughput class: the same
        # ambient channel the HTTP and gRPC edges use, so the gate, the
        # fair line and every per-tenant metric see this traffic
        with tenant_scope(tenant), slo_scope(SLO_THROUGHPUT):
            try:
                stream = engine.generate(
                    tokens, max_new_tokens=max_new,
                    temperature=temperature, top_k=top_k, eos_id=eos,
                    adapter=adapter, seed=seed,
                    continue_from=continue_from)
            except TooManyRequests as e:
                # admission backpressure: keep the progress (a resumed
                # job keeps its emitted prefix), wait out Retry-After,
                # and leave the message uncommitted for redelivery
                self.jobs_backpressured += 1
                self._count("backpressured")
                if emitted:
                    self._save(store, job_id, "running", emitted,
                               tenant or "default")
                retry = float(getattr(e, "retry_after", 0.0) or 0.0)
                if retry > 0 and self.retry_sleep_cap_s > 0:
                    time.sleep(min(retry, self.retry_sleep_cap_s))
                raise
        since_save = 0
        try:
            for item in stream:
                if item is WAKE:
                    continue
                emitted.append(int(item[0] if isinstance(item, tuple)
                                   else item))
                since_save += 1
                if since_save >= self.checkpoint_every:
                    self._save(store, job_id, "running", emitted,
                               tenant or "default")
                    since_save = 0
        except BaseException:
            # a death mid-stream: checkpoint what there is, and let the
            # redelivery resume from here
            try:
                self._save(store, job_id, "running", emitted,
                           tenant or "default")
            except Exception:  # noqa: BLE001 — the original error wins
                pass
            self._count("interrupted")
            raise
        self._save(store, job_id, "done", emitted, tenant or "default")
        self.jobs_done += 1
        self._count("done")
        if self.logger is not None:
            self.logger.info({"event": "async job done", "job_id": job_id,
                              "tenant": tenant or "default",
                              "tokens": len(emitted),
                              "resumed": continue_from is not None})

    def stats(self) -> dict:
        return {"done": self.jobs_done, "resumed": self.jobs_resumed,
                "backpressured": self.jobs_backpressured}


def install_async_lane(app, topic: str | None = None, **kw) -> AsyncLane:
    """Register the async inference lane on an App's subscriber: the
    topic from ``TPU_TENANT_TOPIC`` (default ``inference-jobs``), the
    checkpoint cadence from ``TPU_TENANT_CHECKPOINT_EVERY`` (default 8
    tokens)."""
    topic = topic or app.config.get("TPU_TENANT_TOPIC") or DEFAULT_TOPIC
    kw.setdefault("checkpoint_every",
                  app.config.get_int("TPU_TENANT_CHECKPOINT_EVERY", 8))
    kw.setdefault("logger", app.logger)
    kw.setdefault("metrics", app.container.metrics)
    lane = AsyncLane(**kw)
    app.subscribe(topic, lane.handle)
    return lane
