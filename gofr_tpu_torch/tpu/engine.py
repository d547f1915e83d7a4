"""The engine facade a handler reaches as ``ctx.tpu`` (counterpart of
gofr_tpu/tpu/engine.py): predict programs behind coalescing batchers,
streaming generation, health and close.

  - A program is a plain function on tensors, run at a small lattice of
    (batch, seq) buckets: items are padded to their bucket on the host,
    so the shapes the card sees stay few.
  - One dispatcher thread a program (``CoalescingBatcher``) coalesces
    concurrent handler threads into one dispatch.
  - A batch's inputs are stacked on the host and copied to the card
    once, and its outputs come back in one copy (JAX's
    ``jax.device_get``), as float32 numpy arrays.
  - The dispatcher runs each batch under ``torch.inference_mode`` with
    the engine's card as the current device: grad mode and the current
    device are per thread in PyTorch, and a new thread starts with
    autograd on.

Generation (``generate``) is the ``GenerationEngine``'s own serving
loop; on a Llama engine the ``score`` program's dispatcher launches on
the same card beside it. On a P/D prefill worker
(``TPU_SERVING_ROLE=prefill``, ``pd_prefill``) ``generate`` routes
through the coordinator: the local engine prefills, the KV ships to the
decode peer and its tokens come back; a decode worker's ingest listener
(``pd_ingest``) feeds the same local engine, which still serves its own
requests fused. With a tenancy plane (``tenancy``) ``predict``
resolves the ambient tenant as ``generate`` does and holds one of its
concurrency slots for the call.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .. import tracing
from ..datasource import STATUS_DEGRADED, STATUS_DOWN, STATUS_UP, Health
from ..device import resolve_device
from ..errors import DeadlineExceeded, ProgramNotFound, ServiceUnavailable
from ..resilience import current_deadline, current_slo_class
from ..tenancy.registry import current_tenant
from . import hbm
from .batcher import ClassPolicy, CoalescingBatcher, pad_bucket
from .generator import GenerationEngine, GenStream

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8)
DEFAULT_SEQ_BUCKETS = (32, 64, 128, 256, 512)


def _tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of dicts, lists and tuples of the same
    structure (the items and outputs a program takes and gives)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """One device-to-host copy; numpy has no bfloat16."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


@dataclass
class Program:
    """One servable function.

    kind="tokens": items are 1-D int32 token arrays of varying length;
      the runner pads to (Bb, Sb) buckets and calls
      ``fn(params, tokens [B, S], lengths [B])`` (int32 tensors).
    kind="fixed": items are (trees of) fixed-shape arrays; the runner
      stacks them on a new leading axis, padding with the last item, and
      calls ``fn(params, batch)``.

    ``fn`` returns a tensor (or a tree of them) with a leading batch
    axis. ``compiled_shapes``: the bucket shapes run so far.
    """

    name: str
    fn: Callable
    params: Any
    kind: str = "tokens"
    batch_buckets: tuple[int, ...] = DEFAULT_BATCH_BUCKETS
    seq_buckets: tuple[int, ...] = DEFAULT_SEQ_BUCKETS
    example_item: Any = None  # fixed kind: one item's input, for warmup
    compiled_shapes: set = field(init=False, default_factory=set)
    dispatches: int = field(init=False, default=0)

    def __post_init__(self):
        self.batch_buckets = tuple(sorted(self.batch_buckets))
        self.seq_buckets = tuple(sorted(self.seq_buckets))

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]


class TorchEngine:
    """Registry of predict programs, their coalescing dispatch, the
    generation engine (decoder models) and health.

    Thread-safe: any number of handler threads may call ``predict``
    concurrently; each program's batcher serializes its dispatches."""

    def __init__(self, generator: GenerationEngine | None = None,
                 model_name: str = "", device=None, *, logger=None,
                 metrics=None, max_delay: float = 0.004, gate=None,
                 class_policy: ClassPolicy | None = None, observe=None):
        self.generator = generator
        self.model_name = model_name
        if device is None:
            device = generator.device if generator is not None else "cuda"
        self.device = resolve_device(device)
        self.logger = logger
        self.metrics = metrics
        if metrics is not None:
            # device-byte and arbiter gauges (app_tpu_device_bytes,
            # app_tpu_hbm_*), also for engines without a generator
            hbm.set_metrics(metrics)
        self.max_delay = max_delay
        # resilience.AdmissionGate TEMPLATE (None = admit everything):
        # each program gets its own clone, fed with that program's waits
        self.gate = gate
        self._gates: dict[str, Any] = {}
        self.class_policy = class_policy
        # the App's observability bundle (observe.Observe), if any: each
        # predict call's registry entry and its recorder event on
        # failure
        self.observe = observe
        # the serving timeline: None when emission is off, so a dispatch
        # pays one attribute test
        tl = getattr(observe, "timeline", None)
        self._tl = tl if (tl is not None and tl.enabled) else None
        # tenancy.TenantPlane, set by new_engine_from_config from the
        # TPU_TENANTS rows; None: anonymous single-tenant serving
        self.tenancy = None
        # disaggregated serving (pd/): pd.wire_role sets one of these for
        # a non-fused role, a prefill worker's coordinator (generate
        # routes through it) or a decode worker's KV-ingest listener
        self.serving_role = "fused"
        self.pd_prefill = None
        self.pd_ingest = None
        self._programs: dict[str, Program] = {}
        self._batchers: dict[str, CoalescingBatcher] = {}
        self._lock = threading.Lock()
        self._closed = False

    # -- registration --------------------------------------------------------
    def register(self, name: str, fn: Callable, params: Any, *,
                 kind: str = "tokens",
                 batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
                 seq_buckets: Sequence[int] = DEFAULT_SEQ_BUCKETS,
                 example_item: Any = None) -> Program:
        prog = Program(name=name, fn=fn, params=params, kind=kind,
                       batch_buckets=tuple(batch_buckets),
                       seq_buckets=tuple(seq_buckets),
                       example_item=example_item)
        with self._lock:
            self._programs[name] = prog
            if self.gate is not None:
                self._gates[name] = self.gate.clone(name)
            self._batchers[name] = CoalescingBatcher(
                runner=lambda items, p=prog: self._run_batch(p, items),
                max_batch=prog.max_batch, max_delay=self.max_delay,
                name=f"tpu-{name}", on_dispatch=self._dispatch_metrics(prog),
                on_queue_depth=self._depth_gauge(name),
                on_expired=self._expired_counter(name),
                class_policy=self.class_policy, timeline=self._tl)
        if self.logger is not None:
            self.logger.info({"event": "tpu program registered",
                              "program": name, "kind": kind,
                              "batch_buckets": list(prog.batch_buckets)})
        return prog

    def _depth_gauge(self, program: str):
        if self.metrics is None:
            return None

        def hook(depth: int) -> None:
            self.metrics.set_gauge("app_tpu_queue_depth", float(depth),
                                   program=program)
        return hook

    def _gate_for(self, program: str):
        """The program's own gate clone; made lazily for a gate set
        after registration."""
        g = self._gates.get(program)
        if g is None and self.gate is not None:
            with self._lock:
                g = self._gates.get(program)
                if g is None:
                    g = self.gate.clone(program)
                    self._gates[program] = g
        return g

    def _dispatch_metrics(self, prog: Program):
        def hook(batch_size: int, oldest_wait: float) -> None:
            gate = self._gates.get(prog.name)
            if gate is not None:
                # a new arrival would wait about what this batch's
                # oldest item waited
                gate.note_wait(oldest_wait)
            if self.metrics is None:
                return
            bucket = pad_bucket(batch_size, prog.batch_buckets)
            self.metrics.record_histogram("app_tpu_batch_wait_duration",
                                          oldest_wait, program=prog.name)
            self.metrics.set_gauge("app_tpu_batch_fill", batch_size / bucket,
                                   program=prog.name)
        return hook

    def _expired_counter(self, program: str):
        def hook(n: int) -> None:
            if self.metrics is None:
                return
            for _ in range(n):
                self.metrics.increment_counter(
                    "app_tpu_expired_dropped_total", program=program)
        return hook

    # -- the batched device dispatch ----------------------------------------
    def _run_batch(self, prog: Program, items: list) -> list:
        t0 = time.monotonic()
        out = self._execute(prog, items)
        prog.dispatches += 1
        if self._tl is not None:
            self._tl.predict(t0, time.monotonic(), prog.name, len(items))
        if self.metrics is not None:
            self.metrics.record_histogram("app_tpu_device_execute_duration",
                                          time.monotonic() - t0,
                                          program=prog.name)
        return out

    def _on_device(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _execute(self, prog: Program, items: list) -> list:
        """Pad, copy in, run, copy out: one dispatch of ``items``."""
        with torch.inference_mode(), self._on_device():
            if prog.kind == "tokens":
                out = self._run_tokens(prog, items)
            else:
                out = self._run_fixed(prog, items)
            host = _tree_map(_to_host, out)
        return [_tree_map(lambda a, i=i: a[i], host)
                for i in range(len(items))]

    def _run_tokens(self, prog: Program, items: list):
        rows = [np.asarray(it, np.int32).reshape(-1) for it in items]
        Sb = pad_bucket(max(len(r) for r in rows), prog.seq_buckets)
        Bb = pad_bucket(len(rows), prog.batch_buckets)
        # tokens and lengths in one host buffer: one copy to the card
        host = np.zeros(Bb * Sb + Bb, np.int32)
        tokens = host[:Bb * Sb].reshape(Bb, Sb)
        for i, r in enumerate(rows):
            tokens[i, :len(r)] = r
        host[Bb * Sb:Bb * Sb + len(rows)] = [len(r) for r in rows]
        dev = torch.from_numpy(host).to(self.device)
        self._note_shape(prog, (Bb, Sb))
        return prog.fn(prog.params, dev[:Bb * Sb].view(Bb, Sb),
                       dev[Bb * Sb:])

    def _run_fixed(self, prog: Program, items: list):
        Bb = pad_bucket(len(items), prog.batch_buckets)
        padded = list(items) + [items[-1]] * (Bb - len(items))
        batch = _tree_map(
            lambda *xs: torch.from_numpy(np.stack(xs)).to(self.device),
            *padded)
        self._note_shape(prog, (Bb,))
        return prog.fn(prog.params, batch)

    def _note_shape(self, prog: Program, shape: tuple) -> None:
        if shape not in prog.compiled_shapes:
            prog.compiled_shapes.add(shape)
            if self.logger is not None:
                self.logger.debug({"event": "tpu new shape",
                                   "program": prog.name,
                                   "shape": list(shape)})

    # -- public API (ctx.tpu.predict) ---------------------------------------
    def predict(self, program: str, item: Any, timeout: float | None = 60.0,
                deadline=None, slo_class: str | None = None) -> Any:
        """Run one item through a registered program, coalescing with any
        concurrent callers; returns its un-batched result (numpy).

        ``deadline`` (resilience.Deadline) defaults to the ambient one
        the transport opened from ``X-Request-Timeout``: the wait is
        capped to the remaining budget and the item is dropped
        unexecuted if it expires while queued. The program's gate, when
        configured, sheds with ``TooManyRequests`` before the item joins
        the line. ``slo_class`` defaults to the ambient class."""
        if self._closed:
            raise ServiceUnavailable("TPU engine is closed")
        batcher = self._batchers.get(program)
        if batcher is None:
            raise ProgramNotFound(program, list(self._programs))
        if deadline is None:
            deadline = current_deadline()
        if slo_class is None:
            slo_class = current_slo_class()
        if deadline is not None and deadline.expired():
            if self.metrics is not None:
                self.metrics.increment_counter(
                    "app_tpu_expired_dropped_total", program=program)
            raise DeadlineExceeded(
                f"deadline expired before predict({program!r}) was queued")
        gate = self._gate_for(program)
        span = tracing.current_span()
        trace_id = span.trace_id if span else ""
        spec = None
        if self.tenancy is not None:
            # the edge contract of generate(): resolve the ambient
            # tenant, apply its class default, hold its quota for the
            # call
            spec = self.tenancy.resolve(current_tenant())
            slo_class = self.tenancy.effective_class(spec, slo_class)
            try:
                self.tenancy.admit(spec, program=program,
                                   slo_class=slo_class, gate=gate)
            except BaseException:
                if self._tl is not None:
                    self._tl.shed(program, slo_class, trace_id)
                raise
        try:
            if gate is not None:
                try:
                    gate.admit(batcher.queue_depth(), program=program,
                               slo_class=slo_class,
                               tenant=spec.tenant_id if spec is not None
                               else "")
                except BaseException:
                    if self._tl is not None:
                        self._tl.shed(program, slo_class, trace_id)
                    raise
            self._validate_item(self._programs[program], item)
        except BaseException:
            if spec is not None:
                self.tenancy.release(spec.tenant_id)
            raise
        t0 = time.monotonic()
        entry = None
        if self.observe is not None:
            entry = self.observe.requests.add("predict", program, trace_id,
                                              stage="batch-wait")
        failed = None
        try:
            return batcher.submit(item, timeout=timeout, deadline=deadline,
                                  slo_class=slo_class)
        except BaseException as e:
            failed = e
            raise
        finally:
            if spec is not None:
                self.tenancy.release(spec.tenant_id)
            dur = time.monotonic() - t0
            if self.observe is not None:
                self.observe.requests.remove(entry)
                if failed is not None:
                    # no request_id: that key is the generation streams'
                    # counter, which /debug/events filters by
                    self.observe.recorder.record(
                        "predict_failed", trace_id=entry.trace_id,
                        program=program, duration_s=round(dur, 6),
                        error=repr(failed))
            if self.metrics is not None:
                self.metrics.increment_counter("app_tpu_requests_total",
                                               program=program)
                self.metrics.record_histogram(
                    "app_tpu_predict_duration", dur,
                    exemplar=trace_id or None, program=program)

    def predict_batch(self, program: str, items: list) -> list:
        """Direct batched execution on the calling thread, bypassing
        the coalescing line (for callers that already hold a batch)."""
        prog = self._programs.get(program)
        if prog is None:
            raise ProgramNotFound(program)
        for it in items:
            self._validate_item(prog, it)
        out = []
        for i in range(0, len(items), prog.max_batch):
            out.extend(self._run_batch(prog, items[i:i + prog.max_batch]))
        if self.metrics is not None:
            for _ in items:  # one request per item, as predict counts
                self.metrics.increment_counter("app_tpu_requests_total",
                                               program=program)
        return out

    def _validate_item(self, prog: Program, item: Any) -> None:
        """Refuse a bad input BEFORE it joins a coalesced batch, where it
        would fail every request dispatched with it."""
        if prog.kind == "tokens":
            n = int(np.asarray(item).shape[0])
            limit = prog.seq_buckets[-1]
            if n == 0 or n > limit:
                raise ValueError(f"program {prog.name!r}: item length {n} "
                                 f"outside (0, {limit}]")
        elif prog.example_item is not None:
            want = _tree_map(np.shape, prog.example_item)
            got = _tree_map(np.shape, item)
            if want != got:
                raise ValueError(f"program {prog.name!r}: item shapes {got} "
                                 f"!= expected {want}")

    def generate(self, *args, **kw) -> GenStream:
        """Streaming token generation; see ``GenerationEngine.generate``.
        On a prefill worker this routes through the P/D coordinator
        (``PDPrefill.generate``, the same signature): local prefill-only
        compute, the KV shipped to the decode pool, its tokens relayed
        back as one stream."""
        if self.pd_prefill is not None:
            return self.pd_prefill.generate(*args, **kw)
        if self.generator is None:
            raise ServiceUnavailable(
                "no decoder model configured (TPU_MODEL must be a "
                "llama-family model for generate)")
        return self.generator.generate(*args, **kw)

    # -- warmup --------------------------------------------------------------
    def warmup(self, program: str | None = None) -> None:
        """Run every bucket shape once: every (Bb, Sb) of a tokens
        program (zero tokens, full lengths), every Bb of a fixed program
        that has an ``example_item``. The generator captures its CUDA
        graphs when it is built and has no warmup."""
        names = [program] if program else list(self._programs)
        for name in names:
            prog = self._programs.get(name)
            if prog is None:
                raise ProgramNotFound(name, list(self._programs))
            if prog.kind == "tokens":
                for Bb in prog.batch_buckets:
                    for Sb in prog.seq_buckets:
                        self._execute(prog, [np.zeros(Sb, np.int32)] * Bb)
            elif prog.example_item is not None:
                for Bb in prog.batch_buckets:
                    self._execute(prog, [prog.example_item] * Bb)
            elif self.logger is not None:
                self.logger.warn({"event": "tpu warmup skipped",
                                  "program": name,
                                  "reason": "fixed-kind program registered "
                                            "without example_item"})

    # -- health --------------------------------------------------------------
    def health_check(self) -> Health:
        cuda = self.device.type == "cuda"
        details: dict[str, Any] = {
            "platform": "gpu" if cuda else "cpu",
            "device_kind": (torch.cuda.get_device_name(self.device)
                            if cuda else "cpu"),
            "devices": torch.cuda.device_count() if cuda else 1,
            "device": str(self.device),
            "model": self.model_name,
            "programs": {
                n: {"kind": p.kind,
                    "batch_buckets": list(p.batch_buckets),
                    "compiled_shapes": sorted(map(list, p.compiled_shapes))}
                for n, p in self._programs.items()},
        }
        if self._gates:
            details["admission"] = {n: g.stats()
                                    for n, g in sorted(self._gates.items())}
        gen = self.generator
        if gen is not None and gen.mesh is not None:
            # the JAX engine's axis sizes, plus the device group's
            # backend and whether the dispatches are graphs (never under
            # TP in this slice)
            details["mesh"] = {**gen.mesh.shape(),
                               "backend": gen._tp.backend, "graphs": False}
        if cuda:
            details["memory_allocated"] = torch.cuda.memory_allocated(
                self.device)
        # the memory arbiter: per-subsystem declared bytes, and its
        # budget/reclaim/shed summary (the lease table is on /debug/vars)
        acct = hbm.live_bytes()
        if acct:
            details["device_memory"] = acct
        arb = hbm.arbiter_stats()
        if arb["budget_bytes"] or arb["leases"]:
            details["hbm_arbiter"] = {
                k: arb[k] for k in ("budget_bytes", "in_use_bytes",
                                    "headroom_bytes", "reclaims", "sheds",
                                    "oom_retries")}
        if self.generator is not None:
            details["generator"] = self.generator.stats()
        if self.tenancy is not None:
            details["tenancy"] = self.tenancy.stats()
        if self.serving_role != "fused":
            # which pool this replica serves and whether the cross-pool
            # path is up: a decode worker's listener, a prefill worker's
            # peer connection
            details["serving_role"] = self.serving_role
            pd = self.pd_ingest or self.pd_prefill
            if pd is not None:
                details["pd"] = pd.stats()
        if self._closed or (gen is not None and (gen.down is not None
                                                 or not gen.tp_alive())):
            # a dead tensor-parallel rank takes the engine down
            return Health(STATUS_DOWN, details)
        if self.pd_ingest is not None \
                and not self.pd_ingest.stats()["listening"]:
            # a decode worker that cannot take shipped KV is not serving
            # its role, whatever its local engine does
            return Health(STATUS_DOWN, details)
        # an engine with neither a program nor a generator serves nothing;
        # a prefill worker with no decode peer connected can still
        # prefill (its reconnect is armed) but is degraded
        up = self._programs or self.generator is not None
        if self.pd_prefill is not None and not self.pd_prefill.connected:
            up = False
        return Health(STATUS_UP if up else STATUS_DEGRADED, details)

    def close(self) -> None:
        self._closed = True
        # the P/D half first: the listener stops taking KV and the
        # coordinator fails its relays typed before the engine they feed
        # shuts down
        for pd in (self.pd_ingest, self.pd_prefill):
            if pd is not None:
                pd.close()
        for b in self._batchers.values():
            b.close(drain=False)
        if self.generator is not None:
            self.generator.close()
