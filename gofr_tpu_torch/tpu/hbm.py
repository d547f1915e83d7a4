"""Device-memory arbiter: one budget every subsystem leases from (the
port's own copy of gofr_tpu/tpu/hbm.py).

Each subsystem that holds device memory on the card (the serving KV
cache, the prefix tiers' T0 pool, the scratch row) would otherwise
assume it owned the whole device, and the first one to be wrong kills
the process. This module is the arbitration point that makes them
coexist: ONE budget, leased out per subsystem, with demand-driven
reclaim and a shed path so an allocation failure degrades the
*request* instead of killing the *process*.

Three layers, lowest first:

  **Accounting**: every persistent device buffer is declared via
  :func:`account`, keyed ``(subsystem, owner, tag)`` with SET
  semantics (a recovery reallocation replaces instead of
  double-counting). ``release(owner=self)`` in ``close()``; a weakref
  finalizer backstops owners that die without it.

  **Leases**: :func:`lease` reserves bytes against the budget BEFORE an
  allocation, tagged with a priority class -- ``PRI_SERVING`` (live
  serving state, never auto-reclaimed), ``PRI_CACHE`` (performance
  caches that shrink toward lower tiers), ``PRI_SCRATCH`` (workspace,
  dropped first) -- and an optional **reclaim callback**
  ``(need_bytes) -> freed_bytes``. When a lease would exceed the budget
  the arbiter runs the callbacks (scratch first, then caches), then
  re-checks; if the deficit survives it raises :class:`HBMExhausted`.
  :func:`alloc` is the one-call form serving code uses: lease the bytes
  the caller computed from the allocation's shapes (a torch thunk that
  names its device has no abstract tracer, as ``jax.eval_shape`` is in
  the JAX package), run the thunk, check that the result holds exactly
  those bytes, and on a real device out-of-memory error
  (:func:`is_oom_error`, ``torch.OutOfMemoryError`` among them) reclaim,
  empty the caching allocator's free blocks and retry ONCE.
  :func:`check` is the zero-byte request-path checkpoint the generation
  loop calls per admission.

  **Shed**: :class:`HBMExhausted` IS a ``TooManyRequests``: it carries
  ``Retry-After`` and maps to 429 / RESOURCE_EXHAUSTED at both
  transports, through the admission gate's shed surface
  (``AdmissionGate.shed_memory``, ``app_tpu_hbm_shed_total``), and the
  process keeps serving. The seeded chaos seam ``HBM_ALLOC`` fires at
  every lease point, so a fault schedule can kill allocation N
  deterministically.

The budget: ``TPU_HBM_BUDGET_MB`` when set, else on the card the total
that ``torch.cuda.mem_get_info`` reports less the ``TPU_HBM_HEADROOM``
fraction (default 0.1). The headroom covers what the registry cannot
see: the weights, the CUDA graphs' memory pools, cuBLAS workspaces and
the caching allocator's slack. On the CPU the budget stays OFF unless
set (``set_budget``): there is no device limit to enforce.

Tenancy: :func:`tenant_lease` is a lease tagged ``tenant:{id}`` at
``PRI_SCRATCH`` whose reclaim callback evicts that tenant's prefix-cache
rows, so arbiter pressure asks an over-budget tenant for its own rows
before the ``PRI_CACHE`` pool shrink flushes everyone's.

Observability: ``app_tpu_device_bytes{subsystem=}`` gauges on every
accounting change, ``app_tpu_hbm_budget_bytes``,
``app_tpu_hbm_reclaims_total{subsystem=}`` /
``app_tpu_hbm_shed_total{subsystem=}`` counters, and the
``hbm_arbiter`` section of ``TorchEngine.health_check`` and the App's
``/debug/vars``. Subsystem vocabulary: ``engine`` (serving KV cache +
scratch row), ``kvcache-t0`` (prefix-pool rows), ``batcher``.

Tensor parallelism (the counterpart of JAX's per-device leases and
``alloc_sharded``): a lease may name its ``device`` and ``rank``. Each
rank's process leases its own shard, and rank 0 records every worker
rank's rows under the worker's device, so ``arbiter_stats()`` lists one
row a rank with a ``device`` field. ``TPU_HBM_DEVICE_BUDGET_MB``
(``set_device_budget``) bounds the sum of the rows of each device: two
ranks sharing one card are checked together on rank 0.

Serving timelines (``set_timeline``, weakly held as the metrics sinks
are) receive an ``hbm`` counter sample on every accounting change and
the reclaim and shed instants, so an exported trace carries one
``hbm:<subsystem>`` counter track a subsystem.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Any, Callable

import numpy as np
import torch

from .. import chaos
from ..errors import TooManyRequests

__all__ = ["HBMExhausted", "PRI_CACHE", "PRI_SCRATCH", "PRI_SERVING",
           "account", "alloc", "arbiter_stats", "budget", "check",
           "configure", "device_budget", "is_oom_error", "lease",
           "live_bytes", "note_shed", "reclaim", "release", "reset",
           "set_budget", "set_device_budget", "set_metrics",
           "set_timeline", "snapshot", "tenant_lease", "tree_nbytes"]

GAUGE = "app_tpu_device_bytes"
BUDGET_GAUGE = "app_tpu_hbm_budget_bytes"
RECLAIMS_COUNTER = "app_tpu_hbm_reclaims_total"
SHED_COUNTER = "app_tpu_hbm_shed_total"

# Lease priority classes -- the RECLAIM order, highest value first:
# scratch is dropped before caches shrink, and live serving state is
# never auto-reclaimed (a lease may still attach a callback at
# PRI_SERVING -- the paged engine's cold-prefix release -- but it runs
# last).
PRI_SERVING = 0
PRI_CACHE = 1
PRI_SCRATCH = 2


class HBMExhausted(TooManyRequests):
    """A lease the budget cannot cover even after reclaim (or a real
    device out-of-memory error that survived the reclaim-then-retry
    pass). A ``TooManyRequests`` on purpose: the failure is SERVED --
    429 with ``Retry-After`` on HTTP, RESOURCE_EXHAUSTED with the retry
    trailer on gRPC -- instead of killing the process."""

    def __init__(self, subsystem: str, nbytes: int, *,
                 budget: int | None = None, in_use: int | None = None,
                 retry_after: float = 1.0):
        detail = ""
        if budget is not None:
            detail = (f" (budget {budget >> 20} MiB, "
                      f"in use {(in_use or 0) >> 20} MiB)")
        super().__init__(
            f"hbm arbiter: cannot cover {subsystem!r} lease of "
            f"{int(nbytes)} bytes after reclaim{detail}",
            retry_after=retry_after, reason="hbm")
        self.subsystem = subsystem
        self.nbytes = int(nbytes)


_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "OutOfMemory")


def is_oom_error(e: BaseException) -> bool:
    """Is this the allocation-failure class the arbiter owns? Our own
    :class:`HBMExhausted`, ``torch.OutOfMemoryError`` (the caching
    allocator's "CUDA out of memory"), the chaos harness's injected
    ``ResourceExhausted``, and any RuntimeError or MemoryError whose
    message carries an out-of-memory marker (the JAX package's
    classifier, by name and message)."""
    if isinstance(e, (HBMExhausted, torch.OutOfMemoryError)):
        return True
    name = type(e).__name__
    if "ResourceExhausted" in name or "OutOfMemory" in name:
        return True
    if isinstance(e, (RuntimeError, MemoryError)):
        msg = str(e)
        return any(m in msg for m in _OOM_MARKERS)
    return False


def tree_nbytes(tree: Any) -> int:
    """Total bytes of the tensor and array leaves of ``tree`` (dicts,
    tuples, lists and dataclasses such as a KV cache are walked); None
    leaves (absent scale planes) contribute nothing."""
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_nbytes(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return sum(tree_nbytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return int(getattr(tree, "nbytes", 0) or 0)


class _Registry:
    def __init__(self) -> None:
        self._mu = threading.Lock()
        # ids of owners whose finalizer ran: dropped under _mu, by the
        # finalizer itself or by the next _locked section
        self._dead: list[int] = []
        # (subsystem, owner_id, tag) -> bytes
        self._entries: dict[tuple[str, int, str], int] = {}
        # lease metadata per key: (priority, reclaim-callable-or-ref).
        # Bound-method callbacks are held via weakref.WeakMethod so a
        # registered reclaimer never pins its engine alive; account()
        # keeps a key's meta, so a recovery re-account keeps the lease's
        # class and callback
        self._meta: dict[tuple[str, int, str], tuple[int, Any]] = {}
        # where a lease lives, for a tensor-parallel rank's rows:
        # key -> (device, rank)
        self._place: dict[tuple[str, int, str], tuple[str, int]] = {}
        self._budget: int | None = None
        self._dev_budget: int | None = None
        # single-flight reclaim: one pass at a time process-wide.
        # Concurrent requesters return 0 and judge the budget as-is,
        # which also breaks any cross-engine lock cycle a nested
        # reclaim chain could build (engine A's callback holds A's
        # device lock while B's wants B's)
        self._reclaim_mu = threading.Lock()
        self._reclaims: dict[str, int] = {}
        self._reclaimed_bytes = 0
        self._sheds: dict[str, int] = {}
        self._oom_retries: dict[str, int] = {}
        # gauge sinks, weakly held: the registry outlives any metrics
        # Manager and must not pin one alive
        self._sinks: "weakref.WeakSet[Any]" = weakref.WeakSet()
        # serving timelines (observe/timeline.py), the same weak fan-out:
        # every accounting change lands a counter sample
        self._timelines: "weakref.WeakSet[Any]" = weakref.WeakSet()

    # -- accounting -----------------------------------------------------------
    def account(self, subsystem: str, tree: Any, *, owner: Any = None,
                tag: str = "") -> Any:
        key = (subsystem, id(owner) if owner is not None else 0, tag)
        n = tree_nbytes(tree)
        with self._locked():
            self._entries[key] = n   # SET semantics: replace, never add
        if owner is not None:
            self._finalize(owner)
        self._push(subsystem)
        return tree

    def _finalize(self, owner: Any) -> None:
        # safety net for owners that die WITHOUT close(): an __init__
        # that runs out of memory after its first account() must not
        # leave phantom bytes behind, and a reused id() must not alias
        # a dead owner's entries
        try:
            weakref.finalize(owner, self._release_owner_id, id(owner))
        except TypeError:
            pass  # non-weakrefable owner: explicit release only

    def _release_owner_id(self, oid: int) -> None:
        """An owner's finalizer. It can run inside the garbage collector,
        in any allocation, even one this thread makes while it holds
        ``_mu``: so it queues the id and never waits for the lock. The
        holder of the lock (now, or the next ``_locked`` section) drops
        the owner's entries."""
        self._dead.append(oid)
        if not self._mu.acquire(blocking=False):
            return
        try:
            touched = self._drop_dead_locked()
        finally:
            self._mu.release()
        for sub in touched:
            self._push(sub)

    def _drop_dead_locked(self) -> set[str]:
        touched: set[str] = set()
        while self._dead:
            oid = self._dead.pop()
            for key in [k for k in self._entries if k[1] == oid]:
                self._entries.pop(key)
                touched.add(key[0])
            for key in [k for k in self._meta if k[1] == oid]:
                self._meta.pop(key)
            for key in [k for k in self._place if k[1] == oid]:
                self._place.pop(key)
        return touched

    @contextlib.contextmanager
    def _locked(self):
        """``_mu`` held, the entries of owners that died meanwhile
        dropped first (their gauges pushed after it is released)."""
        self._mu.acquire()
        try:
            touched = self._drop_dead_locked()
            yield
        finally:
            self._mu.release()
        for sub in touched:
            self._push(sub)

    def release(self, subsystem: str | None = None, *,
                owner: Any = None, tag: str | None = None) -> int:
        """Drop entries by subsystem and/or owner (and optionally an
        exact tag); returns the bytes released. ``release(owner=self)``
        in ``close()`` drops every subsystem the instance accounted --
        leases and their reclaim callbacks die with the entries."""
        oid = None if owner is None else id(owner)
        dropped = 0
        touched: set[str] = set()
        with self._locked():
            for key in list(self._entries):
                sub, key_oid, key_tag = key
                if subsystem is not None and sub != subsystem:
                    continue
                if oid is not None and key_oid != oid:
                    continue
                if tag is not None and key_tag != tag:
                    continue
                dropped += self._entries.pop(key)
                self._meta.pop(key, None)
                self._place.pop(key, None)
                touched.add(sub)
        for sub in touched:
            self._push(sub)
        return dropped

    def live_bytes(self) -> dict[str, int]:
        """Accounted bytes aggregated by subsystem."""
        out: dict[str, int] = {}
        with self._locked():
            for (sub, _, _), n in self._entries.items():
                out[sub] = out.get(sub, 0) + n
        return dict(sorted(out.items()))

    def snapshot(self) -> dict[tuple[str, int, str], int]:
        with self._locked():
            return dict(self._entries)

    # -- the arbiter ----------------------------------------------------------
    def set_budget(self, nbytes: int | None) -> None:
        """Install (or clear, with None/0) the process budget in bytes.
        Tests use this directly with tiny synthetic budgets; a serving
        process resolves it via :func:`configure`."""
        self._budget = int(nbytes) if nbytes else None
        for m in list(self._sinks):
            try:
                m.set_gauge(BUDGET_GAUGE, float(self._budget or 0))
            except Exception:  # noqa: BLE001 — telemetry only
                pass

    def budget(self) -> int | None:
        return self._budget

    def set_device_budget(self, nbytes: int | None) -> None:
        """Install (or clear) the per-device budget: the bytes the rows
        placed on one device (``lease(..., device=)``) may hold
        together."""
        self._dev_budget = int(nbytes) if nbytes else None

    def device_budget(self) -> int | None:
        return self._dev_budget

    def configure(self, budget_mb: int | None = None,
                  headroom: float = 0.1, device=None,
                  device_budget_mb: int | None = None) -> int | None:
        """Resolve and install the budget. An explicit ``budget_mb``
        wins; otherwise, for a CUDA ``device``, the card's total memory
        (``torch.cuda.mem_get_info``) less the ``headroom`` fraction
        (clamped to [0, 0.9]). Any other device leaves the budget off.
        ``device_budget_mb`` (TPU_HBM_DEVICE_BUDGET_MB) sets the
        per-device budget, or clears it. Returns the active budget."""
        self.set_device_budget(int(device_budget_mb) << 20
                               if device_budget_mb else None)
        if budget_mb:
            self.set_budget(int(budget_mb) << 20)
            return self._budget
        if device is not None and torch.device(device).type == "cuda":
            _, total = torch.cuda.mem_get_info(torch.device(device))
            frac = min(max(float(headroom), 0.0), 0.9)
            self.set_budget(int(total * (1.0 - frac)))
        return self._budget

    def _in_use_locked(self) -> int:
        return sum(self._entries.values())

    def _device_in_use_locked(self, device: str) -> int:
        return sum(n for k, n in self._entries.items()
                   if self._place.get(k, ("",))[0] == device)

    def tenant_lease(self, subsystem: str, nbytes: int, *, tenant: str,
                     owner: Any = None, priority: int = PRI_SCRATCH,
                     reclaim: Callable[[int], int] | None = None) -> int:
        """A per-tenant cache-quota lease: :func:`lease` with the tag
        ``tenant:{id}``, so the tenant's footprint shows in
        ``snapshot()`` and ``arbiter_stats()`` under its own key. At
        PRI_SCRATCH (reclaimed first), with a callback that evicts that
        tenant's cache rows: under pressure the over-budget tenant gives
        back its own rows before the PRI_CACHE pool shrink flushes
        everyone's. Usually zero bytes: the pool's own lease accounts
        them, and this one exists for its reclaim order."""
        return self.lease(subsystem, int(nbytes), owner=owner,
                          tag=f"tenant:{tenant}", priority=priority,
                          reclaim=reclaim)

    def lease(self, subsystem: str, nbytes: int, *, owner: Any = None,
              tag: str = "", priority: int = PRI_CACHE,
              reclaim: Callable[[int], int] | None = None,
              device: str | None = None, rank: int | None = None,
              _seam: bool = True) -> int:
        """Reserve ``nbytes`` against the budget BEFORE allocating.
        Fires the seeded ``HBM_ALLOC`` chaos seam, runs reclaim when the
        budget can't cover the request, and raises :class:`HBMExhausted`
        on a surviving deficit. On success the reservation is recorded
        under ``(subsystem, owner, tag)`` -- the later :func:`account`
        of the real tree replaces the figure -- with the priority class
        and ``reclaim`` callback attached. ``device``/``rank``: where a
        tensor-parallel rank's row lives; with a per-device budget the
        rows of that device must fit it together (no reclaim: the rows
        of other ranks' processes cannot be reclaimed from here).
        Returns ``nbytes``."""
        if _seam:  # alloc fires it once itself
            self._fire_seam(subsystem, int(nbytes))
        need = int(nbytes)
        key = (subsystem, id(owner) if owner is not None else 0, tag)
        wrapped = self._wrap_reclaim(reclaim)
        place = None if device is None else (str(device), int(rank or 0))
        over_device: list[int] = []   # the device's use, when it is full

        def deficit() -> int:
            with self._locked():
                held = self._entries.get(key, 0)
                return self._in_use_locked() - held + need - self._budget

        def try_reserve() -> bool:
            # the budget checks and the reservation insert under ONE lock
            # hold: two concurrent leases must not both pass a check
            # neither has reserved against yet
            with self._locked():
                held = self._entries.get(key, 0)
                if place is not None and self._dev_budget:
                    on_dev = (held if self._place.get(key, ("",))[0]
                              == place[0] else 0)
                    in_dev = self._device_in_use_locked(place[0]) - on_dev
                    if in_dev + need > self._dev_budget:
                        over_device.append(in_dev)
                        return False
                b = self._budget
                if b and self._in_use_locked() - held + need > b:
                    return False
                self._entries[key] = need
                self._meta[key] = (int(priority), wrapped)
                if place is not None:
                    self._place[key] = place
                return True

        reserved = try_reserve()
        if not reserved and not over_device:
            # no reclaim for a full device: the rows of other ranks'
            # processes cannot be reclaimed from here
            self._reclaim(deficit(), requester=subsystem)
            reserved = try_reserve()
        if not reserved:
            self.note_shed(subsystem)
            if over_device:
                raise HBMExhausted(f"{subsystem}@{place[0]}", need,
                                   budget=self._dev_budget,
                                   in_use=over_device[-1])
            with self._locked():
                in_use = self._in_use_locked() - self._entries.get(key, 0)
            raise HBMExhausted(subsystem, need, budget=self._budget,
                               in_use=in_use)
        if owner is not None:
            self._finalize(owner)
        self._push(subsystem)
        return need

    def alloc(self, subsystem: str, fn: Callable[[], Any], *,
              nbytes: int | None = None, owner: Any = None, tag: str = "",
              priority: int = PRI_CACHE,
              reclaim: Callable[[int], int] | None = None,
              device: str | None = None, rank: int | None = None) -> Any:
        """Reclaim-then-retry allocation, the one call serving code wraps
        its persistent allocations in. Leases ``nbytes`` (the size the
        caller computed from the allocation's shapes; None reserves
        nothing and leaves enforcement to the out-of-memory retry), runs
        the thunk, and on a real device out-of-memory error
        (:func:`is_oom_error`) runs demand-driven reclaim, gives the
        caching allocator's free blocks back to the card and retries
        ONCE; a second failure raises :class:`HBMExhausted` instead of
        the raw error. The result must hold exactly ``nbytes``
        (ValueError otherwise: the lease would misstate it), and is
        accounted under ``(subsystem, owner, tag)``. A failed allocation
        rolls the key back to its pre-lease state, so no phantom bytes
        stay registered. ``device``/``rank``: as for :func:`lease`."""
        key = (subsystem, id(owner) if owner is not None else 0, tag)
        with self._locked():
            prior = self._entries.get(key)
            prior_meta = self._meta.get(key)
            prior_place = self._place.get(key)

        def rollback() -> None:
            with self._locked():
                self._entries.pop(key, None)
                self._meta.pop(key, None)
                self._place.pop(key, None)
                if prior is not None:
                    self._entries[key] = prior
                if prior_meta is not None:
                    self._meta[key] = prior_meta
                if prior_place is not None:
                    self._place[key] = prior_place
            self._push(subsystem)

        need = int(nbytes or 0)
        self._fire_seam(subsystem, need)
        try:
            self.lease(subsystem, need, owner=owner, tag=tag,
                       priority=priority, reclaim=reclaim, device=device,
                       rank=rank, _seam=False)
        except BaseException:
            rollback()
            raise
        try:
            tree = fn()
        except BaseException as e:
            if not is_oom_error(e):
                rollback()
                raise
            with self._locked():
                self._oom_retries[subsystem] = \
                    self._oom_retries.get(subsystem, 0) + 1
            self._reclaim(max(need, 1), requester=subsystem)
            # the reclaimed tensors sit in the caching allocator until
            # its free blocks go back to the card
            _empty_cache()
            try:
                tree = fn()
            except BaseException as e2:
                rollback()
                if is_oom_error(e2):
                    self.note_shed(subsystem)
                    raise HBMExhausted(subsystem, need,
                                       budget=self._budget) from e2
                raise
        got = tree_nbytes(tree)
        if nbytes is not None and got != need:
            rollback()
            raise ValueError(f"hbm.alloc({subsystem!r}, tag={tag!r}): "
                             f"leased {need} bytes from the shapes but "
                             f"the allocation holds {got}")
        return self.account(subsystem, tree, owner=owner, tag=tag)

    def check(self, subsystem: str) -> None:
        """Zero-byte lease for request-path admission points (the
        generation loop calls it once per admission): fires the
        ``HBM_ALLOC`` seam and, when the process sits OVER its budget
        (budget lowered at runtime, or actuals outgrew estimates), runs
        reclaim and raises :class:`HBMExhausted` if the overshoot
        survives -- the caller sheds THAT request and keeps serving."""
        self._fire_seam(subsystem, 0)
        b = self._budget
        if not b:
            return
        with self._locked():
            in_use = self._in_use_locked()
        if in_use <= b:
            return
        self._reclaim(in_use - b, requester=subsystem)
        with self._locked():
            in_use = self._in_use_locked()
        if in_use > b:
            self.note_shed(subsystem)
            raise HBMExhausted(subsystem, 0, budget=b, in_use=in_use)

    def _fire_seam(self, subsystem: str, nbytes: int) -> None:
        try:
            chaos.fire(chaos.HBM_ALLOC)
        except BaseException as e:
            if is_oom_error(e):
                # an injected allocation failure models one that
                # survived retry: exercise the reclaim machinery, then
                # shed deterministically
                self._reclaim(max(int(nbytes), 1), requester=subsystem)
                self.note_shed(subsystem)
                raise HBMExhausted(subsystem, nbytes,
                                   budget=self._budget) from e
            raise

    def reclaim(self, nbytes: int | None = None) -> int:
        """Manually run one demand-driven reclaim pass for ``nbytes``.
        ``None`` asks EVERY registered reclaimer (need = the sum of all
        reclaimable leases): the last-ditch form the batcher's
        out-of-memory retry uses, where the transient deficit is
        unknowable. Returns bytes freed."""
        if nbytes is None:
            with self._locked():
                need = sum(self._entries.get(k, 0)
                           for k, (_, cb) in self._meta.items()
                           if cb is not None) or 1
        else:
            need = max(int(nbytes), 1)
        return self._reclaim(need, requester="manual")

    @staticmethod
    def _wrap_reclaim(cb):
        if cb is None:
            return None
        try:
            return weakref.WeakMethod(cb)
        except TypeError:
            return cb  # plain function/lambda: held strongly

    @staticmethod
    def _deref_reclaim(wrapped):
        if isinstance(wrapped, weakref.WeakMethod):
            return wrapped()
        return wrapped

    def _reclaim(self, need: int, requester: str = "") -> int:
        """Run registered reclaim callbacks, highest priority class
        first (PRI_SCRATCH before PRI_CACHE before PRI_SERVING; the
        larger lease first within a class), until ``need`` bytes are
        freed or the candidates run out. Single-flight: a pass already
        in progress makes this a no-op returning 0."""
        if not self._reclaim_mu.acquire(blocking=False):
            return 0
        try:
            with self._locked():
                candidates = sorted(
                    ((key, meta, self._entries.get(key, 0))
                     for key, meta in self._meta.items()
                     if meta[1] is not None),
                    key=lambda c: (-c[1][0], -c[2]))
            freed = 0
            for key, meta, _ in candidates:
                if freed >= need:
                    break
                cb = self._deref_reclaim(meta[1])
                if cb is None:
                    with self._locked():  # owner died: drop the dead callback
                        self._meta.pop(key, None)
                    continue
                try:
                    got = int(cb(need - freed) or 0)
                except Exception:  # noqa: BLE001 — a failing reclaimer
                    got = 0  # must never take the requester down with it
                if got > 0:
                    freed += got
                    sub = key[0]
                    with self._locked():
                        self._reclaims[sub] = self._reclaims.get(sub, 0) + 1
                        self._reclaimed_bytes += got
                    self._count_metric(RECLAIMS_COUNTER, subsystem=sub)
                    self._event_timeline(sub, "reclaim", got)
            return freed
        finally:
            self._reclaim_mu.release()

    def note_shed(self, subsystem: str) -> None:
        """Record one request degraded (429/RESOURCE_EXHAUSTED) because
        the arbiter could not cover an allocation
        (``app_tpu_hbm_shed_total{subsystem=}``, and an instant on the
        timelines' ``hbm:*`` track). Every
        :class:`HBMExhausted` raise site in this module counts itself;
        a caller that catches and re-routes one must NOT count it again
        (the batcher's own persistent out-of-memory shed, which raises a
        plain TooManyRequests, is the one external caller)."""
        with self._locked():
            self._sheds[subsystem] = self._sheds.get(subsystem, 0) + 1
        self._count_metric(SHED_COUNTER, subsystem=subsystem)
        self._event_timeline(subsystem, "shed", 0)

    def arbiter_stats(self) -> dict:
        """The lease/reclaim table: budget, in-use, per-lease rows
        (subsystem/tag/bytes/priority/reclaimable), and the reclaim/
        shed/retry counters -- what health and /debug/vars render."""
        with self._locked():
            entries = dict(self._entries)
            meta = dict(self._meta)
            place = dict(self._place)
            reclaims = dict(self._reclaims)
            sheds = dict(self._sheds)
            retries = dict(self._oom_retries)
            reclaimed = self._reclaimed_bytes
        in_use = sum(entries.values())
        pri_names = {PRI_SERVING: "serving", PRI_CACHE: "cache",
                     PRI_SCRATCH: "scratch"}
        leases = []
        per_dev: dict[str, int] = {}
        for (sub, oid, tag), n in sorted(entries.items()):
            pri, cb = meta.get((sub, oid, tag), (PRI_CACHE, None))
            row = {
                "subsystem": sub, "owner": oid, "tag": tag, "bytes": n,
                "priority": pri_names.get(pri, str(pri)),
                "reclaimable": self._deref_reclaim(cb) is not None,
            }
            if (sub, oid, tag) in place:
                row["device"], row["rank"] = place[(sub, oid, tag)]
                per_dev[row["device"]] = per_dev.get(row["device"], 0) + n
            leases.append(row)
        out = {
            "budget_bytes": self._budget,
            "in_use_bytes": in_use,
            "headroom_bytes": (self._budget - in_use
                               if self._budget else None),
            "leases": leases,
            "reclaims": reclaims,
            "reclaimed_bytes": reclaimed,
            "sheds": sheds,
            "oom_retries": retries,
        }
        if per_dev or self._dev_budget:
            db = self._dev_budget
            out["device_budget_bytes"] = db
            out["devices"] = {
                d: {"in_use_bytes": n,
                    "headroom_bytes": (db - n) if db else None}
                for d, n in sorted(per_dev.items())}
        return out

    # -- fan-out sinks --------------------------------------------------------
    def set_metrics(self, metrics: Any) -> None:
        """Attach a metrics Manager (weakly held; every attached Manager
        receives every later change as ``app_tpu_device_bytes``).
        ``None`` detaches all sinks."""
        if metrics is None:
            self._sinks.clear()
            return
        self._sinks.add(metrics)
        for sub in self.live_bytes():
            self._push(sub)
        try:
            metrics.set_gauge(BUDGET_GAUGE, float(self._budget or 0))
        except Exception:  # noqa: BLE001 — telemetry only
            pass

    def set_timeline(self, timeline: Any) -> None:
        """Attach a serving timeline (weakly held) that receives an
        ``hbm`` counter sample on every accounting change plus the
        reclaim and shed instants. ``None`` detaches all timelines."""
        if timeline is None:
            self._timelines.clear()
            return
        self._timelines.add(timeline)
        for sub, n in self.live_bytes().items():
            try:
                timeline.hbm(sub, float(n))
            except Exception:  # noqa: BLE001 — telemetry only
                pass

    def reset(self) -> None:
        """Test hook: forget everything -- entries, leases, budget,
        counters (and zero pushed gauges)."""
        with self._locked():
            subs = {sub for (sub, _, _) in self._entries}
            self._entries.clear()
            self._meta.clear()
            self._place.clear()
            self._dead.clear()
            self._reclaims.clear()
            self._sheds.clear()
            self._oom_retries.clear()
            self._reclaimed_bytes = 0
        self.set_budget(None)
        self.set_device_budget(None)
        for sub in subs:
            self._push(sub)

    def _count_metric(self, name: str, **labels) -> None:
        for m in list(self._sinks):
            try:
                m.increment_counter(name, **labels)
            except Exception:  # noqa: BLE001 — accounting must never
                pass  # take the serving path down

    def _event_timeline(self, subsystem: str, what: str,
                        nbytes: int) -> None:
        for tl in list(self._timelines):
            try:
                tl.hbm_event(subsystem, what, float(nbytes))
            except Exception:  # noqa: BLE001 — telemetry only
                pass

    def _push(self, subsystem: str) -> None:
        sinks = list(self._sinks)
        timelines = list(self._timelines)
        if not sinks and not timelines:
            return
        value = float(self.live_bytes().get(subsystem, 0))
        for m in sinks:
            try:
                m.set_gauge(GAUGE, value, subsystem=subsystem)
            except Exception:  # noqa: BLE001 — telemetry only
                pass
        for tl in timelines:
            try:
                tl.hbm(subsystem, value)
            except Exception:  # noqa: BLE001 — telemetry only
                pass


def _empty_cache() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


_registry = _Registry()

account = _registry.account
alloc = _registry.alloc
arbiter_stats = _registry.arbiter_stats
budget = _registry.budget
check = _registry.check
configure = _registry.configure
device_budget = _registry.device_budget
lease = _registry.lease
live_bytes = _registry.live_bytes
note_shed = _registry.note_shed
reclaim = _registry.reclaim
release = _registry.release
reset = _registry.reset
set_budget = _registry.set_budget
set_device_budget = _registry.set_device_budget
set_metrics = _registry.set_metrics
set_timeline = _registry.set_timeline
snapshot = _registry.snapshot
tenant_lease = _registry.tenant_lease
