"""Tenant registry, ambient tenant scope and per-tenant quota book (the
port's own copy of gofr_tpu/tenancy/registry.py).

The registry is the one table every enforcement point reads: tenant id
-> LoRA adapter index, SLO-class default, queue weight (the deficit
round-robin share in the pending line), rps / concurrency quotas (the
admission gate's per-tenant bound) and cache-budget share (the T0
fraction the prefix cache lets this tenant keep resident before its
rows evict first).

Resolution is transport-edge work: the HTTP middleware reads
``X-Tenant-Id``, the gRPC server reads ``x-tenant-id`` metadata, and
both open a ``tenant_scope``, the same ``threading.local`` channel the
port's ``deadline_scope``/``slo_scope`` ride, so ``generate()`` and
``predict()`` pick the tenant up without per-call plumbing. Unknown ids
resolve to the default tenant's spec (shared line, shared quota): the
label cardinality of every per-tenant metric is bounded by the
registry, never by what clients send.

File-driven registries hot-reload on mtime (throttled): edit the JSON
and the next ``resolve()`` sees the new weights and quotas; a malformed
edit keeps the last good table. One difference from the JAX package is
deliberate: ``plane_from_config`` raises ``ValueError`` naming the row
when the ``TPU_TENANTS`` file cannot be read or the
``TPU_TENANTS_INLINE`` document does not parse, where JAX logs it and
serves with tenancy off (quotas gone without a word).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

from ..errors import TooManyRequests
from ..resilience import SLO_LATENCY, parse_slo_class

__all__ = [
    "DEFAULT_TENANT",
    "QuotaBook",
    "TenantPlane",
    "TenantRegistry",
    "TenantSpec",
    "current_tenant",
    "plane_from_config",
    "tenant_scope",
]

DEFAULT_TENANT = "default"

_scope = threading.local()


def current_tenant() -> str:
    """The ambient tenant id the transport opened for this handler
    thread (the default tenant outside any scope)."""
    return getattr(_scope, "tenant", None) or DEFAULT_TENANT


@contextlib.contextmanager
def tenant_scope(tenant: str | None):
    """Make ``tenant`` ambient for the calling thread. None keeps the
    enclosing scope's tenant (transports call this unconditionally); a
    nested explicit tenant wins (the async lane re-tags the consumer
    thread per job)."""
    prev = getattr(_scope, "tenant", None)
    _scope.tenant = tenant if tenant else (prev or DEFAULT_TENANT)
    try:
        yield _scope.tenant
    finally:
        _scope.tenant = prev


class TenantSpec:
    """One tenant's row: identity plus every enforcement knob. All
    quotas default off (0 = unlimited): a registry that only names
    tenants still buys per-tenant fairness, metrics and routing."""

    __slots__ = ("tenant_id", "adapter", "slo_class", "weight", "rps",
                 "max_concurrency", "cache_share")

    def __init__(self, tenant_id: str, *, adapter: int = 0,
                 slo_class: str | None = None, weight: int = 1,
                 rps: float = 0.0, max_concurrency: int = 0,
                 cache_share: float = 0.0):
        self.tenant_id = str(tenant_id)
        self.adapter = max(0, int(adapter))
        # None: no class default; anything else through the alias table
        # the X-SLO-Class header uses
        self.slo_class = parse_slo_class(slo_class) if slo_class else None
        self.weight = max(1, int(weight))
        self.rps = max(0.0, float(rps))
        self.max_concurrency = max(0, int(max_concurrency))
        self.cache_share = min(1.0, max(0.0, float(cache_share)))

    @classmethod
    def from_dict(cls, row: dict) -> "TenantSpec":
        tid = row.get("tenant_id") or row.get("id") or row.get("name")
        if not tid:
            raise ValueError("tenant row needs a tenant_id/id/name")
        return cls(tid, adapter=row.get("adapter", 0),
                   slo_class=row.get("slo_class"),
                   weight=row.get("weight", 1),
                   rps=row.get("rps", 0.0),
                   max_concurrency=row.get("max_concurrency", 0),
                   cache_share=row.get("cache_share", 0.0))

    def as_dict(self) -> dict:
        return {"tenant_id": self.tenant_id, "adapter": self.adapter,
                "slo_class": self.slo_class, "weight": self.weight,
                "rps": self.rps, "max_concurrency": self.max_concurrency,
                "cache_share": self.cache_share}


def _parse(doc) -> tuple[dict[str, TenantSpec], TenantSpec | None]:
    """A registry document ``{"tenants": [row, ...], "default": row?}``
    -> (id -> spec, the default spec or None). Raises ValueError,
    KeyError or TypeError on a malformed one."""
    if isinstance(doc, (str, bytes)):
        doc = json.loads(doc)
    rows = doc.get("tenants", ()) if isinstance(doc, dict) else None
    if not isinstance(rows, (list, tuple)) or \
            not all(isinstance(r, dict) for r in rows):
        raise ValueError("a tenant registry is a JSON object with a "
                         "'tenants' array of objects")
    specs = {s.tenant_id: s for s in (TenantSpec.from_dict(r) for r in rows)}
    default = (TenantSpec.from_dict({"tenant_id": DEFAULT_TENANT,
                                     **doc["default"]})
               if doc.get("default") else None)
    return specs, default


def _read(path: str) -> tuple[dict[str, TenantSpec], TenantSpec | None]:
    with open(path, encoding="utf-8") as f:
        return _parse(json.load(f))


class TenantRegistry:
    """tenant id -> TenantSpec, with an always-present default spec.

    ``path`` makes the registry file-driven: ``resolve()`` rechecks the
    file's mtime at most every ``reload_s`` seconds, and a changed file
    swaps the whole table in one assignment, so concurrent resolvers see
    the old or the new registry, never a half-loaded one."""

    def __init__(self, specs=(), *, default: TenantSpec | None = None,
                 path: str | None = None, reload_s: float = 0.5,
                 logger=None):
        self.path = path
        self.reload_s = max(0.05, float(reload_s))
        self.logger = logger
        self.default = default or TenantSpec(DEFAULT_TENANT)
        self._specs: dict[str, TenantSpec] = {s.tenant_id: s for s in specs}
        self._mtime = 0.0
        self._next_check = 0.0
        self._reload_lock = threading.Lock()
        self.reloads = 0
        if path:
            self._reload(force=True)

    @classmethod
    def from_json(cls, doc, **kw) -> "TenantRegistry":
        specs, default = _parse(doc)
        return cls(specs.values(), default=default, **kw)

    def _reload(self, force: bool = False) -> None:
        with self._reload_lock:
            try:
                mtime = os.stat(self.path).st_mtime
            except OSError:
                return
            if not force and mtime == self._mtime:
                return
            try:
                specs, default = _read(self.path)
            except (OSError, ValueError, KeyError, TypeError) as e:
                # a malformed edit never takes resolution down: keep
                # serving the last good table, and say so once
                if self.logger is not None:
                    self.logger.error({
                        "event": "tenant registry reload failed",
                        "path": self.path, "error": repr(e)})
                self._mtime = mtime   # do not re-parse the same bad file
                return
            self._specs = specs
            self.default = default or TenantSpec(DEFAULT_TENANT)
            if self._mtime and mtime != self._mtime:
                self.reloads += 1
                if self.logger is not None:
                    self.logger.info({
                        "event": "tenant registry reloaded",
                        "path": self.path, "tenants": len(specs)})
            self._mtime = mtime

    def _maybe_reload(self) -> None:
        if self.path is None:
            return
        now = time.monotonic()
        if now < self._next_check:
            return
        self._next_check = now + self.reload_s
        self._reload()

    def resolve(self, tenant_id: str | None) -> TenantSpec:
        """The spec for ``tenant_id``; unknown or absent ids get the
        default spec (its canonical id, not the raw string: bounded
        metric-label cardinality is part of the contract)."""
        self._maybe_reload()
        if tenant_id:
            spec = self._specs.get(str(tenant_id).strip())
            if spec is not None:
                return spec
        return self.default

    def tenants(self) -> list[TenantSpec]:
        self._maybe_reload()
        return [*self._specs.values(), self.default]

    def __len__(self) -> int:
        return len(self._specs)

    def stats(self) -> dict:
        return {"tenants": sorted(self._specs),
                "path": self.path, "reloads": self.reloads}


class QuotaBook:
    """Per-tenant admission quotas: a token bucket per tenant for rps
    and a live concurrency count. ``check()`` consumes on success (one
    token and one concurrency slot); the caller releases the slot at the
    request's terminal. One small lock, touched once per request."""

    def __init__(self):
        self._lock = threading.Lock()
        # tenant -> [tokens, last refill on the monotonic clock]
        self._buckets: dict[str, list] = {}
        self._active: dict[str, int] = {}

    def check(self, spec: TenantSpec) -> tuple[str | None, float]:
        """Try to admit one request for ``spec``'s tenant: (None, 0) on
        admission (the quota consumed), else (reason, retry_after_s)
        with nothing consumed."""
        tid = spec.tenant_id
        with self._lock:
            if spec.max_concurrency > 0 and \
                    self._active.get(tid, 0) >= spec.max_concurrency:
                return "concurrency", 0.25
            if spec.rps > 0:
                now = time.monotonic()
                cap = max(1.0, spec.rps)
                b = self._buckets.get(tid)
                if b is None:
                    b = self._buckets[tid] = [cap, now]
                tokens = min(cap, b[0] + (now - b[1]) * spec.rps)
                if tokens < 1.0:
                    b[0], b[1] = tokens, now
                    return "rps", max(0.05, (1.0 - tokens) / spec.rps)
                b[0], b[1] = tokens - 1.0, now
            self._active[tid] = self._active.get(tid, 0) + 1
            return None, 0.0

    def release(self, tenant_id: str) -> None:
        with self._lock:
            n = self._active.get(tenant_id, 0)
            if n > 1:
                self._active[tenant_id] = n - 1
            else:
                self._active.pop(tenant_id, None)

    def active(self, tenant_id: str) -> int:
        with self._lock:
            return self._active.get(tenant_id, 0)


class TenantPlane:
    """The wired enforcement plane: registry, quota book and the
    per-tenant telemetry. One per engine; every admission point
    (``generate()``, ``predict()``, the async lane) calls ``admit`` and
    ``release`` around the request, and the cache manager reads
    ``cache_shares`` for its per-tenant T0 budgets."""

    def __init__(self, registry: TenantRegistry, *, metrics=None,
                 logger=None):
        self.registry = registry
        self.quotas = QuotaBook()
        self.metrics = metrics
        self.logger = logger
        self._lock = threading.Lock()
        self._admitted: dict[str, int] = {}
        self._shed: dict[str, int] = {}

    # -- resolution ----------------------------------------------------------
    def resolve(self, tenant_id: str | None) -> TenantSpec:
        return self.registry.resolve(tenant_id)

    def effective_class(self, spec: TenantSpec, slo_class: str) -> str:
        """The tenant's registry default applies when the request
        arrived untagged (which resolves to latency, the global
        default): an explicit throughput tag always stands."""
        if spec.slo_class is not None and slo_class == SLO_LATENCY:
            return spec.slo_class
        return slo_class

    def effective_adapter(self, spec: TenantSpec, adapter: int) -> int:
        """Registry-driven LoRA routing: a request that picked no
        adapter (0, the base model) gets the tenant's fine-tune."""
        return spec.adapter if not adapter else adapter

    def cache_shares(self) -> dict[str, float]:
        return {s.tenant_id: s.cache_share
                for s in self.registry.tenants() if s.cache_share > 0}

    # -- admission -----------------------------------------------------------
    def admit(self, spec: TenantSpec, program: str = "",
              slo_class: str = SLO_LATENCY, gate=None) -> None:
        """Per-tenant quota admission: over quota raises
        ``TooManyRequests`` with ``reason=tenant_quota``, a 429 scoped
        to this tenant, never a global shed. With a gate the shed goes
        through its one bookkeeping path; without one the quota is still
        enforced."""
        tid = spec.tenant_id
        try:
            if gate is not None:
                gate.admit_tenant(spec, self.quotas, program=program,
                                  slo_class=slo_class)
            else:
                why, retry_after = self.quotas.check(spec)
                if why is not None:
                    raise TooManyRequests(
                        f"tenant {tid!r} over {why} quota — shed "
                        f"({slo_class})",
                        retry_after=max(0.05, retry_after),
                        reason="tenant_quota")
        except TooManyRequests:
            with self._lock:
                self._shed[tid] = self._shed.get(tid, 0) + 1
                n = self._shed[tid]
            self._gauge("app_tpu_tenant_shed", n, tid)
            raise
        with self._lock:
            self._admitted[tid] = self._admitted.get(tid, 0) + 1
            n = self._admitted[tid]
        self._gauge("app_tpu_tenant_admitted", n, tid)

    def release(self, tenant_id: str | None) -> None:
        self.quotas.release(tenant_id or DEFAULT_TENANT)

    # -- telemetry -----------------------------------------------------------
    def _gauge(self, name: str, value: float, tenant: str) -> None:
        if self.metrics is None:
            return
        try:
            self.metrics.set_gauge(name, float(value), tenant=tenant)
        except Exception:  # noqa: BLE001 — telemetry only
            pass

    def stats(self) -> dict:
        with self._lock:
            admitted = dict(self._admitted)
            shed = dict(self._shed)
        tenants = {}
        for s in self.registry.tenants():
            tid = s.tenant_id
            tenants[tid] = {
                "weight": s.weight,
                "adapter": s.adapter,
                "slo_class": s.slo_class,
                "rps": s.rps,
                "max_concurrency": s.max_concurrency,
                "cache_share": s.cache_share,
                "admitted": admitted.get(tid, 0),
                "shed": shed.get(tid, 0),
                "active": self.quotas.active(tid),
            }
        return {"registry": self.registry.stats(), "tenants": tenants}


def plane_from_config(cfg, metrics=None, logger=None) -> TenantPlane | None:
    """The serving plane from ``TPU_TENANTS`` (the path of a
    hot-reloadable JSON registry file, re-read at most every
    ``TPU_TENANTS_RELOAD_S`` seconds) or ``TPU_TENANTS_INLINE`` (the
    same document inline, static; ``TPU_TENANTS`` wins when both are
    set). None when neither is set: tenancy is opt-in and costs nothing
    when off. A file that cannot be read, or a document that does not
    parse, raises ValueError naming its row."""
    path = (cfg.get("TPU_TENANTS") or "").strip()
    inline = (cfg.get("TPU_TENANTS_INLINE") or "").strip()
    if not path and not inline:
        return None
    row = "TPU_TENANTS" if path else "TPU_TENANTS_INLINE"
    try:
        if path:
            _read(path)   # refused here, not served without quotas
            registry = TenantRegistry(
                path=path, logger=logger,
                reload_s=cfg.get_float("TPU_TENANTS_RELOAD_S", 0.5))
        else:
            registry = TenantRegistry.from_json(inline, logger=logger)
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise ValueError(f"{row}: the tenant registry cannot be read: "
                         f"{e!r}") from e
    return TenantPlane(registry, metrics=metrics, logger=logger)
