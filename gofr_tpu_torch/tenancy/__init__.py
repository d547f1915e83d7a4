"""The multi-tenant serving plane (the port's own copy of
gofr_tpu/tenancy): registry, fair lines, quotas, the async lane.

One process, many tenants, many arrival paths:

- :mod:`.registry`: ``TenantRegistry`` (a hot-reloadable id -> spec
  table), ``tenant_scope``/``current_tenant`` (the ambient tenant),
  ``QuotaBook`` (rps and concurrency quotas) and ``TenantPlane``, the
  enforcement object the engine carries.
- :mod:`.fair`: ``WeightedFairLine``, the deficit-round-robin
  per-tenant line inside each SLO class of the generator's pending
  line.
- :mod:`.lane`: the pub/sub async inference consumer: bulk jobs in,
  tokens and resume checkpoints out to Redis, held back by the same
  admission gate as everything else.

Enable it by pointing ``TPU_TENANTS`` at a registry JSON file (or
``TPU_TENANTS_INLINE`` at the document itself); without either every
request is the anonymous default tenant and nothing here is on the hot
path.
"""

from .fair import WeightedFairLine
from .lane import AsyncLane, install_async_lane
from .registry import (
    DEFAULT_TENANT,
    QuotaBook,
    TenantPlane,
    TenantRegistry,
    TenantSpec,
    current_tenant,
    plane_from_config,
    tenant_scope,
)

__all__ = [
    "AsyncLane",
    "DEFAULT_TENANT",
    "QuotaBook",
    "TenantPlane",
    "TenantRegistry",
    "TenantSpec",
    "WeightedFairLine",
    "current_tenant",
    "install_async_lane",
    "plane_from_config",
    "tenant_scope",
]
