"""The ``TPU_SHARDING`` row and the plan it names (counterpart of
gofr_tpu/parallel/mesh.py's ``MeshPlan`` and gofr_tpu/tpu/__init__.py's
``parse_mesh``).

The JAX package builds a named ``jax.sharding.Mesh`` over the slice and
lets XLA emit the collectives. PyTorch has no partitioner: the port runs
one process a tensor-parallel rank (parallel.distributed) and each rank
calls the single-card kernels on its own head shard. So the plan keeps
the JAX axis vocabulary and row syntax (``tp=2``, ``tp=4,dp=1``), but
only the ``tp`` axis is served; any other axis set above 1 raises
``ShardingConfigError`` naming the row (ROADMAP item 11b). Training
(parallel.train) runs ``dp``, ``fsdp`` and ``tp``, one rank a device of
JAX's mesh: rank r sits at JAX's device r of
``reshape(dp, pp, fsdp, ep, sp, tp)`` (``MeshPlan.coords``), so ``tp``
is the fastest axis.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import ShardingConfigError

AXIS_DP = "dp"
AXIS_PP = "pp"
AXIS_FSDP = "fsdp"
AXIS_EP = "ep"
AXIS_SP = "sp"
AXIS_TP = "tp"
MESH_AXES = (AXIS_DP, AXIS_PP, AXIS_FSDP, AXIS_EP, AXIS_SP, AXIS_TP)
# the axes the batch splits over (JAX's DATA_AXES): ep is a data axis
# for everything but the expert weights
DATA_AXES = (AXIS_DP, AXIS_FSDP, AXIS_EP)


@dataclass(frozen=True)
class MeshPlan:
    """A (dp, pp, fsdp, ep, sp, tp) factorization, in the JAX mesh's
    axis order. The port serves plans whose every axis but ``tp`` is
    1."""

    dp: int = 1
    pp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def shape(self) -> dict[str, int]:
        """Axis -> size, as the JAX engine's health reports its mesh."""
        return {ax: getattr(self, ax) for ax in MESH_AXES}

    @property
    def n_ranks(self) -> int:
        """The devices (ranks) the plan covers."""
        n = 1
        for ax in MESH_AXES:
            n *= getattr(self, ax)
        return n

    def coords(self, rank: int) -> dict[str, int]:
        """Rank ``rank``'s index on each axis, in JAX's device order
        (``reshape(dp, pp, fsdp, ep, sp, tp)``: tp fastest)."""
        if not 0 <= rank < self.n_ranks:
            raise ValueError(f"rank {rank} outside {self.row()}")
        out = {}
        for ax in reversed(MESH_AXES):
            size = getattr(self, ax)
            out[ax] = rank % size
            rank //= size
        return {ax: out[ax] for ax in MESH_AXES}

    def row(self) -> str:
        """The axes above 1 in ``TPU_SHARDING`` syntax."""
        return ",".join(f"{ax}={n}" for ax, n in self.shape().items()
                        if n > 1) or "tp=1"


def parse_mesh_row(spec: str | None, what: str = "TPU_SHARDING"
                   ) -> MeshPlan | None:
    """``"tp=8"`` / ``"dp=2,fsdp=2"`` -> MeshPlan (None when unset), any
    axis at any size; ``what`` names the row in an error. A malformed
    row, an unknown axis or a size below 1 raises
    ``ShardingConfigError`` naming the row."""
    if spec is None or not spec.strip():
        return None
    row = spec.strip()
    axes: dict[str, int] = {}
    for part in row.split(","):
        name, eq, val = part.partition("=")
        name = name.strip()
        try:
            size = int(val)
        except ValueError:
            size = 0
        if not eq or name not in MESH_AXES or size < 1:
            raise ShardingConfigError(
                f"{what}={row!r}: expected comma-separated "
                f"axis=size pairs over {MESH_AXES} with sizes >= 1",
                sharding_row=row)
        axes[name] = size
    return MeshPlan(**axes)


def parse_sharding(spec: str | None) -> MeshPlan | None:
    """``"tp=8"`` / ``"tp=4,dp=1"`` -> MeshPlan (None when unset). A
    malformed row, an unknown axis, a size below 1, or any axis other
    than ``tp`` above 1 raises ``ShardingConfigError`` naming the row."""
    plan = parse_mesh_row(spec)
    if plan is None:
        return None
    row = spec.strip()
    others = [f"{ax}={n}" for ax, n in plan.shape().items()
              if ax != AXIS_TP and n > 1]
    if others:
        raise ShardingConfigError(
            f"TPU_SHARDING={row!r}: gofr_tpu_torch serves the tp axis "
            f"only; {', '.join(others)} is not ported yet (the data "
            "axes dp/fsdp, ep with MoE, pp and sp: ROADMAP item 11b)",
            sharding_row=row)
    return plan
