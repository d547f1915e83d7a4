"""The ``TPU_SHARDING`` row and the plan it names (counterpart of
gofr_tpu/parallel/mesh.py's ``MeshPlan`` and gofr_tpu/tpu/__init__.py's
``parse_mesh``).

The JAX package builds a named ``jax.sharding.Mesh`` over the slice and
lets XLA emit the collectives. PyTorch has no partitioner: the port runs
one process a device of the mesh (parallel.distributed), rank r at JAX's
device r of ``reshape(dp, pp, fsdp, ep, sp, tp)`` (``MeshPlan.coords``:
``tp`` the fastest axis), and each rank calls the single-card kernels on
its own shard. The plan keeps the JAX axis vocabulary and row syntax
(``tp=2``, ``tp=4,dp=2``). Serving takes ``dp``, ``fsdp``, ``ep`` and
``tp``; ``pp`` (training-only in JAX's mesh) and ``sp`` (ROADMAP item
12) raise ``ShardingConfigError`` naming the row. Training
(parallel.train) runs ``dp``, ``fsdp`` and ``tp``.
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
    axis order. ``data``: the product of the data axes (dp, fsdp, ep),
    the number of slot groups a batch splits into."""

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

    @property
    def data(self) -> int:
        """The data axes' product (JAX's ``data`` in its KV-head rule)."""
        return self.dp * self.fsdp * self.ep

    def data_index(self, coords: dict) -> int:
        """The slot group of a rank at ``coords``: its (dp, fsdp, ep)
        index, dp major (the order of JAX's ``DATA_AXES`` spec)."""
        return (coords[AXIS_DP] * self.fsdp + coords[AXIS_FSDP]) \
            * self.ep + coords[AXIS_EP]

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


# the axes serving refuses, and why
_NOT_SERVED = {AXIS_PP: "pp is a training axis (JAX's mesh serves no "
                        "pipeline stages)",
               AXIS_SP: "sp (sequence parallelism, ring attention) is not "
                        "ported yet: ROADMAP item 12"}


def parse_sharding(spec: str | None) -> MeshPlan | None:
    """``"tp=8"`` / ``"tp=4,dp=2"`` / ``"ep=2,tp=2"`` -> MeshPlan (None
    when unset) over dp, fsdp, ep and tp. A malformed row, an unknown
    axis, a size below 1, or ``pp`` or ``sp`` above 1 raises
    ``ShardingConfigError`` naming the row and the axis."""
    plan = parse_mesh_row(spec)
    if plan is None:
        return None
    row = spec.strip()
    refused = [f"{ax}={getattr(plan, ax)} ({why})"
               for ax, why in _NOT_SERVED.items() if getattr(plan, ax) > 1]
    if refused:
        raise ShardingConfigError(
            f"TPU_SHARDING={row!r}: gofr_tpu_torch serves dp, fsdp, ep "
            f"and tp; {'; '.join(refused)}", sharding_row=row)
    return plan
