"""Tensor-parallel serving for the port (counterpart of gofr_tpu/parallel,
the ``tp`` axis on one host): the ``TPU_SHARDING`` plan (mesh), the
slicing rules (sharding), the ranks and their process groups
(distributed), and a worker rank's loop (worker)."""

from .distributed import RankFailure, TPComm, TPRanks
from .mesh import MeshPlan, parse_sharding
from .sharding import (check_tp, kv_frame_shards, kv_head_owners,
                       kv_head_range, kv_head_shards, rank_config,
                       shard_leaf, shard_params)

__all__ = ["MeshPlan", "RankFailure", "TPComm", "TPRanks", "check_tp",
           "kv_frame_shards", "kv_head_owners", "kv_head_range",
           "kv_head_shards", "parse_sharding", "rank_config", "shard_leaf",
           "shard_params"]
