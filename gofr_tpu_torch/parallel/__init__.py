"""Serving over dp, fsdp, ep and tp and training over dp, fsdp and tp
for the port (counterpart of gofr_tpu/parallel): the ``TPU_SHARDING``
and ``-sharding`` plans (mesh), the slicing rules, the slot layout and
the JAX block layout (sharding), the ranks and their process groups
(distributed), a worker rank's loop (worker), and the training step,
its optimizer and checkpoints (train)."""

from .distributed import RankFailure, TPComm, TPRanks, TrainGroups
from .mesh import DATA_AXES, MeshPlan, parse_mesh_row, parse_sharding
from .sharding import (batch_spec, check_plan, check_tp, fit_spec,
                       kv_frame_shards, kv_head_owners, kv_head_range,
                       kv_head_shards, param_specs, rank_config, shard_block,
                       shard_leaf, shard_params, slot_range, spec_for)
from .train import (AdamWState, Optimizer, TrainRanks, TrainState,
                    check_train_plan, default_optimizer, gather_train_state,
                    init_train_state,
                    load_balance_loss, loss_parts, loss_parts_local,
                    make_train_step, next_token_loss, restore_train_state,
                    save_params, save_train_state, state_shardings, train_state_from_jax,
                    training_plan)

__all__ = ["AdamWState", "DATA_AXES", "MeshPlan", "Optimizer", "RankFailure",
           "TPComm", "TPRanks", "TrainGroups", "TrainRanks", "TrainState",
           "batch_spec", "check_plan", "check_tp", "check_train_plan",
           "default_optimizer",
           "fit_spec", "gather_train_state", "init_train_state", "kv_frame_shards",
           "kv_head_owners", "kv_head_range", "kv_head_shards",
           "load_balance_loss", "loss_parts", "loss_parts_local",
           "make_train_step", "next_token_loss", "param_specs",
           "parse_mesh_row", "parse_sharding", "rank_config",
           "restore_train_state", "save_params", "save_train_state", "shard_block",
           "shard_leaf", "shard_params", "slot_range", "spec_for", "state_shardings",
           "train_state_from_jax", "training_plan"]
