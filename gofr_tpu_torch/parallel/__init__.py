"""Tensor-parallel serving and one-device training for the port
(counterpart of gofr_tpu/parallel): the ``TPU_SHARDING`` plan (mesh),
the slicing rules (sharding), the ranks and their process groups
(distributed), a worker rank's loop (worker), and the training step,
its optimizer and checkpoints (train)."""

from .distributed import RankFailure, TPComm, TPRanks
from .mesh import MeshPlan, parse_mesh_row, parse_sharding
from .sharding import (check_tp, kv_frame_shards, kv_head_owners,
                       kv_head_range, kv_head_shards, rank_config,
                       shard_leaf, shard_params)
from .train import (AdamWState, Optimizer, TrainState, default_optimizer,
                    init_train_state, load_balance_loss, loss_parts,
                    loss_parts_local, make_train_step, next_token_loss,
                    restore_train_state, save_train_state,
                    train_state_from_jax, training_plan)

__all__ = ["AdamWState", "MeshPlan", "Optimizer", "RankFailure", "TPComm",
           "TPRanks", "TrainState", "check_tp", "default_optimizer",
           "init_train_state", "kv_frame_shards", "kv_head_owners",
           "kv_head_range", "kv_head_shards", "load_balance_loss",
           "loss_parts", "loss_parts_local", "make_train_step",
           "next_token_loss", "parse_mesh_row", "parse_sharding",
           "rank_config", "restore_train_state", "save_train_state",
           "shard_leaf", "shard_params", "train_state_from_jax",
           "training_plan"]
