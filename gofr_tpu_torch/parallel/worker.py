"""A worker rank: the process that follows rank 0, serving its shard
of a sharded engine (its head shard under tp, its slots and weight
blocks at its coordinates under the data axes) or, with a training
spec (``kind`` "train"), training its blocks of a state
(parallel.train ``serve_rank``: build or restore its blocks, step, save
its share, close, at rank 0's commands).

The JAX package has no counterpart: its single controller hands each
program to GSPMD, which runs it on every chip of the mesh. In the port
rank 0 runs the whole ``GenerationEngine`` (the scheduler, the slots,
the streams, the App) and each worker runs a follower engine
(``GenerationEngine(..., tp_comm=...)``): the same cache, pack, carry
and admission tensors at its shard's shapes, and no serving loop. At
every device dispatch rank 0 first broadcasts one command carrying the
exact host inputs it uploads; the worker applies the same op to its own
parameter and cache shard (``GenerationEngine.follow``), and the
collectives inside the op meet rank 0's. Every rank samples from the
same summed logits with the same threefry keys, so the token fed back
on the device is the same on every rank without a further collective.

Started by parallel.distributed.TPRanks as ``python -c "from
gofr_tpu_torch.parallel.worker import main; main()"`` with a pickled
spec on its standard input. Imports torch and the port, nothing else.
"""

from __future__ import annotations

import json
import pickle
import sys
import traceback

import torch

from ..tpu import hbm
from ..tpu.checkpoint import rank_params
from ..tpu.generator import GenerationEngine
from .distributed import READY_TIMEOUT_S, TPComm, open_store, rank_device
from .sharding import serve_rank_config


def _build(spec: dict, comm: TPComm) -> GenerationEngine:
    cfg, plan = spec["model"], spec["plan"]
    rank = spec["rank"]
    # rank 0's budgets, for this rank's own leases
    hbm.set_budget(spec["budget_bytes"])
    hbm.set_device_budget(spec["device_budget_bytes"])
    source = spec["weights"] if spec["shard"] is None else spec["shard"]
    # the rank's coordinates on the plan: its tp index for the head
    # shard, its data index for its slots and its fsdp and ep blocks
    params = rank_params(cfg, source, rank, plan.tp, comm.device, plan=plan)
    return GenerationEngine(serve_rank_config(cfg, plan, rank, comm), params,
                            tp_comm=comm, tp_model=cfg, device=comm.device,
                            **spec["engine"])


def serve(spec: dict) -> int:
    """Join the group, build this rank's follower engine, report ready,
    then apply rank 0's commands until ``close`` (or rank 0's sockets
    close). Returns the process exit code."""
    rank, tp = spec["rank"], spec["tp"]
    device = rank_device(torch.device(spec["device"]), rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # the ranks share the host's cores: a worker's idle intra-op
        # threads would spin against rank 0's
        torch.set_num_threads(1)
    store = open_store(spec["store"], rank, tp, spec["timeout_s"])
    # a serving rank's comm joins the sub-groups of its coordinates
    # (training builds its own groups)
    comm = TPComm(store, rank, tp, device, spec["timeout_s"],
                  plan=None if spec.get("kind") == "train"
                  else spec["plan"])
    if spec.get("kind") == "train":
        from .train import serve_rank

        try:
            return serve_rank(spec, store, comm)
        except BaseException:
            store.set(f"error/{rank}", f"rank {rank}: "
                      f"{traceback.format_exc(limit=8)}")
            raise
        finally:
            comm.close()
    try:
        try:
            engine = _build(spec, comm)
        except BaseException:
            store.set(f"error/{rank}", f"rank {rank}: "
                      f"{traceback.format_exc(limit=8)}")
            raise
        store.set(f"ready/{rank}", json.dumps(engine.tp_report()))
        comm.gather([1], timeout_s=READY_TIMEOUT_S)
        while True:
            op, args = comm.recv()
            if op == "close":
                engine.close()
                return 0
            engine.follow(op, args)
    finally:
        comm.close()


def main() -> None:
    spec = pickle.load(sys.stdin.buffer)
    try:
        code = serve(spec)
    except Exception:  # noqa: BLE001 — the rank's own report, then exit
        print(f"gofr_tpu_torch tensor-parallel rank {spec.get('rank')} "
              f"failed:\n{traceback.format_exc()}", file=sys.stderr,
              flush=True)
        code = 1
    sys.exit(code)
