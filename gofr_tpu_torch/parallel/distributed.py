"""Tensor-parallel ranks on one host (the port's counterpart of
gofr_tpu/parallel/distributed.py's role: the collective backend).

The JAX package is one controller: GSPMD splits every program over the
mesh, and its multi-host bootstrap (``TPU_COORDINATOR``,
``TPU_NUM_PROCESSES``, ``TPU_PROCESS_ID``) only joins hosts to one PJRT
runtime. PyTorch has no partitioner, so the port runs SPMD ranks:

  - Rank 0 is the serving process (the App, the scheduler, the streams).
    ``TPRanks`` starts ranks 1..N-1 as fresh interpreters
    (parallel.worker; CUDA cannot be forked, and a fresh ``python -c``
    re-imports nothing of the caller's main module), each with its
    rank, the model and engine settings and where its weights come
    from, pickled on its standard input.
  - Rendezvous is a ``torch.distributed`` ``TCPStore`` on localhost,
    hosted by rank 0 on port 0: the kernel picks a free port, so two
    groups on one host never collide.
  - Two process groups (``TPComm``): a CPU gloo group carries rank 0's
    commands, the small gathers (readiness, probes) and the host rows
    that cross ranks point to point (a cache row's shards gathered to
    rank 0 for the prefix tiers, each rank's heads of a row to upload,
    each rank's slice of a LoRA adapter); a device group
    carries the activations' sums. The device group is NCCL when every
    rank has a card of its own and gloo when ranks share one (or run on
    the CPU): the choice follows from the device map alone and health
    names it. Gloo takes only ``broadcast`` and ``all_reduce`` on CUDA
    tensors, so those two are the port's collectives on both backends.
  - Rank r runs on ``cuda:{r % device_count}``, or on the CPU when the
    caller asked for it.
  - Every collective has a timeout: a dead rank (its sockets close) or
    a hung one (the timeout) raises ``RankFailure`` on rank 0, which the
    generator turns into failed streams and an engine that is down. A
    worker waits for its next command without a practical limit, since
    an idle engine sends none, and leaves when rank 0's sockets close.

Serving over the data axes (a ``TPU_SHARDING`` plan over dp, fsdp, ep
and tp) runs one rank a device of the plan, rank r at JAX's device r
(``MeshPlan.coords``: tp innermost). Each rank's ``TPComm`` then also
holds the sub-groups of its coordinates (``MeshGroups`` over
``SERVE_GROUPS``: its ``tp`` group, which carries the model's sums, its
``fsdp`` group, which gathers each layer's weight blocks, its ``ep``
group, the ranks of one (dp, fsdp, tp) index, which gathers the hidden
states an expert rank's experts see, the ``ep_tp`` group that sums an
MoE layer's partial outputs, and the ``data`` group), on the device
group's backend.

Training (parallel.train) runs one rank a device of a (dp, fsdp, tp)
plan, started the same way (``TPRanks`` with a training spec; the
worker runs parallel.train's ops). Each rank also joins the gloo
sub-groups of its coordinates (``TrainGroups``): its ``tp`` group, its
``fsdp`` group, its data group (dp x fsdp: the ranks of one tp index)
and its model group (fsdp x tp: the ranks of one dp index). Gloo takes
only ``broadcast`` and ``all_reduce`` on CUDA tensors, so the training
gather is an ``all_reduce`` of a zero-filled buffer into which each rank
wrote its block, summed as int32 words (a sum of one non-zero
contribution a bit is the bits themselves, so the gather is exact in
any dtype), and the reduce-scatter is an ``all_reduce`` of the whole
gradient (in the params' dtype) followed by each rank's slice. Nothing is staged by
hand: gloo copies a CUDA tensor through the host itself.

Multi-host ranks stay refused: ``TPU_COORDINATOR``, ``TPU_NUM_PROCESSES``,
``TPU_PROCESS_ID`` and ``TPU_COORDINATOR_TIMEOUT_S`` raise by name
(``MULTIHOST_ROWS``; ROADMAP item 11b).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

MULTIHOST_ROWS = ("TPU_COORDINATOR", "TPU_NUM_PROCESSES", "TPU_PROCESS_ID",
                  "TPU_COORDINATOR_TIMEOUT_S")
# every collective's limit unless the engine is given another
DEFAULT_TIMEOUT_S = 60.0
# a worker's wait for rank 0's next command: an idle engine sends none
_IDLE = datetime.timedelta(days=365)
# how long rank 0 waits for a worker to build its shard and report
# ready (its weights are made or read there)
READY_TIMEOUT_S = 900.0
_PKG_ROOT = str(Path(__file__).resolve().parents[2])


class RankFailure(RuntimeError):
    """A tensor-parallel rank died, or a collective failed or timed
    out. The group is unusable from here on."""


def device_backend(device: torch.device, tp: int) -> str:
    """The device group's backend: NCCL when every rank has a card of
    its own, gloo when ranks share one or run on the CPU."""
    if device.type == "cuda" and torch.cuda.device_count() >= tp:
        return "nccl"
    return "gloo"


def _timeout(seconds: float) -> datetime.timedelta:
    if not seconds or seconds <= 0:
        raise ValueError("every collective needs a time limit")
    return datetime.timedelta(seconds=float(seconds))


def rank_device(device: torch.device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:{rank % device_count}``, or the
    CPU."""
    if device.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def open_store(port: int, rank: int, tp: int, timeout_s: float):
    """The rendezvous store on localhost: rank 0 hosts it (``port`` 0:
    a free one), the workers join it at rank 0's port."""
    import torch.distributed as dist

    return dist.TCPStore("127.0.0.1", port, tp, rank == 0,
                         datetime.timedelta(seconds=timeout_s),
                         wait_for_workers=False)


def _process_group(store, name: str, rank: int, size: int, backend: str,
                   timeout: datetime.timedelta):
    import torch.distributed as dist

    prefixed = dist.PrefixStore(name, store)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(prefixed, rank, size, opts)
    return dist.ProcessGroupGloo(prefixed, rank, size, timeout)


class TPComm:
    """One rank's process groups: ``all_reduce`` on the device group
    (what the model sums: the ``tp`` sub-group under a plan with data
    axes), rank 0's commands (``send`` / ``recv``) and ``gather`` on the
    CPU gloo group, and under such a plan ``groups``, the sub-groups of
    the rank's coordinates (``MeshGroups``, None otherwise). ``broken``
    names the first failed collective of any of them."""

    def __init__(self, store, rank: int, tp: int, device: torch.device,
                 timeout_s: float = DEFAULT_TIMEOUT_S, plan=None):
        import torch.distributed as dist

        self.rank = rank
        self.tp = tp
        self.device = device
        self.plan = plan
        self.timeout = datetime.timedelta(seconds=timeout_s)
        self.backend = device_backend(device, tp)
        self._broken: str | None = None
        self._cmd = dist.ProcessGroupGloo(dist.PrefixStore("cmd", store),
                                          rank, tp, self.timeout)
        # the model's sums: over every rank under tp alone, else over
        # the sub-groups of the rank's coordinates
        self._dev = self.groups = None
        if plan is not None and plan.data > 1:
            self.groups = MeshGroups(store, plan, rank, timeout_s,
                                     kinds=SERVE_GROUPS, backend=self.backend,
                                     prefix="serve")
        else:
            self._dev = _process_group(store, "dev", rank, tp, self.backend,
                                       self.timeout)

    @property
    def broken(self) -> str | None:
        if self._broken is None and self.groups is not None:
            return self.groups.broken
        return self._broken

    @broken.setter
    def broken(self, why: str | None) -> None:
        self._broken = why

    def _run(self, what: str, fn):
        if self.broken is not None:
            raise RankFailure(f"tensor-parallel group is broken: "
                              f"{self.broken}")
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — any collective error
            self.broken = f"{what} on rank {self.rank}: {e}"
            raise RankFailure(self.broken) from e

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the rank's tensor-parallel group IN PLACE (the
        device group, or the ``tp`` sub-group under a plan with data
        axes); returns ``t``. Every rank gets the same bits."""
        import torch.distributed as dist

        if self.groups is not None:
            return self.reduce(t, "tp")
        opts = dist.AllreduceOptions()
        opts.timeout = self.timeout
        self._run("all_reduce",
                  lambda: self._dev.allreduce([t], opts).wait())
        return t

    def _bcast(self, t: torch.Tensor, timeout) -> None:
        import torch.distributed as dist

        opts = dist.BroadcastOptions()
        opts.rootRank = 0
        opts.timeout = timeout
        self._run("command broadcast",
                  lambda: self._cmd.broadcast([t], opts).wait())

    def send(self, obj: Any) -> None:
        """Rank 0: broadcast one command (any picklable object)."""
        data = np.frombuffer(pickle.dumps(obj, protocol=5), np.uint8)
        self._bcast(torch.tensor([data.size], dtype=torch.long), self.timeout)
        self._bcast(torch.from_numpy(data.copy()), self.timeout)

    def recv(self) -> Any:
        """A worker: wait for rank 0's next command."""
        n = torch.zeros((1,), dtype=torch.long)
        self._bcast(n, _IDLE)
        buf = torch.empty((int(n[0]),), dtype=torch.uint8)
        self._bcast(buf, self.timeout)
        return pickle.loads(buf.numpy().tobytes())

    def reduce(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """Sum ``t`` over the rank's ``kind`` sub-group IN PLACE (a plan
        with data axes); returns ``t``."""
        if self.broken is not None:
            raise RankFailure(f"tensor-parallel group is broken: "
                              f"{self.broken}")
        return self.groups.all_reduce(t, kind)

    def gather(self, row, timeout_s: float | None = None) -> np.ndarray:
        """Every rank's int64 ``row`` (equal lengths) as a [tp, n] array,
        on every rank (a sum over zero rows, on the CPU group)."""
        import torch.distributed as dist

        row = np.asarray(row, np.int64).reshape(-1)
        t = torch.zeros((self.tp, row.size), dtype=torch.long)
        t[self.rank] = torch.from_numpy(row)
        opts = dist.AllreduceOptions()
        opts.timeout = (self.timeout if timeout_s is None
                        else datetime.timedelta(seconds=timeout_s))
        self._run("gather", lambda: self._cmd.allreduce([t], opts).wait())
        return t.numpy()

    def send_tensors(self, tensors, dst: int) -> None:
        """Send CPU tensors to rank ``dst`` over the command group as one
        byte buffer; the receiver knows their shapes and dtypes from the
        command both ranks follow (``recv_tensors``)."""
        buf = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                         for t in tensors])
        self._run("send", lambda: self._cmd.send([buf], dst, 0)
                  .wait(self.timeout))

    def recv_tensors(self, specs, src: int) -> list[torch.Tensor]:
        """What ``send_tensors`` sent from rank ``src``: ``specs`` the
        [(shape, dtype)] of its tensors, in order."""
        sizes = [int(np.prod(shape, dtype=np.int64))
                 * torch.empty((), dtype=dt).element_size()
                 for shape, dt in specs]
        buf = torch.empty((sum(sizes),), dtype=torch.uint8)
        self._run("recv", lambda: self._cmd.recv([buf], src, 0)
                  .wait(self.timeout))
        out, off = [], 0
        for (shape, dt), n in zip(specs, sizes):
            out.append(buf[off:off + n].clone().view(dt).reshape(shape))
            off += n
        return out

    def close(self) -> None:
        if self.groups is not None:
            self.groups.close()
        for pg in (self._dev, self._cmd):
            if pg is not None:
                with contextlib.suppress(Exception):
                    pg.shutdown()
        self._dev = self._cmd = None


class TPRanks:
    """Rank 0's handle on a tensor-parallel group: starts the worker
    ranks, holds rank 0's ``TPComm``, sends commands, and stops every
    worker on ``close``.

    ``spec``: what each worker needs to build its share (the worker
    reads ``spec`` plus its ``rank``); ``shards``: per worker rank, a
    weight tree of its own to pass (numpy leaves), or None; ``plan``:
    a serving plan with data axes (each rank's comm joins the
    sub-groups of its coordinates; a worker reads it from ``spec``).

    ``step(op, args)`` is how rank 0 runs anything the ranks must run
    together: under one lock it broadcasts the command, then rank 0
    runs its own share inside the ``with`` block, so the commands (and
    the collectives inside each op) reach every rank in one order
    whichever of rank 0's threads issued them."""

    def __init__(self, tp: int, device: torch.device, spec: dict, *,
                 shards: list | None = None, timeout_s: float = DEFAULT_TIMEOUT_S,
                 plan=None):
        self.tp = tp
        self.device = device
        self.timeout_s = float(timeout_s)
        self.lock = threading.RLock()
        self.procs: list[subprocess.Popen] = []
        self.comm: TPComm | None = None
        self.ready: list[dict] = []
        self._store = open_store(0, 0, tp, self.timeout_s)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_PKG_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        try:
            for rank in range(1, tp):
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c",
                     "from gofr_tpu_torch.parallel.worker import main; "
                     "main()"], stdin=subprocess.PIPE, env=env))
            # every worker is started before any is written to: a spec
            # past the pipe's buffer blocks until its worker reads it,
            # after its imports, and the workers import side by side
            for rank, proc in enumerate(self.procs, start=1):
                msg = dict(spec, rank=rank, tp=tp, store=self._store.port,
                           device=str(device), timeout_s=self.timeout_s,
                           shard=None if shards is None else shards[rank])
                proc.stdin.write(pickle.dumps(msg, protocol=5))
                proc.stdin.close()
            self.comm = TPComm(self._store, 0, tp, rank_device(device, 0),
                               self.timeout_s, plan=plan)
        except BaseException:
            self.close()
            raise

    @property
    def backend(self) -> str:
        return self.comm.backend if self.comm is not None else ""

    def devices(self) -> list[str]:
        return [str(rank_device(self.device, r)) for r in range(self.tp)]

    def alive(self) -> bool:
        return all(p.poll() is None for p in self.procs)

    def worker_error(self) -> str | None:
        """The first error a worker posted to the store, if any."""
        for rank in range(1, self.tp):
            key = f"error/{rank}"
            with contextlib.suppress(Exception):
                if self._store.check([key]):
                    return self._store.get(key).decode()
        return None

    def wait_ready(self, own: dict) -> list[dict]:
        """Wait until every worker has built its share; returns each
        rank's report (rank 0's is ``own``). A worker that failed
        raises RankFailure with the worker's error."""
        import json

        try:
            self.comm.gather([1], timeout_s=READY_TIMEOUT_S)
        except RankFailure as e:
            # a worker posts its error before it exits, and so before
            # its sockets close
            raise RankFailure(f"a tensor-parallel worker failed to start: "
                              f"{self.worker_error() or e}") from None
        self.ready = [own] + [json.loads(self._store.get(f"ready/{r}"))
                              for r in range(1, self.tp)]
        return self.ready

    @contextlib.contextmanager
    def step(self, op: str, *args):
        """Broadcast ``(op, args)``, then run rank 0's own share in the
        block, all under the group lock."""
        with self.lock:
            self.comm.send((op, args))
            yield

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop every worker, then drop the groups. While the group works
        a ``close`` command ends each worker's loop and a worker that has
        not left within ``timeout_s`` is killed; once it is broken (a
        rank lost or hung) every worker is killed at once, since a
        stopped or waiting peer may never answer. The groups are shut
        down only after every worker has gone, so no teardown waits on a
        peer. Idempotent."""
        with self.lock:
            working = (self.comm is not None and self.comm.broken is None
                       and self.alive())
            if working:
                with contextlib.suppress(Exception):
                    self.comm.send(("close", ()))
            deadline = time.monotonic() + (timeout_s if working else 0.0)
            for p in self.procs:
                try:
                    p.wait(max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            if self.comm is not None:
                self.comm.close()
                self.comm = None
            self._store = None


# the sub-groups: kind -> (the axes a member differs on). Training's:
TRAIN_GROUPS = {"world": ("dp", "fsdp", "tp"), "tp": ("tp",),
                "fsdp": ("fsdp",), "data": ("dp", "fsdp"),
                "model": ("fsdp", "tp")}
# serving's over dp, fsdp, ep and tp: the model's sums over tp, each
# layer's gather over fsdp (over fsdp x tp where a block is not the
# part a rank computes with), an MoE layer's hidden states over ep and
# its partial outputs summed over ep x tp
SERVE_GROUPS = {"tp": ("tp",), "fsdp": ("fsdp",), "ep": ("ep",),
                "ep_tp": ("ep", "tp"), "model": ("fsdp", "tp"),
                "data": ("dp", "fsdp", "ep")}
_GROUP_AXES = ("dp", "fsdp", "ep", "tp")


class MeshGroups:
    """One rank's process groups over a MeshPlan (``plan``): for each
    kind of ``kinds`` the ranks that differ from it only on that kind's
    axes, each None where it has one member, on ``backend`` (gloo, or
    NCCL where every rank has a card of its own). Every collective has
    ``timeout_s``; a failure or a timeout marks the groups broken and
    raises ``RankFailure``. ``collective_s`` sums the host time spent in
    the collectives (a call on CUDA tensors waits for the device work
    queued before it)."""

    def __init__(self, store, plan, rank: int,
                 timeout_s: float = DEFAULT_TIMEOUT_S, *,
                 kinds: dict = TRAIN_GROUPS, backend: str = "gloo",
                 prefix: str = "train"):
        self.plan = plan
        self.rank = rank
        self.kinds = kinds
        self.coords = plan.coords(rank)
        self.timeout = _timeout(timeout_s)
        self.broken: str | None = None
        self.collective_s = 0.0
        self.calls = 0
        self.groups: dict[str, Any] = {}
        for kind, axes in kinds.items():
            members = self.members(kind)
            if len(members) == 1:
                self.groups[kind] = None
                continue
            key = [self.coords[ax] for ax in _GROUP_AXES if ax not in axes]
            name = f"{prefix}/{kind}/{'.'.join(map(str, key))}"
            self.groups[kind] = _process_group(
                store, name, members.index(rank), len(members), backend,
                self.timeout)

    def members(self, kind: str) -> list[int]:
        """The ranks of this rank's ``kind`` group, in rank order."""
        axes = self.kinds[kind]
        return [r for r in range(self.plan.n_ranks)
                if all(self.plan.coords(r)[ax] == self.coords[ax]
                       for ax in _GROUP_AXES if ax not in axes)]

    def _run(self, what: str, fn):
        if self.broken is not None:
            raise RankFailure(f"rank group is broken: {self.broken}")
        t0 = time.perf_counter()
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — any collective error
            self.broken = f"{what} on rank {self.rank}: {e}"
            raise RankFailure(self.broken) from e
        finally:
            self.collective_s += time.perf_counter() - t0
            self.calls += 1

    def all_reduce(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """Sum ``t`` over this rank's ``kind`` group IN PLACE; returns
        ``t`` (itself where the group has one member)."""
        import torch.distributed as dist

        pg = self.groups[kind]
        if pg is None:
            return t
        opts = dist.AllreduceOptions()
        opts.timeout = self.timeout
        self._run(f"{kind} all_reduce",
                  lambda: pg.allreduce([t], opts).wait())
        return t

    def gather_bytes(self, buf: torch.Tensor, kind: str) -> torch.Tensor:
        """The gather: ``buf`` (uint8, zero where this rank has no
        block) summed over the ``kind`` group as int32 words, IN PLACE.
        Exact when each byte has at most one non-zero contributor; the
        buffer is a whole number of int32 words."""
        self.all_reduce(buf.view(torch.int32), kind)
        return buf

    def close(self) -> None:
        for pg in self.groups.values():
            if pg is not None:
                with contextlib.suppress(Exception):
                    pg.shutdown()
        self.groups = {k: None for k in self.groups}


class TrainGroups(MeshGroups):
    """A training rank's gloo groups (``TRAIN_GROUPS``: the whole
    ``world`` and its ``tp``, ``fsdp``, ``data`` and ``model``
    groups)."""
