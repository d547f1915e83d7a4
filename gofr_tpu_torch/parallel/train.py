"""Training (counterpart of gofr_tpu/parallel/train.py): forward,
loss, gradients and an AdamW update, with JAX's names and numbers, on
one device or over ``dp``, ``fsdp`` and ``tp`` ranks.

The JAX package jits the whole step over a mesh and lets GSPMD shard
the state and insert the collectives. The port trains on one device,
or on one rank a device of the ``-sharding`` plan (``training_plan``:
``ep``, ``pp`` and ``sp`` raise ``ShardingConfigError`` naming the axis,
as do ring attention and int8 weights; ``n_microbatches`` raises as
JAX's does without ``pp``).

Over ranks (SPMD, the ranks of parallel.distributed started by rank 0,
the caller's process, which owns the data and broadcasts each command
with the step's tokens and lengths; ``TrainRanks``):

- Each rank stores its block of every param and of both moments in
  JAX's layout (parallel.sharding ``spec_for``/``fit_spec``/
  ``shard_block``): 1/(fsdp·tp) of a leaf both axes divide. The blocks
  are slices of exactly the one-device ``init_train_state(cfg, seed)``.
- The step gathers each layer's blocks over the ``fsdp`` group into the
  weights its ``tp`` rank computes with (the Megatron split of
  parallel.sharding ``train_span``; over the fsdp x tp group where the
  stored split is not the computed one, as a KV head that ``tp``
  splits), inside the checkpointed layer, so ``remat`` gathers again
  for the recomputation. The backward of that gather is the gradient's
  reduce-scatter: a sum in the params' dtype over the data group (and
  over ``tp`` where the split differs, which sums a replicated KV
  head's parts) and the rank's block of it.
- The model's own collectives (models.common ``TrainRanksComm``) are
  differentiable: identity forward and a sum backward at every
  column-parallel input and a vocab-split head's input, a sum forward
  and identity backward at the row-parallel outputs, the vocab-split
  lookup and the logits. A tied embedding's lookup and head gradients
  meet in one gathered tensor before the reduce.
- Each rank takes its rows of the batch (``batch_spec``: the data axes
  dp-major); a batch the data axes do not divide is replicated and its
  gradient is not summed over them. The loss is the global masked
  mean (the NLL sum and the mask count summed over the data group); an
  MoE load-balancing loss sums its fractions and probabilities over it
  too.
- The global norm counts each distinct block once (a replicated leaf
  on one rank); the clip and the fused AdamW run on each rank's blocks.
- ``save_train_state`` gathers every leaf to rank 0, one at a time, into
  the one-device ``.npz`` layout; ``restore_train_state`` reads each
  rank's blocks from such a file on any plan (each rank maps the file
  and reads only its blocks), a one-device checkpoint too.

On one device and on each rank:

- The forward is ``models.llama.forward(..., train=True)``: attention
  through the plain ``ops.attention.causal_attention`` under the
  validity mask, the JAX package's training attention (it reaches no
  Pallas kernel, so the port's training reaches no CUDA kernel).
  ``remat`` checkpoints each layer (``torch.utils.checkpoint``): a
  memory choice, the same numbers.
- The optimizer is ``torch.optim.AdamW`` (fused), driven so that it
  gives optax's numbers for ``default_optimizer``: the gradients are
  clipped by their global norm as ``optax.clip_by_global_norm`` clips
  them (``g / norm * max`` where ``norm >= max``), the moments stay in
  the params' dtype (optax's ``mu``/``nu`` with ``mu_dtype`` unset),
  and the learning rate is optax's ``warmup_cosine_decay_schedule``
  read at the count before the update, so the first step has lr 0.
- The state is updated IN PLACE: a step returns a new ``TrainState``
  over the same tensors, as the JAX step donates its input state.
- Checkpoints are one ``.npz`` in the ``/``-joined layout of
  tpu/checkpoint.py (orbax is JAX's): the step, the params, both
  moments and the optimizer's count. ``train_state_from_jax`` carries a
  JAX ``TrainState`` (numpy leaves) across, so the port continues a JAX
  run step for step.
"""

from __future__ import annotations

import atexit
import os
import tempfile
import zipfile
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..errors import ShardingConfigError
from ..models import llama
from ..models.common import ModelConfig, TrainRanksComm, _Sum
from ..ops.quant import QuantizedLinear
from ..tpu.checkpoint import _unflatten, from_jax_params, to_tensor
from .distributed import DEFAULT_TIMEOUT_S, RankFailure, TPRanks, TrainGroups
from .mesh import MeshPlan, parse_mesh_row
from .sharding import (Box, LeafLayout, _dims, _holds, _numel,
                       _param_shapes, _slices, check_tp, fit_spec,
                       gather_blocks, leaf_layout, rank_config, shard_block,
                       spec_for)

# where each axis the port does not train lands in ROADMAP
_AXIS_HOME = {
    "ep": "ROADMAP item 11b step 3c, ep with MoE",
    "pp": "ROADMAP item 12, parallel/pipeline.py",
    "sp": "ROADMAP item 12, ops/ring_attention.py",
}


def training_plan(spec: str | None) -> MeshPlan:
    """The ``-sharding`` row of a training run -> MeshPlan over ``dp``,
    ``fsdp`` and ``tp`` (an empty row is the one device, as JAX's
    ``single_device_mesh``). ``ep``, ``pp`` or ``sp`` above 1 raises
    ``ShardingConfigError`` naming the axis and where it lands in
    ROADMAP."""
    plan = parse_mesh_row(spec, "-sharding") or MeshPlan()
    above = [f"{ax}={n} ({_AXIS_HOME[ax]})"
             for ax, n in plan.shape().items()
             if n > 1 and ax in _AXIS_HOME]
    if above:
        raise ShardingConfigError(
            f"-sharding={spec.strip()!r}: gofr_tpu_torch trains over dp, "
            f"fsdp and tp; not ported yet: {', '.join(above)}",
            sharding_row=spec.strip())
    return plan


def check_train_plan(cfg: ModelConfig, plan: MeshPlan) -> None:
    """Refuse a plan ``cfg`` does not train on: an axis other than dp,
    fsdp and tp, a mixture of experts under tp, or a tp the head counts
    do not take (parallel.sharding ``check_tp``'s rules)."""
    row = plan.row()
    training_plan(row)
    if plan.tp > 1 and cfg.n_experts > 0:
        raise ShardingConfigError(
            f"-sharding={row!r}: a mixture of experts ({cfg.name!r}) "
            "trains over dp and fsdp only; tp inside each expert is not "
            "ported yet (ROADMAP item 11b step 3c)", sharding_row=row)
    try:
        check_tp(cfg, plan.tp, row)
    except ShardingConfigError as e:
        raise ShardingConfigError(
            f"-sharding={row!r}: tp={plan.tp} does not train {cfg.name!r}: "
            f"{str(e).rpartition(': ')[2]}", sharding_row=row) from None


class TrainState(NamedTuple):
    step: int
    params: dict
    opt_state: "AdamWState"

    def close(self) -> None:
        """A sharded state: stop the ranks it started (or, on ranks the
        caller passed in, free its blocks there); unusable after. A
        no-op on one device."""
        shard = self.opt_state.shard
        if shard is not None and shard.ranks is not None:
            shard.ranks.release(shard.sid)


@dataclass
class AdamWState:
    """``default_optimizer``'s state (optax's chain state): a
    ``torch.optim.AdamW`` over ``leaves`` (the params' tensors by their
    ``/``-joined tree paths), whose per-leaf ``exp_avg``/``exp_avg_sq``
    are optax's ``mu``/``nu``, and ``count``, the updates applied
    (optax's ``ScaleByAdamState.count`` and the schedule's count)."""

    optimizer: torch.optim.AdamW
    leaves: dict
    count: int
    # on ranks: where this rank's blocks sit in the whole state
    shard: "StateShard | None" = None

    def moment(self, name: str) -> dict:
        """``"mu"`` or ``"nu"`` by leaf path."""
        key = {"mu": "exp_avg", "nu": "exp_avg_sq"}[name]
        return {path: self.optimizer.state[t][key]
                for path, t in self.leaves.items()}


def _leaves(params: dict, prefix: str = "") -> dict:
    """Tree path -> tensor, keys sorted as JAX's tree order. An int8
    leaf raises: training runs on the model dtype's weights."""
    out = {}
    for k in sorted(params):
        v, path = params[k], f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_leaves(v, path + "/"))
        elif isinstance(v, QuantizedLinear) or (
                isinstance(v, tuple) and getattr(v, "_fields", None)
                == ("w", "scale")):
            raise ValueError(
                f"{path} is int8-quantized: training runs on the model "
                "dtype's weights, as the JAX package's does")
        else:
            out[path] = v
    return out


def _adamw(leaves: dict, mu: dict | None = None, nu: dict | None = None,
           count: int = 0) -> AdamWState:
    """AdamW over ``leaves`` (made leaf tensors that require grad), its
    state set now (optax allocates its moments at init): zero moments,
    or ``mu``/``nu`` tensors by path. Fused: one kernel a step over
    every leaf, no full-size temporaries of the moments. The step's
    hyperparameters are set at each update (``Optimizer.apply``)."""
    tensors = list(leaves.values())
    for t in tensors:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(tensors, lr=0.0, fused=True)
    for path, t in leaves.items():
        st = opt.state[t]
        st["step"] = torch.tensor(float(count), dtype=torch.float32,
                                  device=t.device)
        st["exp_avg"] = (torch.zeros_like(t) if mu is None
                         else mu[path].to(t.device, t.dtype))
        st["exp_avg_sq"] = (torch.zeros_like(t) if nu is None
                            else nu[path].to(t.device, t.dtype))
    return AdamWState(optimizer=opt, leaves=leaves, count=count)


def global_norm(tensors) -> torch.Tensor:
    """optax's ``global_norm``: the L2 norm of every element of every
    tensor, float32 on their device."""
    norms = torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32)
                         for t in tensors])
    return torch.sqrt(torch.sum(norms * norms))


def clip_by_global_norm(grads: list, max_norm: float,
                        gnorm: torch.Tensor | None = None) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the list ``grads``, IN PLACE
    (each entry replaced, so one gradient's copy exists at a time): each
    gradient as it is where the global norm is below ``max_norm``, else
    ``g / norm * max_norm`` (in that order, the norm in the gradient's
    dtype), chosen on the device with no host read. ``gnorm``: the
    norm when the caller computed it (over every rank's blocks).
    Returns the norm before clipping."""
    gnorm = global_norm(grads) if gnorm is None else gnorm
    keep = gnorm < max_norm
    for i, g in enumerate(grads):
        grads[i] = torch.where(keep, g, g / gnorm.to(g.dtype) * max_norm)
    return gnorm


# AdamW's betas and epsilon, fixed as the JAX package's
# ``default_optimizer`` fixes them (optax's eps default).
_B1, _B2, _EPS = 0.9, 0.95, 1e-8


@dataclass(frozen=True)
class Optimizer:
    """optax's ``chain(clip_by_global_norm(grad_clip),
    adamw(warmup_cosine_decay_schedule(0, lr, warmup, decay_steps),
    b1=0.9, b2=0.95, weight_decay))`` as ``default_optimizer`` builds
    it."""

    lr: float
    warmup: int
    decay_steps: int
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def schedule(self, count: int) -> float:
        """The learning rate at ``count`` updates applied, in float32 as
        optax computes it: linear from 0 over ``warmup``, then a cosine
        to 0 at ``decay_steps``."""
        f32 = np.float32
        if count < self.warmup:
            frac = f32(1) - f32(count) / f32(self.warmup)
            return float(f32(-self.lr) * frac + f32(self.lr))
        span = self.decay_steps - self.warmup
        t = f32(min(count - self.warmup, span))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / f32(span)))
        return float(f32(self.lr) * cos)

    def init(self, params: dict) -> AdamWState:
        return _adamw(_leaves(params))

    def apply(self, state: AdamWState, grads: list,
              gnorm: torch.Tensor | None = None) -> torch.Tensor:
        """One update of ``state``'s leaves by ``grads`` (a list in leaf
        order, consumed), IN PLACE: clip by the global norm (``gnorm``
        where the ranks computed it), then AdamW at the schedule's rate
        for the count before the update. Returns the global norm before
        clipping, float32 on the device."""
        gnorm = clip_by_global_norm(grads, self.grad_clip, gnorm)
        for t, g in zip(state.leaves.values(), grads):
            t.grad = g
        grads.clear()
        group = state.optimizer.param_groups[0]
        group.update(lr=self.schedule(state.count), betas=(_B1, _B2),
                     eps=_EPS, weight_decay=self.weight_decay)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.count += 1
        return gnorm


def default_optimizer(lr: float = 3e-4, *, warmup: int = 100,
                      total_steps: int = 10_000,
                      weight_decay: float = 0.1,
                      grad_clip: float = 1.0) -> Optimizer:
    return Optimizer(lr=lr, warmup=warmup,
                     decay_steps=max(total_steps, warmup + 1),
                     weight_decay=weight_decay, grad_clip=grad_clip)


def loss_parts_local(logits: torch.Tensor, tokens_full: torch.Tensor,
                     lengths: torch.Tensor, g0, S: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of masked next-token NLL, number of masked positions) for a
    SEQUENCE SHARD: ``logits`` [B, Sn, V] sits at global positions
    [g0, g0+Sn) of a length-S sequence whose full token ids are
    ``tokens_full`` [B, S]; the next-token shift reads cross-boundary
    targets from the full ids. loss_parts is the g0=0, Sn=S case and
    next_token_loss its ratio."""
    B, sn, _ = logits.shape
    tgt_i = g0 + torch.arange(sn, device=logits.device) + 1    # [Sn] global
    safe = torch.clamp(tgt_i, max=S - 1)
    tgt = torch.gather(tokens_full.long(), 1, safe.expand(B, sn))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]      # [B, Sn]
    mask = ((tgt_i[None, :] < lengths[:, None])
            & (tgt_i[None, :] <= S - 1)).float()
    return torch.sum(nll * mask), torch.sum(mask)


def loss_parts(logits: torch.Tensor, tokens: torch.Tensor,
               lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Additive causal-LM loss over the full sequence."""
    return loss_parts_local(logits, tokens, lengths, 0, logits.shape[1])


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Mean causal-LM cross-entropy: logits [B, S, V] float32 predict
    tokens shifted left; positions >= length are masked out."""
    nll_sum, mask_sum = loss_parts(logits, tokens, lengths)
    return nll_sum / torch.clamp(mask_sum, min=1.0)


def load_balance_loss(router_probs: torch.Tensor,
                      lengths: torch.Tensor, total=None) -> torch.Tensor:
    """Switch-Transformer-style MoE auxiliary loss: E * mean over layers
    of sum_e f_e * P_e over VALID tokens, f_e the fraction of tokens
    whose top-1 expert is e and P_e the mean router probability of e.
    1.0 at perfect balance, up to E as the router collapses.
    router_probs: [L, B, S, E] float32. ``total``: the sum over the
    ranks that hold the batch's other rows (a split batch), applied to
    the token count and both per-expert sums before they divide."""
    L, B, S, E = router_probs.shape
    dev = router_probs.device
    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None]).float()
    top1 = torch.argmax(router_probs, dim=-1)                 # [L, B, S]
    onehot = (top1[..., None] == torch.arange(E, device=dev)).float()
    sums = [torch.sum(mask), torch.sum(onehot * mask[None, ..., None],
                                       dim=(1, 2)),
            torch.sum(router_probs * mask[None, ..., None], dim=(1, 2))]
    if total is not None:
        sums = [total(t) for t in sums]
    count, f_sum, p_sum = sums
    denom = torch.clamp(count, min=1.0)
    f = f_sum / denom
    p = p_sum / denom
    return E * torch.mean(torch.sum(f * p, dim=-1))


def init_train_state(cfg: ModelConfig, seed: int, optimizer: Optimizer, *,
                     plan: MeshPlan | None = None,
                     ranks: "TrainRanks | None" = None,
                     device="cuda") -> TrainState:
    """Seeded params (``models.llama.init``) and zero moments on
    ``device`` (the card unless the caller asks for another). Over the
    ranks of ``plan`` (started for this state, or ``ranks``, a
    ``TrainRanks`` the caller keeps), each rank draws the same leaves and
    keeps its block of each: rank 0's are the state's tensors."""
    device = resolve_device(device)
    group, owned = _ranks_for(cfg, plan, ranks, device)
    if group is None:
        params = llama.init(cfg, seed, device=device)
        return TrainState(step=0, params=params,
                          opt_state=optimizer.init(params))
    return group.open("init", cfg, (int(seed),), owned)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *,
                    remat: bool = True, seq_parallel: str = "auto",
                    moe_aux_weight: float = 0.01,
                    n_microbatches: int | None = None,
                    device="cuda") -> Callable:
    """step(state, tokens [B, S], lengths [B]) -> (state, metrics): the
    forward and loss, the gradients, the clipped AdamW update, IN PLACE
    on ``state``'s tensors. ``metrics``: ``loss`` (with the MoE term),
    ``grad_norm`` (before clipping, optax's ``global_norm``),
    ``aux_loss`` (the load-balancing loss; 0 for a dense model), float32
    tensors on the device, and ``step``: the global values, on rank 0
    for a state on ranks (whose step every rank runs on its rows).

    MoE configs add ``moe_aux_weight`` times ``load_balance_loss``.
    ``seq_parallel``: "auto" and "dense" train on the dense attention
    (the port has no sp axis); "ring" raises. ``n_microbatches``
    raises, as JAX's does without pp."""
    device = resolve_device(device)
    if n_microbatches is not None:
        raise ValueError("n_microbatches only applies to pp>1 meshes "
                         "(gradient accumulation without pp is not "
                         "implemented)")
    if seq_parallel == "ring":
        raise ShardingConfigError(
            "seq_parallel='ring': ring attention (sp) is not ported yet "
            f"({_AXIS_HOME['sp']}); the port trains on the dense "
            "attention")
    if seq_parallel not in ("auto", "dense"):
        raise ValueError(f"seq_parallel must be 'auto', 'dense' or "
                         f"'ring', got {seq_parallel!r}")
    moe = cfg.n_experts > 0
    settings = (optimizer, bool(remat), float(moe_aux_weight))

    def loss_fn(params, tokens, lengths):
        logits, probs = llama.forward(params, cfg, tokens, lengths,
                                      return_router_probs=True, train=True,
                                      remat=remat)
        lm = next_token_loss(logits, tokens, lengths)
        if moe:
            aux = load_balance_loss(probs, lengths)
            return lm + moe_aux_weight * aux, aux
        return lm, torch.zeros((), device=device)

    def step(state: TrainState, tokens, lengths):
        leaves = state.opt_state.leaves
        if _leaves(state.params).keys() != leaves.keys():
            raise ValueError("the state's params are not its optimizer's")
        first = next(iter(leaves.values())).device
        if first.type != device.type or device.index not in (None,
                                                             first.index):
            raise ValueError(f"the state lies on {first}, the step "
                             f"trains on {device}")
        shard = state.opt_state.shard
        if shard is not None:
            return _ranks_step(shard, cfg, settings, tokens, lengths)
        tokens = torch.as_tensor(np.asarray(tokens), device=device).long()
        lengths = torch.as_tensor(np.asarray(lengths),
                                  device=device).to(torch.int32)
        loss, aux = loss_fn(state.params, tokens, lengths)
        grads = list(torch.autograd.grad(loss, list(leaves.values())))
        gnorm = optimizer.apply(state.opt_state, grads)
        new = TrainState(step=state.step + 1, params=state.params,
                         opt_state=state.opt_state)
        return new, {"loss": loss.detach().float(), "grad_norm": gnorm,
                     "aux_loss": aux.detach().float(), "step": new.step}

    return step


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 as raw 2-byte voids, which
    ``to_tensor`` reads back as bfloat16."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _write_npz(path: str, entries) -> None:
    """``entries``: (name, a function giving its array), written one at
    a time into an uncompressed ``.npz`` at ``path`` (overwritten: a
    resume loop saves back to its own output), then renamed into
    place."""
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, get in entries:
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, get(), allow_pickle=False)
    os.replace(tmp, path)


_TREES = ("params", "opt_state/mu", "opt_state/nu")


def _state_trees(opt: AdamWState) -> list:
    return list(zip(_TREES, (opt.leaves, opt.moment("mu"),
                             opt.moment("nu"))))


def save_train_state(path: str, state: TrainState) -> None:
    """Checkpoint the full training state into one ``.npz`` at ``path``
    (overwritten: a resume loop saves back to its own output): ``step``,
    ``params/...``, ``opt_state/mu/...``, ``opt_state/nu/...`` and
    ``opt_state/count``. Written one leaf at a time, so the host holds
    one leaf's copy at once, then renamed into place. A state on ranks
    is gathered to rank 0 leaf by leaf into the same layout."""
    opt = state.opt_state
    if opt.shard is not None:
        opt.shard.ranks.call("save", opt.shard.sid, os.path.abspath(path))
        return
    entries = [("step", lambda: np.asarray(state.step, np.int64)),
               ("opt_state/count", lambda: np.asarray(opt.count, np.int64))]
    for prefix, tree in _state_trees(opt):
        entries += [(f"{prefix}/{p}", lambda t=t: _host(t))
                    for p, t in tree.items()]
    _write_npz(path, entries)


def restore_train_state(path: str, cfg: ModelConfig, optimizer: Optimizer,
                        *, plan: MeshPlan | None = None,
                        ranks: "TrainRanks | None" = None,
                        device="cuda") -> TrainState:
    """A ``save_train_state`` checkpoint (of any plan) on ``device``, or
    over the ranks of ``plan`` (or ``ranks``), each reading only its
    blocks. The params must be ``cfg``'s (shapes checked);
    ``optimizer`` only builds the state (its schedule is the step's: a
    resume passes the one it trains with to ``make_train_step``)."""
    device = resolve_device(device)
    group, owned = _ranks_for(cfg, plan, ranks, device)
    if group is not None:
        _check_checkpoint(path, cfg)
        return group.open("restore", cfg, (os.path.abspath(path),), owned)
    flat: dict[str, dict] = {"params": {}, "mu": {}, "nu": {}}
    with np.load(path) as f:
        step, count = int(f["step"]), int(f["opt_state/count"])
    for key, member in _npz_members(path).items():
        head, _, name = key.partition("/")
        if head == "opt_state" and name[:3] in ("mu/", "nu/"):
            head, name = name[:2], name[3:]
        if head in flat:
            flat[head][name] = to_tensor(_read_block(
                path, member, tuple((0, n) for n in member.shape)), device)
    params = _unflatten(flat["params"])
    _check_shapes(params, cfg)
    leaves = _leaves(params)
    if flat["mu"].keys() != leaves.keys() or flat["nu"].keys() \
            != leaves.keys():
        raise ValueError(f"{path}: the moments do not cover the params")
    return TrainState(step=step, params=params,
                      opt_state=_adamw(leaves, flat["mu"], flat["nu"],
                                       count))


def _check_shapes(params: dict, cfg: ModelConfig) -> None:
    """The embedding is [V, D] and every layer leaf stacks n_layers."""
    emb = tuple(params["embedding"].shape)
    bad = [] if emb == (cfg.vocab_size, cfg.dim) else [f"embedding {emb}"]
    bad += [f"layers/{k} {tuple(v.shape)}"
            for k, v in params["layers"].items()
            if v.shape[0] != cfg.n_layers]
    if bad:
        raise ValueError(f"a checkpoint that is not {cfg.name}'s: "
                         f"{', '.join(bad)}")


def _find(node: Any, fields: tuple) -> list:
    """Every named tuple with exactly ``fields`` inside an optax state
    (nested tuples and named tuples)."""
    if isinstance(node, tuple):
        if getattr(node, "_fields", None) == fields:
            return [node]
        return [x for child in node for x in _find(child, fields)]
    return []


def _np_leaves(tree: dict, prefix: str = "") -> dict:
    """A nested dict of arrays -> ``/``-joined path -> array, sorted."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_np_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def train_state_from_jax(state: Any, *, cfg: ModelConfig | None = None,
                         plan: MeshPlan | None = None,
                         ranks: "TrainRanks | None" = None,
                         device="cuda") -> TrainState:
    """A JAX ``TrainState`` of ``default_optimizer`` (numpy leaves, e.g.
    ``jax.device_get`` of one, from any mesh) as the port's: the params,
    optax's ``ScaleByAdamState`` ``mu``/``nu`` and its count, which must
    equal the schedule's count. The port then continues the run step
    for step. Over the ranks of ``plan`` (or ``ranks``; ``cfg`` names
    the model) the state crosses through a temporary checkpoint each
    rank reads its blocks of."""
    device = resolve_device(device)
    adam = _find(state.opt_state, ("count", "mu", "nu"))
    sched = _find(state.opt_state, ("count",))
    if len(adam) != 1 or len(sched) != 1:
        raise ValueError("not a default_optimizer state: expected one "
                         "ScaleByAdamState and one ScaleByScheduleState")
    count = int(np.asarray(adam[0].count))
    if int(np.asarray(sched[0].count)) != count:
        raise ValueError("the schedule's count is not the moments' count")
    if (plan is not None and plan.n_ranks > 1) or ranks is not None:
        if cfg is None:
            raise ValueError("a JAX state crosses onto ranks with its cfg")
        step = int(np.asarray(state.step))
        entries = [("step", lambda: np.asarray(step, np.int64)),
                   ("opt_state/count", lambda: np.asarray(count, np.int64))]
        cpu = torch.device("cpu")
        for prefix, tree in zip(_TREES, (state.params, adam[0].mu,
                                         adam[0].nu)):
            entries += [(f"{prefix}/{p}",
                         lambda a=a: _host(to_tensor(np.asarray(a), cpu)))
                        for p, a in _np_leaves(tree).items()]
        fd, tmp = tempfile.mkstemp(suffix=".npz", prefix="jax-state-")
        os.close(fd)
        try:
            _write_npz(tmp, entries)
            return restore_train_state(tmp, cfg, None, plan=plan,
                                       ranks=ranks, device=device)
        finally:
            os.unlink(tmp)
    params = from_jax_params(state.params, device=device)
    leaves = _leaves(params)
    mu = _leaves(from_jax_params(adam[0].mu, device=device))
    nu = _leaves(from_jax_params(adam[0].nu, device=device))
    return TrainState(step=int(np.asarray(state.step)), params=params,
                      opt_state=_adamw(leaves, mu, nu, count))


# -- training over ranks ---------------------------------------------------


def _layouts(cfg: ModelConfig, plan: MeshPlan, coords: dict) -> dict:
    return {p: leaf_layout(p, shape, cfg, plan, coords)
            for p, shape in _param_shapes(cfg).items()}


def state_shardings(state_like: Any, plan: MeshPlan) -> dict:
    """The fitted spec of every leaf of a state (JAX's
    ``state_shardings``): ``params`` by path, the moments ``mu`` and
    ``nu`` mirroring their param's spec (matched by path, as JAX
    matches by the dict-key chain), ``step`` and ``count`` replicated
    (``()``). ``state_like``: a TrainState or a params tree."""
    params = getattr(state_like, "params", state_like)
    specs = {}
    for path, t in _leaves(params).items():
        shape = tuple(t.shape)
        if state_like is not params and state_like.opt_state.shard \
                is not None:
            shape = state_like.opt_state.shard.layouts[path].shape
        name = path.rpartition("/")[2]
        specs[path] = fit_spec(spec_for(name, len(shape),
                                        path.startswith("layers/")),
                               shape, plan)
    return {"step": (), "params": specs, "mu": dict(specs),
            "nu": dict(specs), "count": ()}


@dataclass
class StateShard:
    """A rank's part of a state on ranks: its id there, each leaf's
    layout, and on rank 0 the ``TrainRanks`` that runs the others."""

    sid: int
    layouts: dict
    ranks: "TrainRanks | None" = None


class _Group:
    """One kind of a rank's ``TrainGroups`` as the in-place
    ``all_reduce(t)`` models.common's collectives take."""

    def __init__(self, groups: TrainGroups, kind: str):
        self.groups, self.kind = groups, kind

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return self.groups.all_reduce(t, self.kind)


class _GatherJob:
    """The gather of one set of leaves (a layer's, ``layer``: their
    per-layer slices, or the leaves outside the layers) and, as its
    backward, the reduce-scatter of their gradients."""

    def __init__(self, rank: "RankContext", lays: list, layer: bool,
                 split: bool):
        self.rank, self.lays, self.layer, self.split = rank, lays, layer, split

    def _boxes(self, lay: LeafLayout) -> tuple:
        cut = 1 if self.layer else 0
        return lay.block[cut:], lay.region[cut:], lay.compute[cut:]

    def gather(self, shards) -> list:
        return gather_blocks(self.rank.groups, self.lays, shards, self.layer)

    def reduce(self, grads, shards_meta) -> list:
        out: list = [None] * len(grads)
        jobs: dict[str, list] = {}
        for i, (lay, g) in enumerate(zip(self.lays, grads)):
            kind = lay.reduce_group(self.split)
            block, _, comp = self._boxes(lay)
            dtype, device = shards_meta[i]
            if kind is None:
                if g is None:
                    g = torch.zeros(_dims(comp), dtype=dtype, device=device)
                out[i] = g[_slices(block, comp)].to(dtype)
            else:
                jobs.setdefault(kind, []).append(i)
        for kind, idx in jobs.items():
            sizes = [_numel(self._boxes(self.lays[i])[1]) for i in idx]
            buf = torch.zeros(sum(sizes), dtype=shards_meta[idx[0]][0],
                              device=shards_meta[idx[0]][1])
            regions, off = [], 0
            for i, n in zip(idx, sizes):
                lay, g = self.lays[i], grads[i]
                _, region, comp = self._boxes(lay)
                reg = buf[off:off + n].view(_dims(region))
                off += n
                if g is not None and (lay.aligned or lay.tp_split
                                      or self.rank.coords["tp"] == 0):
                    reg[_slices(comp, region)] = g
                regions.append(reg)
            self.rank.groups.all_reduce(buf, kind)
            for i, reg in zip(idx, regions):
                block, region, _ = self._boxes(self.lays[i])
                out[i] = reg[_slices(block, region)].to(
                    shards_meta[i][0], copy=True)
        return out


class _Gathered(torch.autograd.Function):
    """A ``_GatherJob``'s gather forward, its reduce-scatter backward."""

    @staticmethod
    def forward(ctx, job, *shards):
        ctx.job = job
        ctx.meta = [(x.dtype, x.device) for x in shards]
        return tuple(job.gather(shards))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.job.reduce(grads, ctx.meta))


class RankContext:
    """One training rank: its plan, rank, command group (``comm``, a
    parallel.distributed.TPComm), training groups and device, and the
    states it holds by id."""

    def __init__(self, plan: MeshPlan, rank: int, comm, groups: TrainGroups,
                 device: torch.device):
        self.plan, self.rank, self.comm = plan, rank, comm
        self.groups, self.device = groups, device
        self.coords = plan.coords(rank)
        self.states: dict[int, TrainState] = {}

    def state(self, sid: int, cfg: ModelConfig, params: dict, count: int,
              step: int, mu=None, nu=None) -> TrainState:
        leaves = _leaves(params)
        opt = _adamw(leaves, mu, nu, count)
        opt.shard = StateShard(sid, _layouts(cfg, self.plan, self.coords))
        st = TrainState(step=step, params=params, opt_state=opt)
        self.states[sid] = st
        return st


def _op_init(rank: RankContext, sid: int, cfg: ModelConfig, seed: int):
    shapes = _param_shapes(cfg)
    lays = _layouts(cfg, rank.plan, rank.coords)
    paths = {p.rpartition("/")[2]: p for p in shapes}

    def block(name, t):
        lay = lays[paths[name]]
        return t[_slices(lay.block, tuple((0, n) for n in lay.shape))] \
            .contiguous().clone()

    params = llama.init(cfg, seed, device=rank.device, leaf=block)
    state = rank.state(sid, cfg, params, 0, 0)
    rank.comm.gather([1])   # every rank holds its blocks
    return state


class _Member(NamedTuple):
    """An array of an uncompressed ``.npz``: where its data starts in the
    file, its dtype and its shape."""

    offset: int
    dtype: np.dtype
    shape: tuple


def _npz_members(path: str) -> dict:
    """Each array of an uncompressed ``.npz`` by its name (without
    ``.npy``), located in the file, so a reader takes only the bytes it
    needs (``_read_block``), with no pass over the rest."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: {info.filename} is compressed")
            f.seek(info.header_offset)
            head = f.read(30)
            n_name = int.from_bytes(head[26:28], "little")
            n_extra = int.from_bytes(head[28:30], "little")
            f.seek(info.header_offset + 30 + n_name + n_extra)
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            if fortran:
                raise ValueError(f"{path}: {info.filename} is Fortran-ordered")
            name = info.filename[:-4] if info.filename.endswith(".npy") \
                else info.filename
            out[name] = _Member(f.tell(), dtype, tuple(shape))
    return out


def _read_block(path: str, member: _Member, box: Box) -> np.ndarray:
    """``box`` of ``member`` from the ``.npz`` at ``path``, copied out of
    a read-only map of the member: only the pages the box touches are
    read, and the host holds no copy of the rest of the leaf."""
    whole = np.memmap(path, dtype=member.dtype, mode="r",
                      offset=member.offset, shape=member.shape)
    try:
        return np.array(whole[_slices(box, tuple((0, n)
                                                 for n in member.shape))])
    finally:
        del whole


def _check_checkpoint(path: str, cfg: ModelConfig) -> None:
    """The checkpoint holds every leaf of ``cfg``'s params and moments at
    its shape."""
    members = _npz_members(path)
    bad = []
    for p, shape in _param_shapes(cfg).items():
        for prefix in _TREES:
            got = members.get(f"{prefix}/{p}")
            if got is None or got.shape != shape:
                bad.append(f"{prefix}/{p} "
                           f"{None if got is None else got.shape}")
    if bad:
        raise ValueError(f"a checkpoint that is not {cfg.name}'s: "
                         f"{', '.join(bad[:6])}")


def _op_restore(rank: RankContext, sid: int, cfg: ModelConfig, path: str):
    members = _npz_members(path)
    with np.load(path) as f:
        step, count = int(f["step"]), int(f["opt_state/count"])
    lays = _layouts(cfg, rank.plan, rank.coords)
    trees = [{p: to_tensor(_read_block(path, members[f"{prefix}/{p}"],
                                       lay.block), rank.device)
              for p, lay in lays.items()} for prefix in _TREES]
    params = _unflatten(trees[0])
    state = rank.state(sid, cfg, params, count, step, trees[1], trees[2])
    rank.comm.gather([1])   # every rank has read its blocks
    return state


def _rank_rows(tokens: np.ndarray, lengths: np.ndarray, plan: MeshPlan,
               coords: dict) -> tuple:
    """This rank's rows of the batch (``batch_spec``: the data axes,
    dp-major) and whether the batch is split (else every rank takes it
    all, as ``fit_spec`` replicates a batch the axes do not divide)."""
    n = plan.dp * plan.fsdp
    B = tokens.shape[0]
    if n == 1 or B % n:
        return tokens, lengths, False
    b = B // n
    i = coords["dp"] * plan.fsdp + coords["fsdp"]
    return tokens[i * b:(i + 1) * b], lengths[i * b:(i + 1) * b], True


def _op_step(rank: RankContext, sid: int, cfg: ModelConfig, settings,
             tokens, lengths):
    optimizer, remat, aux_weight = settings
    state = rank.states[sid]
    opt = state.opt_state
    lays, groups, plan = opt.shard.layouts, rank.groups, rank.plan
    tokens, lengths, split = _rank_rows(np.asarray(tokens),
                                        np.asarray(lengths), plan,
                                        rank.coords)
    tk = torch.as_tensor(tokens, device=rank.device).long()
    ln = torch.as_tensor(lengths, device=rank.device).to(torch.int32)
    rcfg = cfg if plan.tp == 1 else rank_config(
        cfg, plan.tp, rank.coords["tp"], TrainRanksComm(_Group(groups, "tp")))
    leaves = opt.leaves
    top = [p for p in leaves if not p.startswith("layers/")]
    views = _Gathered.apply(_GatherJob(rank, [lays[p] for p in top], False,
                                       split), *[leaves[p] for p in top])
    params = dict(zip(top, views), layers=state.params["layers"])
    keys = sorted(state.params["layers"])
    layer_lays = [lays[f"layers/{k}"] for k in keys]

    def gather(i, w):
        job = _GatherJob(rank, layer_lays, True, split)
        return dict(zip(keys, _Gathered.apply(job, *[w[k] for k in keys])))

    logits, probs = llama.forward(params, rcfg, tk, ln,
                                  return_router_probs=True, train=True,
                                  remat=remat, gather=gather)
    nll, count = loss_parts(logits, tk, ln)
    del logits
    data = _Group(groups, "data")
    count = count.detach().clone()
    if split:
        data.all_reduce(count)
    denom = torch.clamp(count, min=1.0)
    loss = nll / denom
    aux = torch.zeros((), device=rank.device)
    if cfg.n_experts > 0:
        aux = load_balance_loss(probs, ln, (lambda t: _Sum.apply(t, data))
                                if split else None)
        loss = loss + aux_weight * aux
    grads = list(torch.autograd.grad(loss, list(leaves.values())))
    zero = torch.zeros((), dtype=torch.float32, device=rank.device)
    sq = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) ** 2
                      if lays[p].holds else zero
                      for p, g in zip(leaves, grads)]).sum().reshape(1)
    gnorm = torch.sqrt(groups.all_reduce(sq, "world"))[0]
    optimizer.apply(opt, grads, gnorm)
    total = nll.detach().clone()
    if split:
        data.all_reduce(total)
    reported = total / denom + aux_weight * aux.detach() \
        if cfg.n_experts > 0 else total / denom
    new = TrainState(step=state.step + 1, params=state.params, opt_state=opt)
    rank.states[sid] = new
    return new, {"loss": reported.float(), "grad_norm": gnorm,
                 "aux_loss": aux.detach().float(), "step": new.step}


def _op_save(rank: RankContext, sid: int, path: str | None,
             params_only: bool = False):
    """Every leaf gathered to rank 0, one at a time: written to ``path``
    (or, with None, returned as a dict of arrays); ``params_only``: the
    params alone, in the serving layout (``save_params``)."""
    state = rank.states[sid]
    opt, plan = state.opt_state, rank.plan

    def whole(lay: LeafLayout, t: torch.Tensor):
        if rank.rank != 0:
            if lay.holds:
                rank.comm.send_tensors([t.detach().cpu()], 0)
            return None
        full = tuple((0, n) for n in lay.shape)
        out = torch.empty(lay.shape, dtype=t.dtype)
        for r in range(plan.n_ranks):
            co = plan.coords(r)
            if not _holds(lay.spec, plan, co):
                continue
            box = shard_block(lay.spec, lay.shape, plan, co)
            part = (t.detach().cpu() if r == 0 else
                    rank.comm.recv_tensors([(_dims(box), t.dtype)], r)[0])
            out[_slices(box, full)] = part
        return _host(out)

    entries = [("step", lambda: np.asarray(state.step, np.int64)),
               ("opt_state/count", lambda: np.asarray(opt.count, np.int64))]
    for prefix, tree in _state_trees(opt):
        entries += [(f"{prefix}/{p}",
                     lambda p=p, t=t: whole(opt.shard.layouts[p], t))
                    for p, t in tree.items()]
    if params_only:
        entries = [(name[len("params/"):], get) for name, get in entries
                   if name.startswith("params/")]
        if rank.rank != 0:
            for _, get in entries:
                get()
            return None
        _write_npz(path, entries)
        return None
    if rank.rank != 0:
        for _, get in entries[2:]:
            get()
        return None
    if path is None:
        return {name: get() for name, get in entries}
    _write_npz(path, entries)
    return None


def _op_report(rank: RankContext, sid: int) -> list:
    """Every rank's bytes of params, mu and nu, each leaf's block size,
    its time in collectives so far and its peak device memory (0 on the
    CPU), on rank 0."""
    opt = rank.states[sid].opt_state
    trees = [t for _, t in _state_trees(opt)]
    row = [sum(t.numel() * t.element_size() for t in tree.values())
           for tree in trees]
    row += [t.numel() for t in opt.leaves.values()]
    peak = (torch.cuda.max_memory_allocated(rank.device)
            if rank.device.type == "cuda" else 0)
    row += [int(rank.groups.collective_s * 1e6), rank.groups.calls, peak]
    rows = rank.comm.gather(row)
    names = list(opt.leaves)
    return [{"params_bytes": int(r[0]), "mu_bytes": int(r[1]),
             "nu_bytes": int(r[2]),
             "numel": dict(zip(names, map(int, r[3:3 + len(names)]))),
             "collective_s": int(r[-3]) / 1e6,
             "collective_calls": int(r[-2]), "peak_bytes": int(r[-1])}
            for r in rows]


def _op_drop(rank: RankContext, sid: int) -> None:
    rank.states.pop(sid, None)


_OPS = {"init": _op_init, "restore": _op_restore, "step": _op_step,
        "save": _op_save, "report": _op_report, "drop": _op_drop}


class TrainRanks:
    """Rank 0's handle on the training ranks of ``plan``: starts ranks
    1..N-1 (parallel.distributed ``TPRanks`` with a training spec), joins
    their training groups, and runs each op on every rank (``call``:
    the command broadcast, then rank 0's own share). One group holds
    any number of states (``open``); ``close`` stops the workers (also at
    exit). ``timeout_s`` limits every collective."""

    def __init__(self, plan: MeshPlan, device="cuda",
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        training_plan(plan.row())
        self.plan = plan
        self.device = resolve_device(device)
        self.owner: int | None = None
        self._last_sid = 0
        self._tp = TPRanks(plan.n_ranks, self.device,
                           {"kind": "train", "plan": plan},
                           timeout_s=timeout_s)
        try:
            groups = TrainGroups(self._tp._store, plan, 0, timeout_s)
            self._tp.wait_ready({})
        except BaseException:
            self._tp.close()
            raise
        self.rank = RankContext(plan, 0, self._tp.comm, groups,
                                self._tp.comm.device)
        atexit.register(self.close)

    def call(self, op: str, *args):
        if self._tp is None:
            raise RankFailure("the training ranks are closed")
        try:
            with self._tp.step(op, *args):
                return _OPS[op](self.rank, *args)
        except RankFailure as e:
            err = self._tp.worker_error()
            raise RankFailure(f"{e}; {err}" if err else str(e)) from None

    def open(self, op: str, cfg: ModelConfig, args: tuple,
             owned: bool = False) -> TrainState:
        """A new state on every rank (``op`` "init" or "restore")."""
        self._last_sid += 1
        sid = self._last_sid
        state = self.call(op, sid, cfg, *args)
        state.opt_state.shard.ranks = self
        if owned:
            self.owner = sid
        return state

    def report(self, state: TrainState) -> list:
        """Each rank's state bytes, block sizes and collective time."""
        return self.call("report", state.opt_state.shard.sid)

    def release(self, sid: int) -> None:
        """Free state ``sid`` on every rank; the state that started the
        ranks stops them."""
        if self._tp is None:
            return
        if sid == self.owner:
            self.close()
        else:
            self.call("drop", sid)

    def close(self) -> None:
        if self._tp is None:
            return
        tp, self._tp = self._tp, None
        atexit.unregister(self.close)
        tp.close()
        self.rank.groups.close()
        self.rank.states.clear()


def _ranks_for(cfg: ModelConfig, plan: MeshPlan | None,
               ranks: TrainRanks | None, device: torch.device) -> tuple:
    """(the ranks a state goes on, whether it starts them): None for one
    device. A caller that wants another collective time limit than
    DEFAULT_TIMEOUT_S passes its own ``TrainRanks``."""
    if ranks is not None:
        if plan is not None and plan != ranks.plan:
            raise ValueError(f"plan {plan.row()} on ranks of "
                             f"{ranks.plan.row()}")
        check_train_plan(cfg, ranks.plan)
        return ranks, False
    if plan is None:
        return None, False
    check_train_plan(cfg, plan)
    if plan.n_ranks == 1:
        return None, False
    return TrainRanks(plan, device), True


def _ranks_step(shard: StateShard, cfg: ModelConfig, settings, tokens,
                lengths):
    """Rank 0: a step of a state on ranks."""
    if shard.ranks is None:
        raise ValueError("a worker rank's state steps at rank 0's command")
    tokens, lengths = np.asarray(tokens), np.asarray(lengths)
    if tokens.ndim != 2 or lengths.shape != tokens.shape[:1]:
        raise ValueError(f"tokens {tokens.shape} and lengths "
                         f"{lengths.shape}: expected [B, S] and [B]")
    plan = shard.ranks.plan
    if cfg.moe_capacity_factor > 0 and cfg.n_experts > 0 and \
            _rank_rows(tokens, lengths, plan, plan.coords(0))[2]:
        raise ShardingConfigError(
            f"-sharding={plan.row()!r}: grouped MoE dispatch "
            f"(moe_capacity_factor={cfg.moe_capacity_factor}) over a "
            "split batch: JAX's capacity is over the whole batch; not "
            "ported yet (ROADMAP item 11b step 3c)",
            sharding_row=plan.row())
    return shard.ranks.call("step", shard.sid, cfg, settings,
                            tokens.astype(np.int32),
                            lengths.astype(np.int32))


def serve_rank(spec: dict, store, comm) -> int:
    """A worker rank's training loop (parallel.worker): join the
    training groups, report ready, then run rank 0's ops until
    ``close``."""
    from .distributed import READY_TIMEOUT_S

    plan = spec["plan"]
    groups = TrainGroups(store, plan, spec["rank"], spec["timeout_s"])
    rank = RankContext(plan, spec["rank"], comm, groups, comm.device)
    try:
        store.set(f"ready/{rank.rank}", "{}")
        comm.gather([1], timeout_s=READY_TIMEOUT_S)
        while True:
            op, args = comm.recv()
            if op == "close":
                return 0
            _OPS[op](rank, *args)
    finally:
        groups.close()


def save_params(path: str, state: TrainState) -> None:
    """The state's params alone into an ``.npz`` in the serving layout
    (``/``-joined tree paths, the JAX package's ``save_npz``: what
    TPU_WEIGHTS reads), written one leaf at a time; a state on ranks is
    gathered to rank 0 leaf by leaf."""
    opt = state.opt_state
    if opt.shard is not None:
        opt.shard.ranks.call("save", opt.shard.sid, os.path.abspath(path),
                             True)
        return
    _write_npz(path, [(p, lambda t=t: _host(t))
                      for p, t in opt.leaves.items()])


def gather_train_state(state: TrainState) -> dict:
    """Every leaf of ``state`` whole on the host by its checkpoint name
    (``step``, ``opt_state/count``, ``params/...``, ``opt_state/mu/...``,
    ``opt_state/nu/...``; bfloat16 as 2-byte voids, as saved): a
    state on ranks gathered to rank 0, as ``save_train_state`` gathers
    it."""
    opt = state.opt_state
    if opt.shard is not None:
        return opt.shard.ranks.call("save", opt.shard.sid, None)
    out = {"step": np.asarray(state.step, np.int64),
           "opt_state/count": np.asarray(opt.count, np.int64)}
    for prefix, tree in _state_trees(opt):
        out.update({f"{prefix}/{p}": _host(t) for p, t in tree.items()})
    return out
