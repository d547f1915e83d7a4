"""Training on one device (counterpart of gofr_tpu/parallel/train.py):
forward, loss, gradients and an AdamW update, with JAX's names and
numbers.

The JAX package jits the whole step over a mesh and lets GSPMD shard
the state over its data axes. The port trains on one device: every
``-sharding`` axis above 1 raises ``ShardingConfigError`` naming the
axis (``training_plan``), as do ring attention and int8 weights;
``n_microbatches`` raises as JAX's does without ``pp``.

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

import os
import zipfile
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..errors import ShardingConfigError
from ..models import llama
from ..models.common import ModelConfig
from ..ops.quant import QuantizedLinear
from ..tpu.checkpoint import _unflatten, from_jax_params, to_tensor
from .mesh import MeshPlan, parse_mesh_row

# where each axis of a training mesh lands in ROADMAP
_AXIS_HOME = {
    "dp": "ROADMAP item 11b step 3, the data axes",
    "fsdp": "ROADMAP item 11b step 3, the data axes",
    "ep": "ROADMAP item 11b step 3, ep with MoE",
    "tp": "ROADMAP item 11b step 3, training under tp",
    "pp": "ROADMAP item 12, parallel/pipeline.py",
    "sp": "ROADMAP item 12, ops/ring_attention.py",
}


def training_plan(spec: str | None) -> MeshPlan:
    """The ``-sharding`` row of a training run -> MeshPlan. The port
    trains on one device: any axis above 1 raises
    ``ShardingConfigError`` naming the axis and where it lands in
    ROADMAP (an empty row is the one device, as JAX's
    ``single_device_mesh``)."""
    plan = parse_mesh_row(spec, "-sharding") or MeshPlan()
    above = [f"{ax}={n} ({_AXIS_HOME[ax]})"
             for ax, n in plan.shape().items() if n > 1]
    if above:
        raise ShardingConfigError(
            f"-sharding={spec.strip()!r}: gofr_tpu_torch trains on one "
            f"device; not ported yet: {', '.join(above)}",
            sharding_row=spec.strip())
    return plan


class TrainState(NamedTuple):
    step: int
    params: dict
    opt_state: "AdamWState"


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


def clip_by_global_norm(grads: list, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the list ``grads``, IN PLACE
    (each entry replaced, so one gradient's copy exists at a time): each
    gradient as it is where the global norm is below ``max_norm``, else
    ``g / norm * max_norm`` (in that order, the norm in the gradient's
    dtype), chosen on the device with no host read. Returns the norm
    before clipping."""
    gnorm = global_norm(grads)
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

    def apply(self, state: AdamWState, grads: list) -> torch.Tensor:
        """One update of ``state``'s leaves by ``grads`` (a list in leaf
        order, consumed), IN PLACE: clip by the global norm, then AdamW
        at the schedule's rate for the count before the update. Returns
        the global norm before clipping, float32 on the device."""
        gnorm = clip_by_global_norm(grads, self.grad_clip)
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
                      lengths: torch.Tensor) -> torch.Tensor:
    """Switch-Transformer-style MoE auxiliary loss: E * mean over layers
    of sum_e f_e * P_e over VALID tokens, f_e the fraction of tokens
    whose top-1 expert is e and P_e the mean router probability of e.
    1.0 at perfect balance, up to E as the router collapses.
    router_probs: [L, B, S, E] float32."""
    L, B, S, E = router_probs.shape
    dev = router_probs.device
    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None]).float()
    denom = torch.clamp(torch.sum(mask), min=1.0)
    top1 = torch.argmax(router_probs, dim=-1)                 # [L, B, S]
    onehot = (top1[..., None] == torch.arange(E, device=dev)).float()
    f = torch.sum(onehot * mask[None, ..., None], dim=(1, 2)) / denom
    p = torch.sum(router_probs * mask[None, ..., None], dim=(1, 2)) / denom
    return E * torch.mean(torch.sum(f * p, dim=-1))


def init_train_state(cfg: ModelConfig, seed: int, optimizer: Optimizer, *,
                     device="cuda") -> TrainState:
    """Seeded params (``models.llama.init``) and zero moments on
    ``device`` (the card unless the caller asks for another)."""
    device = resolve_device(device)
    params = llama.init(cfg, seed, device=device)
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


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
    tensors on the device, and ``step``.

    MoE configs add ``moe_aux_weight`` times ``load_balance_loss``.
    ``seq_parallel``: "auto" and "dense" train on the dense attention
    (one device has no sp axis); "ring" raises. ``n_microbatches``
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
            "attention on one device")
    if seq_parallel not in ("auto", "dense"):
        raise ValueError(f"seq_parallel must be 'auto', 'dense' or "
                         f"'ring', got {seq_parallel!r}")
    moe = cfg.n_experts > 0

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


def save_train_state(path: str, state: TrainState) -> None:
    """Checkpoint the full training state into one ``.npz`` at ``path``
    (overwritten: a resume loop saves back to its own output): ``step``,
    ``params/...``, ``opt_state/mu/...``, ``opt_state/nu/...`` and
    ``opt_state/count``. Written one leaf at a time, so the host holds
    one leaf's copy at once, then renamed into place."""
    opt = state.opt_state
    entries = [("step", lambda: np.asarray(state.step, np.int64)),
               ("opt_state/count", lambda: np.asarray(opt.count, np.int64))]
    for prefix, tree in (("params", opt.leaves), ("opt_state/mu",
                                                  opt.moment("mu")),
                         ("opt_state/nu", opt.moment("nu"))):
        entries += [(f"{prefix}/{p}", lambda t=t: _host(t))
                    for p, t in tree.items()]
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, get in entries:
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, get(), allow_pickle=False)
    os.replace(tmp, path)


def restore_train_state(path: str, cfg: ModelConfig, optimizer: Optimizer,
                        *, device="cuda") -> TrainState:
    """A ``save_train_state`` checkpoint on ``device``. The params must
    be ``cfg``'s (shapes checked); ``optimizer`` only builds the state
    (its schedule is the step's: a resume passes the one it trains
    with to ``make_train_step``)."""
    device = resolve_device(device)
    flat: dict[str, dict] = {"params": {}, "mu": {}, "nu": {}}
    with np.load(path) as f:
        step, count = int(f["step"]), int(f["opt_state/count"])
        for key in f.files:
            head, _, name = key.partition("/")
            if head == "opt_state" and name[:3] in ("mu/", "nu/"):
                head, name = name[:2], name[3:]
            if head in flat:
                flat[head][name] = to_tensor(f[key], device)
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


def train_state_from_jax(state: Any, *, device="cuda") -> TrainState:
    """A JAX ``TrainState`` of ``default_optimizer`` (numpy leaves, e.g.
    ``jax.device_get`` of one) as the port's: the params, optax's
    ``ScaleByAdamState`` ``mu``/``nu`` and its count, which must equal
    the schedule's count. The port then continues the run step for
    step."""
    device = resolve_device(device)
    adam = _find(state.opt_state, ("count", "mu", "nu"))
    sched = _find(state.opt_state, ("count",))
    if len(adam) != 1 or len(sched) != 1:
        raise ValueError("not a default_optimizer state: expected one "
                         "ScaleByAdamState and one ScaleByScheduleState")
    count = int(np.asarray(adam[0].count))
    if int(np.asarray(sched[0].count)) != count:
        raise ValueError("the schedule's count is not the moments' count")
    params = from_jax_params(state.params, device=device)
    leaves = _leaves(params)
    mu = _leaves(from_jax_params(adam[0].mu, device=device))
    nu = _leaves(from_jax_params(adam[0].nu, device=device))
    return TrainState(step=int(np.asarray(state.step)), params=params,
                      opt_state=_adamw(leaves, mu, nu, count))

