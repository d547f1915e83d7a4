"""Training on one device (gofr_tpu_torch.parallel.train) against the
JAX package's ``parallel.train`` on ``tiny`` and ``tiny-moe``, on the CPU.

The same seeded inputs (numpy) go through both packages; the JAX params
cross over through ``from_jax_params``, so both start from the same
values. JAX trains on its one-device mesh (``single_device_mesh``), in
float32 with conftest's float32 matmuls. Tolerances, float32:

- the loss functions (``loss_parts_local`` with a sequence shard,
  ``next_token_loss`` with padded rows, ``load_balance_loss``): atol
  1e-6;
- the learning rate at counts 0..N: rtol 1e-6 of optax's schedule;
  the clip below and above ``grad_clip``: rtol 1e-6, atol 1e-9;
- gradients leaf by leaf against ``jax.grad``: rtol 1e-4, atol 1e-5
  (the two sum in other orders; a few embedding rows of the grouped
  dispatch cancel to 1e-3 and part by 2e-6);
- 5 steps of ``make_train_step`` at lr 1e-2: loss, ``grad_norm`` and
  ``aux_loss`` rtol 1e-4; the params after the steps: all but one
  element in 1000 of each leaf within 1e-5 of JAX's, and every element
  within lr (Adam's m / sqrt(v) turns the last bits of a gradient near
  zero into an update of up to lr: 1-2 elements in 10^4 part by
  2.7e-5-1.5e-4);
- save -> restore -> continue: bit-equal to continuing in memory;
- the example's ``train`` and ``resume`` sub-commands on each package's
  ``new_cmd`` (the port's are chip_smoke.py's ``finetune_routes``, the
  copy phase ``train`` runs on the card): the same step and the printed
  loss within 1e-4.
"""

import contextlib
import functools
import importlib.util
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
import gofr_tpu_torch
from gofr_tpu import parallel as jpar
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.parallel import train as jtrain
from gofr_tpu_torch import parallel as ppar
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.errors import ShardingConfigError
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.parallel import train as ptrain
from gofr_tpu_torch.tpu import from_jax_params, maybe_quantize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5
LR = 1e-2


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _batch(seed: int, cfg, b: int = 2, s: int = 16):
    """Tokens [b, s] and lengths with one padded row."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    lengths = np.full((b,), s, np.int32)
    lengths[-1] = s - 5
    return tokens, lengths


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.detach() if isinstance(
                v, torch.Tensor) else v, np.float32)
    return out


# -- the loss functions, the schedule and the clip ----------------------------

def _loss_case(name: str):
    rng = np.random.default_rng(1)
    B, S, V = 3, 12, 40
    logits = rng.standard_normal((B, S, V)).astype(np.float32)
    tokens = rng.integers(0, V, (B, S)).astype(np.int32)
    lengths = np.array([12, 7, 0], np.int32)
    if name == "loss_parts_local":
        g0, sn = 4, 5   # a shard at [4, 9) of the 12 positions
        want = jtrain.loss_parts_local(jnp.asarray(logits[:, g0:g0 + sn]),
                                       jnp.asarray(tokens),
                                       jnp.asarray(lengths), jnp.int32(g0), S)
        got = ptrain.loss_parts_local(_t(logits[:, g0:g0 + sn]), _t(tokens),
                                      _t(lengths), g0, S)
    elif name == "next_token_loss":
        want = jtrain.next_token_loss(jnp.asarray(logits), jnp.asarray(tokens),
                                      jnp.asarray(lengths))
        got = ptrain.next_token_loss(_t(logits), _t(tokens), _t(lengths))
    else:
        probs = rng.dirichlet(np.ones(4), (2, B, S)).astype(np.float32)
        want = jtrain.load_balance_loss(jnp.asarray(probs),
                                        jnp.asarray(lengths))
        got = ptrain.load_balance_loss(_t(probs), _t(lengths))
    return np.asarray(want), np.asarray([g.numpy() for g in got]
                                        if isinstance(got, tuple) else got)


@pytest.mark.parametrize("name", ["loss_parts_local", "next_token_loss",
                                  "load_balance_loss"])
def test_the_loss_functions_equal_jax(name):
    want, got = _loss_case(name)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_the_schedule_is_optax_s_at_every_count():
    for lr, warmup, total in ((3e-4, 2, 20), (1e-2, 1, 5), (1e-3, 10, 11)):
        sched = optax.warmup_cosine_decay_schedule(
            0.0, lr, warmup, max(total, warmup + 1))
        opt = ppar.default_optimizer(lr=lr, warmup=warmup,
                                     total_steps=total)
        for count in range(total + 3):
            np.testing.assert_allclose(opt.schedule(count),
                                       float(sched(count)), rtol=1e-6,
                                       atol=0)
        assert opt.schedule(0) == 0.0


@pytest.mark.parametrize("scale", [0.01, 100.0], ids=["below", "above"])
def test_the_clip_is_optax_s_below_and_above_the_bound(scale):
    rng = np.random.default_rng(2)
    grads = {"a": rng.standard_normal((4, 5)).astype(np.float32) * scale,
             "b": rng.standard_normal((7,)).astype(np.float32) * scale}
    clip = optax.clip_by_global_norm(1.0)
    want, _ = clip.update(jax.tree.map(jnp.asarray, grads), clip.init(grads))
    got = [_t(grads["a"]), _t(grads["b"])]
    norm = ptrain.clip_by_global_norm(got, 1.0)
    np.testing.assert_allclose(float(norm),
                               float(optax.global_norm(grads)), rtol=1e-6)
    for g, name in zip(got, ("a", "b")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=1e-9)
    assert (float(norm) < 1.0) == (scale < 1)


# -- gradients ------------------------------------------------------------------

GRAD_CASES = {"tiny": ("tiny", 0.0), "tiny-moe-dense": ("tiny-moe", 0.0),
              "tiny-moe-grouped": ("tiny-moe", 1.0)}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_gradients_equal_jax_grad_leaf_by_leaf(case):
    name, capacity = GRAD_CASES[case]
    jcfg = JAX_CONFIGS[name].with_(moe_capacity_factor=capacity)
    cfg = LLAMA_CONFIGS[name].with_(moe_capacity_factor=capacity)
    jparams = jllama.init(jcfg, jax.random.PRNGKey(3))
    tokens, lengths = _batch(4, cfg)
    moe = cfg.n_experts > 0

    def jloss(p):
        if moe:
            logits, probs = jllama.forward(p, jcfg, tokens, lengths,
                                           return_router_probs=True)
            return (jtrain.next_token_loss(logits, tokens, lengths)
                    + 0.01 * jtrain.load_balance_loss(probs, lengths))
        return jtrain.next_token_loss(jllama.forward(p, jcfg, tokens, lengths),
                                      tokens, lengths)

    jl, jgrads = jax.value_and_grad(jloss)(jparams)
    params = from_jax_params(_np_tree(jparams), device="cpu")
    leaves = ptrain._leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    tk, ln = _t(tokens).long(), _t(lengths)
    logits, probs = tllama.forward(params, cfg, tk, ln, train=True,
                                   return_router_probs=True)
    loss = ptrain.next_token_loss(logits, tk, ln)
    if moe:
        loss = loss + 0.01 * ptrain.load_balance_loss(probs, ln)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    want = _flat(_np_tree(jgrads))
    assert sorted(want) == sorted(leaves)
    for (path, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4,
                                   atol=1e-5, err_msg=path)


# -- the train step against JAX's ----------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_run(name: str):
    """JAX's one-device run of STEPS steps: the initial params, the
    state after 3 steps, each step's metrics and the final params (all
    numpy)."""
    jcfg = JAX_CONFIGS[name]
    mesh = jpar.single_device_mesh()
    opt = jpar.default_optimizer(lr=LR, warmup=2, total_steps=10)
    state = jpar.init_train_state(jcfg, jax.random.PRNGKey(5), mesh, opt)
    step = jpar.make_train_step(jcfg, opt, mesh)
    init = _np_tree(state.params)
    tokens, lengths = _batch(6, jcfg, b=4, s=24)
    metrics, at3 = [], None
    for i in range(STEPS):
        if i == 3:
            at3 = _np_tree(state)
        state, m = step(state, tokens, lengths)
        metrics.append({k: float(v) for k, v in m.items()})
    return init, at3, metrics, _np_tree(state.params), (tokens, lengths)


def _port_state(params_np, opt):
    params = from_jax_params(params_np, device="cpu")
    return ppar.TrainState(step=0, params=params, opt_state=opt.init(params))


def _check_metrics(got: list, want: list):
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        for k in ("loss", "grad_norm", "aux_loss"):
            np.testing.assert_allclose(float(g[k]), w[k], rtol=1e-4,
                                       atol=1e-7, err_msg=k)


def _check_params(params, want_np):
    want = _flat(want_np)
    for path, t in ptrain._leaves(params).items():
        diff = np.abs(t.detach().numpy() - want[path])
        assert np.mean(diff > 1e-5) < 1e-3 and diff.max() < LR, \
            (path, float(np.mean(diff > 1e-5)), float(diff.max()))


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_five_steps_equal_jax_s(name, remat):
    init, _, want, final, (tokens, lengths) = _jax_run(name)
    cfg = LLAMA_CONFIGS[name]
    opt = ppar.default_optimizer(lr=LR, warmup=2, total_steps=10)
    state = _port_state(init, opt)
    step = ppar.make_train_step(cfg, opt, remat=remat, device="cpu")
    got = []
    for _ in range(STEPS):
        state, m = step(state, tokens, lengths)
        got.append(m)
    _check_metrics(got, want)
    assert got[0]["grad_norm"] > 1.0   # the clip ran
    if cfg.n_experts:
        assert 1.0 <= float(got[0]["aux_loss"]) <= cfg.n_experts
    _check_params(state.params, final)
    assert state.step == STEPS and state.opt_state.count == STEPS


def test_a_jax_state_carried_across_continues_step_for_step():
    """``train_state_from_jax`` after 3 JAX steps: 2 more port steps end
    where JAX's 5 do."""
    _, at3, want, final, (tokens, lengths) = _jax_run("tiny")
    cfg = LLAMA_CONFIGS["tiny"]
    opt = ppar.default_optimizer(lr=LR, warmup=2, total_steps=10)
    state = ppar.train_state_from_jax(at3, device="cpu")
    assert state.step == 3 and state.opt_state.count == 3
    step = ppar.make_train_step(cfg, opt, device="cpu")
    got = []
    for _ in range(2):
        state, m = step(state, tokens, lengths)
        got.append(m)
    _check_metrics(got, want[3:])
    _check_params(state.params, final)


def test_save_restore_continue_is_bit_equal_to_continuing_in_memory(tmp_path):
    cfg = LLAMA_CONFIGS["tiny-moe"]
    opt = ppar.default_optimizer(lr=LR, warmup=2, total_steps=10)
    tokens, lengths = _batch(8, cfg, b=3, s=20)
    step = ppar.make_train_step(cfg, opt, device="cpu")
    state = ppar.init_train_state(cfg, 0, opt, device="cpu")
    for _ in range(2):
        state, _ = step(state, tokens, lengths)
    path = str(tmp_path / "state.npz")
    ppar.save_train_state(path, state)
    restored = ppar.restore_train_state(path, cfg, opt, device="cpu")
    assert restored.step == 2 and restored.opt_state.count == 2
    runs = []
    for st in (state, restored):
        for _ in range(2):
            st, m = step(st, tokens, lengths)
        runs.append((st, m))
    (a, ma), (b, mb) = runs
    for k in ("loss", "grad_norm", "aux_loss"):
        assert torch.equal(ma[k], mb[k]), k
    for tree in ("mu", "nu"):
        for path_, t in a.opt_state.moment(tree).items():
            assert torch.equal(t, b.opt_state.moment(tree)[path_])
    for (pa, ta), (pb, tb) in zip(ptrain._leaves(a.params).items(),
                                  ptrain._leaves(b.params).items()):
        assert pa == pb and torch.equal(ta, tb), pa


def test_a_bf16_checkpoint_round_trips_bit_for_bit(tmp_path):
    # saved after two steps at lr > 0: the params have moved and both
    # bf16 moments are non-zero
    cfg = LLAMA_CONFIGS["tiny"].with_(dtype="bfloat16")
    opt = ppar.default_optimizer(lr=LR, warmup=1, total_steps=10)
    tokens, lengths = _batch(9, cfg, b=2, s=16)
    state = ppar.init_train_state(cfg, 0, opt, device="cpu")
    init = {p: t.clone() for p, t in ptrain._leaves(state.params).items()}
    step = ppar.make_train_step(cfg, opt, device="cpu")
    for _ in range(2):
        state, _ = step(state, tokens, lengths)
    path = str(tmp_path / "bf16.npz")
    ppar.save_train_state(path, state)
    back = ppar.restore_train_state(path, cfg, opt, device="cpu")
    assert back.step == 2 and back.opt_state.count == 2
    trees = [(ptrain._leaves(state.params), ptrain._leaves(back.params))]
    trees += [(state.opt_state.moment(m), back.opt_state.moment(m))
              for m in ("mu", "nu")]
    for tree, (a, b) in zip(("params", "mu", "nu"), trees):
        assert a.keys() == b.keys()
        for p, ta in a.items():
            tb = b[p]
            assert tb.dtype == torch.bfloat16 and torch.equal(ta, tb), \
                (tree, p)
        if tree == "params":
            assert any(not torch.equal(t, init[p]) for p, t in a.items())
        else:
            assert all(bool(t.any()) for t in a.values()), tree
    with pytest.raises(ValueError, match="not tiny-moe's"):
        ppar.restore_train_state(path, LLAMA_CONFIGS["tiny-moe"].with_(
            n_layers=3), opt, device="cpu")


# -- the refusals ---------------------------------------------------------------

def _refusal(case: str):
    cfg = LLAMA_CONFIGS["tiny"]
    opt = ppar.default_optimizer()
    if case.startswith("sharding:"):
        return lambda: ppar.training_plan(case.split(":", 1)[1])
    if case == "ring":
        return lambda: ppar.make_train_step(cfg, opt, seq_parallel="ring",
                                            device="cpu")
    if case == "n_microbatches":
        return lambda: ppar.make_train_step(cfg, opt, n_microbatches=2,
                                            device="cpu")
    if case == "int8":
        params = maybe_quantize(tllama.init(cfg, 0, device="cpu"), True)
        return lambda: opt.init(params)
    if case.startswith("plan:"):
        # refused by the model's check before any rank starts
        name, _, row = case[5:].partition("@")
        return lambda: ppar.init_train_state(
            LLAMA_CONFIGS[name], 0, opt,
            plan=ppar.MeshPlan(**{k: int(v) for k, v in
                                  (a.split("=") for a in row.split(","))}),
            device="cpu")
    return lambda: ppar.init_train_state(cfg, 0, opt)   # "card"


REFUSALS = {
    "plan:tiny@ep=2": (ShardingConfigError, "ep=2.*3c, ep with MoE"),
    "plan:tiny-moe@tp=2": (ShardingConfigError, "mixture of experts.*3c"),
    "plan:tiny@tp=3": (ShardingConfigError, "tp=3.*n_heads=4"),
    "sharding:ep=2": (ShardingConfigError, "ep=2.*MoE"),
    "sharding:pp=2": (ShardingConfigError, "pp=2.*pipeline.py"),
    "sharding:sp=2": (ShardingConfigError, "sp=2.*ring_attention.py"),
    "sharding:dp=2,pp=2": (ShardingConfigError, "dp=2.*pp=2"),
    "sharding:xx=2": (ShardingConfigError, "axis=size"),
    "ring": (ShardingConfigError, "ring attention"),
    "n_microbatches": (ValueError, "n_microbatches"),
    "int8": (ValueError, "int8-quantized"),
    "card": (RuntimeError, "no CUDA device"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_what_the_port_does_not_train_raises_by_name(case, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    error, match = REFUSALS[case]
    with pytest.raises(error, match=match):
        _refusal(case)()


def test_one_device_rows_pass():
    for row in ("", "tp=1", "dp=1,fsdp=1,ep=1,pp=1,sp=1,tp=1"):
        assert ppar.training_plan(row).shape() == {
            ax: 1 for ax in ("dp", "pp", "fsdp", "ep", "sp", "tp")}


@pytest.mark.parametrize("row", ["dp=2", "fsdp=2,tp=1", "tp=2",
                                 "dp=2,fsdp=2,tp=2"])
def test_the_rows_over_dp_fsdp_and_tp_pass(row):
    """The rows the port now trains on (tests/test_torch_train_mesh.py
    trains them); ``tiny`` takes each."""
    plan = ppar.training_plan(row)
    want = {k: int(v) for k, v in (a.split("=") for a in row.split(","))}
    assert {ax: n for ax, n in plan.shape().items() if n > 1} == {
        ax: n for ax, n in want.items() if n > 1}
    ppar.check_train_plan(LLAMA_CONFIGS["tiny"], plan)


# -- examples/tpu-finetune's train and resume on both packages' new_cmd ---------

def _jax_example():
    """examples/tpu-finetune/main.py, its App built on test rows."""
    import gofr_tpu.app as app_mod

    orig = app_mod.App.__init__

    def patched(self, config=None, config_folder="./configs"):
        orig(self, JMapConfig({"LOG_LEVEL": "ERROR"}))

    app_mod.App.__init__ = patched
    try:
        path = os.path.join(ROOT, "examples", "tpu-finetune", "main.py")
        spec = importlib.util.spec_from_file_location(
            "example_tpu_finetune_torch_test", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.app
    finally:
        app_mod.App.__init__ = orig


def _run_command(app, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = app.run_command(list(argv))
    return rc, out.getvalue()


def test_the_example_s_train_and_resume_equal_jax_s(tmp_path, monkeypatch):
    """Both packages' ``new_cmd`` run ``train -steps=3`` then ``resume
    -steps=2`` on ``tiny`` from the same weights (the port's seeded
    init replaced by JAX's ``PRNGKey(seed)`` draw, carried across): the
    same steps, the printed losses within 1e-4, and the resumed run
    learned."""
    jinit = jllama.init

    def jax_weights(cfg, seed, device="cuda", **_):
        return from_jax_params(_np_tree(jinit(JAX_CONFIGS[cfg.name],
                                              jax.random.PRNGKey(seed))),
                               device=device)

    monkeypatch.setattr(tllama, "init", jax_weights)
    papp = gofr_tpu_torch.new_cmd(MapConfig({"LOG_LEVEL": "ERROR"}))
    chip_smoke.finetune_routes(papp, "cpu")
    apps = {"jax": _jax_example(), "port": papp}
    outs = {"jax": str(tmp_path / "jax_ckpt"),
            "port": str(tmp_path / "port_ckpt.npz")}
    common = ["-model=tiny", "-batch=4", "-seq=32", "-lr=1e-2"]
    got = {}
    for side, app in apps.items():
        lines = []
        for argv in (["train", "-steps=3"], ["resume", "-steps=2"]):
            rc, text = _run_command(app, argv + common + [f"-out={outs[side]}"])
            assert rc == 0, (side, text)
            m = re.search(r"trained to step (\d+) loss ([\d.]+)", text)
            lines.append((int(m.group(1)), float(m.group(2))))
        got[side] = lines
    assert [s for s, _ in got["port"]] == [3, 5]
    assert [s for s, _ in got["port"]] == [s for s, _ in got["jax"]]
    for (_, a), (_, b) in zip(got["port"], got["jax"]):
        assert abs(a - b) <= 1e-4, got
    assert got["port"][1][1] < got["port"][0][1] - 1e-4
