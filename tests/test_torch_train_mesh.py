"""Training over dp, fsdp and tp ranks (gofr_tpu_torch.parallel.train)
against the JAX package's ``parallel.train`` on ``tiny`` and
``tiny-moe``, on the CPU.

The ranks are worker processes on ``device="cpu"`` over gloo, shared
by the tests of one plan (``ranks``, module-scoped, started on first
use). Each case starts from JAX's ``init_train_state`` (``PRNGKey(5)``)
carried across with ``train_state_from_jax``, and trains 5 steps at lr
1e-2 on the same seeded numpy tokens (batch 8, sequence 32, one row
padded), float32:

- against JAX's mesh step at the same factorization: ``loss`` and
  ``grad_norm`` within 1e-5 relative, the gathered params, ``mu`` and
  ``nu`` within 2e-4 absolute (measured at most: loss and grad_norm
  1.2e-6 relative; params 1.7e-4, mu 4.7e-7, nu 1.3e-8);
- against JAX's one-device step (``single_device_mesh``) on the same
  tolerances, but for at most 2 params elements that may part by up to
  5e-4 (measured: loss and grad_norm 1.5e-6 relative; params 1.8e-4
  at every element but one of 106816 at tp=2 (2.02e-4) and one at
  dp=2,fsdp=2,tp=2 (2.27e-4); mu 5.0e-7, nu 1.3e-8). Those elements
  sit where Adam's m / sqrt(v) turns the last bits of a near-zero
  gradient into an update of up to lr (mu there agrees within 2e-7),
  as the one-device step parts from JAX's by up to 1.5e-4
  (tests/test_torch_train.py).
  JAX's own mesh step drifts about 1% from its one-device step at
  dp=2,fsdp=2,tp=2 in tests/test_parallel.py's resume case (lr 1e-3,
  batch 4); on these inputs it agrees with its one-device step at every
  factorization here (loss and grad_norm within 4.8e-7 relative, params
  within 8.7e-5), so the port is held to both.

Also: the layout rules against JAX's (each fitted spec, each rank's
block the slice JAX's sharding puts on its device, each rank's rows of
the batch), each rank's blocks (1/(fsdp·tp) of a leaf both axes divide,
slices of the one-device init bit for bit), a rank's reads of its
blocks from a checkpoint, a checkpoint saved at
dp=2,fsdp=2,tp=2 restored bit-equal at tp=4,dp=2 and on one device (and
a one-device one onto the ranks), a JAX mesh state carried across that
continues step for step, and examples/tpu-finetune's ``train`` at
dp=2,fsdp=2,tp=2 then ``resume`` at tp=4,dp=2 through chip_smoke.py's
``finetune_routes`` (tests/test_examples.py's run: the resumed loss
falls, trained to step 5), its printed losses within 1e-4 of the same
commands on one device.
"""

import contextlib
import functools
import io
import math
import re
import signal
import threading

import jax
import numpy as np
import pytest

import chip_smoke
import gofr_tpu_torch
from gofr_tpu import parallel as jpar
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch import parallel as ppar
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.models import LLAMA_CONFIGS
from gofr_tpu_torch.parallel import train as ptrain

STEPS, LR, SEQ = 5, 1e-2, 32
# one test's limit: a hang fails it; every collective has its own
_LIMIT_S = 120
CASES = {"dp=2": ("tiny", 8), "fsdp=2": ("tiny", 8), "tp=2": ("tiny", 8),
         "dp=2,fsdp=2,tp=2": ("tiny", 8), "tp=4,dp=2": ("tiny", 8),
         "moe:dp=2,fsdp=2": ("tiny-moe", 8), "b3:dp=2": ("tiny", 3)}


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(*_):
        raise TimeoutError(f"a training-ranks test ran past {_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, _LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


class _Ranks:
    """One ``TrainRanks`` a plan row, started on first use."""

    def __init__(self):
        self.groups = {}

    def __call__(self, row: str) -> ppar.TrainRanks:
        if row not in self.groups:
            self.groups[row] = ppar.TrainRanks(ppar.training_plan(row),
                                               device="cpu", timeout_s=60)
        return self.groups[row]

    def close(self):
        threads = [threading.Thread(target=g.close)
                   for g in self.groups.values()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()


@pytest.fixture(scope="module")
def ranks():
    r = _Ranks()
    yield r
    r.close()


def _batch(b: int):
    rng = np.random.default_rng(6)
    tokens = rng.integers(1, 256, (b, SEQ)).astype(np.int32)
    lengths = np.full((b,), SEQ, np.int32)
    lengths[-1] = SEQ - 5
    return tokens, lengths


def _optimizer(pkg):
    return pkg.default_optimizer(lr=LR, warmup=2, total_steps=10)


def _jax_flat(state) -> dict:
    """A device_get JAX TrainState by checkpoint name, float32."""
    adam = ptrain._find(state.opt_state, ("count", "mu", "nu"))[0]
    out = {}
    for prefix, tree in zip(ptrain._TREES, (state.params, adam.mu, adam.nu)):
        out.update({f"{prefix}/{p}": np.asarray(a, np.float32)
                    for p, a in ptrain._np_leaves(tree).items()})
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(name: str, row: str, b: int):
    """JAX's run of STEPS steps on one device (row "") or on its mesh of
    ``row``: the initial state, the state after 3 steps, each step's
    metrics and the final state by checkpoint name (numpy)."""
    cfg = JAX_CONFIGS[name]
    if row:
        axes = {k: int(v) for k, v in
                (part.split("=") for part in row.split(","))}
        mesh = jpar.make_mesh(devices=jax.devices()[:math.prod(
            axes.values())], **axes)
    else:
        mesh = jpar.single_device_mesh()
    opt = _optimizer(jpar)
    state = jpar.init_train_state(cfg, jax.random.PRNGKey(5), mesh, opt)
    step = jpar.make_train_step(cfg, opt, mesh)
    init = jax.device_get(state)
    tokens, lengths = _batch(b)
    metrics, at3 = [], None
    for i in range(STEPS):
        if i == 3:
            at3 = jax.device_get(state)
        state, m = step(state, tokens, lengths)
        metrics.append({k: float(v) for k, v in m.items()})
    return init, at3, metrics, _jax_flat(jax.device_get(state))


def _check_metrics(got: list, want: list, rtol: float = 1e-5):
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        for k in ("loss", "grad_norm", "aux_loss"):
            np.testing.assert_allclose(float(g[k]), w[k], rtol=rtol,
                                       atol=1e-7, err_msg=k)


def _check_state(got: dict, want: dict, outliers: int = 0):
    """Every leaf within 2e-4; with ``outliers``, that many params
    elements may part by up to 5e-4 (Adam's near-zero gradients)."""
    over = 0
    for name, w in want.items():
        d = np.abs(got[name].astype(np.float32) - w)
        assert d.max() < (5e-4 if name.startswith("params/") and outliers
                          else 2e-4), (name, float(d.max()))
        over += int((d > 2e-4).sum())
    assert over <= outliers, over


@pytest.mark.parametrize("case", list(CASES))
def test_five_steps_on_ranks_equal_jax_s_one_device_and_mesh_steps(
        case, ranks):
    row = case.rpartition(":")[2]
    name, b = CASES[case]
    init, _, want, final = _jax_run(name, "", b)
    _, _, want_mesh, final_mesh = _jax_run(name, row, b)
    cfg = LLAMA_CONFIGS[name]
    state = ppar.train_state_from_jax(init, cfg=cfg, ranks=ranks(row),
                                      device="cpu")
    step = ppar.make_train_step(cfg, _optimizer(ppar), device="cpu")
    tokens, lengths = _batch(b)
    got = []
    try:
        for _ in range(STEPS):
            state, m = step(state, tokens, lengths)
            got.append(m)
        whole = ppar.gather_train_state(state)
    finally:
        state.close()
    assert got[0]["grad_norm"] > 1.0   # the clip ran
    if cfg.n_experts:
        assert 1.0 <= float(got[0]["aux_loss"]) <= cfg.n_experts
    _check_metrics(got, want)
    _check_metrics(got, want_mesh)
    _check_state(whole, final, outliers=2)
    _check_state(whole, final_mesh)
    assert int(whole["step"]) == STEPS == int(whole["opt_state/count"])


@pytest.mark.parametrize("row", ["dp=2", "fsdp=2", "tp=2",
                                 "dp=2,fsdp=2,tp=2", "tp=4,dp=2"])
def test_each_rank_holds_its_block_of_the_one_device_init(row, ranks):
    cfg = LLAMA_CONFIGS["tiny"]
    group = ranks(row)
    plan = group.plan
    opt = _optimizer(ppar)
    state = ppar.init_train_state(cfg, 0, opt, ranks=group, device="cpu")
    try:
        report = group.report(state)
        whole = ppar.gather_train_state(state)
    finally:
        state.close()
    one = ppar.gather_train_state(ppar.init_train_state(cfg, 0, opt,
                                                        device="cpu"))
    assert whole.keys() == one.keys()
    for name, a in one.items():
        assert np.array_equal(whole[name], a), name
    shapes = ptrain._param_shapes(cfg)
    specs = ppar.state_shardings(state, plan)["params"]
    split = plan.fsdp * plan.tp
    above = {ax for ax in ("fsdp", "tp") if getattr(plan, ax) > 1}
    assert len(report) == plan.n_ranks
    for r, rep in enumerate(report):
        assert rep["params_bytes"] == rep["mu_bytes"] == rep["nu_bytes"]
        for path, n in rep["numel"].items():
            lay = ptrain.leaf_layout(path, shapes[path], cfg, plan,
                                     plan.coords(r))
            assert n == math.prod(hi - lo for lo, hi in lay.block), path
            whole_n = math.prod(shapes[path])
            if above <= ppar.sharding.spec_axes(specs[path], plan):
                assert n * split == whole_n, (r, path)
            if path.endswith("norm"):
                assert n == whole_n, (r, path)
    # every leaf both axes divide is cut in fsdp·tp
    assert report[0]["numel"]["layers/wq"] * split == math.prod(
        shapes["layers/wq"])


@pytest.mark.parametrize("row", ["dp=2,fsdp=2,tp=2", "tp=4,dp=2",
                                 "fsdp=4,tp=2", "dp=8"])
def test_each_rank_s_blocks_and_rows_are_jax_s_device_slices(row):
    """The layout rules (``spec_for``, ``fit_spec``, ``param_specs``,
    ``shard_block``, ``batch_spec`` through ``_rank_rows``) against
    JAX's: for every leaf of tiny and tiny-moe, the fitted spec equals
    JAX's and rank r's block is the slice JAX's ``NamedSharding`` puts
    on device r of its mesh; rank r's rows of a batch of 8 are the rows
    JAX's batch sharding gives device r."""
    from jax.sharding import NamedSharding

    plan = ppar.training_plan(row)
    axes = {k: int(v) for k, v in (a.split("=") for a in row.split(","))}
    mesh = jpar.make_mesh(devices=jax.devices()[:plan.n_ranks], **axes)
    devices = list(mesh.devices.flat)
    for name in ("tiny", "tiny-moe"):
        jparams = jax.eval_shape(lambda k: jllama.init(JAX_CONFIGS[name], k),
                                 jax.random.PRNGKey(0))
        jspecs = jpar.param_specs(jparams)
        ports = ppar.param_specs(jax.tree.map(
            lambda a: np.zeros((1,) * a.ndim), jparams))
        flat = {p: a.shape for p, a in ptrain._np_leaves(jparams).items()}
        want_specs = ptrain._np_leaves(jspecs)
        port_specs = ptrain._np_leaves(ports)
        for path, shape in flat.items():
            jfit = jpar.fit_spec(want_specs[path], shape, mesh)
            fit = ppar.fit_spec(port_specs[path], shape, plan)
            assert tuple(jfit) == fit, (name, path)
            where = NamedSharding(mesh, jfit).devices_indices_map(shape)
            for r, dev in enumerate(devices):
                got = ppar.shard_block(fit, shape, plan, plan.coords(r))
                want = tuple((sl.start or 0, shape[i] if sl.stop is None
                              else sl.stop)
                             for i, sl in enumerate(where[dev]))
                assert got == want, (name, path, r)
    tokens = np.arange(8 * 4).reshape(8, 4)
    where = NamedSharding(mesh, jpar.fit_spec(
        jpar.batch_spec(), tokens.shape, mesh)).devices_indices_map(
            tokens.shape)
    assert ppar.batch_spec() == tuple(jpar.batch_spec())
    for r, dev in enumerate(devices):
        rows, _, _ = ptrain._rank_rows(tokens, tokens[:, 0], plan,
                                       plan.coords(r))
        assert np.array_equal(rows, tokens[where[dev]]), r


def test_a_block_of_a_saved_leaf_reads_as_its_slice(tmp_path):
    """``_read_block`` (how a rank reads its blocks, and one device a
    whole leaf) against numpy slicing, bf16 leaves among them: every
    box of the layouts of tp=4,dp=2 and dp=2,fsdp=2,tp=2 on tiny, and
    each leaf whole."""
    cfg = LLAMA_CONFIGS["tiny"].with_(dtype="bfloat16")
    state = ppar.init_train_state(cfg, 0, _optimizer(ppar), device="cpu")
    path = str(tmp_path / "state.npz")
    ppar.save_train_state(path, state)
    whole = ppar.gather_train_state(state)
    members = ptrain._npz_members(path)
    shapes = ptrain._param_shapes(cfg)
    for row in ("tp=4,dp=2", "dp=2,fsdp=2,tp=2"):
        plan = ppar.training_plan(row)
        for r in range(plan.n_ranks):
            for p, shape in shapes.items():
                lay = ptrain.leaf_layout(p, shape, cfg, plan, plan.coords(r))
                for boxed in (lay.block, tuple((0, n) for n in shape)):
                    got = ptrain._read_block(path, members[f"params/{p}"],
                                             boxed)
                    want = whole[f"params/{p}"][tuple(
                        slice(lo, hi) for lo, hi in boxed)]
                    assert got.dtype == want.dtype and np.array_equal(
                        got.view(np.uint16), want.view(np.uint16)), \
                        (row, r, p)
                    assert got.flags.c_contiguous and got.flags.writeable


def _names_and_dtypes(path):
    with np.load(path) as f:
        return sorted((k, f[k].dtype.str, f[k].shape) for k in f.files)


def test_a_checkpoint_restores_bit_equal_on_another_plan_and_one_device(
        tmp_path, ranks):
    cfg = LLAMA_CONFIGS["tiny"]
    opt = _optimizer(ppar)
    tokens, lengths = _batch(8)
    step = ppar.make_train_step(cfg, opt, device="cpu")
    state = ppar.init_train_state(cfg, 0, opt,
                                  ranks=ranks("dp=2,fsdp=2,tp=2"),
                                  device="cpu")
    try:
        for _ in range(2):
            state, _ = step(state, tokens, lengths)
        path = str(tmp_path / "mesh.npz")
        ppar.save_train_state(path, state)
        saved = ppar.gather_train_state(state)
    finally:
        state.close()
    # the one-device layout, unchanged
    one = ppar.init_train_state(cfg, 0, opt, device="cpu")
    for _ in range(2):
        one, _ = step(one, tokens, lengths)
    ppar.save_train_state(str(tmp_path / "one.npz"), one)
    assert _names_and_dtypes(path) == _names_and_dtypes(
        str(tmp_path / "one.npz"))
    with np.load(path) as f:
        assert {k: f[k] for k in f.files}.keys() == saved.keys()
        for k in f.files:
            assert np.array_equal(f[k], saved[k]), k
    back = ppar.restore_train_state(path, cfg, opt, ranks=ranks("tp=4,dp=2"),
                                    device="cpu")
    try:
        assert back.step == 2 and back.opt_state.count == 2
        moved = ppar.gather_train_state(back)
    finally:
        back.close()
    local = ppar.gather_train_state(ppar.restore_train_state(
        path, cfg, opt, device="cpu"))
    for got in (moved, local):
        assert got.keys() == saved.keys()
        for k, a in saved.items():
            assert np.array_equal(got[k], a), k
    # and a one-device checkpoint onto the ranks
    onto = ppar.restore_train_state(str(tmp_path / "one.npz"), cfg, opt,
                                    ranks=ranks("dp=2,fsdp=2,tp=2"),
                                    device="cpu")
    try:
        got = ppar.gather_train_state(onto)
    finally:
        onto.close()
    for k, a in ppar.gather_train_state(one).items():
        assert np.array_equal(got[k], a), k
    deeper = cfg.with_(name="tiny-3", n_layers=3)
    with pytest.raises(ValueError, match="not tiny-3's"):
        ppar.restore_train_state(path, deeper, opt, ranks=ranks("tp=4,dp=2"),
                                 device="cpu")


def test_a_jax_mesh_state_carried_across_continues_step_for_step(ranks):
    """JAX's dp=2,fsdp=2,tp=2 state after 3 steps onto the port's ranks
    of the same plan: 2 more steps end where JAX's 5 do."""
    row = "dp=2,fsdp=2,tp=2"
    _, at3, want, final = _jax_run("tiny", row, 8)
    cfg = LLAMA_CONFIGS["tiny"]
    state = ppar.train_state_from_jax(at3, cfg=cfg, ranks=ranks(row),
                                      device="cpu")
    step = ppar.make_train_step(cfg, _optimizer(ppar), device="cpu")
    tokens, lengths = _batch(8)
    got = []
    try:
        assert state.step == 3 and state.opt_state.count == 3
        for _ in range(2):
            state, m = step(state, tokens, lengths)
            got.append(m)
        whole = ppar.gather_train_state(state)
    finally:
        state.close()
    _check_metrics(got, want[3:])
    _check_state(whole, final)


def _run_command(app, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = app.run_command(list(argv))
    return rc, out.getvalue()


def test_the_example_s_train_on_ranks_and_resume_on_another_plan(tmp_path):
    """examples/tpu-finetune's run of tests/test_examples.py through
    ``finetune_routes``: ``train -steps=3`` at dp=2,fsdp=2,tp=2, then
    ``resume -steps=2`` at tp=4,dp=2 from its checkpoint: trained to
    steps 3 and 5, the resumed loss below the first run's, and both
    printed losses within 1e-4 of the same commands on one device."""
    app = gofr_tpu_torch.new_cmd(MapConfig({"LOG_LEVEL": "ERROR"}))
    chip_smoke.finetune_routes(app, "cpu")
    common = ["-model=tiny", "-batch=4", "-seq=32"]
    got = {}
    for side, rows in (("ranks", ("dp=2,fsdp=2,tp=2", "tp=4,dp=2")),
                       ("one", ("", ""))):
        out = str(tmp_path / f"{side}.npz")
        lines = []
        for argv, row in ((["train", "-steps=3"], rows[0]),
                          (["resume", "-steps=2"], rows[1])):
            rc, text = _run_command(app, argv + common + [
                f"-out={out}", f"-sharding={row}"])
            assert rc == 0, (side, text)
            m = re.search(r"trained to step (\d+) loss ([\d.]+)", text)
            lines.append((int(m.group(1)), float(m.group(2))))
        got[side] = lines
    assert [s for s, _ in got["ranks"]] == [3, 5] == \
        [s for s, _ in got["one"]]
    for (_, a), (_, b) in zip(got["ranks"], got["one"]):
        assert abs(a - b) <= 1e-4, got
    assert got["ranks"][1][1] < got["ranks"][0][1] - 1e-4
