"""The CLI App of both packages (``gofr_tpu.new_cmd`` and the port's
``gofr_tpu_torch.new_cmd``): ``parse_args`` splits the same argv lists
alike; ``run_command`` gives the same exit codes, stdout and stderr for a
greeting, flags, an unknown command (``No Command Found!`` and the help),
a raising handler, regex named groups and ``bind`` into a dataclass;
``CMD_LOGS_FILE`` sends the logs to its file and leaves stdout to the
commands.

The slice as a whole: a CMD App of each package on ``tiny`` (the JAX
weights written once to a ``.npz`` that both read through
``TPU_WEIGHTS``; the port on ``device="cpu"``, the JAX engine running
its kernels as its own tests run them) with a sqlite file runs the same
migrations (a table, the model ledger, one that fails and rolls back)
and a ``generate`` sub-command for prompts of bucket and lattice length:
the greedy tokens on stdout, the SQL rows and the ledgers are identical.
Then the port's CLI runs as a process of its own, which exits 0 by
itself with the engine's threads still live.

Every test runs under its own time limit (``_LIMIT_S``); every
subprocess has a timeout.
"""

import contextlib
import dataclasses
import io
import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu import cli as jcli
from gofr_tpu import migration as jmig
from gofr_tpu import version as jversion
from gofr_tpu.config import MapConfig as JMapConfig
from gofr_tpu.models import LLAMA_CONFIGS as JAX_CONFIGS
from gofr_tpu.models import llama as jllama
from gofr_tpu.tpu.checkpoint import save_npz
from gofr_tpu_torch import cli as pcli
from gofr_tpu_torch import migration as pmig
from gofr_tpu_torch.config import MapConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (gofr_tpu.new_cmd, JMapConfig, jcli, jmig, {}),
            "port": (gofr_tpu_torch.new_cmd, MapConfig, pcli, pmig,
                     {"device": "cpu"})}
JCFG = JAX_CONFIGS["tiny"]
ROWS = {"TPU_MODEL": "tiny", "TPU_SLOTS": "2", "TPU_MAX_SEQ": "128",
        "TPU_SEQ_BUCKETS": "16,32", "DB_DIALECT": "sqlite",
        "LOG_LEVEL": "INFO"}
# prompt lengths: two buckets, a full bucket and one past the largest
# bucket (the chunk lattice)
LENS = (5, 20, 32, 60)
NEW = 12
_LIMIT_S = 300
_SUBPROCESS_S = 180

ARGVS = [
    ["do", "thing", "-a=1", "--b", "2", "-c"],
    ["hello", "-name", "Ada"],
    ["-k=v=w", "--flag"],
    ["x", "--", "y"],
    ["-a", "-b", "c", "tail"],
    ["pos1", "-x=", "pos2"],
    [],
    ["--n=-1", "-m", "-1"],
    ["generate", "-prompt", "1,2,3", "-max", "8", "-seed", "0"],
]


@pytest.fixture(autouse=True)
def _time_limit():
    """Fail a test that runs past _LIMIT_S (a hang shows as a failure,
    not a stuck run)."""
    def expire(*_):
        raise TimeoutError(f"CLI test ran past {_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, _LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.mark.parametrize("argv", ARGVS, ids=[str(i) for i in range(len(ARGVS))])
def test_parse_args_splits_argv_alike(argv):
    assert pcli.parse_args(list(argv)) == jcli.parse_args(list(argv))


def test_parse_args_reads_each_flag_form():
    assert pcli.parse_args(ARGVS[0]) == (["do", "thing"],
                                         {"a": "1", "b": "2", "c": "true"})


@dataclasses.dataclass
class Opts:
    name: str = ""
    count: int = 0
    loud: bool = False


def _cli_routes(app) -> None:
    @app.sub_command("hello", description="greet by -name")
    def hello(ctx):
        return f"Hello {ctx.param('name', 'World')}!"

    @app.sub_command("params", description="echo parsed flags")
    def params(ctx):
        return {"name": ctx.param("name"), "id": ctx.param("id")}

    @app.sub_command("fail")
    def fail(ctx):
        raise ValueError(f"bad input: {ctx.param('x', 'none')}")

    def show(ctx):
        return {"uid": ctx.path_param("uid"), "verbose": ctx.param("v"),
                "header": ctx.header("X-Any", "dflt")}

    app.sub_command(r"user (?P<uid>\d+) show", show, "show a user")

    @app.sub_command("bind")
    def bind(ctx):
        return dataclasses.asdict(ctx.bind(Opts))

    @app.sub_command("flags")
    def flags(ctx):
        return ctx.bind()

    @app.sub_command("none")
    def none(ctx):
        return None

    @app.sub_command("list")
    def listing(ctx):
        return [1, "two", {"three": None}]


CLI_CASES = [
    ["hello", "-name=gofr"],
    ["hello"],
    ["params", "--name", "x", "-id=7"],
    ["unknown"],
    ["hello", "extra"],
    [],
    ["fail", "-x", "7"],
    ["user", "42", "show", "-v"],
    ["user", "ab", "show"],
    ["bind", "-name", "n", "-count=3", "-loud"],
    ["bind", "-loud=no"],
    ["flags", "-a", "1", "--b"],
    ["none"],
    ["list"],
]


def _run(app, argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = app.run_command(argv)
    return rc, out.getvalue(), err.getvalue()


def _cli_app(pk, rows=None):
    new_cmd, cfg, _, _, kw = PACKAGES[pk]
    return new_cmd(cfg(dict({"LOG_LEVEL": "ERROR"}, **(rows or {}))), **kw)


@pytest.mark.parametrize("argv", CLI_CASES,
                         ids=[str(i) for i in range(len(CLI_CASES))])
def test_run_command_answers_alike(argv):
    got = {}
    for pk in PACKAGES:
        app = _cli_app(pk)
        try:
            _cli_routes(app)
            got[pk] = _run(app, list(argv))
        finally:
            app.stop()
    assert got["port"] == got["jax"]


def test_the_exit_codes_and_the_stdout_stderr_split():
    app = _cli_app("port")
    try:
        _cli_routes(app)
        assert _run(app, ["hello", "-name=gofr"]) == (0, "Hello gofr!\n", "")
        rc, out, err = _run(app, ["unknown"])
        assert (rc, out) == (1, "")
        assert err.startswith("No Command Found!\n")
        assert "show a user" in err and "greet by -name" in err
        assert _run(app, ["fail", "-x", "7"]) == (1, "", "bad input: 7\n")
        rc, out, _ = _run(app, ["user", "42", "show", "-v"])
        assert (rc, json.loads(out)) == (0, {"uid": "42", "verbose": "true",
                                             "header": "dflt"})
        rc, out, _ = _run(app, ["bind", "-name", "n", "-count=3", "-loud"])
        assert json.loads(out) == {"name": "n", "count": 3, "loud": True}
        assert _run(app, ["none"]) == (0, "", "")
    finally:
        app.stop()


def test_an_app_without_sub_commands_exits_1_silently():
    for pk in PACKAGES:
        app = _cli_app(pk)
        try:
            assert _run(app, ["anything"]) == (1, "", "")
        finally:
            app.stop()


def test_the_cmd_request_reads_alike():
    def reading(mod):
        r = mod.CmdRequest(["a"], {"k": "v", "n": "2"})
        r.path_params["p"] = "pp"
        return (r.param("k"), r.param("z", "d"), r.path_param("p"),
                r.path_param("k"), r.header("H", "h"), r.host_name(),
                r.bind())

    assert reading(pcli) == reading(jcli) == (
        "v", "d", "pp", "v", "h", "cli", {"k": "v", "n": "2"})


def test_the_version_constants():
    assert gofr_tpu_torch.__version__ == jversion.__version__
    assert gofr_tpu_torch.FRAMEWORK == "gofr_tpu_torch"
    assert jversion.FRAMEWORK == "gofr_tpu"


def test_cmd_logs_file_sends_the_logs_to_its_file(tmp_path):
    """The migration events and the level change go to the file, in
    JSON lines; stdout carries the command's output alone."""
    for pk in PACKAGES:
        log = tmp_path / f"{pk}.log"
        app = _cli_app(pk, {"CMD_LOGS_FILE": str(log), "LOG_LEVEL": "INFO",
                            "DB_DIALECT": "sqlite"})
        try:
            _cli_routes(app)
            mig = PACKAGES[pk][3]
            app.migrate({1: mig.Migrate(up=lambda ds: ds.sql.execute(
                "CREATE TABLE t (x INTEGER)"))})
            rc = _run(app, ["hello", "-name=file"])
            app.logger.warn({"event": "from a handler's logger"})
        finally:
            app.stop()
        assert rc == (0, "Hello file!\n", "")
        events = [json.loads(ln)["message"]
                  for ln in log.read_text().splitlines()]
        assert {"event": "migration applied", "version": 1,
                "duration_ms": events[-2]["duration_ms"]} in events, pk
        assert events[-1] == {"event": "from a handler's logger"}
        assert "Hello file!" not in log.read_text()


# -- the slice as a whole ------------------------------------------------------

@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "tiny.npz"
    save_npz(str(path), jax.tree.map(
        np.asarray, jllama.init(JCFG, jax.random.PRNGKey(3))))
    return str(path)


def _prompts():
    rng = np.random.default_rng(13)
    return [rng.integers(1, JCFG.vocab_size, n).tolist() for n in LENS]


def _generate_command(app) -> None:
    """The ``generate`` sub-command: ``-prompt`` token ids, ``-max`` new
    tokens, ``-seed``; a row in ``generations``; the stream as JSON."""
    @app.sub_command("generate", description="-prompt 1,2,3 -max N -seed S")
    def generate(ctx):
        prompt = [int(t) for t in ctx.param("prompt").split(",")]
        n = int(ctx.param("max", "16"))
        seed = int(ctx.param("seed", "0"))
        tokens = ctx.tpu.generate(prompt, max_new_tokens=n,
                                  seed=seed).tokens()
        ctx.sql.execute("INSERT INTO generations (prompt_len, max_new, "
                        "seed, tokens) VALUES (?, ?, ?, ?)", len(prompt), n,
                        seed, json.dumps(tokens))
        return {"prompt_len": len(prompt), "tokens": tokens}


def _migrations(mig, weights, seen: list) -> dict:
    def register(ds):
        ds.tpu.register_model("tiny", weights_path=weights, revision="seed3")
        seen.extend(ds.tpu.registered)

    return {1: mig.Migrate(up=lambda ds: ds.sql.execute(
                "CREATE TABLE generations (id INTEGER PRIMARY KEY, "
                "prompt_len INTEGER, max_new INTEGER, seed INTEGER, "
                "tokens TEXT)")),
            2: mig.Migrate(up=register)}


def _slice_run(pk, tmp_path, weights) -> dict:
    new_cmd, cfg, _, mig, kw = PACKAGES[pk]
    rows = dict(ROWS, TPU_WEIGHTS=weights,
                DB_NAME=str(tmp_path / f"{pk}.db"),
                CMD_LOGS_FILE=str(tmp_path / f"{pk}.log"))
    app = new_cmd(cfg(rows), **kw)
    seen: list = []
    try:
        app.migrate(_migrations(mig, weights, seen))
        app.migrate(_migrations(mig, weights, seen))   # applies nothing

        def doomed(ds):
            ds.sql.execute("CREATE TABLE doomed (x INTEGER)")
            raise RuntimeError("no")

        with pytest.raises(mig.MigrationError):
            app.migrate({3: doomed})
        _generate_command(app)
        runs = [_run(app, ["generate", "-prompt", ",".join(map(str, p)),
                           "-max", str(NEW), "-seed", "0"])
                for p in _prompts()]
        sql = app.container.sql
        out = {"runs": runs, "seen": seen,
               "ledger": [(r["version"], r["method"]) for r in sql.query(
                   "SELECT version, method FROM gofr_migrations "
                   "ORDER BY version")],
               "rows": sql.query("SELECT prompt_len, max_new, seed, tokens "
                                 "FROM generations ORDER BY id"),
               "doomed": sql.query("SELECT name FROM sqlite_master "
                                   "WHERE name = 'doomed'")}
        if pk == "port":
            # the same prompts straight through the engine
            out["direct"] = [app.container.tpu.generate(
                p, max_new_tokens=NEW, seed=0).tokens() for p in _prompts()]
        return out
    finally:
        app.stop()


def test_a_generate_sub_command_streams_the_same_tokens_as_jax(
        tmp_path, weights_npz):
    got = {pk: _slice_run(pk, tmp_path, weights_npz) for pk in PACKAGES}
    port, jx = got["port"], got["jax"]
    assert [rc for rc, _, _ in port["runs"]] == [0] * len(LENS)
    assert [err for _, _, err in port["runs"]] == [""] * len(LENS)
    results = [json.loads(out) for _, out, _ in port["runs"]]
    assert [json.loads(out) for _, out, _ in jx["runs"]] == results
    assert [r["prompt_len"] for r in results] == list(LENS)
    assert all(len(r["tokens"]) == NEW for r in results)
    assert [r["tokens"] for r in results] == port.pop("direct")
    assert port == jx
    assert port["ledger"] == [(1, "UP"), (2, "UP")]
    assert port["doomed"] == []
    assert port["seen"] == [{"name": "tiny", "weights_path": weights_npz,
                             "revision": "seed3"}]
    assert [json.loads(r["tokens"]) for r in port["rows"]] == \
        [r["tokens"] for r in results]
    for pk in PACKAGES:
        # log lines only: the commands' output went to stdout
        events = [json.loads(ln) for ln in
                  (tmp_path / f"{pk}.log").read_text().splitlines()]
        assert all(set(e) >= {"level", "time", "message"} for e in events)
        names = [e["message"].get("event") for e in events
                 if isinstance(e["message"], dict)]
        assert names.count("migration applied") == 2, pk
        assert names.count("migration failed") == 1, pk


# the port's CLI as a process of its own: it builds its engine, runs one
# command and exits with the command's code while the engine's threads
# are still live
CLI_PROGRAM = """
import json, sys, threading
from gofr_tpu_torch import new_cmd
from gofr_tpu_torch.config import MapConfig

app = new_cmd(MapConfig(json.loads(sys.argv[1])), device="cpu")


@app.sub_command("generate")
def generate(ctx):
    prompt = [int(t) for t in ctx.param("prompt").split(",")]
    return {"tokens": ctx.tpu.generate(
        prompt, max_new_tokens=int(ctx.param("max")),
        seed=int(ctx.param("seed", "0"))).tokens()}


code = app.run_command(sys.argv[2:])
assert any(t.name == "gofr-torch-gen" and t.is_alive()
           for t in threading.enumerate())
raise SystemExit(code)
"""


def test_the_port_s_cli_process_exits_by_itself(tmp_path, weights_npz):
    rows = dict(ROWS, TPU_WEIGHTS=weights_npz,
                DB_NAME=str(tmp_path / "cli.db"),
                CMD_LOGS_FILE=str(tmp_path / "cli.log"))
    prompt = _prompts()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", CLI_PROGRAM, json.dumps(rows), "generate",
         "-prompt", ",".join(map(str, prompt)), "-max", str(NEW)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=_SUBPROCESS_S, stdin=subprocess.DEVNULL)
    assert proc.returncode == 0, proc.stderr[-2000:]
    tokens = json.loads(proc.stdout)["tokens"]
    app = gofr_tpu_torch.new_cmd(MapConfig(dict(ROWS,
                                                TPU_WEIGHTS=weights_npz)),
                                 device="cpu")
    try:
        assert tokens == app.container.tpu.generate(
            prompt, max_new_tokens=NEW, seed=0).tokens()
    finally:
        app.stop()
    assert '"torch engine ready"' in (tmp_path / "cli.log").read_text()
    bad = subprocess.run(
        [sys.executable, "-c", CLI_PROGRAM, json.dumps(rows), "nope"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=_SUBPROCESS_S, stdin=subprocess.DEVNULL)
    assert (bad.returncode, bad.stdout) == (1, "")
    assert bad.stderr.startswith("No Command Found!")


def test_an_engine_left_open_is_stopped_at_interpreter_exit():
    """A process may exit with its engine open (the CLI process above
    does): every engine with a serving loop is registered with the exit
    hook, which stops the loop and joins its thread before the
    interpreter's finalization could stop that daemon thread inside a
    CUDA call."""
    from gofr_tpu_torch.models import LLAMA_CONFIGS, llama
    from gofr_tpu_torch.tpu import generator

    cfg = LLAMA_CONFIGS["tiny"]
    eng = generator.GenerationEngine(cfg, llama.init(cfg, 0, device="cpu"),
                                     slots=2, max_seq=64,
                                     prompt_buckets=(16,), device="cpu")
    try:
        assert eng in generator._LOOPS and eng._thread.is_alive()
        assert len(eng.generate([1, 2, 3], max_new_tokens=4).tokens()) == 4
        eng._stop_loop(timeout=10.0)
        assert not eng._thread.is_alive()
    finally:
        eng.close()
