"""The port stands alone: nothing under gofr_tpu_torch/, and not
chip_smoke.py, imports JAX or the JAX package; its entry points run on
the card unless the caller asks for the CPU, and raise rather than fall
back when there is no card; importing it builds nothing; and every C
launcher it binds with ctypes, and every one-time set-up it calls at
load, exists in its source with the argument count the binding
declares.
"""

import ast
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "gofr_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "gofr_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    # the port's own copies of the JAX package's JAX-free modules
    for own in ("chaos.py", "wire.py", "config.py", "resilience.py",
                "errors.py", "app.py", "container.py", "context.py",
                "glog.py", "metrics.py", "tracing.py", "serving.py",
                "static.py", "http/server.py", "http/middleware.py",
                "observe/registry.py", "tpu/kvcache/radix.py",
                "tpu/batcher.py", "grpcx/__init__.py", "grpcx/_hufftable.py",
                "grpcx/hpack.py", "grpcx/http2.py", "grpcx/service.py",
                "grpcx/server.py", "grpcx/client.py", "subscriber.py",
                "datasource/__init__.py", "datasource/pubsub/__init__.py",
                "datasource/pubsub/mem.py", "datasource/pubsub/kafka.py",
                "datasource/pubsub/google.py", "datasource/pubsub/mqtt.py",
                "datasource/redisclient.py", "tenancy/__init__.py",
                "tenancy/registry.py", "tenancy/fair.py", "tenancy/lane.py",
                "service/__init__.py", "service/wrap.py", "service/client.py",
                "service/auth.py", "service/circuit_breaker.py",
                "service/health.py", "service/reconnect.py",
                "service/retry.py", "gateway/__init__.py",
                "gateway/table.py", "gateway/router.py",
                "gateway/relay.py", "pd/__init__.py", "pd/protocol.py",
                "pd/ingest.py", "pd/prefill.py", "version.py",
                "remote_level.py", "datasource/sql.py", "migration.py",
                "cli.py", "observe/__init__.py", "observe/recorder.py",
                "observe/timeline.py", "observe/clock.py",
                "observe/fleet.py", "observe/profiler.py",
                "observe/debug.py"):
        assert PORT / own in files
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p)
                                            & set(FORBIDDEN))
           for p in files}
    assert not {p: r for p, r in bad.items() if r}
    # and the scan would see one if it were there
    assert "gofr_tpu" in _imported_roots(
        ROOT / "tests" / "test_torch_llama.py")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _entry_points():
    from gofr_tpu_torch import App, new_cmd, resolve_device
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.models import (BERT_CONFIGS, LLAMA_CONFIGS,
                                       VIT_CONFIGS, bert, llama, vit)
    from gofr_tpu_torch.tpu import (GenerationEngine, TorchEngine,
                                    from_jax_params, new_engine_from_config)

    tiny = LLAMA_CONFIGS["tiny"]
    rows = {"TPU_MODEL": "tiny", "HTTP_PORT": "0", "METRICS_PORT": "0"}
    return {
        "TorchEngine": lambda: TorchEngine(),
        "bert.init": lambda: bert.init(BERT_CONFIGS["tiny"], 0),
        "vit.init": lambda: vit.init(VIT_CONFIGS["tiny"], 0),
        "new_engine_from_config[bert]": lambda: new_engine_from_config(
            MapConfig({"TPU_MODEL": "bert-tiny"})),
        "new_engine_from_config[vit]": lambda: new_engine_from_config(
            MapConfig({"TPU_MODEL": "vit-tiny"})),
        "App": lambda: App(MapConfig(rows)),
        "new_cmd": lambda: new_cmd(MapConfig(dict(rows, DB_DIALECT="sqlite"))),
        "Container": lambda: Container(MapConfig(rows)),
        "resolve_device": lambda: resolve_device(),
        "llama.init": lambda: llama.init(tiny, 0),
        "llama.init_cache": lambda: llama.init_cache(tiny, 2, 16),
        "from_jax_params": lambda: from_jax_params({}),
        "GenerationEngine": lambda: GenerationEngine(
            tiny, llama.init(tiny, 0, device="cpu"), slots=2, max_seq=16),
        "new_engine_from_config": lambda: new_engine_from_config(
            MapConfig({"TPU_MODEL": "tiny"})),
    }


ENTRY_POINTS = ["App", "Container", "GenerationEngine", "TorchEngine",
                "bert.init", "from_jax_params", "llama.init",
                "llama.init_cache", "new_cmd", "new_engine_from_config",
                "new_engine_from_config[bert]",
                "new_engine_from_config[vit]", "resolve_device", "vit.init"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_without_a_device_raise_when_there_is_no_card(
        no_card, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_the_cpu_is_used_only_when_asked_for(no_card):
    from gofr_tpu_torch import resolve_device
    from gofr_tpu_torch.models import LLAMA_CONFIGS, llama

    assert sorted(_entry_points()) == ENTRY_POINTS
    assert resolve_device("cpu") == torch.device("cpu")
    cache = llama.init_cache(LLAMA_CONFIGS["tiny"], 2, 16, device="cpu")
    assert cache.k.device.type == "cpu"


def test_an_app_without_a_model_serves_where_there_is_no_card(no_card):
    """An App with no TPU_* rows touches no device: it builds and serves
    its routes, health and metrics on a machine without a card."""
    import json
    import urllib.request

    from gofr_tpu_torch import App
    from gofr_tpu_torch.config import MapConfig

    app = App(MapConfig({"HTTP_PORT": "0", "METRICS_PORT": "0",
                         "LOG_LEVEL": "ERROR"}))
    app.get("/ping", lambda ctx: "pong")
    assert app.container.tpu is None
    with app:
        base = f"http://127.0.0.1:{app.http_port}"
        with urllib.request.urlopen(base + "/ping", timeout=5) as r:
            assert json.loads(r.read()) == {"data": "pong"}
        with urllib.request.urlopen(base + "/.well-known/health",
                                    timeout=5) as r:
            health = json.loads(r.read())["data"]
        assert health["status"] == "UP" and "tpu" not in health
        with urllib.request.urlopen(
                f"http://127.0.0.1:{app.metrics_port}/metrics",
                timeout=5) as r:
            assert b"app_http_response" in r.read()


def test_importing_the_port_builds_nothing():
    from gofr_tpu_torch.ops import kernels

    assert kernels._libs == {} and kernels._fns == {}


def _c_launchers(source: str) -> dict[str, int]:
    """Exported launcher name -> parameter count, read from the source."""
    text = (PORT / "ops" / "csrc" / source).read_text()
    found = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
        found[m.group(1)] = len([p for p in m.group(2).split(",")
                                 if p.strip()])
    return found


def test_every_ctypes_binding_matches_its_c_launcher():
    from gofr_tpu_torch.ops import kernels

    for name, (source, argtypes) in kernels.SIGNATURES.items():
        assert (PORT / "ops" / "csrc" / source).exists(), source
        launchers = _c_launchers(source)
        assert name in launchers, (name, source)
        assert launchers[name] == len(argtypes), name


def test_every_one_time_setup_exists_in_its_source():
    """A source's set-up entry point (run once at load, never at a
    launch a CUDA graph may capture) takes no arguments."""
    from gofr_tpu_torch.ops import kernels

    assert kernels.INITS
    for source, name in kernels.INITS.items():
        assert _c_launchers(source).get(name) == 0, (source, name)
    # the launchers themselves set no attribute at a launch
    text = (PORT / "ops" / "csrc" / "flash_prefill.cu").read_text()
    launcher = text[text.index("int gofr_flash_prefill_bf16"):]
    assert "cudaFuncSetAttribute" not in launcher


def _functions(text: str) -> dict[str, tuple[int, int]]:
    """C++ function definitions at the start of a line: name -> the span
    of its body, braces matched."""
    spans = {}
    for m in re.finditer(r'^[\w:<>, *&"]*?\b(\w+)\(([^;{}]*)\)\s*\{', text,
                         re.MULTILINE):
        depth, i = 0, m.end() - 1
        for i in range(m.end() - 1, len(text)):
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            if depth == 0:
                break
        spans[m.group(1)] = (m.end(), i)
    return spans


def test_no_launch_path_sets_a_function_attribute():
    """Every ``cudaFuncSetAttribute`` in ops/csrc sits in a function that
    only a one-time set-up (``kernels.INITS``) reaches: no launcher
    calls one, however indirectly, so every launch can sit inside a
    captured CUDA graph."""
    from gofr_tpu_torch.ops import kernels

    inits = set(kernels.INITS.values())
    for src in sorted((PORT / "ops" / "csrc").glob("*.cu*")):
        # comments out, so that only code is read
        text = re.sub(r"//[^\n]*|/\*.*?\*/", "", src.read_text(),
                      flags=re.DOTALL)
        bodies = {n: text[a:b] for n, (a, b) in _functions(text).items()}
        assert text.count("cudaFuncSetAttribute") == sum(
            b.count("cudaFuncSetAttribute") for b in bodies.values())
        # the functions that set an attribute, and every one that calls
        # one of those, transitively
        reach = {n for n, b in bodies.items() if "cudaFuncSetAttribute" in b}
        grew = True
        while grew:
            callers = {n for n, b in bodies.items() if n not in reach and any(
                re.search(rf"\b{r}\s*[<(]", b) for r in reach)}
            reach |= callers
            grew = bool(callers)
        launchers = {n for n, (source, _) in kernels.SIGNATURES.items()
                     if source == src.name}
        assert not launchers & reach, (src.name, launchers & reach)
        assert not reach or reach & inits, src.name


def test_every_kernel_source_names_the_tpu_kernel_it_replaces():
    for cu in sorted((PORT / "ops" / "csrc").glob("*.cu")):
        text = cu.read_text()
        assert "Replaces the TPU kernel gofr_tpu/ops/" in text, cu.name
        assert "What bounds it on an H100" in text, cu.name


def _fake_nvcc(tmp_path, status: int):
    """A stand-in compiler that writes its -o file and exits ``status``."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'while [ $# -gt 0 ]; do [ "$1" = -o ] && echo lib > "$2"; shift; '
        "done\n"
        f"echo 'ptxas info    : Used 8 registers'\nexit {status}\n")
    nvcc.chmod(0o755)
    return str(nvcc)


def test_build_all_compiles_each_source_once_into_the_build_dir(
        tmp_path, monkeypatch):
    from gofr_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    nvcc = _fake_nvcc(tmp_path, 0)  # written once: builds run it at once
    monkeypatch.setattr(kernels, "nvcc_path", lambda: nvcc)
    logs = kernels.build_all()
    sources = {src for src, _ in kernels.SIGNATURES.values()}
    assert set(logs) == sources
    assert all("registers" in log for log in logs.values())
    built = sorted(p.name for p in (tmp_path / "_build").glob("*.so"))
    assert len(built) == len(sources)
    # a built library is reused as it is
    assert set(kernels.build_all().values()) == {""}


def test_a_failed_build_raises_and_leaves_no_library(tmp_path, monkeypatch):
    from gofr_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    nvcc = _fake_nvcc(tmp_path, 1)
    monkeypatch.setattr(kernels, "nvcc_path", lambda: nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build_all()
    assert not list((tmp_path / "_build").glob("*.so"))
