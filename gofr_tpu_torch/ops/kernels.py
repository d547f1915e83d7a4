"""Build and load the hand-written CUDA kernels in ``ops/csrc``.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its
own with ``nvcc`` for ``sm_90a`` into a shared library, loaded with
``ctypes``. Building happens at first use (or all at once through
``build_all``, which starts one ``nvcc`` per source in parallel) into
``ops/_build/``; a library's file name carries a hash of its source and
flags, so an edited source rebuilds and an unchanged one loads as built.
A source's one-time set-up (``INITS``) runs once, right after its
library is loaded. Nothing here runs when the module is imported.

``check_attention_shape`` holds what the attention kernels take of a
model (head_dim, activation dtype, query heads per KV head, the paged
block size, the verify window): every wrapper's input check and the
serving engine's construction-time check call it, so the two cannot
drift apart.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of every exported launcher: name -> (source, argtypes).
# Every launcher returns its cudaError_t as an int (0 = success).
SIGNATURES = {
    # q, k, v, lengths, out, B, S, H, KV, scale, stream
    "gofr_flash_prefill_bf16": (
        "flash_prefill.cu", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P]),
    # q, k_cache, v_cache, k_scale, v_scale, lengths, k_new, v_new, out,
    # work, B, Smax, H, KV, W, chunk, scale, stream
    "gofr_flash_decode_int8": (
        "flash_decode.cu",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
         _P]),
    "gofr_flash_decode_bf16": (
        "flash_decode.cu",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
         _P]),
    # q, k_pool, v_pool, k_scale, v_scale, table, lengths, k_new, v_new,
    # out, work, B, MB, T, N, H, KV, W, chunk, scale, stream
    "gofr_paged_decode_int8": (
        "paged_decode.cu",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         _I, _I, _F, _P]),
    "gofr_paged_decode_bf16": (
        "paged_decode.cu",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         _I, _I, _F, _P]),
    # q, k_pool, v_pool, k_scale, v_scale, table, lengths, k_new, v_new,
    # out, work, B, MB, T, N, Wn, H, KV, NB, chunk, scale, stream
    "gofr_paged_window_int8": (
        "paged_window.cu",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         _I, _I, _I, _F, _P]),
    "gofr_paged_window_bf16": (
        "paged_window.cu",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         _I, _I, _I, _F, _P]),
}

# one-time set-up entry points, run once right after a library is loaded
# (each returns its cudaError_t as an int): what may not run at a launch
# that sits inside a captured CUDA graph
INITS = {"flash_prefill.cu": "gofr_flash_prefill_init",
         "paged_window.cu": "gofr_paged_window_init"}

# What the attention kernels take (csrc/*.cu): head_dim 128, bf16
# activations; the decodes (K2, K3) and the verify window (K3w) G = H/KV
# in GROUP_SIZES, a pool block size that is a multiple of 8, and a verify
# window of 1 to MAX_WINDOW query positions (paged_window.cu's
# kMaxWindow)
HEAD_DIM = 128
GROUP_SIZES = (1, 2, 4, 8)
MAX_WINDOW = 16
KERNELS = ("flash_prefill", "flash_decode", "paged_decode", "paged_window")


def check_attention_shape(kernel: str, *, head_dim: int, n_heads: int,
                          n_kv_heads: int, dtype: torch.dtype,
                          block_size: int | None = None,
                          window: int = 1) -> None:
    """Raise if attention kernel ``kernel`` (one of ``KERNELS``) does not
    take a model with these shapes: TypeError for the activation dtype,
    ValueError for a shape. ``block_size``: the paged pool's T (paged
    kernels); ``window``: the verify window W (``paged_window``)."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown attention kernel {kernel!r}")
    if dtype != torch.bfloat16:
        raise TypeError(f"{kernel} kernel takes bf16 activations, got "
                        f"{dtype}")
    if head_dim != HEAD_DIM:
        raise ValueError(f"{kernel} kernel takes head_dim {HEAD_DIM}, got "
                         f"{head_dim}")
    if n_kv_heads <= 0 or n_heads % n_kv_heads:
        raise ValueError(f"{kernel} kernel: query heads {n_heads} not a "
                         f"multiple of KV heads {n_kv_heads}")
    if kernel == "flash_prefill":
        return
    if n_heads // n_kv_heads not in GROUP_SIZES:
        raise ValueError(f"{kernel} kernel takes H/KV in {GROUP_SIZES}, got "
                         f"H={n_heads} KV={n_kv_heads}")
    if kernel.startswith("paged") and (block_size is None or block_size <= 0
                                       or block_size % 8):
        raise ValueError(f"{kernel} kernel takes a block size that is a "
                         f"multiple of 8, got T={block_size}")
    if not 1 <= window <= (MAX_WINDOW if kernel == "paged_window" else 1):
        raise ValueError(f"{kernel} kernel takes a window of 1 to "
                         f"{MAX_WINDOW if kernel == 'paged_window' else 1} "
                         f"query positions, got W={window} (W*G = "
                         f"{window * (n_heads // n_kv_heads)} rows)")


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, object] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(source: str) -> Path:
    text = (CSRC / source).read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


class _Build:
    """One source's library: already built, or an ``nvcc`` run that
    writes a temporary file renamed into place when it succeeds (so a
    failed or cut build never leaves a library that looks built)."""

    def __init__(self, source: str):
        self.source = source
        self.out = _target(source)
        self.proc: subprocess.Popen | None = None
        if self.out.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.tmp = self.out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(self.tmp),
               str(CSRC / source)]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def wait(self) -> str:
        """Wait for ``nvcc`` and return its log ("" if already built);
        ``failed`` then holds the error, if any."""
        self.failed = ""
        if self.proc is None:
            return ""
        log, _ = self.proc.communicate()
        (BUILD_DIR / f"{self.out.stem}.log").write_text(log)
        if self.proc.returncode != 0:
            self.failed = (f"nvcc failed on {self.source} "
                           f"(exit {self.proc.returncode}):\n{log}")
        else:
            os.replace(self.tmp, self.out)
        return log


def _wait_all(builds: "list[_Build]") -> dict[str, str]:
    """Wait for every build, then raise if any failed."""
    logs = {b.source: b.wait() for b in builds}
    failed = [b.failed for b in builds if b.failed]
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def build_all() -> dict[str, str]:
    """Compile every source that is not built yet, one ``nvcc`` per
    source, all started together. Returns each source's compiler log
    (empty for a source that was already built)."""
    sources = sorted({src for src, _ in SIGNATURES.values()})
    with _lock:
        return _wait_all([_Build(src) for src in sources])


def _library(source: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build = _Build(source)
            _wait_all([build])
            lib = ctypes.CDLL(str(build.out))
            lib.gofr_error_string.argtypes = [_I]
            lib.gofr_error_string.restype = ctypes.c_char_p
            init = INITS.get(source)
            if init is not None:
                fn = getattr(lib, init)
                fn.argtypes = []
                fn.restype = _I
                err = fn()
                if err != 0:
                    raise RuntimeError(
                        f"{init} failed with CUDA error {err}: "
                        f"{lib.gofr_error_string(err).decode()}")
            _libs[source] = lib
        return lib


def function(name: str):
    """The ctypes function ``name`` with its argtypes set, building and
    loading its library at first use."""
    fn = _fns.get(name)
    if fn is None:
        source, argtypes = SIGNATURES[name]
        fn = getattr(_library(source), name)
        fn.argtypes = argtypes
        fn.restype = _I
        _fns[name] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if err != 0:
        lib = _library(SIGNATURES[name][0])
        text = lib.gofr_error_string(err).decode()
        raise RuntimeError(f"{name} failed with CUDA error {err}: {text}")
