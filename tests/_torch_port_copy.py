"""A JAX package test file run on the port: its source with every
``gofr_tpu`` import renamed to ``gofr_tpu_torch``, executed as a module
of its own, so its test functions and fixtures can be re-exported by a
``test_torch_*.py`` file (a fixture of the same name there overrides
one of the copy's)."""

from __future__ import annotations

import re
import types
from pathlib import Path


def port_copy(name: str, **patch) -> types.ModuleType:
    """tests/<name> with its imports of the JAX package renamed to the
    port's; ``patch`` replaces its globals after it ran."""
    path = Path(__file__).with_name(name)
    src = re.sub(r"\bgofr_tpu\b", "gofr_tpu_torch", path.read_text())
    mod = types.ModuleType(f"_port_{path.stem}")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    mod.__dict__.update(patch)
    return mod
