"""gofr_tpu_torch: the PyTorch/CUDA port of gofr_tpu's serving path.

The package mirrors gofr_tpu's layout (``ops/``, ``models/``, ``tpu/``)
so each module has an obvious counterpart, and imports nothing of
gofr_tpu or JAX: where it needs a framework piece (the config reader,
the push stream, error types) it keeps its own copy.

Entry points take an explicit ``device``, ``"cuda"`` by default; with
no card they raise instead of falling back to the CPU. The CPU runs
only when the caller asks for it, as the tests do.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
