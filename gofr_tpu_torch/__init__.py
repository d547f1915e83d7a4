"""gofr_tpu_torch: the PyTorch/CUDA port of gofr_tpu's serving path.

The package mirrors gofr_tpu's layout (``app.py``, ``http/``, ``ops/``,
``models/``, ``tpu/``) so each module has an obvious counterpart, and
imports nothing of gofr_tpu or JAX: where it needs a framework piece
(the App and its HTTP transport, the config reader, the push stream,
error types) it keeps its own copy. A service moves to the port by
changing one import::

    from gofr_tpu_torch import App       # or new_cmd, for a CLI

Entry points take an explicit ``device``, ``"cuda"`` by default; with
no card they raise instead of falling back to the CPU. The CPU runs
only when the caller asks for it, as the tests do.
"""

from .app import App, new_app, new_cmd
from .device import resolve_device
from .serving import install_embeddings, install_generate
from .version import FRAMEWORK, __version__

__all__ = ["App", "FRAMEWORK", "__version__", "install_embeddings",
           "install_generate", "new_app", "new_cmd", "resolve_device"]
