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

from .version import FRAMEWORK, __version__
from .errors import (BadRequest, DeadlineExceeded, EntityNotFound, Forbidden,
                     GofrError, HTTPError, InternalServerError, NotFound,
                     ServiceUnavailable, TooManyRequests, Unauthorized)
from .config import Config, EnvConfig, MapConfig
from .glog import Logger, LogLevel, new_logger
from .context import Context
from .container import Container
from .app import App, new_app, new_cmd
from .resilience import (AdmissionGate, Deadline, current_deadline,
                         deadline_scope)
from .device import resolve_device
from .serving import install_embeddings, install_generate

__all__ = ["__version__", "FRAMEWORK", "App", "new_app", "new_cmd",
           "Context", "Container", "Config", "EnvConfig", "MapConfig",
           "Logger", "LogLevel", "new_logger", "GofrError", "HTTPError",
           "BadRequest", "Unauthorized", "Forbidden", "NotFound",
           "EntityNotFound", "InternalServerError", "ServiceUnavailable",
           "TooManyRequests", "DeadlineExceeded", "AdmissionGate",
           "Deadline", "current_deadline", "deadline_scope",
           # the port's own entry points beside gofr_tpu's
           "install_embeddings", "install_generate", "resolve_device"]
