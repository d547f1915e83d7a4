"""The engine facade a handler reaches as ``ctx.tpu`` (counterpart of
gofr_tpu/tpu/engine.py, reduced to generation): ``generate``,
``health_check`` and ``close``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from .generator import GenerationEngine, GenStream

STATUS_UP = "UP"
STATUS_DOWN = "DOWN"


@dataclass
class Health:
    status: str
    details: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        """The health check's wire form, as the App's
        ``/.well-known/health`` reads every datasource's."""
        return {"status": self.status, "details": self.details}


class TorchEngine:
    def __init__(self, generator: GenerationEngine, model_name: str,
                 device: torch.device):
        self.generator = generator
        self.model_name = model_name
        self.device = device
        self._closed = False

    def generate(self, *args, **kw) -> GenStream:
        """Streaming token generation; see ``GenerationEngine.generate``."""
        return self.generator.generate(*args, **kw)

    def health_check(self) -> Health:
        details: dict[str, Any] = {"model": self.model_name,
                                   "device": str(self.device),
                                   "generator": self.generator.stats()}
        if self.device.type == "cuda":
            details["device_kind"] = torch.cuda.get_device_name(self.device)
            details["memory_allocated"] = torch.cuda.memory_allocated(
                self.device)
        down = self._closed or self.generator.down is not None
        return Health(STATUS_DOWN if down else STATUS_UP, details)

    def close(self) -> None:
        self._closed = True
        self.generator.close()
