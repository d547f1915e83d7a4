"""Model definitions of the port (counterpart of gofr_tpu/models)."""

from .common import LLAMA_CONFIGS, ModelConfig

__all__ = ["LLAMA_CONFIGS", "ModelConfig"]
