"""Model definitions of the port (counterpart of gofr_tpu/models)."""

from .common import BERT_CONFIGS, LLAMA_CONFIGS, VIT_CONFIGS, ModelConfig

__all__ = ["BERT_CONFIGS", "LLAMA_CONFIGS", "ModelConfig", "VIT_CONFIGS"]
