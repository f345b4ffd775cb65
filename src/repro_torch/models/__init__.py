"""Models of the port: configuration, layers, attention, the dense
attention-only ``Model`` and the converter from the reference's
parameter pytree."""
from .config import KV_BLOCKS, ModelConfig, dense_pattern
from .model import Model

__all__ = ["KV_BLOCKS", "ModelConfig", "dense_pattern", "Model"]
