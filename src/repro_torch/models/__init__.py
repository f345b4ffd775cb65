"""Models of the port: configuration, layers, attention, recurrent
blocks, the block-pattern ``Model`` (Whisper's encoder-decoder and
``forward_train`` included) and the converter from the reference's
parameter pytree."""
from .config import KV_BLOCKS, ModelConfig, dense_pattern
from .model import Model

__all__ = ["KV_BLOCKS", "ModelConfig", "dense_pattern", "Model"]
