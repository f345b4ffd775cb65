"""Qwen3-4B — qk_norm, GQA [hf:Qwen/Qwen3-8B family]; port of
``repro.configs.qwen3_4b``."""
from repro_torch.models.config import ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        arch_type="dense",
        n_layers=36,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=9728,
        vocab_size=151936,
        block_pattern=dense_pattern(36),
        head_dim=128,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        source="hf:Qwen/Qwen3-8B (4B sibling)",
    )
