"""Qwen2-7B — the paper's dense testbed model (§4.1); port of
``repro.configs.qwen2_7b``."""
from repro_torch.models.config import ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b",
        arch_type="dense",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        block_pattern=dense_pattern(28),
        head_dim=128,
        rope_theta=1_000_000.0,
        source="paper §4.1 testbed (Qwen2-7B)",
    )
