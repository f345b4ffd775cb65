"""Yi-6B — llama-arch GQA [arXiv:2403.04652]; port of
``repro.configs.yi_6b``."""
from repro_torch.models.config import ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b",
        arch_type="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        block_pattern=dense_pattern(32),
        head_dim=128,
        rope_theta=5_000_000.0,
        source="arXiv:2403.04652 (Yi)",
    )
