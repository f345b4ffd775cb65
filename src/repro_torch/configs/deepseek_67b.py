"""DeepSeek-67B — llama-arch GQA [arXiv:2401.02954]; port of
``repro.configs.deepseek_67b``."""
from repro_torch.models.config import ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b",
        arch_type="dense",
        n_layers=95,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=102400,
        block_pattern=dense_pattern(95),
        head_dim=128,
        source="arXiv:2401.02954 (DeepSeek LLM)",
    )
