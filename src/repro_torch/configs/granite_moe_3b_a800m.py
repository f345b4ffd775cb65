"""IBM Granite-MoE 3B-A800M — 40-expert top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base family]; port of
``repro.configs.granite_moe_3b_a800m``."""
from repro_torch.models.config import ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        arch_type="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        block_pattern=dense_pattern(32),
        head_dim=64,
        n_experts=40,
        top_k=8,
        moe_d_ff=512,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )
