"""Snowflake Arctic-480B — 128-expert top-2 MoE + dense residual FFN
[hf:Snowflake/snowflake-arctic-base]; port of
``repro.configs.arctic_480b``."""
from repro_torch.models.config import ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        arch_type="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        block_pattern=dense_pattern(35),
        head_dim=128,
        n_experts=128,
        top_k=2,
        moe_d_ff=4864,
        dense_residual_d_ff=4864,   # arctic's dense-MoE hybrid residual
        opt_state_dtype="bfloat16",  # 3.8TB of f32 adam state won't fit 1 pod
        source="hf:Snowflake/snowflake-arctic-base",
    )
