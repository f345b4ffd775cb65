"""Qwen3-30B-A3B MoE — the paper's MoE testbed model (§4.1); port of
``repro.configs.qwen3_30b_moe``.  ``Model`` serves it (48 layers of
attention and a 128-expert top-8 MoE FFN), and the simulator and the
fleet read its shapes (``spec_from_config``).
"""
from repro_torch.models.config import ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-30b-moe",
        arch_type="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=768,
        vocab_size=151936,
        block_pattern=dense_pattern(48),
        head_dim=128,
        qk_norm=True,
        rope_theta=1_000_000.0,
        n_experts=128,
        top_k=8,
        moe_d_ff=768,
        source="paper §4.1 testbed (Qwen3-30B-A3B)",
    )
