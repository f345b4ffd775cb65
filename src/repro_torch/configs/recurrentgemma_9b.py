"""RecurrentGemma-9B — RG-LRU + local attention, 2 recurrent : 1 local-attn
[arXiv:2402.19427 (Griffin) / RecurrentGemma model card]; port of
``repro.configs.recurrentgemma_9b``."""
from repro_torch.models.config import ModelConfig, hybrid_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        arch_type="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,               # MQA local attention
        d_ff=12288,
        vocab_size=256000,
        block_pattern=hybrid_pattern(38, ("rglru", "rglru", "swa")),
        head_dim=256,
        ffn_act="geglu",
        window_size=2048,           # griffin local attention window
        d_rnn=4096,
        conv_width=4,
        tie_embeddings=True,
        scale_embed=True,
        source="arXiv:2402.19427 (Griffin/RecurrentGemma)",
    )
