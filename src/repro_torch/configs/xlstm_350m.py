"""xLSTM-350M — sLSTM + mLSTM blocks [arXiv:2405.04517]; port of
``repro.configs.xlstm_350m``."""
from repro_torch.models.config import ModelConfig

# 7 mLSTM blocks per sLSTM block (xLSTM[7:1]); 24 layers = 3 units of 8.
_UNIT = ("mlstm",) * 7 + ("slstm",)


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        arch_type="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,                      # mLSTM blocks have no separate FFN
        vocab_size=50304,
        block_pattern=tuple(_UNIT[i % 8] for i in range(24)),
        head_dim=64,
        use_rope=False,
        tie_embeddings=True,
        source="arXiv:2405.04517 (xLSTM)",
    )
