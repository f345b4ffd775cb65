"""MiniCPM-2B — llama-like dense, WSD LR schedule [arXiv:2404.06395];
port of ``repro.configs.minicpm_2b``."""
from repro_torch.models.config import ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b",
        arch_type="dense",
        n_layers=40,
        d_model=2304,
        n_heads=36,
        n_kv_heads=36,              # MHA
        d_ff=5760,
        vocab_size=122753,
        block_pattern=dense_pattern(40),
        head_dim=64,
        tie_embeddings=True,
        lr_schedule="wsd",          # warmup-stable-decay (the paper's WSD)
        source="arXiv:2404.06395 (MiniCPM)",
    )
