"""Whisper-medium — encoder-decoder, conv frontend stub
[arXiv:2212.04356]; port of ``repro.configs.whisper_medium``.

The mel-spectrogram and conv feature extractor are a stub, as in the
reference: the encoder takes (B, 1500, 1024) frame embeddings.
``max_position`` is raised beyond Whisper's native 448, as in the
reference, so that long decoder caches are expressible.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        arch_type="audio",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,              # MHA
        d_ff=4096,
        vocab_size=51865,
        block_pattern=("xattn",) * 24,
        head_dim=64,
        ffn_act="gelu",
        norm_type="layernorm",
        norm_eps=1e-5,
        use_rope=False,             # learned decoder positions
        max_position=33024,
        tie_embeddings=True,
        enc_layers=24,
        enc_seq=1500,
        enc_d_model=1024,
        source="arXiv:2212.04356 (Whisper)",
    )
