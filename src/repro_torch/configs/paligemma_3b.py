"""PaliGemma-3B — SigLIP (stub) + gemma decoder backbone
[arXiv:2407.07726]; port of ``repro.configs.paligemma_3b``.

The vision tower is a stub, as in the reference: the caller supplies
pre-computed (B, 256, 1152) SigLIP patch embeddings (``batch=
{"patch_embeds": ...}`` to ``Model.prefill``); the port implements the
linear projector and the Gemma-2B-style decoder that consumes them.
"""
from repro_torch.models.config import ModelConfig, dense_pattern


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        arch_type="vlm",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,               # MQA
        d_ff=16384,
        vocab_size=257216,
        block_pattern=dense_pattern(18),
        head_dim=256,
        ffn_act="geglu",
        tie_embeddings=True,
        scale_embed=True,
        n_patches=256,
        source="arXiv:2407.07726 (PaliGemma)",
    )
