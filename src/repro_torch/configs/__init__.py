"""Architecture configs — port of ``repro.configs``.

Each submodule exports ``config() -> ModelConfig`` with the reference's
hyper-parameters.  ``get_config(name)`` resolves by id, as the
reference does: the ``-swa`` suffix gives the sliding-window variant
(every ``attn`` block becomes ``swa``, window 4096), the ``-smoke``
suffix the reduced smoke-test variant.  The port carries every model of
the reference: the paper's testbeds Qwen2-7B and Qwen3-30B-A3B (MoE),
Qwen3-4B, Yi-6B, MiniCPM-2B, DeepSeek-67B, PaliGemma-3B (patch-embedding
inputs), the MoE models Granite-MoE-3B and Arctic-480B (a dense residual
FFN beside the experts), the recurrent families RecurrentGemma-9B and
xLSTM-350M, and Whisper-medium, the one encoder-decoder (held at model
level: the serving engine refuses it, as the reference's does).  An
unknown id raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

#: in the reference's order: the ten assigned archs, then the paper's own
#: testbed models
ARCH_IDS = ("xlstm_350m", "paligemma_3b", "yi_6b", "recurrentgemma_9b",
            "whisper_medium", "deepseek_67b", "arctic_480b",
            "granite_moe_3b_a800m", "minicpm_2b", "qwen3_4b", "qwen2_7b",
            "qwen3_30b_moe")

ASSIGNED_ARCHS = ARCH_IDS[:10]


def _norm(name: str) -> str:
    return name.replace("-", "_")


def get_config(name: str) -> ModelConfig:
    name = _norm(name)
    smoke = name.endswith("_smoke")
    if smoke:
        name = name[: -len("_smoke")]
    swa = name.endswith("_swa")
    if swa:
        name = name[: -len("_swa")]
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    cfg = importlib.import_module(f"repro_torch.configs.{name}").config()
    if swa:
        cfg = cfg.with_sliding_window()
    return cfg.reduced() if smoke else cfg
