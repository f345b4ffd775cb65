"""Architecture configs — port of ``repro.configs``.

Each submodule exports ``config() -> ModelConfig`` with the reference's
hyper-parameters.  ``get_config(name)`` resolves by id; the ``-smoke``
suffix gives the reduced smoke-test variant.  The port carries the
models its engine serves: the paper's Qwen2-7B testbed, Qwen3-4B
(qk-norm, tied embeddings), whose smoke variant the reference's engine
tests use, and the two recurrent families, RecurrentGemma-9B (RG-LRU and
sliding-window attention) and xLSTM-350M (mLSTM and sLSTM); and the
paper's MoE testbed Qwen3-30B-A3B, whose config the heterogeneous fleet
and the simulator read (``core.fleet``) but which ``Model`` refuses:
MoE layers are not ported yet.  Every other id of the reference raises
``NotImplementedError``: its block kinds or experts are not ported yet
(ROADMAP Queue A).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = ("qwen2_7b", "qwen3_4b", "recurrentgemma_9b", "xlstm_350m",
            "qwen3_30b_moe")

#: ids of the reference that the port does not serve yet
NOT_PORTED = ("paligemma_3b", "yi_6b", "whisper_medium", "deepseek_67b",
              "arctic_480b", "granite_moe_3b_a800m", "minicpm_2b")


def _norm(name: str) -> str:
    return name.replace("-", "_")


def get_config(name: str) -> ModelConfig:
    name = _norm(name)
    smoke = name.endswith("_smoke")
    if smoke:
        name = name[: -len("_smoke")]
    if name.endswith("_swa") or name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet; see ROADMAP.md "
            f"Queue A (ported: {ARCH_IDS})")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    cfg = importlib.import_module(f"repro_torch.configs.{name}").config()
    return cfg.reduced() if smoke else cfg
