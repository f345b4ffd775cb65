"""Assigned input shapes and per-arch input specs — port of
``repro.launch.shapes``.

``input_specs`` gives ``meta`` tensors (shapes and dtypes, nothing
allocated) where the reference gives ``ShapeDtypeStruct``s; a decode
spec's cache is the port's own (``Model.init_cache`` on ``meta``: one
dict per layer, Whisper's cross caches padded to ``cross_rows``, no
encoder output beside them).  ``model_flops`` and ``analytic_flops`` are
the reference's arithmetic on the config.  The ``*_at`` forms take any
(kind, seq, batch), e.g. a run's own, where the others read the table.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models import Model
from ..models.model import VISION_DIM

INPUT_SHAPES = {
    "train_4k":    dict(kind="train",   seq=4_096,   batch=256),
    "prefill_32k": dict(kind="prefill", seq=32_768,  batch=32),
    "decode_32k":  dict(kind="decode",  seq=32_768,  batch=128),
    "long_500k":   dict(kind="decode",  seq=524_288, batch=1),
}


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def resolve_arch_for_shape(cfg, shape_name: str):
    """long_500k needs sub-quadratic decode: dense/vlm archs swap in their
    sliding-window variant; whisper (enc-dec full attention) is skipped.
    Returns (cfg', skip_reason|None)."""
    if shape_name != "long_500k":
        return cfg, None
    if cfg.supports_long_decode():
        return cfg, None
    if cfg.is_encdec:
        return cfg, ("enc-dec full-attention (whisper): no faithful "
                     "sub-quadratic variant; skipped per DESIGN.md")
    return cfg.with_sliding_window(), None


def input_specs(cfg, shape_name: str) -> Dict:
    """``meta`` tensors for one (arch, shape) combination.

    train  -> {"batch": {tokens,targets[,frames,patch_embeds]}}
    prefill-> {"batch": {tokens[,frames,patch_embeds]}}
    decode -> {"token", "pos", "cache"}  (cache on ``meta``)
    """
    return input_specs_at(cfg, **INPUT_SHAPES[shape_name])


def input_specs_at(cfg, kind: str, seq: int, batch: int) -> Dict:
    """``input_specs`` at any (kind, seq, batch)."""
    B, S = batch, seq
    dtype = getattr(torch, cfg.dtype)

    def extras(b):
        out = {}
        if cfg.is_encdec:
            out["frames"] = _spec((b, cfg.enc_seq,
                                   cfg.enc_d_model or cfg.d_model), dtype)
        if cfg.n_patches:
            out["patch_embeds"] = _spec((b, cfg.n_patches, VISION_DIM),
                                        dtype)
        return out

    if kind in ("train", "prefill"):
        s_text = S - (cfg.n_patches or 0)
        batch = {"tokens": _spec((B, s_text), torch.int32)}
        if kind == "train":
            batch["targets"] = _spec((B, s_text), torch.int32)
        return {"kind": kind, "batch": {**batch, **extras(B)}}
    # decode: one new token against a seq_len cache
    return {"kind": kind,
            "token": _spec((B, 1), torch.int32),
            "pos": _spec((B,), torch.int32),
            "cache": Model(cfg, device="meta").init_cache(B, S)}


def model_flops(cfg, shape_name: str) -> float:
    """MODEL_FLOPS: 6·N·D for train, 2·N·D for inference (N = active
    params, D = tokens processed)."""
    return model_flops_at(cfg, **INPUT_SHAPES[shape_name])


def model_flops_at(cfg, kind: str, seq: int, batch: int) -> float:
    """``model_flops`` at any (kind, seq, batch), e.g. a run's own."""
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        # serving semantics: lm-head logits for the LAST position only
        lm = 0 if cfg.tie_embeddings else cfg.d_model * cfg.vocab_size
        return 2.0 * (n - lm) * batch * seq + 2.0 * lm * batch
    return 2.0 * n * batch                # decode: one token per sequence


def analytic_flops(cfg, shape_name: str) -> float:
    """MODEL_FLOPS + attention/recurrence flops (the quadratic terms 6·N·D
    misses): the roofline's compute term."""
    return analytic_flops_at(cfg, **INPUT_SHAPES[shape_name])


def analytic_flops_at(cfg, kind: str, seq: int, batch: int) -> float:
    """``analytic_flops`` at any (kind, seq, batch)."""
    B, S = batch, seq
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    extra = 0.0
    for bk in cfg.block_pattern:
        if bk in ("attn", "xattn"):
            span = S
        elif bk == "swa":
            span = min(S, cfg.window_size)
        elif bk == "mlstm":
            # chunkwise: intra-chunk (L) + matrix-memory (hd) terms
            di_hd = 2 * cfg.d_model // H
            span = 256 + 2 * di_hd
        elif bk in ("rglru", "slstm"):
            span = 8   # elementwise recurrence: negligible vs matmuls
        else:
            span = 0
        if kind == "decode":
            extra += 4.0 * B * span * H * hd
        else:
            eff = span / 2 if bk in ("attn", "xattn") else span
            extra += 4.0 * B * S * eff * H * hd
        if bk == "xattn" and kind != "decode":
            extra += 4.0 * B * S * cfg.enc_seq * H * hd
    if kind == "train":
        extra *= 3.0   # fwd + bwd
    return model_flops_at(cfg, kind, seq, batch) + extra
