"""Dense attention-only model — port of ``repro.models.model`` for the
patterns the serving engine runs (every block ``attn``, dense FFN).

Parameters are a plain dict: ``embed``, ``final_norm``, ``lm_head``
(absent when embeddings are tied) and ``layers``, a list of per-layer
block dicts in the reference's block layout (``models.convert`` unstacks
the reference's scan-stacked parameters into it).  The KV cache is
``{"k", "v"}``, each ``(n_layers, B, max_len, KV, hd)``.

Three entry points, as in the reference:

* ``prefill`` — the plain full forward (dense or blockwise attention as
  plain PyTorch), the reference the engine path is held against;
* ``prefill_cached`` — one chunk continuing a cache, through the
  ``flash_prefill`` kernel (the engine's prefill);
* ``decode_step`` — one token per sequence, through the
  ``paged_attention`` kernel (the engine's decode).

The two cached entry points update the cache in place and return the
same dict.  Logits are f32, sliced to ``vocab_size``; the lm-head product
runs in the parameter dtype.  Not ported: MoE, recurrent blocks, sliding
window and cross attention, the encoder, VLM inputs, logit soft-capping
and ``forward_train``.

``Model(cfg, device="cuda")`` needs a card; ``device="cpu"`` runs the
kernels' plain versions.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch

from ..core.indicators import resolve_device
from . import attention as attn
from .config import ModelConfig
from .layers import (embed_apply, ffn_apply, init_embed, init_ffn,
                     init_linear, init_norm, linear, norm_apply)


def _unsupported(cfg: ModelConfig) -> str:
    if any(k != "attn" for k in cfg.block_pattern):
        return f"block kinds {sorted(set(cfg.block_pattern))}"
    if cfg.n_experts:
        return "MoE"
    if cfg.is_encdec or cfg.n_patches:
        return "encoder / VLM inputs"
    if cfg.logit_soft_cap:
        return "logit soft-capping"
    return ""


def _ffn_act(p, cfg: ModelConfig) -> str:
    if "wg" in p:
        return "geglu" if cfg.ffn_act == "geglu" else "swiglu"
    return "gelu"


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        why = _unsupported(cfg)
        if why:
            raise NotImplementedError(f"{cfg.name}: {why} not ported to "
                                      "repro_torch yet (ROADMAP Queue A)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self._tables: Dict[tuple, torch.Tensor] = {}

    # -------------------------------------------------------------- init
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random parameters with the reference's distributions, drawn from
        ``generator`` (which must live on the model's device)."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{dev}")
        params: Dict[str, Any] = {
            "embed": init_embed(generator, cfg.padded_vocab_size,
                                cfg.d_model, dt),
            "final_norm": init_norm(cfg.d_model, dt, dev, cfg.norm_type),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = init_linear(generator, cfg.d_model,
                                            cfg.padded_vocab_size, dt)
        params["layers"] = [
            {"norm1": init_norm(cfg.d_model, dt, dev, cfg.norm_type),
             "attn": attn.init_attention(generator, cfg, "attn"),
             "norm2": init_norm(cfg.d_model, dt, dev, cfg.norm_type),
             "ffn": init_ffn(generator, cfg.d_model, cfg.d_ff, dt,
                             cfg.ffn_act)}
            for _ in range(cfg.n_layers)]
        return params

    def init_cache(self, B: int, max_len: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        shp = (cfg.n_layers, B, max_len, cfg.n_kv_heads,
               cfg.resolved_head_dim)
        return {"k": torch.zeros(shp, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shp, dtype=self.dtype, device=self.device)}

    # ----------------------------------------------------------- helpers
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        if params["embed"]["w"].device != self.device:
            raise ValueError(f"parameters on {params['embed']['w'].device}, "
                             f"model on {self.device}")
        x = embed_apply(params["embed"], tokens.to(self.device))
        if self.cfg.scale_embed:
            x = x * math.sqrt(self.cfg.d_model)
        return x

    def _ffn(self, p, x):
        cfg = self.cfg
        return ffn_apply(p["ffn"], norm_apply(p["norm2"], x, cfg.norm_eps),
                         _ffn_act(p["ffn"], cfg))

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = norm_apply(params["final_norm"], x, cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = x @ params["embed"]["w"].T
        else:
            logits = linear(params["lm_head"], x)
        return logits.float()[..., :cfg.vocab_size]

    # ---------------------------------------------------------- serving
    def prefill(self, params, tokens: torch.Tensor, positions=None,
                last_only: bool = False):
        """Plain full forward.  tokens: (B, S).  Returns (logits, cache)
        with the cache sized to the prompt; ``last_only`` computes the
        lm-head logits of the last position only."""
        cfg = self.cfg
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, device=self.device).expand(B, S)
        x = self._embed(params, tokens)
        ks, vs = [], []
        for p in params["layers"]:
            h, (k, v) = attn.attn_prefill(
                p["attn"], norm_apply(p["norm1"], x, cfg.norm_eps),
                positions, cfg, "attn")
            x = x + h
            x = x + self._ffn(p, x)
            ks.append(k)
            vs.append(v)
        if last_only:
            x = x[:, -1:]
        return self._logits(params, x), {"k": torch.stack(ks),
                                         "v": torch.stack(vs)}

    def prefill_cached(self, params, tokens: torch.Tensor,
                       positions: torch.Tensor, cache,
                       cache_len: Sequence[int], last_only: bool = False):
        """Chunked prefill continuing ``cache`` (the engine's hot path).

        tokens: (B, S_c); positions: (B, S_c) absolute, equal to
        ``cache_len[b] + arange(S_c)``; cache_len: (B,) host ints (or a
        tensor), the valid prefix already in the cache.  The chunk's K/V
        are written into ``cache`` in place.  Returns (logits, cache)."""
        cfg = self.cfg
        lens = [int(c) for c in torch.as_tensor(cache_len).reshape(-1)]
        Sc = tokens.shape[1]
        kv_len = max(lens) + Sc
        if kv_len > cache["k"].shape[2]:
            raise ValueError(f"cache_len + chunk = {kv_len} exceeds the "
                             f"cache length {cache['k'].shape[2]}")
        kv_offset = torch.tensor(lens, dtype=torch.int32, device=self.device)
        positions = positions.to(self.device)
        x = self._embed(params, tokens)
        for i, p in enumerate(params["layers"]):
            x = x + attn.attn_prefill_cached(
                p["attn"], norm_apply(p["norm1"], x, cfg.norm_eps),
                positions, cfg, "attn", cache["k"][i], cache["v"][i],
                kv_offset, kv_len)
            x = x + self._ffn(p, x)
        if last_only:
            x = x[:, -1:]
        return self._logits(params, x), cache

    def decode_step(self, params, token: torch.Tensor, pos: torch.Tensor,
                    cache):
        """token: (B, 1); pos: (B,) absolute position of the new token.
        The new K/V are written into ``cache`` in place.  Returns
        (logits (B, 1, V), cache)."""
        cfg = self.cfg
        B, S = cache["k"].shape[1], cache["k"].shape[2]
        tables = self._tables.get((B, S))
        if tables is None:
            tables = attn.decode_tables(B, S, self.device)
            self._tables[(B, S)] = tables
        pos = pos.to(self.device)
        x = self._embed(params, token)
        for i, p in enumerate(params["layers"]):
            x = x + attn.attn_decode(
                p["attn"], norm_apply(p["norm1"], x, cfg.norm_eps), pos, cfg,
                "attn", cache["k"][i], cache["v"][i], tables)
            x = x + self._ffn(p, x)
        return self._logits(params, x), cache
