"""Block-pattern model — port of ``repro.models.model`` for the
decoder-only patterns the serving engine runs: ``attn`` and ``swa``
attention blocks with a dense or a top-k MoE FFN (``layers.moe_apply``;
Arctic's dense residual beside it), RG-LRU blocks (RecurrentGemma), and
mLSTM / sLSTM blocks (xLSTM); with PaliGemma's patch-embedding inputs
and logit soft-capping.

Parameters are a plain dict: ``embed``, ``final_norm``, ``lm_head``
(absent when embeddings are tied) and ``layers``, a list of per-layer
block dicts in the reference's block layout (``models.convert`` unstacks
the reference's scan-stacked parameters into it).  The cache is a list
with one dict per layer, every leaf batch-major:

* ``attn``: ``{"k", "v"}``, each ``(B, max_len, KV, hd)``;
* ``swa``: ``{"k", "v"}``, each ``(B, W, KV, hd)``, a ring of
  ``W = min(window, max_len)`` rows;
* ``rglru``: ``{"h", "conv"}``; ``mlstm``: ``{"C", "n", "m"}``;
  ``slstm``: ``{"c", "n", "m", "h"}`` (``models.recurrent``, float32).

Three entry points, as in the reference:

* ``prefill`` — the plain full forward (plain attention, and the plain
  versions of the recurrent kernels), the reference the engine path is
  held against;
* ``prefill_cached`` — one chunk continuing a cache, through the
  ``flash_prefill``, ``rglru_scan`` and ``mlstm_chunk`` kernels (the
  engine's prefill); recurrent blocks resume from their state, as in the
  reference, whatever ``cache_len`` says;
* ``decode_step`` — one token per sequence, through the
  ``paged_attention`` kernel (the engine's decode).

The two cached entry points update the cache in place and return the
same list.  Logits are f32, sliced to ``vocab_size``, soft-capped when
``logit_soft_cap`` is set; the lm-head product runs in the parameter
dtype.  A MoE layer computes its capacity per call and per batch row, as
in the reference, so a chunked prefill drops other choices than the full
forward unless ``capacity_factor >= n_experts / top_k`` (ROADMAP Queue
C.12).  ``prefill`` takes the reference's ``batch``: with
``batch["patch_embeds"]`` (B, n_patches, ``VISION_DIM``) the projected
patches precede the tokens and positions restart at 0; the cached entry
points take tokens only, as in the reference.  Not ported: cross
attention, the encoder (Whisper) and ``forward_train``.

``Model(cfg, device="cuda")`` needs a card; ``device="cpu"`` runs the
kernels' plain versions.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import torch

from ..core.indicators import resolve_device
from . import attention as attn
from . import recurrent as rec
from .config import ModelConfig
from .layers import (embed_apply, ffn_apply, init_embed, init_ffn,
                     init_linear, init_moe, init_norm, linear, moe_apply,
                     norm_apply)

#: stub SigLIP patch-embedding width (PaliGemma), as in the reference
VISION_DIM = 1152

#: block kinds the port serves
SERVED_KINDS = ("attn", "swa", "rglru", "mlstm", "slstm")
ATTN_KINDS = ("attn", "swa")

Cache = List[Dict[str, torch.Tensor]]


def _unsupported(cfg: ModelConfig) -> str:
    kinds = sorted(set(cfg.block_pattern) - set(SERVED_KINDS))
    if kinds:
        return f"block kinds {kinds}"
    if cfg.is_encdec:
        return "the encoder"
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
    def _init_block(self, gen, kind: str) -> Dict[str, Any]:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        p: Dict[str, Any] = {"norm1": init_norm(cfg.d_model, dt, dev,
                                                cfg.norm_type)}
        if kind in ATTN_KINDS:
            p["attn"] = attn.init_attention(gen, cfg, kind)
            if cfg.n_experts:
                p["norm2"] = init_norm(cfg.d_model, dt, dev, cfg.norm_type)
                p["ffn"] = init_moe(gen, cfg, dt)
                return p
            d_ff, act = cfg.d_ff, cfg.ffn_act
        elif kind == "rglru":
            p["rglru"] = rec.init_rglru(gen, cfg)
            d_ff, act = cfg.d_ff, cfg.ffn_act
        elif kind == "mlstm":
            p["mlstm"] = rec.init_mlstm(gen, cfg)
            return p
        else:
            p["slstm"] = rec.init_slstm(gen, cfg)
            d_ff, act = max(4 * cfg.d_model // 3, 64), "geglu"
        p["norm2"] = init_norm(cfg.d_model, dt, dev, cfg.norm_type)
        p["ffn"] = init_ffn(gen, cfg.d_model, d_ff, dt, act)
        return p

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
        params["layers"] = [self._init_block(generator, kind)
                            for kind in cfg.block_pattern]
        if cfg.n_patches:
            params["vlm_proj"] = init_linear(generator, VISION_DIM,
                                             cfg.d_model, dt)
        return params

    def init_cache(self, B: int, max_len: int) -> Cache:
        """Zero K/V caches and the reference's initial recurrent states
        (``m = -1e30``)."""
        cfg, dev = self.cfg, self.device
        KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        out: Cache = []
        for kind in cfg.block_pattern:
            if kind in ATTN_KINDS:
                S = max_len if kind == "attn" else min(cfg.window_size,
                                                       max_len)
                out.append({n: torch.zeros((B, S, KV, hd), dtype=self.dtype,
                                           device=dev) for n in ("k", "v")})
            else:
                out.append(getattr(rec, f"{kind}_init_state")(B, cfg, dev))
        return out

    # ----------------------------------------------------------- helpers
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        if params["embed"]["w"].device != self.device:
            raise ValueError(f"parameters on {params['embed']['w'].device}, "
                             f"model on {self.device}")
        x = embed_apply(params["embed"], tokens.to(self.device))
        if self.cfg.scale_embed:
            x = x * math.sqrt(self.cfg.d_model)
        return x

    def _norm1(self, p, x):
        return norm_apply(p["norm1"], x, self.cfg.norm_eps)

    def _ffn(self, p, x):
        cfg = self.cfg
        h = norm_apply(p["norm2"], x, cfg.norm_eps)
        if "router" in p["ffn"]:
            return moe_apply(p["ffn"], h, cfg)[0]
        return ffn_apply(p["ffn"], h, _ffn_act(p["ffn"], cfg))

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = norm_apply(params["final_norm"], x, cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = x @ params["embed"]["w"].T
        else:
            logits = linear(params["lm_head"], x)
        logits = logits.float()[..., :cfg.vocab_size]
        if cfg.logit_soft_cap:
            logits = torch.tanh(logits / cfg.logit_soft_cap) \
                * cfg.logit_soft_cap
        return logits

    def _recurrent(self, p, kind, x, state, mode, plain=False):
        """One recurrent block (prefill or decode) -> (x, new state)."""
        cfg = self.cfg
        h = self._norm1(p, x)
        if mode == "decode":
            y, st = getattr(rec, f"{kind}_decode")(p[kind], h, state, cfg)
        elif kind == "slstm":
            y, st = rec.slstm_prefill(p[kind], h, cfg, state)
        else:
            y, st = getattr(rec, f"{kind}_prefill")(p[kind], h, cfg, state,
                                                    plain=plain)
        x = x + y
        if kind != "mlstm":
            x = x + self._ffn(p, x)
        return x, st

    @staticmethod
    def _store(entry: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]):
        for name, t in new.items():
            entry[name].copy_(t)

    # ---------------------------------------------------------- serving
    def prefill(self, params, tokens: torch.Tensor, batch=None,
                positions=None, last_only: bool = False):
        """Plain full forward.  tokens: (B, S); ``batch``: optional
        ``{"patch_embeds": (B, n_patches, VISION_DIM)}`` for a VLM, whose
        projection precedes the tokens (logits and caches then cover
        ``n_patches + S`` positions, numbered from 0).  Returns (logits,
        cache) with attention caches sized to the input (``swa``: its
        ring) and the recurrent states after it; ``last_only`` computes
        the lm-head logits of the last position only."""
        cfg = self.cfg
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, device=self.device).expand(B, S)
        x = self._embed(params, tokens)
        patches = (batch or {}).get("patch_embeds")
        if cfg.n_patches and patches is not None:
            pe = linear(params["vlm_proj"],
                        torch.as_tensor(patches).to(self.device, x.dtype))
            x = torch.cat([pe, x], dim=1)
            positions = torch.arange(x.shape[1],
                                     device=self.device).expand(B, -1)
        cache: Cache = []
        for p, kind in zip(params["layers"], cfg.block_pattern):
            if kind in ATTN_KINDS:
                h, (k, v) = attn.attn_prefill(p["attn"], self._norm1(p, x),
                                              positions, cfg, kind)
                x = x + h
                x = x + self._ffn(p, x)
                cache.append({"k": k, "v": v})
            else:
                x, st = self._recurrent(p, kind, x, None, "prefill",
                                        plain=True)
                cache.append(st)
        if last_only:
            x = x[:, -1:]
        return self._logits(params, x), cache

    def prefill_cached(self, params, tokens: torch.Tensor,
                       positions: torch.Tensor, cache: Cache,
                       cache_len: Sequence[int], last_only: bool = False):
        """Chunked prefill continuing ``cache`` (the engine's hot path).

        tokens: (B, S_c); positions: (B, S_c) absolute, equal to
        ``cache_len[b] + arange(S_c)``; cache_len: (B,) host ints (or a
        tensor), the valid prefix already in the attention caches.  The
        chunk's K/V and the recurrent states are written into ``cache`` in
        place.  Returns (logits, cache)."""
        cfg = self.cfg
        lens = [int(c) for c in torch.as_tensor(cache_len).reshape(-1)]
        Sc = tokens.shape[1]
        plans: Dict[str, Dict[str, Any]] = {}
        for entry, kind in zip(cache, cfg.block_pattern):
            if kind in ATTN_KINDS and kind not in plans:
                plans[kind] = attn.prefill_plan(
                    kind, lens, Sc, entry["k"].shape[1], self.device)
        positions = positions.to(self.device)
        x = self._embed(params, tokens)
        for p, kind, entry in zip(params["layers"], cfg.block_pattern,
                                  cache):
            if kind in ATTN_KINDS:
                x = x + attn.attn_prefill_cached(
                    p["attn"], self._norm1(p, x), positions, cfg, kind,
                    entry["k"], entry["v"], plans[kind])
                x = x + self._ffn(p, x)
            else:
                x, st = self._recurrent(p, kind, x, entry, "prefill")
                self._store(entry, st)
        if last_only:
            x = x[:, -1:]
        return self._logits(params, x), cache

    def decode_step(self, params, token: torch.Tensor, pos: torch.Tensor,
                    cache: Cache):
        """token: (B, 1); pos: (B,) absolute position of the new token.
        The new K/V and the recurrent states are written into ``cache`` in
        place.  Returns (logits (B, 1, V), cache)."""
        cfg = self.cfg
        pos = pos.to(self.device)
        x = self._embed(params, token)
        for p, kind, entry in zip(params["layers"], cfg.block_pattern,
                                  cache):
            if kind in ATTN_KINDS:
                B, S = entry["k"].shape[:2]
                tables = self._tables.get((B, S))
                if tables is None:
                    tables = attn.decode_tables(B, S, self.device)
                    self._tables[(B, S)] = tables
                x = x + attn.attn_decode(
                    p["attn"], self._norm1(p, x), pos, cfg, kind,
                    entry["k"], entry["v"], tables)
                x = x + self._ffn(p, x)
            else:
                x, st = self._recurrent(p, kind, x, entry, "decode")
                self._store(entry, st)
        return self._logits(params, x), cache
