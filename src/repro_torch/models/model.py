"""Block-pattern model — port of ``repro.models.model``: ``attn`` and
``swa`` attention blocks with a dense or a top-k MoE FFN
(``layers.moe_apply``; Arctic's dense residual beside it), RG-LRU blocks
(RecurrentGemma), mLSTM / sLSTM blocks (xLSTM), Whisper's encoder and
its ``xattn`` decoder blocks (causal self-attention plus cross-attention
over the encoder's output, learned decoder positions ``dec_pos``); with
PaliGemma's patch-embedding inputs and logit soft-capping.

Parameters are a plain dict: ``embed``, ``final_norm``, ``lm_head``
(absent when embeddings are tied) and ``layers``, a list of per-layer
block dicts in the reference's block layout (``models.convert`` unstacks
the reference's scan-stacked parameters into it); an encoder-decoder
adds ``encoder`` (``{"layers": [...], "final_norm"}``, one dict per
encoder layer) and ``dec_pos`` (max_position, d_model).  The cache is a
list with one dict per layer, every leaf batch-major:

* ``attn``: ``{"k", "v"}``, each ``(B, max_len, KV, hd)``;
* ``swa``: ``{"k", "v"}``, each ``(B, W, KV, hd)``, a ring of
  ``W = min(window, max_len)`` rows;
* ``xattn``: ``{"k", "v"}`` as ``attn`` and the cross cache ``{"xk",
  "xv"}``, each ``(B, X, KV, hd)``, ``X = attention.cross_rows(enc_seq)``
  (1504 for 1500 frames: whole decode pages; the padding rows are zero
  and never read);
* ``rglru``: ``{"h", "conv"}``; ``mlstm``: ``{"C", "n", "m"}``;
  ``slstm``: ``{"c", "n", "m", "h"}`` (``models.recurrent``, float32).

Entry points, as in the reference:

* ``prefill`` — the plain full forward (plain attention, the plain
  versions of the recurrent kernels, the encoder's plain attention), the
  reference the cached path is held against;
* ``encode`` — the encoder alone, its attention through
  ``flash_prefill`` with ``kv_offset = S`` (no causal mask: every row
  sees every frame), the input of ``prefill_cached``'s ``enc_out``;
* ``prefill_cached`` — one chunk continuing a cache, through the
  ``flash_prefill``, ``rglru_scan`` and ``mlstm_chunk`` kernels (the
  engine's prefill); recurrent blocks resume from their state, as in the
  reference, whatever ``cache_len`` says; ``xattn`` blocks compute their
  cross cache from ``enc_out`` when it is given, else read it;
* ``decode_step`` — one token per sequence, through the
  ``paged_attention`` kernel (the engine's decode; ``xattn`` blocks twice:
  self and cross);
* ``forward_train`` — the full forward and the loss (CE over
  ``targets >= 0``, z-loss, the MoE aux loss summed over layers) on the
  reference's own functions, so through no kernel: the kernels have no
  backward; ``remat`` checkpoints each layer.

The two cached entry points update the cache in place and return the
same list.  Logits are f32, sliced to ``vocab_size``, soft-capped when
``logit_soft_cap`` is set; the lm-head product runs in the parameter
dtype.  A MoE layer computes its capacity per call and per batch row, as
in the reference, so a chunked prefill drops other choices than the full
forward unless ``capacity_factor >= n_experts / top_k`` (ROADMAP Queue
C.12).  ``prefill`` and ``forward_train`` take the reference's
``batch``: with ``batch["patch_embeds"]`` (B, n_patches, ``VISION_DIM``)
the projected patches precede the tokens and positions restart at 0;
with ``batch["frames"]`` (B, enc_seq, enc_d_model) the encoder runs
first.  The cached entry points take tokens only, as in the reference.

``Model(cfg, device="cuda")`` needs a card; ``device="cpu"`` runs the
kernels' plain versions.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import torch

from torch.utils.checkpoint import checkpoint

from ..core.indicators import resolve_device
from ..kernels.prefill_attention import flash_prefill
from . import attention as attn
from . import recurrent as rec
from .config import ModelConfig
from .layers import (MetaDraws, embed_apply, ffn_apply, init_embed,
                     init_ffn, init_linear, init_moe, init_norm, linear,
                     moe_apply, norm_apply, source)

#: stub SigLIP patch-embedding width (PaliGemma), as in the reference
VISION_DIM = 1152

ATTN_KINDS = attn.KINDS
#: the cache entries of an attention block, in ``attn_prefill``'s order
KV_NAMES = ("k", "v", "xk", "xv")

Cache = List[Dict[str, torch.Tensor]]


def _ffn_act(p, cfg: ModelConfig) -> str:
    if "wg" in p:
        return "geglu" if cfg.ffn_act == "geglu" else "swiglu"
    return "gelu"


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        """``device="meta"`` builds shapes only (``abstract_params``,
        ``init_cache``); nothing on it runs a forward."""
        self.cfg = cfg
        self.device = torch.device("meta") if str(device) == "meta" \
            else resolve_device(device)
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
        if cfg.is_encdec:
            params["encoder"] = self._init_encoder(generator)
            params["dec_pos"] = (torch.randn(
                (cfg.max_position, cfg.d_model), generator=source(generator),
                device=dev) * 0.01).to(dt)
        return params

    def abstract_params(self) -> Dict[str, Any]:
        """The parameter tree as ``meta`` tensors: shapes and dtypes,
        nothing allocated (the reference's ``eval_shape`` of ``init``)."""
        return Model(self.cfg, device="meta").init(MetaDraws())

    def _init_encoder(self, gen) -> Dict[str, Any]:
        """Whisper's encoder layers (pre-LayerNorm, MHA of ``n_heads``
        heads over ``enc_d_model``, a GELU FFN of 4 x enc_d_model)."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        eD = cfg.enc_d_model or cfg.d_model

        def layer():
            return {"norm1": init_norm(eD, dt, dev, "layernorm"),
                    **{n: init_linear(gen, eD, eD, dt)
                       for n in ("wq", "wk", "wv", "wo")},
                    "norm2": init_norm(eD, dt, dev, "layernorm"),
                    "ffn": init_ffn(gen, eD, 4 * eD, dt, "gelu")}
        return {"layers": [layer() for _ in range(cfg.enc_layers)],
                "final_norm": init_norm(eD, dt, dev, "layernorm")}

    def init_cache(self, B: int, max_len: int) -> Cache:
        """Zero K/V caches and the reference's initial recurrent states
        (``m = -1e30``)."""
        cfg, dev = self.cfg, self.device
        KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        out: Cache = []
        for kind in cfg.block_pattern:
            if kind in ATTN_KINDS:
                S = min(cfg.window_size, max_len) if kind == "swa" \
                    else max_len
                out.append({n: torch.zeros((B, S, KV, hd), dtype=self.dtype,
                                           device=dev) for n in ("k", "v")})
                if kind == "xattn":
                    X = attn.cross_rows(cfg.enc_seq)
                    out[-1].update({n: torch.zeros(
                        (B, X, KV, hd), dtype=self.dtype, device=dev)
                        for n in ("xk", "xv")})
            else:
                out.append(getattr(rec, f"{kind}_init_state")(B, cfg, dev))
        return out

    # ----------------------------------------------------------- helpers
    def _embed(self, params, tokens: torch.Tensor,
               positions=None) -> torch.Tensor:
        """Token embeddings (scaled for Gemma), plus the learned decoder
        positions ``dec_pos[clip(positions)]`` of an encoder-decoder."""
        if params["embed"]["w"].device != self.device:
            raise ValueError(f"parameters on {params['embed']['w'].device}, "
                             f"model on {self.device}")
        x = embed_apply(params["embed"], tokens.to(self.device))
        cfg = self.cfg
        if cfg.scale_embed:
            x = x * math.sqrt(cfg.d_model)
        if cfg.is_encdec:
            idx = torch.clamp(positions, 0, cfg.max_position - 1).long()
            x = x + params["dec_pos"][idx]
        return x

    def _inputs(self, params, tokens, batch, positions):
        """The reference's ``_embed_inputs``: embeddings, with a VLM's
        projected patches first (positions then restart at 0)."""
        cfg = self.cfg
        x = self._embed(params, tokens, positions)
        patches = (batch or {}).get("patch_embeds")
        if cfg.n_patches and patches is not None:
            pe = linear(params["vlm_proj"],
                        torch.as_tensor(patches).to(self.device, x.dtype))
            x = torch.cat([pe, x], dim=1)
            positions = torch.arange(x.shape[1],
                                     device=self.device).expand(
                                         x.shape[0], -1)
        return x, positions

    def encode(self, params, frames, plain: bool = False) -> torch.Tensor:
        """Whisper's encoder (the reference's ``_encoder_apply``): frames
        (B, S, enc_d_model) plus sinusoidal positions, pre-LayerNorm
        blocks of unmasked MHA (``n_heads`` heads of ``enc_d_model /
        n_heads``) and a GELU FFN, a final LayerNorm.  Attention goes
        through ``flash_prefill`` with ``kv_offset = S`` (the kernel on a
        card, its plain version on the CPU); ``plain=True`` runs the
        reference's ``_sdpa`` instead (the plain full forward and
        training)."""
        cfg = self.cfg
        enc = params["encoder"]
        eD = cfg.enc_d_model or cfg.d_model
        H = cfg.n_heads
        hd = eD // H
        x = torch.as_tensor(frames).to(self.device, self.dtype)
        B, S, _ = x.shape
        pos = torch.arange(S, dtype=torch.float32, device=self.device)
        dim = torch.arange(eD // 2, dtype=torch.float32, device=self.device)
        angle = pos[:, None] / torch.pow(10000.0, 2 * dim[None] / eD)
        x = x + torch.cat([torch.sin(angle), torch.cos(angle)],
                          dim=-1).to(x.dtype)
        offs = torch.full((B,), S, dtype=torch.int32, device=self.device)
        for lp in enc["layers"]:
            h = norm_apply(lp["norm1"], x, cfg.norm_eps)
            q, k, v = (linear(lp[n], h).reshape(B, S, H, hd)
                       for n in ("wq", "wk", "wv"))
            y = attn._sdpa(q, k, v, None) if plain else \
                flash_prefill(q, k, v, offs)
            x = x + linear(lp["wo"], y.reshape(B, S, -1))
            x = x + ffn_apply(lp["ffn"], norm_apply(lp["norm2"], x,
                                                    cfg.norm_eps), "gelu")
        return norm_apply(enc["final_norm"], x, cfg.norm_eps)

    def _norm1(self, p, x):
        return norm_apply(p["norm1"], x, self.cfg.norm_eps)

    def _ffn(self, p, x):
        """The FFN (or MoE) sub-block -> (y, aux loss)."""
        cfg = self.cfg
        h = norm_apply(p["norm2"], x, cfg.norm_eps)
        if "router" in p["ffn"]:
            return moe_apply(p["ffn"], h, cfg)
        return ffn_apply(p["ffn"], h, _ffn_act(p["ffn"], cfg)), 0.0

    def _logits(self, params, x: torch.Tensor,
                padded: bool = False) -> torch.Tensor:
        """f32 logits over ``vocab_size`` (``padded``: over the padded
        vocabulary, as the reference's training loss takes them)."""
        cfg = self.cfg
        x = norm_apply(params["final_norm"], x, cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = x @ params["embed"]["w"].T
        else:
            logits = linear(params["lm_head"], x)
        logits = logits.float()
        if not padded:
            logits = logits[..., :cfg.vocab_size]
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
            x = x + self._ffn(p, x)[0]
        return x, st

    @staticmethod
    def _store(entry: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]):
        for name, t in new.items():
            entry[name].copy_(t)

    # ---------------------------------------------------------- serving
    def _block(self, p, kind, x, positions, enc_out):
        """One layer of the plain full forward -> (x, cache entry, aux)."""
        if kind in ATTN_KINDS:
            h, kv = attn.attn_prefill(p["attn"], self._norm1(p, x),
                                      positions, self.cfg, kind, enc_out)
            x = x + h
            f, aux = self._ffn(p, x)
            return x + f, dict(zip(KV_NAMES, kv)), aux
        x, st = self._recurrent(p, kind, x, None, "prefill", plain=True)
        return x, st, 0.0

    def _stack(self, params, tokens, batch, positions, remat=False):
        """Embeddings and every layer of the plain full forward -> (x,
        cache, aux); ``remat`` checkpoints each layer (no cache then)."""
        cfg = self.cfg
        batch = batch or {}
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, device=self.device).expand(B, S)
        enc_out = self.encode(params, batch["frames"], plain=True) \
            if cfg.is_encdec else None
        x, positions = self._inputs(params, tokens, batch, positions)
        cache: Cache = []
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for p, kind in zip(params["layers"], cfg.block_pattern):
            if remat:
                x, a = checkpoint(self._train_block, p, kind, x, positions,
                                  enc_out, use_reentrant=False)
            else:
                x, entry, a = self._block(p, kind, x, positions, enc_out)
                cache.append(entry)
            aux = aux + a
        return x, cache, aux

    def _train_block(self, p, kind, x, positions, enc_out):
        x, _, a = self._block(p, kind, x, positions, enc_out)
        return x, torch.as_tensor(a, dtype=torch.float32, device=x.device)

    def prefill(self, params, tokens: torch.Tensor, batch=None,
                positions=None, last_only: bool = False):
        """Plain full forward.  tokens: (B, S); ``batch``: optional
        ``{"patch_embeds": (B, n_patches, VISION_DIM)}`` for a VLM, whose
        projection precedes the tokens (logits and caches then cover
        ``n_patches + S`` positions, numbered from 0), and ``{"frames":
        (B, enc_seq, enc_d_model)}`` for an encoder-decoder (required).
        Returns (logits, cache) with attention caches sized to the input
        (``swa``: its ring; ``xattn``: the cross K/V of the ``enc_seq``
        frames) and the recurrent states after it; ``last_only`` computes
        the lm-head logits of the last position only."""
        x, cache, _ = self._stack(params, tokens, batch, positions)
        if last_only:
            x = x[:, -1:]
        return self._logits(params, x), cache

    # ------------------------------------------------------------ train
    def forward_train(self, params, batch, remat: bool = True):
        """The reference's training forward.  batch: ``tokens`` (B, S),
        ``targets`` (B, S) (ids < 0 are not scored), optional ``frames``
        or ``patch_embeds`` (the loss then covers the text tokens only).
        Returns (loss, {"ce", "aux", "zloss", "tokens"}): CE over the
        padded vocabulary's logits, ``1e-4 * mean(logz^2)`` and the MoE
        aux loss summed over layers, as tensors on the model's device.
        Runs no kernel (plain attention and recurrences), so autograd
        reaches every parameter; ``remat`` checkpoints each layer
        (``torch.utils.checkpoint``, not reentrant)."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"]).to(self.device)
        x, _, aux = self._stack(params, tokens, batch, None, remat=remat)
        if cfg.n_patches:
            x = x[:, cfg.n_patches:]          # loss only on text tokens
        logits = self._logits(params, x, padded=True)
        targets = torch.as_tensor(batch["targets"]).to(self.device).long()
        mask = (targets >= 0).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, targets.clamp_min(0)[..., None])[..., 0]
        denom = mask.sum().clamp_min(1.0)
        ce = ((logz - gold) * mask).sum() / denom
        zloss = 1e-4 * (logz.square() * mask).sum() / denom
        return ce + zloss + aux, {"ce": ce, "aux": aux, "zloss": zloss,
                                  "tokens": mask.sum()}

    def prefill_cached(self, params, tokens: torch.Tensor,
                       positions: torch.Tensor, cache: Cache,
                       cache_len: Sequence[int], last_only: bool = False,
                       enc_out=None):
        """Chunked prefill continuing ``cache`` (the engine's hot path).

        tokens: (B, S_c); positions: (B, S_c) absolute, equal to
        ``cache_len[b] + arange(S_c)``; cache_len: (B,) host ints (or a
        tensor), the valid prefix already in the attention caches.  The
        chunk's K/V and the recurrent states are written into ``cache`` in
        place.  An encoder-decoder's ``enc_out`` (``encode``'s output),
        when given, fills the cross caches first; without it they are
        read as they stand.  Returns (logits, cache)."""
        cfg = self.cfg
        lens = [int(c) for c in torch.as_tensor(cache_len).reshape(-1)]
        Sc = tokens.shape[1]
        plans: Dict[str, Dict[str, Any]] = {}
        for entry, kind in zip(cache, cfg.block_pattern):
            if kind in ATTN_KINDS and kind not in plans:
                plans[kind] = attn.prefill_plan(
                    kind, lens, Sc, entry["k"].shape[1], self.device)
        positions = positions.to(self.device)
        if enc_out is not None:
            enc_out = torch.as_tensor(enc_out).to(self.device, self.dtype)
        x = self._embed(params, tokens, positions)
        for p, kind, entry in zip(params["layers"], cfg.block_pattern,
                                  cache):
            if kind in ATTN_KINDS:
                cross = (entry["xk"], entry["xv"], enc_out) \
                    if kind == "xattn" else None
                x = x + attn.attn_prefill_cached(
                    p["attn"], self._norm1(p, x), positions, cfg, kind,
                    entry["k"], entry["v"], plans[kind], cross)
                x = x + self._ffn(p, x)[0]
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
        x = self._embed(params, token, pos[:, None])
        for p, kind, entry in zip(params["layers"], cfg.block_pattern,
                                  cache):
            if kind in ATTN_KINDS:
                cross = (entry["xk"], entry["xv"],
                         self._decode_tables(entry["xk"])) \
                    if kind == "xattn" else None
                x = x + attn.attn_decode(
                    p["attn"], self._norm1(p, x), pos, cfg, kind,
                    entry["k"], entry["v"], self._decode_tables(entry["k"]),
                    cross)
                x = x + self._ffn(p, x)[0]
            else:
                x, st = self._recurrent(p, kind, x, entry, "decode")
                self._store(entry, st)
        return self._logits(params, x), cache

    def _decode_tables(self, k: torch.Tensor) -> torch.Tensor:
        """``attention.decode_tables`` of a (B, S, KV, hd) slot cache,
        built once per (B, S)."""
        B, S = k.shape[:2]
        tables = self._tables.get((B, S))
        if tables is None:
            tables = self._tables[(B, S)] = attn.decode_tables(
                B, S, self.device)
        return tables
