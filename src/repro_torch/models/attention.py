"""GQA attention: prefill, cached chunked prefill and cached decode — port
of ``repro.models.attention`` for the ``attn`` block kind.

``attn_prefill`` (the plain full forward, the reference for the engine
path) keeps the reference's dense and blockwise scaled-dot-product
attention as plain PyTorch.  The two serving entry points go through the
port's kernels:

* ``attn_prefill_cached`` writes the chunk's K/V into the cache and calls
  ``kernels.prefill_attention.flash_prefill`` on the cache's first
  ``cache_len + S_c`` rows with ``kv_offset = cache_len``.  The reference
  attends over the whole buffer under a ``j < cache_len`` mask plus the
  chunk; the function is the same, only the order of the keys inside the
  softmax differs.
* ``attn_decode`` writes the new K/V at ``min(pos, S-1)`` and calls
  ``kernels.paged_attention.paged_attention`` on the slot cache viewed as
  pages: slot b of a ``(B, S, KV, hd)`` cache is pages ``b*P .. b*P+P-1``
  of its free ``(B*S/page, page, KV, hd)`` view, with
  ``context_lens = min(pos, S-1) + 1`` — the reference's ``j <= pos``.

Both update the cache tensors in place (the reference returns new ones).
``swa`` and ``xattn`` blocks are not ported.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..kernels.paged_attention import paged_attention
from ..kernels.prefill_attention import flash_prefill
from .config import ModelConfig
from .layers import apply_rope, init_linear, init_norm, linear, norm_apply

# sequence length above which attn_prefill goes blockwise (online softmax
# over KV chunks) instead of materialising (S, S) scores
BLOCKWISE_THRESHOLD = 2048
KV_CHUNK = 1024
#: page size of the decode view of a slot cache
DECODE_PAGE = 16

NEG_INF = -1e30


def _check_kind(kind: str):
    if kind != "attn":
        raise NotImplementedError(f"attention kind {kind!r} is not ported to "
                                  "repro_torch yet (ROADMAP Queue A)")


def init_attention(gen, cfg: ModelConfig, kind: str):
    _check_kind(kind)
    D = cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dtype = getattr(torch, cfg.dtype)
    p = {
        "wq": init_linear(gen, D, H * hd, dtype),
        "wk": init_linear(gen, D, KV * hd, dtype),
        "wv": init_linear(gen, D, KV * hd, dtype),
        "wo": init_linear(gen, H * hd, D, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_norm(hd, dtype, gen.device)
        p["k_norm"] = init_norm(hd, dtype, gen.device)
    return p


def _qkv(p, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(B, S, H, hd)
    k = linear(p["wk"], x).reshape(B, S, KV, hd)
    v = linear(p["wv"], x).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = norm_apply(p["q_norm"], q, cfg.norm_eps)
        k = norm_apply(p["k_norm"], k, cfg.norm_eps)
    if cfg.use_rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask):
    """q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd), mask: (B,Sq,Sk) bool or None.
    f32 scores and softmax; the weights are rounded to v's dtype before
    the PV product, as in the reference."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(),
                          k.float()) / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _blockwise_sdpa(q, k, v, positions, kv_chunk=KV_CHUNK):
    """Causal online-softmax attention over KV chunks of ``kv_chunk``.

    q, k, v: (B, S, ·, hd); positions: (B, S) absolute positions.  The
    queries are scaled by 1/sqrt(hd) in their own dtype before the product
    and the weights rounded to v's dtype, as in the reference."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    nchunk = (S + kv_chunk - 1) // kv_chunk
    pad = nchunk * kv_chunk - S
    kpos = positions
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = torch.nn.functional.pad(positions, (0, pad),
                                       value=torch.iinfo(torch.int32).max)
    qf = (q.reshape(B, S, KV, G, hd) / math.sqrt(hd)).to(q.dtype).float()
    ks = k.reshape(B, nchunk, kv_chunk, KV, hd)
    vs = v.reshape(B, nchunk, kv_chunk, KV, hd)
    kpos = kpos.reshape(B, nchunk, kv_chunk)
    m = torch.full((B, KV, G, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, S, hd), dtype=torch.float32,
                      device=q.device)
    qp = positions[:, None, None, :, None]
    for c in range(nchunk):
        kc, vc, pc = ks[:, c], vs[:, c], kpos[:, c]
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, kc.float())
        pcb = pc[:, None, None, None, :]
        s = torch.where(qp >= pcb, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def attn_prefill(p, x, positions, cfg: ModelConfig,
                 kind: str) -> Tuple[torch.Tensor, Tuple]:
    """The plain full forward.  Returns (y, (k, v)) with k/v the prompt's
    (B, S, KV, hd) cache entries."""
    _check_kind(kind)
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    if S > BLOCKWISE_THRESHOLD:
        y = _blockwise_sdpa(q, k, v, positions)
    else:
        mask = positions[:, :, None] >= positions[:, None, :]
        y = _sdpa(q, k, v, mask)
    y = linear(p["wo"], y.reshape(B, S, -1))
    return y, (k, v)


def attn_prefill_cached(p, x, positions, cfg: ModelConfig, kind: str,
                        cache_k: torch.Tensor, cache_v: torch.Tensor,
                        kv_offset: torch.Tensor, kv_len: int):
    """Chunked prefill continuing a cache (the engine's hot path: a KV$ hit
    skips compute because only the chunk's new tokens are processed).

    x: (B, S_c, D) chunk; positions: (B, S_c) absolute, equal to
    ``kv_offset[b] + arange(S_c)``; cache_k/cache_v: (B, S, KV, hd),
    written in place at ``positions``; kv_offset: (B,) int32 cached-prefix
    lengths on x's device; kv_len: ``max(kv_offset) + S_c`` (<= S), the
    cache rows the chunk attends over.  Returns y (B, S_c, D)."""
    _check_kind(kind)
    B, Sc, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    S = cache_k.shape[1]
    bidx = torch.arange(B, device=x.device)[:, None]
    slot = torch.clamp_max(positions, S - 1).long()
    cache_k[bidx, slot] = k
    cache_v[bidx, slot] = v
    y = flash_prefill(q, cache_k[:, :kv_len], cache_v[:, :kv_len], kv_offset)
    return linear(p["wo"], y.reshape(B, Sc, -1))


def decode_tables(B: int, S: int, device) -> torch.Tensor:
    """Block tables of the paged view of a (B, S, KV, hd) slot cache: slot
    b owns pages b*P .. b*P+P-1, P = S / DECODE_PAGE."""
    if S % DECODE_PAGE:
        raise ValueError(f"cache length {S} must be a multiple of the "
                         f"decode page {DECODE_PAGE}")
    P = S // DECODE_PAGE
    return torch.arange(B * P, dtype=torch.int32, device=device).reshape(B, P)


def attn_decode(p, x, pos: torch.Tensor, cfg: ModelConfig, kind: str,
                cache_k: torch.Tensor, cache_v: torch.Tensor,
                block_tables: torch.Tensor):
    """One-token decode.  x: (B, 1, D); pos: (B,) absolute position of the
    new token; cache_k/cache_v: (B, S, KV, hd), written in place at
    ``min(pos, S-1)``; block_tables: ``decode_tables(B, S)``.  Returns
    y (B, 1, D)."""
    _check_kind(kind)
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k_new, v_new = _qkv(p, x, cfg, pos[:, None])
    S = cache_k.shape[1]
    bidx = torch.arange(B, device=x.device)
    slot = torch.clamp_max(pos, S - 1).long()
    cache_k[bidx, slot] = k_new[:, 0]
    cache_v[bidx, slot] = v_new[:, 0]
    pages = (B * S // DECODE_PAGE, DECODE_PAGE, KV, hd)
    ctx = (slot + 1).to(torch.int32)
    y = paged_attention(q[:, 0], cache_k.view(pages), cache_v.view(pages),
                        block_tables, ctx)
    return linear(p["wo"], y.reshape(B, 1, H * hd))
