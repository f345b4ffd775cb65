"""GQA attention: prefill, cached chunked prefill and cached decode — port
of ``repro.models.attention`` for the ``attn``, ``swa`` and ``xattn``
block kinds.

``attn_prefill`` (the plain full forward, the reference for the engine
path) keeps the reference's dense and blockwise scaled-dot-product
attention as plain PyTorch, both with the sliding window of ``swa``.
The two serving entry points go through the port's kernels:

* ``attn_prefill_cached`` writes the chunk's K/V into the cache and calls
  ``kernels.prefill_attention.flash_prefill`` on the cache's first
  ``cache_len + S_c`` rows with ``kv_offset = cache_len``.  The reference
  attends over the whole buffer under a ``j < cache_len`` mask plus the
  chunk; the function is the same, only the order of the keys inside the
  softmax differs.
* For ``swa`` the cache is a ring of ``W = min(window, max_len)`` rows
  (position ``a`` in slot ``a % W``).  The chunk's keys are the ring's
  last ``kept = min(cache_len, W)`` positions, rolled into position
  order, then the chunk: ``flash_prefill`` with ``kv_offset = kept`` and
  the window (its mask is shift-invariant).  Only then is the chunk
  written into the ring: written first, a wrapping chunk would overwrite
  keys its earlier queries still see.
* ``attn_decode`` writes the new K/V at ``min(pos, S-1)`` (``swa``:
  ``pos % W``) and calls ``kernels.paged_attention.paged_attention`` on
  the slot cache viewed as pages: slot b of a ``(B, S, KV, hd)`` cache is
  pages ``b*P .. b*P+P-1`` of its free ``(B*S/page, page, KV, hd)`` view,
  with ``context_lens = min(pos, S-1) + 1`` — the reference's
  ``j <= pos``, and for the ring its ``abs_j >= 0`` (decode softmax does
  not depend on the order of the keys).

The reference's ``swa`` cached prefill masks its ring on the positions
the slots would hold had the ring been filled, so while
``0 < cache_len < W`` it also attends to ring slots never written (zero,
or a stored fragment's tail) and differs from its own full forward
(ROADMAP Queue C.10).  The port computes the full forward's function.

Both serving entry points update the cache tensors in place (the
reference returns new ones).

``xattn`` blocks (Whisper's decoder) add cross-attention over the
encoder's output, with no mask, to their causal self-attention (which
runs as ``attn``).  The cross K/V live in a cache of their own, ``(B,
X, KV, hd)`` with ``X = cross_rows(enc_seq)`` (``enc_seq`` rounded up to
the decode page, so that the decode view pages it; the padding rows are
never read):

* ``attn_prefill`` computes them from ``enc_out`` and attends plainly;
* ``attn_prefill_cached`` computes them from ``enc_out`` when it is
  given and writes them into the cross cache, else reads them from it;
  the chunk attends through ``flash_prefill`` over the cache's first
  ``enc_seq`` rows with ``kv_offset = enc_seq`` (row i sees key j iff
  ``j <= enc_seq + i``: every key);
* ``attn_decode`` attends through ``paged_attention`` over the cross
  cache's paged view with ``context_lens = enc_seq``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

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


KINDS = ("attn", "swa", "xattn")


def _check_kind(kind: str):
    if kind not in KINDS:
        raise ValueError(f"attention kind {kind!r} is not one of {KINDS}")


def cross_rows(enc_seq: int) -> int:
    """Rows of an ``xattn`` block's cross cache: ``enc_seq`` rounded up to
    a whole number of decode pages (1500 -> 1504)."""
    return -(-enc_seq // DECODE_PAGE) * DECODE_PAGE


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
    if kind == "xattn":
        eD = cfg.enc_d_model or D
        p["xwq"] = init_linear(gen, D, H * hd, dtype)
        p["xwk"] = init_linear(gen, eD, KV * hd, dtype)
        p["xwv"] = init_linear(gen, eD, KV * hd, dtype)
        p["xwo"] = init_linear(gen, H * hd, D, dtype)
    return p


def cross_kv(p, enc_out: torch.Tensor, cfg: ModelConfig):
    """The cross K/V of an ``xattn`` block: (B, enc_seq, KV, hd) each."""
    B, eS, _ = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return (linear(p["xwk"], enc_out).reshape(B, eS, KV, hd),
            linear(p["xwv"], enc_out).reshape(B, eS, KV, hd))


def _cross_q(p, x, cfg: ModelConfig):
    B, S, _ = x.shape
    return linear(p["xwq"], x).reshape(B, S, cfg.n_heads,
                                       cfg.resolved_head_dim)


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


def _sdpa(q, k, v, mask, soft_cap=0.0):
    """q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd), mask: (B,Sq,Sk) bool or None.
    f32 scores (soft-capped when ``soft_cap`` > 0) and softmax; the
    weights are rounded to v's dtype before the PV product, as in the
    reference."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(),
                          k.float()) / math.sqrt(hd)
    if soft_cap:
        scores = torch.tanh(scores / soft_cap) * soft_cap
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _blockwise_sdpa(q, k, v, positions, window=None, soft_cap=0.0,
                    kv_chunk=KV_CHUNK):
    """Causal (optionally windowed) online-softmax attention over KV
    chunks of ``kv_chunk``.

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
        if soft_cap:
            s = torch.tanh(s / soft_cap) * soft_cap
        pcb = pc[:, None, None, None, :]
        seen = qp >= pcb
        if window is not None:
            seen &= (qp - pcb) < window
        s = torch.where(seen, s, NEG_INF)
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

def attn_prefill(p, x, positions, cfg: ModelConfig, kind: str,
                 enc_out=None) -> Tuple[torch.Tensor, Tuple]:
    """The plain full forward.  Returns (y, (k, v)) with k/v the prompt's
    (B, S, KV, hd) cache entries; for ``swa`` the last ``window`` keys as a
    (B, window, KV, hd) ring (slot ``pos % window``, unwritten slots 0);
    for ``xattn`` (y, (k, v, xk, xv)), with the cross attention over
    ``enc_out`` (B, enc_seq, enc_d_model) added and its (B, enc_seq, KV,
    hd) K/V."""
    _check_kind(kind)
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    window = cfg.window_size if kind == "swa" else None
    if S > BLOCKWISE_THRESHOLD:
        y = _blockwise_sdpa(q, k, v, positions, window, cfg.logit_soft_cap)
    else:
        i, j = positions[:, :, None], positions[:, None, :]
        mask = i >= j
        if window is not None:
            mask &= (i - j) < window
        y = _sdpa(q, k, v, mask, cfg.logit_soft_cap)
    y = linear(p["wo"], y.reshape(B, S, -1))
    if kind == "xattn":
        xk, xv = cross_kv(p, enc_out, cfg)
        xy = _sdpa(_cross_q(p, x, cfg), xk, xv, None, cfg.logit_soft_cap)
        return y + linear(p["xwo"], xy.reshape(B, S, -1)), (k, v, xk, xv)
    if window is None:
        return y, (k, v)
    W = window
    if S >= W:
        kw, vw, wpos = k[:, -W:], v[:, -W:], positions[:, -W:]
    else:
        kw = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, W - S))
        vw = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, W - S))
        wpos = torch.nn.functional.pad(positions, (0, W - S), value=-1)
    # ring order: slot = pos % W; padding goes to a scratch slot W
    slot = torch.where(wpos >= 0, wpos % W, W).long()
    bidx = torch.arange(B, device=x.device)[:, None]
    kr = k.new_zeros((B, W + 1) + tuple(k.shape[2:]))
    vr = v.new_zeros((B, W + 1) + tuple(v.shape[2:]))
    kr[bidx, slot] = kw
    vr[bidx, slot] = vw
    return y, (kr[:, :W], vr[:, :W])


def prefill_plan(kind: str, lens: Sequence[int], Sc: int, S: int,
                 device) -> Dict[str, Any]:
    """What a chunk of ``Sc`` tokens after cached lengths ``lens`` (host
    ints, one per row) attends over in a cache of ``S`` rows, computed
    once per chunk for every layer of ``kind``.

    ``attn``: the cache's first ``kv_len = max(lens) + Sc`` rows with
    ``kv_offset = lens``.  ``swa`` (a ring of ``W = S`` rows): row b keeps
    its last ``kept_b = min(lens_b, W)`` ring positions; ``index`` (B, Sk)
    picks, from the ring followed by the chunk, those positions in order
    and then the chunk (``Sk = max(kept) + Sc``; rows past a shorter row's
    end repeat its last token, masked by causality), with
    ``kv_offset = kept``.  ``xattn`` plans its self-attention as
    ``attn``."""
    if kind in ("attn", "xattn"):
        kv_len = max(lens) + Sc
        if kv_len > S:
            raise ValueError(f"cache_len + chunk = {kv_len} exceeds the "
                             f"cache length {S}")
        return {"kv_offset": torch.tensor(lens, dtype=torch.int32,
                                          device=device), "kv_len": kv_len}
    _check_kind(kind)
    kept = [min(n, S) for n in lens]
    Sk = max(kept) + Sc
    j = torch.arange(Sk, device=device)[None]
    kept_t = torch.tensor(kept, device=device)[:, None]
    start = torch.tensor([n - k for n, k in zip(lens, kept)],
                         device=device)[:, None]
    index = torch.where(j < kept_t, (start + j) % S,
                        S + torch.clamp(j - kept_t, 0, Sc - 1))
    return {"kv_offset": torch.tensor(kept, dtype=torch.int32,
                                      device=device), "index": index}


def attn_prefill_cached(p, x, positions, cfg: ModelConfig, kind: str,
                        cache_k: torch.Tensor, cache_v: torch.Tensor,
                        plan: Dict[str, Any], cross=None):
    """Chunked prefill continuing a cache (the engine's hot path: a KV$ hit
    skips compute because only the chunk's new tokens are processed).

    x: (B, S_c, D) chunk; positions: (B, S_c) absolute, equal to
    ``cache_len[b] + arange(S_c)``; cache_k/cache_v: (B, S, KV, hd) (for
    ``swa`` the ring), written in place at the chunk's positions (``swa``:
    ``pos % S``); plan: ``prefill_plan(kind, cache_len, S_c, S)``.
    ``xattn`` takes ``cross = (xk, xv, enc_out)``: the (B, X, KV, hd)
    cross cache and the encoder's output (B, enc_seq, eD) or None (then
    the cache holds the cross K/V; given, it is written with them).
    Returns y (B, S_c, D)."""
    _check_kind(kind)
    B, Sc, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    S = cache_k.shape[1]
    bidx = torch.arange(B, device=x.device)[:, None]
    if kind in ("attn", "xattn"):
        slot = torch.clamp_max(positions, S - 1).long()
        cache_k[bidx, slot] = k
        cache_v[bidx, slot] = v
        kv_len = plan["kv_len"]
        y = flash_prefill(q, cache_k[:, :kv_len], cache_v[:, :kv_len],
                          plan["kv_offset"], soft_cap=cfg.logit_soft_cap)
    else:
        idx = plan["index"]
        ks = torch.cat([cache_k, k], dim=1)[bidx, idx]
        vs = torch.cat([cache_v, v], dim=1)[bidx, idx]
        y = flash_prefill(q, ks, vs, plan["kv_offset"], cfg.window_size,
                          cfg.logit_soft_cap)
        # the ring keeps the chunk's last S positions
        tail = slice(max(0, Sc - S), Sc)
        slot = (positions[:, tail] % S).long()
        cache_k[bidx, slot] = k[:, tail]
        cache_v[bidx, slot] = v[:, tail]
    y = linear(p["wo"], y.reshape(B, Sc, -1))
    if kind == "xattn":
        xk, xv, enc_out = cross
        eS = cfg.enc_seq
        if enc_out is not None:
            if enc_out.shape[1] != eS:
                raise ValueError(f"enc_out has {enc_out.shape[1]} frames, "
                                 f"the config {eS}")
            nk, nv = cross_kv(p, enc_out, cfg)
            xk[:, :eS] = nk
            xv[:, :eS] = nv
        offs = torch.full((B,), eS, dtype=torch.int32, device=x.device)
        xy = flash_prefill(_cross_q(p, x, cfg), xk[:, :eS], xv[:, :eS], offs,
                           soft_cap=cfg.logit_soft_cap)
        y = y + linear(p["xwo"], xy.reshape(B, Sc, -1))
    return y


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
                block_tables: torch.Tensor, cross=None):
    """One-token decode.  x: (B, 1, D); pos: (B,) absolute position of the
    new token; cache_k/cache_v: (B, S, KV, hd), written in place at
    ``min(pos, S-1)`` (``swa``: the ring, at ``pos % S``); block_tables:
    ``decode_tables(B, S)``.  ``xattn`` takes ``cross = (xk, xv,
    x_tables)``: the (B, X, KV, hd) cross cache and
    ``decode_tables(B, X)``.  Returns y (B, 1, D)."""
    _check_kind(kind)
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k_new, v_new = _qkv(p, x, cfg, pos[:, None])
    S = cache_k.shape[1]
    bidx = torch.arange(B, device=x.device)
    if kind in ("attn", "xattn"):
        slot = torch.clamp_max(pos, S - 1).long()
    else:
        slot = (pos % S).long()
    cache_k[bidx, slot] = k_new[:, 0]
    cache_v[bidx, slot] = v_new[:, 0]
    pages = (B * S // DECODE_PAGE, DECODE_PAGE, KV, hd)
    ctx = (torch.clamp_max(pos, S - 1) + 1).to(torch.int32)
    y = paged_attention(q[:, 0], cache_k.view(pages), cache_v.view(pages),
                        block_tables, ctx, cfg.logit_soft_cap)
    y = linear(p["wo"], y.reshape(B, 1, H * hd))
    if kind == "xattn":
        xk, xv, x_tables = cross
        xpages = (B * xk.shape[1] // DECODE_PAGE, DECODE_PAGE, KV, hd)
        xctx = torch.full((B,), cfg.enc_seq, dtype=torch.int32,
                          device=x.device)
        xy = paged_attention(_cross_q(p, x, cfg)[:, 0], xk.view(xpages),
                             xv.view(xpages), x_tables, xctx,
                             cfg.logit_soft_cap)
        y = y + linear(p["xwo"], xy.reshape(B, 1, H * hd))
    return y
