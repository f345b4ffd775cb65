"""Primitive layers — port of ``repro.models.layers``: linear, norms, RoPE,
dense FFNs, the top-k MoE layer, embedding and their initialisers.

Parameters are plain nested dicts of tensors, in the reference's layouts
(a linear weight is ``(d_in, d_out)`` and applies as ``x @ w``), so the
reference's parameters carry over as copies (``models.convert``).
Initialisers draw from an explicit ``torch.Generator`` with the
reference's distributions; the numbers differ from ``jax.random``'s, so
parity tests convert the reference's parameters instead.  ``MetaDraws``
stands in for the generator when a tree is built on the ``meta`` device
(``Model.abstract_params``): shapes and dtypes, nothing drawn or
allocated.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..profiling import span

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

class MetaDraws:
    """The generator of a parameter tree built on the ``meta`` device."""
    device = torch.device("meta")


def source(gen):
    """The ``generator=`` argument of a draw from ``gen``: ``None`` for
    ``MetaDraws``, whose draws on ``meta`` are shapes only."""
    return None if isinstance(gen, MetaDraws) else gen


def _dense_init(gen: torch.Generator, shape, dtype, scale=None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=source(gen), dtype=torch.float32,
                    device=gen.device)
    return (w.mul_(scale)).to(dtype)


def init_linear(gen, d_in, d_out, dtype, scale=None) -> Params:
    return {"w": _dense_init(gen, (d_in, d_out), dtype, scale)}


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"]


def init_norm(d, dtype, device, norm_type="rmsnorm") -> Params:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(p: Params, x: torch.Tensor, eps=1e-6) -> torch.Tensor:
    """RMSNorm (or LayerNorm when ``p`` has a bias), computed in f32 and
    cast back to ``x.dtype``."""
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split-half, not interleaved)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., S, hd/2)
    angles = angles[..., None, :]                             # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense FFN
# ---------------------------------------------------------------------------

def init_ffn(gen, d_model, d_ff, dtype, act="swiglu") -> Dict[str, Params]:
    if act in ("swiglu", "geglu"):
        return {"wi": init_linear(gen, d_model, d_ff, dtype),
                "wg": init_linear(gen, d_model, d_ff, dtype),
                "wo": init_linear(gen, d_ff, d_model, dtype)}
    return {"wi": init_linear(gen, d_model, d_ff, dtype),
            "wo": init_linear(gen, d_ff, d_model, dtype)}


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def ffn_apply(p, x: torch.Tensor, act="swiglu") -> torch.Tensor:
    h = linear(p["wi"], x)
    if act == "swiglu":
        h = F.silu(linear(p["wg"], x)) * h
    elif act == "geglu":
        h = _gelu(linear(p["wg"], x)) * h
    else:
        h = _gelu(h)
    return linear(p["wo"], h)


# ---------------------------------------------------------------------------
# MoE: top-k routing with per-row capacity dispatch
# ---------------------------------------------------------------------------

def init_moe(gen, cfg, dtype) -> Dict[str, Params]:
    """Router (float32, as in the reference), the experts' stacked
    ``wi``/``wg`` ``(E, D, F)`` and ``wo`` ``(E, F, D)``, and Arctic's dense
    residual FFN when ``cfg.dense_residual_d_ff``."""
    D, E, F = cfg.d_model, cfg.n_experts, cfg.resolved_moe_d_ff
    p = {"router": init_linear(gen, D, E, torch.float32),
         "wi": {"w": _dense_init(gen, (E, D, F), dtype)},
         "wg": {"w": _dense_init(gen, (E, D, F), dtype)},
         "wo": {"w": _dense_init(gen, (E, F, D), dtype)}}
    if cfg.dense_residual_d_ff:
        p["dense"] = init_ffn(gen, D, cfg.dense_residual_d_ff, dtype,
                              cfg.ffn_act)
    return p


def moe_capacity(S: int, cfg) -> int:
    """Buffer rows per expert and batch row for a call over ``S`` tokens:
    ``max(ceil(S * K / E * capacity_factor), K)``."""
    K = cfg.top_k
    return max(int(math.ceil(S * K / cfg.n_experts * cfg.capacity_factor)),
               K)


def moe_route(p, x: torch.Tensor, cfg) -> Dict[str, torch.Tensor]:
    """The routing half of ``moe_apply``.  x: (B, S, D).  Returns

    * ``topw`` (B, S, K) f32, the top-k probabilities renormalised over k
      (floor 1e-9), and ``topi`` (B, S, K) their experts, in descending
      order with ties to the lower index (``jax.lax.top_k``'s order);
    * ``keep`` (B, S*K): the (token, k) choice got a buffer row, i.e. its
      place in its expert's buffer — an exclusive count over the
      token-major, then k-major, flattened choices of its row — is below
      the capacity ``cap`` (``moe_capacity``); ``slot`` (B, S*K), its row
      in the row's ``(E*cap + 1)``-row buffer, ``E*cap`` (the drop row)
      when dropped;
    * ``aux``, the Switch-style load-balance loss (a scalar)."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    cap = moe_capacity(S, cfg)
    probs = torch.softmax(x.float() @ p["router"]["w"].float(), dim=-1)
    # a stable descending sort keeps equal probabilities in index order
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :K], topi[..., :K]
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)

    # one-hot choices expert-major, (B, E, S*K), so that the count runs
    # along the innermost axis (a scan along an outer axis is slow on the
    # card); nothing here waits for the device
    eid = topi.reshape(B, S * K)
    sel = eid[:, None, :] == torch.arange(E, device=x.device)[None, :, None]

    me = probs.mean(dim=(0, 1))                                # (E,)
    ce = sel.sum(dim=(0, 2)).float() / (B * S)
    aux = cfg.router_aux_coef * E * (me * ce).sum()

    count = sel.cumsum(dim=-1, dtype=torch.int32)
    pos = count.gather(1, eid[:, None, :])[:, 0] - 1           # (B,S*K)
    keep = pos < cap
    slot = torch.where(keep, eid * cap + pos, E * cap)
    return {"topw": topw, "topi": topi, "keep": keep, "slot": slot,
            "cap": cap, "aux": aux}


def moe_apply(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (B, S, D), aux loss.  The reference's semantics:
    routing per batch row (one row is one group, so rows never displace
    each other's choices), each row's kept choices scattered into its
    ``(E, cap, D)`` buffer, the three expert products over every expert's
    whole buffer, the outputs gathered back, weighted by the routing
    weights cast to the activation dtype and summed over k; plus Arctic's
    dense residual FFN.  Runs inside the profiler range ``model.moe``."""
    with span("model.moe"):
        return _moe_apply(p, x, cfg)


def _moe_apply(p, x: torch.Tensor, cfg):
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    r = moe_route(p, x, cfg)
    cap, slot = r["cap"], r["slot"]
    w = r["topw"].reshape(B, S * K) * r["keep"]
    bidx = torch.arange(B, device=x.device)[:, None]
    # kept slots are distinct within a row, so an assignment into zeros is
    # the reference's scatter-add; only the drop row takes several writes,
    # and it is cut off
    buf = x.new_zeros((B, E * cap + 1, D))
    buf[bidx, slot] = x[:, :, None].expand(B, S, K, D).reshape(B, S * K, D)
    buf = buf[:, :-1].reshape(B, E, cap, D)
    h = torch.einsum("becd,edf->becf", buf, p["wi"]["w"])
    if cfg.ffn_act in ("swiglu", "geglu"):
        g = torch.einsum("becd,edf->becf", buf, p["wg"]["w"])
        h = (F.silu(g) if cfg.ffn_act == "swiglu" else _gelu(g)) * h
    else:
        h = _gelu(h)
    out = torch.einsum("becf,efd->becd", h, p["wo"]["w"])
    out = torch.cat([out.reshape(B, E * cap, D), out.new_zeros((B, 1, D))],
                    dim=1)
    y = (out[bidx, slot] * w[..., None].to(out.dtype)).reshape(
        B, S, K, D).sum(dim=2)
    if "dense" in p:                                  # Arctic's residual
        y = y + ffn_apply(p["dense"], x, cfg.ffn_act)
    return y, r["aux"]


def init_embed(gen, vocab, d_model, dtype) -> Params:
    return {"w": _dense_init(gen, (vocab, d_model), dtype, 0.02)}


def embed_apply(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), p["w"])
