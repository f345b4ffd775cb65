"""Primitive layers — port of ``repro.models.layers``: linear, norms, RoPE,
dense FFNs, embedding and their initialisers.

Parameters are plain nested dicts of tensors, in the reference's layouts
(a linear weight is ``(d_in, d_out)`` and applies as ``x @ w``), so the
reference's parameters carry over as copies (``models.convert``).
Initialisers draw from an explicit ``torch.Generator`` with the
reference's distributions; the numbers differ from ``jax.random``'s, so
parity tests convert the reference's parameters instead.  MoE is not
ported (ROADMAP Queue A).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def _dense_init(gen: torch.Generator, shape, dtype, scale=None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
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


def init_embed(gen, vocab, d_model, dtype) -> Params:
    return {"w": _dense_init(gen, (vocab, d_model), dtype, 0.02)}


def embed_apply(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), p["w"])
