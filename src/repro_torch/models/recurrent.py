"""Recurrent blocks: RG-LRU (Griffin/RecurrentGemma), mLSTM and sLSTM
(xLSTM) — port of ``repro.models.recurrent``.

Each block has ``*_prefill`` (a whole chunk from an optional state),
``*_decode`` (one token) and ``*_init_state``.  States are fixed-size
dicts of float32 tensors, batch-major:

* RG-LRU: ``{"h": (B, dr), "conv": (B, cw-1, dr)}``;
* mLSTM: ``{"C": (B, H, hd, hd), "n": (B, H, hd), "m": (B, H)}``;
* sLSTM: ``{"c", "n", "m", "h"}``, each ``(B, D)``.

The prefills run through the port's kernels: ``rglru_prefill`` calls
``kernels.rglru_scan`` with ``h0`` taken from the state (the reference
folds ``h0`` in as a virtual step 0 of an associative scan; the function
is the same), and ``mlstm_prefill`` pads and chunks as the reference does
and calls ``kernels.mlstm_cell.mlstm_chunk`` once per chunk.  ``plain=True``
runs the kernels' plain versions instead (the model's plain full
forward, which the engine path is held against).  The decode steps and
the whole of sLSTM are plain PyTorch, as the reference computes them
outside any Pallas kernel.

Initialisers draw from an explicit ``torch.Generator`` with the
reference's distributions.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels.mlstm_cell import mlstm_chunk, mlstm_chunk_plain
from ..kernels.rglru_scan import rglru_scan, rglru_scan_plain
from .config import ModelConfig
from .layers import _dense_init, _gelu, init_linear, linear, source

MLSTM_CHUNK = 256
RGLRU_C = 8.0  # Griffin's fixed recurrence-gate exponent
NEG_INF = -1e30

State = Dict[str, torch.Tensor]


# ===========================================================================
# RG-LRU
# ===========================================================================

def init_rglru(gen: torch.Generator, cfg: ModelConfig):
    D, dr, cw = cfg.d_model, cfg.resolved_d_rnn, cfg.conv_width
    dtype = getattr(torch, cfg.dtype)
    dev = gen.device
    # Λ init so that a = sigmoid(Λ)^c is in (0.9, 0.999) — griffin-style
    u = torch.rand((dr,), generator=source(gen), dtype=torch.float32,
                   device=dev) * (0.999 - 0.9) + 0.9
    root = u ** (1.0 / RGLRU_C)
    lam = torch.log(root / (1 - root))
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "wx": init_linear(gen, D, dr, dtype),
        "wgate": init_linear(gen, D, dr, dtype),
        "conv": _dense_init(gen, (cw, dr), dtype, 1.0 / math.sqrt(cw)),
        "wo": init_linear(gen, dr, D, dtype),
        "lambda": lam,
        "wa": _dense_init(gen, (dr,), torch.float32, 1.0),
        "ba": torch.zeros((dr,), **f32),
        "wi": torch.ones((dr,), **f32),
        "bi": torch.zeros((dr,), **f32),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv.  x: (B, S, dr), w: (cw, dr), state:
    (B, cw-1, dr) (stored f32, consumed in x's dtype).  Returns (out, new
    conv state in x's dtype)."""
    cw = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + S] * w[i]
    return out, xp[:, xp.shape[1] - (cw - 1):]


def _rglru_gates(p, u):
    """u: conv output (..., dr) -> (a, gated input), both f32."""
    uf = u.float()
    r = torch.sigmoid(uf * p["wa"] + p["ba"])
    i = torch.sigmoid(uf * p["wi"] + p["bi"])
    log_a = -RGLRU_C * r * F.softplus(p["lambda"])  # log sigmoid(Λ)^(c·r)
    a = torch.exp(log_a)
    x_in = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                      1e-12)) * (i * uf)
    return a, x_in


def rglru_prefill(p, x, cfg: ModelConfig, state: Optional[State] = None,
                  plain: bool = False):
    """x: (B, S, D) -> (y, new_state); ``rglru_scan`` from ``state["h"]``
    (zeros without a state)."""
    B, S, D = x.shape
    gate = _gelu(linear(p["wgate"], x))
    u = linear(p["wx"], x)
    u, conv_state = _causal_conv(u, p["conv"],
                                 None if state is None else state["conv"])
    a, x_in = _rglru_gates(p, u)                         # (B, S, dr) f32
    h0 = (torch.zeros((B, a.shape[-1]), dtype=torch.float32,
                      device=x.device) if state is None
          else state["h"].float())
    scan = rglru_scan_plain if plain else rglru_scan
    h, h_last = scan(a.contiguous(), x_in.contiguous(), h0.contiguous())
    y = linear(p["wo"], (gate.float() * h).to(x.dtype))
    return y, {"h": h_last, "conv": conv_state.float()}


def rglru_decode(p, x, state: State, cfg: ModelConfig):
    """x: (B, 1, D), state {'h': (B, dr), 'conv': (B, cw-1, dr)} ->
    (y, new_state)."""
    gate = _gelu(linear(p["wgate"], x))
    u = linear(p["wx"], x)
    u, conv_state = _causal_conv(u, p["conv"], state["conv"])
    a, x_in = _rglru_gates(p, u)
    h = a[:, 0] * state["h"].float() + x_in[:, 0]
    y = linear(p["wo"], (gate.float() * h[:, None]).to(x.dtype))
    return y, {"h": h, "conv": conv_state.float()}


def rglru_init_state(B: int, cfg: ModelConfig, device) -> State:
    dr, cw = cfg.resolved_d_rnn, cfg.conv_width
    return {"h": torch.zeros((B, dr), dtype=torch.float32, device=device),
            "conv": torch.zeros((B, cw - 1, dr), dtype=torch.float32,
                                device=device)}


# ===========================================================================
# mLSTM (matrix memory, chunkwise-parallel prefill)
# ===========================================================================

def init_mlstm(gen: torch.Generator, cfg: ModelConfig):
    D, H = cfg.d_model, cfg.n_heads
    di = 2 * D
    dtype = getattr(torch, cfg.dtype)
    return {
        "up": init_linear(gen, D, 2 * di, dtype),     # -> (x_m, z)
        "wq": init_linear(gen, di, di, dtype),
        "wk": init_linear(gen, di, di, dtype),
        "down": init_linear(gen, di, D, dtype),
        "wif": _dense_init(gen, (di, 2 * H), torch.float32, 0.01),
        "bif": torch.cat([torch.zeros((H,), device=gen.device),
                          torch.full((H,), 3.0, device=gen.device)]),
    }


def _mlstm_qkvif(p, x, cfg: ModelConfig):
    B, S, D = x.shape
    H = cfg.n_heads
    di = 2 * D
    hd = di // H
    up = linear(p["up"], x)
    x_m, z = up.chunk(2, dim=-1)
    q = linear(p["wq"], x_m).reshape(B, S, H, hd)
    k = linear(p["wk"], x_m).reshape(B, S, H, hd) / math.sqrt(hd)
    v = x_m.reshape(B, S, H, hd)
    gates = x_m.float() @ p["wif"] + p["bif"]
    ilog = gates[..., :H]                                    # (B, S, H)
    flog = F.logsigmoid(gates[..., H:])                      # (B, S, H)
    return q, k, v, ilog, flog, z


def mlstm_prefill(p, x, cfg: ModelConfig, state: Optional[State] = None,
                  chunk: int = MLSTM_CHUNK, plain: bool = False):
    """Chunkwise-parallel mLSTM.  x: (B, S, D) -> (y, new_state): one
    ``mlstm_chunk`` per chunk of ``L = min(chunk, S)`` positions, the last
    one padded with zero q/k/v, ``ilog = -1e30`` and ``flog = 0``."""
    B, S, D = x.shape
    H = cfg.n_heads
    di = 2 * D
    hd = di // H
    q, k, v, ilog, flog, z = _mlstm_qkvif(p, x, cfg)
    L = min(chunk, S)
    nchunk = (S + L - 1) // L
    pad = nchunk * L - S
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        ilog = F.pad(ilog, (0, 0, 0, pad), value=NEG_INF)  # i=0 for padding
        flog = F.pad(flog, (0, 0, 0, pad))
    if state is None:
        st = mlstm_init_state(B, cfg, x.device)
        C, n, m = st["C"], st["n"], st["m"]
    else:
        C, n, m = state["C"], state["n"], state["m"]
    cell = mlstm_chunk_plain if plain else mlstm_chunk
    hs = []
    for c in range(nchunk):
        sl = slice(c * L, (c + 1) * L)
        h, (C, n, m) = cell(q[:, sl].contiguous(), k[:, sl].contiguous(),
                            v[:, sl].contiguous(), ilog[:, sl].contiguous(),
                            flog[:, sl].contiguous(), C.contiguous(),
                            n.contiguous(), m.contiguous())
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(B, nchunk * L, di)[:, :S]
    y = linear(p["down"], h.to(x.dtype) * F.silu(z))
    return y, {"C": C, "n": n, "m": m}


def mlstm_decode(p, x, state: State, cfg: ModelConfig):
    """x: (B, 1, D) -> (y, new_state)."""
    B = x.shape[0]
    q, k, v, ilog, flog, z = _mlstm_qkvif(p, x, cfg)
    qf, kf, vf = (t[:, 0].float() for t in (q, k, v))
    i0, f0 = ilog[:, 0], flog[:, 0]                          # (B, H)
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(f0 + m, i0)
    w_old = torch.exp(f0 + m - m_new)[..., None]
    w_in = torch.exp(i0 - m_new)[..., None]
    C = C * w_old[..., None] + (w_in[..., None]
                                * kf[..., :, None] * vf[..., None, :])
    n = n * w_old + w_in * kf
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, 1, -1)
    y = linear(p["down"], h.to(x.dtype) * F.silu(z))
    return y, {"C": C, "n": n, "m": m_new}


def mlstm_init_state(B: int, cfg: ModelConfig, device) -> State:
    H = cfg.n_heads
    hd = 2 * cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((B, H, hd, hd), **f32),
            "n": torch.zeros((B, H, hd), **f32),
            "m": torch.full((B, H), NEG_INF, **f32)}


# ===========================================================================
# sLSTM (scalar memory, true recurrence -> stepwise loop)
# ===========================================================================

def init_slstm(gen: torch.Generator, cfg: ModelConfig):
    D, H = cfg.d_model, cfg.n_heads
    hd = D // H
    dtype = getattr(torch, cfg.dtype)
    return {
        "wx": init_linear(gen, D, 4 * D, dtype),                # z,i,f,o
        "r": _dense_init(gen, (4, H, hd, hd), dtype,
                         1.0 / math.sqrt(hd)),                  # recurrent
        "b": torch.zeros((4 * D,), dtype=torch.float32, device=gen.device),
    }


def _slstm_step(p, cfg: ModelConfig, carry, xw):
    """carry: (c, n, m, h) each (B, D) f32; xw: precomputed W x_t (B, 4D)."""
    c, n, m, h = carry
    B, D = h.shape
    H = cfg.n_heads
    hd = D // H
    hh = h.reshape(B, H, hd)
    rec = torch.einsum("bhd,ghde->bghe", hh.float(),
                       p["r"].float()).reshape(B, 4 * D)
    pre = xw.float() + rec + p["b"]
    zp, ip, fp, op = pre.chunk(4, dim=-1)
    zt = torch.tanh(zp)
    ilog = ip
    flog = F.logsigmoid(fp)
    m_new = torch.maximum(flog + m, ilog)
    iw = torch.exp(ilog - m_new)
    fw = torch.exp(flog + m - m_new)
    c_new = fw * c + iw * zt
    n_new = fw * n + iw
    h_new = torch.sigmoid(op) * c_new / torch.clamp_min(n_new, 1e-6)
    return (c_new, n_new, m_new, h_new), h_new


def slstm_prefill(p, x, cfg: ModelConfig, state: Optional[State] = None):
    B, S, D = x.shape
    xw = linear(p["wx"], x)                                  # (B, S, 4D)
    if state is None:
        state = slstm_init_state(B, cfg, x.device)
    carry = (state["c"], state["n"], state["m"], state["h"])
    hs = []
    for t in range(S):
        carry, h = _slstm_step(p, cfg, carry, xw[:, t])
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)
    c, n, m, h = carry
    return y, {"c": c, "n": n, "m": m, "h": h}


def slstm_decode(p, x, state: State, cfg: ModelConfig):
    xw = linear(p["wx"], x)[:, 0]
    carry = (state["c"], state["n"], state["m"], state["h"])
    carry, h = _slstm_step(p, cfg, carry, xw)
    c, n, m, hh = carry
    return h[:, None].to(x.dtype), {"c": c, "n": n, "m": m, "h": hh}


def slstm_init_state(B: int, cfg: ModelConfig, device) -> State:
    D = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((B, D), **f32), "n": torch.zeros((B, D), **f32),
            "m": torch.full((B, D), NEG_INF, **f32),
            "h": torch.zeros((B, D), **f32)}
