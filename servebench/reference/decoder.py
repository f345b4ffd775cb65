"""Plain reference of a decoder-only transformer with grouped-query
attention, as Hugging Face's ``Qwen2ForCausalLM`` and
``Qwen3MoeForCausalLM`` compute it: RMSNorm, split-half RoPE, optional
per-head RMSNorm of q and k (Qwen3), causal softmax attention, a SwiGLU
FFN or a dropless top-k mixture of experts with renormalised weights, a
final RMSNorm and an untied lm-head.

Everything is float32 with TF32 off, one whole sequence at a time, no
cache and no kernel: the forward pass the served tokens are judged by.
It runs layer by layer over all the sequences it is given, converting one
layer's weights to float32 at a time, so that a model whose float32
weights would not fit the card still runs.  It imports nothing of the
program.

The weights are the benchmark's own tensors (``servebench/weights.py``),
in that file's layout: a linear weight is ``(d_in, d_out)``; ``wg``,
``wi`` and ``wo`` are the gate, up and down projections; a MoE layer
holds ``router`` (d, E) and the experts' stacks ``wg``/``wi`` (E, d, F)
and ``wo`` (E, F, d).  Qwen2's q/k/v biases are zero, as Hugging Face
initialises them, and are left out.

``convert(w, kind)`` turns each weight into the float32 tensor used, and
``mm(x, w)`` multiplies activations by a weight; the control passes ones
that round both through float8 (``servebench/check.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch


def plain_f32(w: torch.Tensor, kind: str) -> torch.Tensor:
    return w.float()


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, h, hd); positions 0 .. S-1; rotate_half convention."""
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None]
    x1, x2 = x.chunk(2, -1)
    return x * cos + torch.cat([-x2, x1], -1) * sin


def _attention(x: torch.Tensor, w: Dict, cfg: Dict, mm) -> torch.Tensor:
    S = x.shape[0]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // H
    q = mm(x, w["wq"]).view(S, H, hd)
    k = mm(x, w["wk"]).view(S, KV, hd)
    v = mm(x, w["wv"]).view(S, KV, hd)
    if "q_norm" in w:
        q = _rms(q, w["q_norm"], cfg["rms_norm_eps"])
        k = _rms(k, w["k_norm"], cfg["rms_norm_eps"])
    q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / hd ** 0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return mm(torch.einsum("hqk,khd->qhd", p, v).reshape(S, H * hd), w["wo"])


def _moe(x: torch.Tensor, w: Dict, cfg: Dict, mm) -> torch.Tensor:
    """Dropless top-k: every token's ``num_experts_per_tok`` experts,
    weights renormalised over them (``norm_topk_prob``)."""
    K = cfg["num_experts_per_tok"]
    probs = torch.softmax(mm(x, w["router"]), dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :K], topi[:, :K]
    topw = topw / topw.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in torch.unique(topi).tolist():
        tok, slot = (topi == e).nonzero(as_tuple=True)
        xe = x[tok]
        h = torch.nn.functional.silu(mm(xe, w["wg"][e])) * mm(xe, w["wi"][e])
        out.index_add_(0, tok, mm(h, w["wo"][e]) * topw[tok, slot, None])
    return out


def _ffn(x: torch.Tensor, w: Dict, mm) -> torch.Tensor:
    return mm(torch.nn.functional.silu(mm(x, w["wg"])) * mm(x, w["wi"]),
              w["wo"])


def _layer_weights(p: Dict, convert: Callable) -> Dict:
    a, f = p["attn"], p["ffn"]
    w = {n: convert(a[n]["w"], "linear") for n in ("wq", "wk", "wv", "wo")}
    for n in ("q_norm", "k_norm"):
        if n in a:
            w[n] = a[n]["scale"].float()
    w["norm1"] = p["norm1"]["scale"].float()
    w["norm2"] = p["norm2"]["scale"].float()
    ffn = {n: convert(f[n]["w"], "linear") for n in ("wg", "wi", "wo")}
    if "router" in f:
        ffn["router"] = convert(f["router"]["w"], "linear")
    w["ffn"] = ffn
    return w


@torch.no_grad()
def logits_at(cfg: Dict, params: Dict, seqs: Sequence[torch.Tensor],
              want: Sequence[torch.Tensor],
              convert: Callable = plain_f32,
              mm: Callable = torch.matmul) -> List[torch.Tensor]:
    """Float32 logits over ``vocab_size`` of each sequence at the
    positions ``want[i]`` (the logits predicting token ``pos + 1``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = cfg["rms_norm_eps"]
    emb = convert(params["embed"]["w"], "embed")
    xs = [emb[s] for s in seqs]
    del emb
    lengths = [len(s) for s in seqs]
    for p in params["layers"]:
        w = _layer_weights(p, convert)
        # attention sequence by sequence; the FFN acts on each token alone,
        # so it runs once over all of them
        x = torch.cat([x + _attention(_rms(x, w["norm1"], eps), w, cfg, mm)
                       for x in xs])
        h = _rms(x, w["norm2"], eps)
        x = x + (_moe(h, w["ffn"], cfg, mm) if "router" in w["ffn"]
                 else _ffn(h, w["ffn"], mm))
        xs = list(x.split(lengths))
        del w, x, h
    head = convert(params["lm_head"]["w"], "linear")
    scale = params["final_norm"]["scale"].float()
    V = cfg["vocab_size"]
    return [mm(_rms(x[idx], scale, eps), head)[:, :V]
            for x, idx in zip(xs, want)]
