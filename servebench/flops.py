"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes of each step and each attention launch.

``prefill_bound`` and ``paged_bound`` are frozen copies of
``chip_smoke.py``'s, with the widths passed in; ``step_flops`` follows
``repro_torch.launch.shapes.analytic_flops_at`` (twice the parameters a
token passes through, plus ``4 * hd`` operations per head and key it
attends to), counted per served token so that it reads what a step does
for the requests it serves: a prefill chunk's tokens, with the lm-head on
its last position only, and one token per running request in a decode
step.  The embedding is a row lookup and counts no operations.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

#: NVIDIA H100 SXM data sheet, dense bf16, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
#: NVIDIA H100 SXM data sheet, HBM3
PEAK_HBM_BYTES = 3.35e12


def min_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes at
    the HBM rate and the operations at the bf16 rate."""
    return max(nbytes / PEAK_HBM_BYTES, ops / PEAK_BF16_FLOPS)


def prefill_bound(Sq: int, off: int, H: int, KV: int, hd: int,
                  elt: int = 2) -> Tuple[int, int]:
    """(bytes, operations) of one causal chunk of ``Sq`` queries after
    ``off`` cached keys: q, k, v and out read or written once (k and v
    span ``off + Sq`` keys), and ``4 * hd`` operations per (query row,
    head, key it sees) for QK and PV."""
    Sk = off + Sq
    seen = Sq * off + Sq * (Sq + 1) // 2
    nbytes = elt * (2 * Sq * H * hd + 2 * Sk * KV * hd) + 4
    return nbytes, 4 * hd * H * seen


def paged_bound(ctx: Sequence[int], page: int, H: int, KV: int, hd: int,
                elt: int = 2) -> Tuple[int, int]:
    """(bytes, operations) of one decode launch over contexts ``ctx``:
    the K/V rows in context, q and out, the block-table entries and
    context lengths read once; ``4 * hd`` operations per (head, key in
    context)."""
    B, total = len(ctx), int(sum(ctx))
    pages = int(sum(-(-int(c) // page) for c in ctx))
    nbytes = (elt * 2 * total * KV * hd + elt * 2 * B * H * hd + 4 * pages
              + 4 * B)
    return nbytes, 4 * hd * H * total


def layer_params(m: Dict) -> int:
    """Parameters one token passes through in one decoder layer (the MoE
    layer: the router and ``top_k`` experts)."""
    D, H, KV, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    n = D * H * hd + 2 * D * KV * hd + H * hd * D
    if m["n_experts"]:
        n += D * m["n_experts"] + m["top_k"] * 3 * D * m["expert_d_ff"]
    else:
        n += 3 * D * m["d_ff"]
    return n


def step_flops(m: Dict, kind: str, spans: Sequence[Tuple[int, int]]) -> float:
    """Model operations of one engine step.  ``spans``: (start, n) of each
    served sequence: a prefill chunk of ``n`` tokens after ``start``
    cached ones (lm-head on its last position), or a decode token
    (``n = 1``) at position ``start``."""
    L, H, hd = m["n_layers"], m["n_heads"], m["head_dim"]
    per_tok = 2.0 * L * layer_params(m)
    head = 2.0 * m["d_model"] * m["vocab_size"]
    total = 0.0
    for start, n in spans:
        seen = n * start + n * (n + 1) // 2
        total += per_tok * n + 4.0 * L * H * hd * seen + head
    return total


def model_shape(cfg: Dict) -> Dict:
    """The widths this file needs, from a configuration file's published
    keys."""
    return {
        "n_layers": cfg["num_hidden_layers"],
        "d_model": cfg["hidden_size"],
        "n_heads": cfg["num_attention_heads"],
        "n_kv_heads": cfg["num_key_value_heads"],
        "head_dim": cfg.get("head_dim")
        or cfg["hidden_size"] // cfg["num_attention_heads"],
        "d_ff": cfg["intermediate_size"],
        "n_experts": cfg.get("num_experts", 0),
        "top_k": cfg.get("num_experts_per_tok", 0),
        "expert_d_ff": cfg.get("moe_intermediate_size", 0),
        "vocab_size": cfg["vocab_size"],
    }
