"""Model configuration — port of ``repro.models.config``.

A model is a sequence of *blocks* drawn from a small vocabulary of block
kinds, compiled into a *repeating unit* (``repeating_unit``) — the layout
of the reference's stacked parameters, which ``models.convert`` unstacks.
The dataclass keeps every field of the reference so a configuration is
the same object in both packages.

Block kinds: ``attn`` (full causal GQA attention + FFN), ``swa``
(sliding-window attention over a ring-buffer cache + FFN), ``rglru``
(Griffin's RG-LRU + FFN), ``mlstm`` / ``slstm`` (xLSTM), ``xattn``
(Whisper's decoder block: causal self-attention, cross-attention over
the encoder's output, FFN).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

BLOCK_KINDS = ("attn", "swa", "rglru", "mlstm", "slstm", "xattn")

# Block kinds that keep a KV cache (per-position key/value state).
KV_BLOCKS = ("attn", "swa", "xattn")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[str, ...]      # one kind per layer
    head_dim: int = 0                   # 0 -> d_model // n_heads
    # --- FFN / MoE ---
    ffn_act: str = "swiglu"             # swiglu | geglu | gelu
    n_experts: int = 0                  # 0 -> dense FFN
    top_k: int = 0
    moe_d_ff: int = 0                   # 0 -> d_ff
    dense_residual_d_ff: int = 0        # arctic: parallel dense FFN next to MoE
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01       # load-balance auxiliary loss weight
    # --- attention details ---
    qk_norm: bool = False               # qwen3
    rope_theta: float = 10000.0
    use_rope: bool = True               # whisper uses learned positions
    window_size: int = 4096             # for "swa" blocks (recurrentgemma: 2048)
    logit_soft_cap: float = 0.0
    # --- recurrent details ---
    d_rnn: int = 0                      # RG-LRU recurrence width (0 -> d_model)
    conv_width: int = 4
    # --- norms / embeddings ---
    norm_type: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scale_embed: bool = False           # gemma-style sqrt(d) embedding scale
    max_position: int = 1 << 20         # learned-position table (whisper only)
    # --- encoder (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 0                    # number of (stub-frontend) audio frames
    enc_d_model: int = 0
    # --- vlm (paligemma) ---
    n_patches: int = 0                  # stub SigLIP patch embeddings
    # --- dtypes ---
    dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    # --- training ---
    lr_schedule: str = "cosine"         # cosine | wsd (minicpm)
    # --- provenance ---
    source: str = ""

    def __post_init__(self):
        if len(self.block_pattern) != self.n_layers:
            raise ValueError(f"{self.name}: pattern len "
                             f"{len(self.block_pattern)} != n_layers "
                             f"{self.n_layers}")
        for k in self.block_pattern:
            if k not in BLOCK_KINDS:
                raise ValueError(f"{self.name}: unknown block kind {k!r}")

    # ------------------------------------------------------------------
    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to a multiple of 16, the embedding and lm-head
        width of the reference's parameters.  I/O stays at
        ``vocab_size``."""
        return -(-self.vocab_size // 16) * 16

    @property
    def resolved_d_rnn(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def has_kv_blocks(self) -> bool:
        return any(k in KV_BLOCKS for k in self.block_pattern)

    @property
    def full_attention(self) -> bool:
        """True if any block is full (unwindowed) attention -> quadratic."""
        return any(k in ("attn", "xattn") for k in self.block_pattern)

    def supports_long_decode(self) -> bool:
        """sub-quadratic decode: no full-attention block, or enc-dec skip."""
        return not self.full_attention

    # ------------------------------------------------------------------
    def repeating_unit(self) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
        """Return (unit, n_units, remainder) with pattern == unit*n + rem."""
        p = self.block_pattern
        for ulen in range(1, len(p) + 1):
            unit = p[:ulen]
            n = len(p) // ulen
            rem = p[n * ulen:]
            ok = all(p[i] == unit[i % ulen] for i in range(n * ulen))
            ok = ok and all(rem[i] == unit[i] for i in range(len(rem)))
            if ok:
                return unit, n, rem
        return p, 1, ()

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        D, H, KV = self.d_model, self.n_heads, self.n_kv_heads
        hd = self.resolved_head_dim
        F, V = self.d_ff, self.vocab_size
        moe_d_ff = self.moe_d_ff or self.d_ff
        total = V * D                              # embed
        if not self.tie_embeddings:
            total += V * D
        n_ffn_mats = 3 if self.ffn_act in ("swiglu", "geglu") else 2
        for kind in self.block_pattern:
            if kind in ("attn", "swa", "xattn"):
                attn = D * H * hd + 2 * D * KV * hd + H * hd * D
                if kind == "xattn":
                    attn *= 2                      # self + cross
                total += attn
                if self.n_experts:
                    total += self.n_experts * n_ffn_mats * D * moe_d_ff
                    total += D * self.n_experts    # router
                    if self.dense_residual_d_ff:
                        total += n_ffn_mats * D * self.dense_residual_d_ff
                else:
                    total += n_ffn_mats * D * F
            elif kind == "rglru":
                dr = self.resolved_d_rnn
                total += 2 * D * dr + dr * D + dr * self.conv_width + 3 * dr
                total += n_ffn_mats * D * F
            elif kind == "mlstm":
                di = 2 * D
                # up (D,2di) + wq,wk (di,di) + down (di,D) + gates (di,2H)
                total += D * 2 * di + 2 * di * di + di * D + di * 2 * H
            elif kind == "slstm":
                total += 4 * D * D + 4 * D * D + n_ffn_mats * D * (4 * D // 3)
        if self.enc_layers:
            eD = self.enc_d_model or D
            enc_attn = 4 * eD * eD
            total += self.enc_layers * (enc_attn + 2 * eD * 4 * eD)
        return total

    def active_param_count(self) -> int:
        """Params active per token (MoE: top_k experts only)."""
        if not self.n_experts:
            return self.param_count()
        n_ffn_mats = 3 if self.ffn_act in ("swiglu", "geglu") else 2
        moe_layers = sum(1 for k in self.block_pattern if k in ("attn", "swa"))
        inactive = (self.n_experts - self.top_k) * n_ffn_mats * \
            self.d_model * (self.moe_d_ff or self.d_ff) * moe_layers
        return self.param_count() - inactive

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 scan units, d_model<=512, <=4 experts."""
        unit, _, _ = self.repeating_unit()
        n_layers = min(self.n_layers, max(2, len(unit)))
        pattern = tuple(unit[i % len(unit)] for i in range(n_layers))
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            block_pattern=pattern,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            moe_d_ff=min(self.resolved_moe_d_ff, 256) if self.n_experts else 0,
            dense_residual_d_ff=min(self.dense_residual_d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            d_rnn=min(self.d_rnn or self.d_model, 256),
            window_size=min(self.window_size, 64),
            enc_layers=min(self.enc_layers, 2),
            enc_seq=min(self.enc_seq, 32) if self.enc_seq else 0,
            enc_d_model=min(self.enc_d_model, 256) if self.enc_d_model else 0,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            max_position=4096,
        )

    def with_sliding_window(self, window: int = 4096) -> "ModelConfig":
        """The sliding-window variant: every ``attn`` block becomes
        ``swa`` with ``window``."""
        pattern = tuple("swa" if k == "attn" else k for k in self.block_pattern)
        return dataclasses.replace(
            self, name=self.name + "-swa", block_pattern=pattern,
            window_size=window)


def dense_pattern(n: int) -> Tuple[str, ...]:
    return ("attn",) * n


def hybrid_pattern(n: int, unit=("rglru", "rglru", "attn")) -> Tuple[str, ...]:
    return tuple(unit[i % len(unit)] for i in range(n))
