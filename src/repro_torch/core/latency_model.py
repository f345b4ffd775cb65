"""Analytic instance latency model (VIDUR-retrofit, paper §4.6) — port
of ``repro.core.latency_model``.

Serves two roles:

1. **Ground truth** for the discrete-event cluster simulator: the step
   time of a PD-colocated chunked-prefill engine iteration.
2. **Predictor** inside simulation-based policies (llm-d, PolyServe).

Step-time model for a batch of (prefill-chunk tokens P, decode batch D,
resident context C):

    t_step = c0 + c_flops * (P + D) + c_attn * (C * [D > 0] + P / 4) .

``c_flops`` derives from active-parameter FLOPs at the chip's peak
(``EngineSpec.peak_flops``); ``c_attn`` covers KV-bandwidth-bound
attention reads (``EngineSpec.hbm_bw``).  The reference hard-codes its
chip's two rates; here they are fields, and their defaults are the
NVIDIA H100 SXM5 data sheet's (80 GB HBM3, 700 W power limit): 989.4
TFLOP/s dense bf16 and 3.35 TB/s.  Nothing else is fitted to the card:
the per-step overhead and the achievable fraction of peak keep the
reference's defaults.  Every formula keeps the reference's operation
order, so with the reference's rates passed in the floats are
bit-identical.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

#: NVIDIA H100 SXM5 data sheet ("NVIDIA H100 80GB HBM3", 700 W power
#: limit): dense bf16 tensor-core rate and HBM3 rate
H100_PEAK_FLOPS = 989.4e12    # FLOP/s
H100_HBM_BW = 3.35e12         # bytes/s


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    name: str
    active_params: float          # per-token active parameters
    n_layers: int
    kv_bytes_per_token: int       # 2 * n_kv * hd * layers * 2B
    chips: int = 1
    chunk_tokens: int = 2048      # chunked-prefill budget per step
    max_batch: int = 256
    kv_capacity_tokens: int = 500_000
    step_overhead: float = 0.004  # c0: per-step host+launch overhead (s)
    mfu: float = 0.5              # achievable fraction of peak
    peak_flops: float = H100_PEAK_FLOPS   # per chip
    hbm_bw: float = H100_HBM_BW           # per chip

    @property
    def c_flops(self) -> float:
        return 2.0 * self.active_params / (self.peak_flops * self.chips
                                           * self.mfu)

    @property
    def c_attn(self) -> float:
        return self.kv_bytes_per_token / (self.hbm_bw * self.chips)

    @property
    def prefill_token_cost(self) -> float:
        """Marginal step-time cost of one queued prefill token (s/token):
        the prefill terms of ``step_time``, the compute term plus the
        quarter-weighted attention-read term."""
        return self.c_flops + self.c_attn * 0.25


def spec_from_config(cfg, chips: int = 1, **kw) -> EngineSpec:
    kv_layers = sum(1 for k in cfg.block_pattern if k in ("attn", "swa",
                                                          "xattn"))
    kvb = 2 * cfg.n_kv_heads * cfg.resolved_head_dim * kv_layers * 2
    return EngineSpec(
        name=cfg.name,
        active_params=cfg.active_param_count(),
        n_layers=cfg.n_layers,
        kv_bytes_per_token=max(kvb, 64),
        chips=chips,
        **kw)


class LatencyModel:
    def __init__(self, spec: EngineSpec, error_std: float = 0.0,
                 seed: int = 0):
        self.spec = spec
        self.error_std = error_std
        self._rng_state = seed or 1

    # -- deterministic cheap LCG so predictor error is reproducible -------
    # (Python integers, so the draws equal the reference's bit for bit)
    def _noise(self) -> float:
        if not self.error_std:
            return 1.0
        self._rng_state = (self._rng_state * 6364136223846793005 +
                           1442695040888963407) & ((1 << 64) - 1)
        u = (self._rng_state >> 11) / float(1 << 53)
        # lognormal-ish multiplicative error
        return math.exp((u - 0.5) * 2.0 * self.error_std)

    def noise_draws(self, n: int):
        """``n`` successive noise draws as an array (1.0 when disabled).

        Advances the LCG exactly as ``n`` scalar ``_noise()`` calls would,
        so vectorized policies stay bit-compatible with the scalar path.
        """
        if not self.error_std:
            return 1.0
        return np.array([self._noise() for _ in range(n)])

    # ---------------------------------------------------------------------
    def step_time(self, prefill_tokens: int, decode_bs: int,
                  context_tokens: int) -> float:
        s = self.spec
        t = (s.step_overhead
             + s.c_flops * (prefill_tokens + decode_bs)
             + s.c_attn * context_tokens * (1 if decode_bs else 0)
             + s.c_attn * prefill_tokens * 0.25)
        return t

    # ---------------------------------------------------------------------
    def predict_ttft(self, queued_prefill_tokens: int, new_tokens: int,
                     decode_bs: int, context_tokens: int) -> float:
        """Expected TTFT if a request with ``new_tokens`` new prefill tokens
        joins an instance with the given state (chunked prefill interleaved
        with running decodes)."""
        s = self.spec
        todo = queued_prefill_tokens + new_tokens
        steps = max(1, math.ceil(todo / s.chunk_tokens))
        per_step = self.step_time(min(todo, s.chunk_tokens), decode_bs,
                                  context_tokens)
        return steps * per_step * self._noise()

    def predict_tpot(self, decode_bs: int, context_tokens: int,
                     queued_prefill_tokens: int = 0) -> float:
        """Expected per-output-token time at the instance's current load."""
        s = self.spec
        # decode steps share the engine with queued prefill chunks
        prefill_share = min(1.0, queued_prefill_tokens / (4 * s.chunk_tokens))
        t = self.step_time(int(prefill_share * s.chunk_tokens),
                           decode_bs + 1, context_tokens)
        return t * self._noise()

    # ---- vectorized twins (bit-compatible with the scalar path) ---------
    # Each *_batch method evaluates the scalar formula elementwise with the
    # identical operation order, so results match the per-instance loop to
    # the last float bit; noise draws are taken in instance order (pass
    # ``noise`` to control interleaving).

    def step_time_batch(self, prefill_tokens, decode_bs,
                        context_tokens) -> np.ndarray:
        s = self.spec
        decode_bs = np.asarray(decode_bs)
        return (s.step_overhead
                + s.c_flops * (prefill_tokens + decode_bs)
                + s.c_attn * context_tokens * (decode_bs != 0)
                + s.c_attn * prefill_tokens * 0.25)

    def predict_ttft_batch(self, queued_prefill_tokens, new_tokens,
                           decode_bs, context_tokens,
                           noise=None) -> np.ndarray:
        s = self.spec
        todo = np.asarray(queued_prefill_tokens) + new_tokens
        steps = np.maximum(1, np.ceil(todo / s.chunk_tokens))
        per_step = self.step_time_batch(np.minimum(todo, s.chunk_tokens),
                                        decode_bs, context_tokens)
        if noise is None:
            noise = self.noise_draws(len(per_step))
        return steps * per_step * noise

    def predict_tpot_batch(self, decode_bs, context_tokens,
                           queued_prefill_tokens=0,
                           noise=None) -> np.ndarray:
        s = self.spec
        decode_bs = np.asarray(decode_bs)
        prefill_share = np.minimum(
            1.0, np.asarray(queued_prefill_tokens) / (4 * s.chunk_tokens))
        t = self.step_time_batch(
            (prefill_share * s.chunk_tokens).astype(np.int64),
            decode_bs + 1, context_tokens)
        if noise is None:
            noise = self.noise_draws(len(t))
        return t * noise
