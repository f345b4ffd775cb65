"""Scheduling policies (paper §4–§5) — port of ``repro.core.policies``.

Every policy is "filter → score → select_min" over the indicator
factory.  Scoring is vectorized numpy over the factory's indicator
arrays and the ``hits_for`` hit vector, with the exact operation order
of the reference, so host decisions are bit-identical to it.

  JSQPolicy          vLLM-v1 default             (Fig. 6a)
  LinearKVPolicy     BAILIAN linear combination  (Fig. 6b)
  FilterKVPolicy     AIBrix filter-based         (Fig. 13)
  LMetricPolicy      THE PAPER: P-token × BS     (Fig. 17b)

Batch routing: ``plan_submit``/``plan_collect`` are the score stage of
``Router.route_batch`` — the fused sequential-argmin-with-feedback loop
of ``repro_torch.kernels.route_score`` over the factory's device mirror.
``batch_supported`` is False (host fallback: the router routes the wave
sequentially, with the same decisions) for an ``exact_only`` factory
and while any instance is masked out by ``alive``.

Not ported yet: the simulator-based, Dynamo, Preble, PolyServe,
session-affinity and route-then-balance policies, LMetric's "cost" load
indicator and its hotspot detector.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..kernels import route_score
from .indicators import IndicatorFactory
from .types import Request

_EPS = 1e-9


class Policy:
    name = "base"
    requires_kv = True
    #: route_score kind for device batch planning; None = host fallback
    batch_kind: Optional[str] = None
    #: whether the device kind scores KV$ hits (False skips the wave's
    #: aggregated-index walks and LCP matrix entirely)
    batch_needs_kv = True

    def __init__(self):
        # round-robin tie counter: a plain int so plan_submit can *peek*
        # (device plans consume one value per committed decision, and a
        # mid-wave fallback must resume exactly where sequential routing
        # would be)
        self._tie_n = 0
        # failed-instance mask: None while the whole fleet is alive, else
        # a boolean (n,) array that _select_min intersects every
        # candidate set with
        self.alive: Optional[np.ndarray] = None

    def _next_tie(self) -> int:
        r = self._tie_n
        self._tie_n = r + 1
        return r

    def _select_min(self, scores, allowed=None) -> int:
        """Vectorized argmin with epsilon-tie round-robin: minimum over
        the allowed indices, ties within ``_EPS``, round-robin among ties
        via the per-policy counter.  While instances are failed,
        candidates are intersected with the live set; a candidate set
        that is entirely dead falls back to all live instances."""
        s = np.asarray(scores)
        if self.alive is not None:
            live = np.flatnonzero(self.alive)
            if allowed is None:
                allowed = live
            else:
                a = np.asarray(allowed)
                a = a[self.alive[a]]
                allowed = a if len(a) else live
        if allowed is None:
            best = s.min()
            ties = np.flatnonzero(s <= best + _EPS)
        else:
            a = np.asarray(allowed)
            sub = s[a]
            best = sub.min()
            ties = a[sub <= best + _EPS]
        return int(ties[self._next_tie() % len(ties)])

    def route(self, req: Request, factory: IndicatorFactory,
              now: float) -> int:
        raise NotImplementedError

    # ---- batch APIs ------------------------------------------------------
    def _batch_params(self) -> tuple:
        """Static parameters of the device wave loop."""
        return ()

    def batch_supported(self, factory: IndicatorFactory) -> bool:
        """Whether this policy can plan waves on the device against this
        factory.  Off while any instance is failed: the fused kernel has
        no mask input, so the host path carries ``self.alive``."""
        return self.batch_kind is not None and factory._agg is not None \
            and self.alive is None

    def wave_inputs(self, reqs: Sequence[Request],
                    factory: IndicatorFactory):
        """The (depth, lcp, plen) triple the device plan consumes — real
        aggregated-index walks for KV$-aware kinds; for KV$-unaware kinds
        no walk and no matrices (depth and lcp are None: the kernel
        scores no hits)."""
        if self.batch_needs_kv:
            return factory.wave_inputs(reqs)
        return None, None, self._plens(reqs)

    def plan_submit(self, wave, factory: IndicatorFactory):
        """Score-stage dispatch: start the fused device loop over the
        wave inputs and the factory's device mirror; returns a
        ``route_score`` handle."""
        depth, lcp, plen = wave
        rbs, qbs, qpt, tt = factory.device_view()
        return route_score.route_wave_submit(
            self.batch_kind, self._batch_params(), factory.block_size,
            rbs, qbs, qpt, tt, depth, lcp, plen, self._tie_n)

    @staticmethod
    def plan_collect(handle):
        return route_score.route_wave_collect(handle)

    def plan_batch(self, reqs: Sequence[Request],
                   factory: IndicatorFactory, now: float):
        """Plan a wave's assignments on the device; None => host
        fallback.  Returns (decisions (k,), predicted hit tokens (k,)),
        bit-identical to k sequential ``route`` calls as long as no KV$
        eviction fires mid-wave.  The tie counter is only *read* here —
        the router consumes one value per committed decision."""
        if not self.batch_supported(factory):
            return None
        return self.plan_collect(self.plan_submit(
            self.wave_inputs(reqs, factory), factory))

    def scores_batch(self, reqs: Sequence[Request],
                     factory: IndicatorFactory, now: float) -> np.ndarray:
        """(k, n) score matrix against the current frozen state."""
        raise NotImplementedError

    def on_finish(self, iid: int, req: Request):
        """Response-piggyback hook: stateful policies observe
        completions here."""

    # ---- instance churn --------------------------------------------------
    def on_instance_failed(self, iid: int, n: int):
        """Mask ``iid`` out of every future candidate set."""
        if self.alive is None:
            self.alive = np.ones(n, dtype=bool)
        self.alive[iid] = False

    def on_instance_recovered(self, iid: int):
        """Readmit ``iid``; a fully recovered fleet drops the mask so the
        device path resumes."""
        if self.alive is not None:
            self.alive[iid] = True
            if bool(self.alive.all()):
                self.alive = None

    @staticmethod
    def _hits_matrix(reqs, factory) -> np.ndarray:
        """(k, n) hit-token matrix (one aggregated walk per unique
        prompt; per-instance walks on exact_only factories)."""
        if factory._agg is not None:
            depth, _, plen = factory.wave_inputs(reqs, with_lcp=False)
            return np.minimum(depth * factory.block_size, plen[:, None])
        return np.stack([factory.hits_for(r) for r in reqs])

    @staticmethod
    def _plens(reqs) -> np.ndarray:
        return np.fromiter((r.prompt_len for r in reqs), np.int64,
                           len(reqs))

    def describe(self) -> str:
        return self.name


# ---------------------------------------------------------------------------
class JSQPolicy(Policy):
    """vLLM-v1: score = 4*Q-BS + R-BS (Fig. 6a). KV$-unaware."""
    name = "vllm"
    requires_kv = False
    batch_kind = "jsq"
    batch_needs_kv = False

    def route(self, req, factory, now):
        scores = 4.0 * factory.q_bs + factory.r_bs
        return self._select_min(scores)

    def scores_batch(self, reqs, factory, now):
        # request-independent: every wave row sees the same queue state
        return np.tile(4.0 * factory.q_bs + factory.r_bs, (len(reqs), 1))


# ---------------------------------------------------------------------------
class LinearKVPolicy(Policy):
    """BAILIAN: λ·(1 − kv_hit_ratio) + (1−λ)·norm(BS) (Fig. 6b)."""
    name = "linear"
    batch_kind = "linear"

    def __init__(self, lam: float = 0.7):
        super().__init__()
        self.lam = lam
        self.name = f"linear(λ={lam})"

    def _batch_params(self):
        return (self.lam,)

    def route(self, req, factory, now):
        hits = factory.hits_for(req)
        bs = factory.bs_vector()
        max_bs = max(int(bs.max()), 1)
        L = max(req.prompt_len, 1)
        scores = self.lam * (1.0 - hits / L) \
            + (1.0 - self.lam) * (bs / max_bs)
        return self._select_min(scores)

    def scores_batch(self, reqs, factory, now):
        hits = self._hits_matrix(reqs, factory)
        bs = factory.bs_vector()
        max_bs = max(int(bs.max()), 1)
        L = np.maximum(self._plens(reqs), 1)[:, None]
        return self.lam * (1.0 - hits / L) \
            + (1.0 - self.lam) * (bs / max_bs)


# ---------------------------------------------------------------------------
class FilterKVPolicy(Policy):
    """AIBrix prefix-cache policy (Fig. 13)."""
    name = "filter"
    batch_kind = "filter"

    def __init__(self, bs_range: int = 8):
        super().__init__()
        self.bs_range = bs_range
        self.name = f"filter(range={bs_range})"

    def _batch_params(self):
        return (self.bs_range,)

    def route(self, req, factory, now):
        bss = factory.bs_vector()
        if int(bss.max()) - int(bss.min()) > self.bs_range:  # load balance
            return self._select_min(bss)
        hits = factory.hits_for(req)                         # KV$-awareness
        cand = np.flatnonzero(hits >= hits.max())
        return self._select_min(bss, allowed=cand)

    def scores_batch(self, reqs, factory, now):
        # both branches minimise BS (the KV$ branch just restricts the
        # candidates); the monitoring matrix is the BS row per request
        return np.tile(factory.bs_vector().astype(float),
                       (len(reqs), 1))


# ---------------------------------------------------------------------------
class LMetricPolicy(Policy):
    """THE PAPER (Fig. 17b):  route to argmin  P-token_i × (BS_i + 1).

    kv_indicator:   "ptoken" (paper) | "one_minus_hit" (§5.1 ablation)
    load_indicator: "bs" (paper) | "tokens" (§5.1 ablation)

    Every combination plans waves on the device.  The reference's "cost"
    load indicator and its §5.2 hotspot detector are not ported yet and
    raise ``NotImplementedError``.
    """
    name = "lmetric"
    batch_kind = "lmetric"

    def __init__(self, kv_indicator: str = "ptoken",
                 load_indicator: str = "bs", detector=None,
                 latency_model=None):
        super().__init__()
        if detector is not None:
            raise NotImplementedError(
                "the hotspot detector is not ported to repro_torch yet")
        if load_indicator == "cost" or latency_model is not None:
            raise NotImplementedError(
                "the 'cost' load indicator is not ported to repro_torch yet")
        if kv_indicator not in ("ptoken", "one_minus_hit"):
            raise ValueError(f"kv_indicator {kv_indicator!r}")
        if load_indicator not in ("bs", "tokens"):
            raise ValueError(f"load_indicator {load_indicator!r}")
        self.kv_indicator = kv_indicator
        self.load_indicator = load_indicator
        if kv_indicator == "ptoken" and load_indicator == "bs":
            self.name = "lmetric"
        else:
            self.name = f"lmetric[{kv_indicator}×{load_indicator}]"

    def scores(self, req, factory, hits):
        hits = np.asarray(hits)
        L = max(req.prompt_len, 1)
        if self.kv_indicator == "ptoken":
            a = factory.p_tokens_for(req, hits) + 1.0
        else:
            a = 1.0 - hits / L + 1e-3
        if self.load_indicator == "bs":
            b = factory.bs_vector() + 1.0
        else:
            b = factory.total_tokens + 1.0
        return a * b

    def _batch_params(self):
        return (self.kv_indicator, self.load_indicator)

    def scores_batch(self, reqs, factory, now):
        hits = self._hits_matrix(reqs, factory)
        plens = self._plens(reqs)
        L = np.maximum(plens, 1)[:, None]
        if self.kv_indicator == "ptoken":
            a = (factory.queued_prefill_tokens
                 + (plens[:, None] - hits)) + 1.0
        else:
            a = 1.0 - hits / L + 1e-3
        if self.load_indicator == "bs":
            b = factory.bs_vector() + 1.0
        else:
            b = factory.total_tokens + 1.0
        return a * b

    def route(self, req, factory, now):
        hits = factory.hits_for(req)
        return self._select_min(self.scores(req, factory, hits))


_NOT_PORTED = ("dynamo", "llm-d", "simulation", "preble", "polyserve",
               "session-affinity", "smetric", "affinity",
               "route-then-balance", "rtb")


def make_policy(name: str, **kw) -> Policy:
    name = name.lower()
    if name in ("vllm", "jsq"):
        return JSQPolicy()
    if name in ("linear", "bailian"):
        return LinearKVPolicy(**kw)
    if name in ("filter", "aibrix"):
        return FilterKVPolicy(**kw)
    if name == "lmetric":
        return LMetricPolicy(**kw)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"policy {name!r} is not ported to repro_torch yet")
    raise KeyError(name)
