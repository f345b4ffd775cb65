"""Scheduling policies (paper §4–§5) — port of ``repro.core.policies``.

Every policy is "filter → score → select_min" over the indicator
factory.  Scoring is vectorized numpy over the factory's indicator
arrays and the ``hits_for`` hit vector, with the exact operation order
of the reference, so host decisions are bit-identical to it.

  JSQPolicy          vLLM-v1 default             (Fig. 6a)
  LinearKVPolicy     BAILIAN linear combination  (Fig. 6b)
  DynamoPolicy       ai-Dynamo weighted P-token + total-tokens
  FilterKVPolicy     AIBrix filter-based         (Fig. 13)
  SimulationPolicy   llm-d latency-based         (Fig. 14)
  PreblePolicy       hybrid filter + linear      (Fig. 30)
  PolyServePolicy    SLO/utilization packing     (Fig. 33)
  LMetricPolicy      THE PAPER: P-token × BS     (Fig. 17b)
  SessionAffinityPolicy  session-centric baseline: sticky session →
                         instance pins with a load-spread escape valve
  RouteThenBalancePolicy two-layer baseline for heterogeneous fleets:
                         hardware class by mean load, then the plain
                         product within it

Batch routing: ``plan_submit``/``plan_collect`` are the score stage of
``Router.route_batch`` — the fused sequential-argmin-with-feedback loop
of ``repro_torch.kernels.route_score`` over the factory's device mirror.
``batch_supported`` is False (the router routes the wave sequentially,
with the same decisions) for an ``exact_only`` factory, while any
instance is masked out by ``alive``, and for the host-only policies, as
in the reference: llm-d and PolyServe (their predictor's noise is a host
stream), Dynamo (per-request max-normalisation), Preble (windowed
fallback state), session affinity (the pin map changes per decision),
LMetric with the "cost" load indicator, a hotspot detector or a
heterogeneous fleet's normalization (the kernel has no norm input; a
homogeneous fleet collapses the norm and keeps the device plan), and
route-then-balance.
``scores_batch`` is the side-effect-free (k, n) inspection matrix of a
wave against the frozen state: it leaves the noise stream, the rings and
the pins as they were.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..kernels import route_score
from .indicators import IndicatorFactory
from .latency_model import LatencyModel
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

    def session_pin(self, session_id: int) -> Optional[int]:
        """Which instance holds this session's KV$ lineage, if the
        policy tracks pins (None otherwise or for unknown sessions)."""
        return None

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
class DynamoPolicy(Policy):
    """ai-Dynamo: weighted, normalised P-token + total-tokens (§6.1)."""
    name = "dynamo"

    def __init__(self, lam: float = 0.5):
        super().__init__()
        self.lam = lam
        self.name = f"dynamo(λ={lam})"

    def route(self, req, factory, now):
        pt = factory.p_tokens_for(req)
        tt = factory.total_tokens
        mp, mt = max(int(pt.max()), 1), max(int(tt.max()), 1)
        scores = self.lam * pt / mp + (1 - self.lam) * tt / mt
        return self._select_min(scores)

    def scores_batch(self, reqs, factory, now):
        # each row is normalised by its own request's P-token maximum
        hits = self._hits_matrix(reqs, factory)
        pt = factory.queued_prefill_tokens \
            + (self._plens(reqs)[:, None] - hits)
        tt = factory.total_tokens
        mp = np.maximum(pt.max(axis=1), 1)[:, None]
        mt = max(int(tt.max()), 1)
        return self.lam * pt / mp + (1 - self.lam) * tt / mt


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
class SimulationPolicy(Policy):
    """llm-d: route to min simulator-predicted TTFT (Fig. 14)."""
    name = "llm-d"

    def __init__(self, model: LatencyModel, kv_aware: bool = True):
        super().__init__()
        self.model = model
        self.kv_aware = kv_aware
        self.name = "llm-d" + ("" if kv_aware else "-nokv")

    def route(self, req, factory, now):
        hits = factory.hits_for(req) if self.kv_aware else 0
        new = req.prompt_len - hits
        # draws len(factory) values from the predictor's noise stream
        scores = self.model.predict_ttft_batch(
            factory.queued_prefill_tokens, new, factory.r_bs,
            factory.total_tokens)
        return self._select_min(scores)

    def scores_batch(self, reqs, factory, now):
        # noise-free, so that the stream is left as it was for route()
        hits = (self._hits_matrix(reqs, factory) if self.kv_aware
                else np.zeros((len(reqs), len(factory)), np.int64))
        new = self._plens(reqs)[:, None] - hits
        return self.model.predict_ttft_batch(
            factory.queued_prefill_tokens, new, factory.r_bs,
            factory.total_tokens, noise=1.0)


# ---------------------------------------------------------------------------
class PreblePolicy(Policy):
    """Preble (Fig. 30): KV$ filter on hit ratio T, else 3-min-window
    linear fallback  α·Σ P-token + β·Σ BS."""
    name = "preble"

    def __init__(self, T: float = 0.5, alpha: float = 1.0,
                 beta: float = 100.0, window: float = 180.0):
        super().__init__()
        self.T = T
        self.alpha = alpha
        self.beta = beta
        self.window = window
        self.name = f"preble(T={T})"
        self.branch_counts = {"kv": 0, "fallback": 0}

    def _fallback_scores(self, factory, now, trim=True):
        # the windowed linear fallback over the factory's routed-window
        # rings: one vectorized trim + sum + count
        sum_pt, cnt = factory.window_stats(now, self.window, trim=trim)
        return self.alpha * sum_pt + self.beta * cnt

    def route(self, req, factory, now):
        hits = factory.hits_for(req)
        L = max(req.prompt_len, 1)
        ratios = hits / L
        best = ratios.max()
        if best > self.T:
            self.branch_counts["kv"] += 1
            cand = np.flatnonzero(ratios >= best - _EPS)
            pts = factory.p_tokens_for(req, hits)
            return self._select_min(pts, allowed=cand)
        self.branch_counts["fallback"] += 1
        return self._select_min(self._fallback_scores(factory, now))

    def scores_batch(self, reqs, factory, now):
        # rows that pass the hit-ratio threshold: the P-token vector the
        # KV$ branch minimises; the others: the windowed fallback score,
        # computed without trimming the rings
        hits = self._hits_matrix(reqs, factory)
        plens = self._plens(reqs)
        L = np.maximum(plens, 1)[:, None]
        kv_rows = factory.queued_prefill_tokens \
            + (plens[:, None] - hits)
        best = (hits / L).max(axis=1)
        fb = self._fallback_scores(factory, now, trim=False)
        return np.where((best > self.T)[:, None], kv_rows, fb[None, :])


# ---------------------------------------------------------------------------
class PolyServePolicy(Policy):
    """PolyServe (Fig. 33): pack the most-loaded instance that still meets
    (SLO_TTFT, SLO_TPOT); else min predicted TPOT."""
    name = "polyserve"

    def __init__(self, model: LatencyModel, slo_ttft: float = 2.0,
                 slo_tpot: float = 0.020):
        super().__init__()
        self.model = model
        self.slo_ttft = slo_ttft
        self.slo_tpot = slo_tpot
        self.name = f"polyserve(τ={slo_tpot * 1e3:.0f}ms)"

    def route(self, req, factory, now):
        hits = factory.hits_for(req)
        new = req.prompt_len - hits
        n = len(factory)
        # the reference draws ttft0, tpot0, ttft1, tpot1, ...: deal the
        # same 2n draws out interleaved
        draws = self.model.noise_draws(2 * n)
        tn = pn = 1.0
        if isinstance(draws, np.ndarray):
            tn, pn = draws[0::2], draws[1::2]
        ttfts = self.model.predict_ttft_batch(
            factory.queued_prefill_tokens, new, factory.r_bs,
            factory.total_tokens, noise=tn)
        tpots = self.model.predict_tpot_batch(
            factory.r_bs, factory.total_tokens,
            factory.queued_prefill_tokens, noise=pn)
        feasible = np.flatnonzero((ttfts <= self.slo_ttft)
                                  & (tpots <= self.slo_tpot))
        if feasible.size == 0:                   # load-balancing branch
            return self._select_min(tpots)
        # utilization branch: the MOST loaded feasible instance
        return self._select_min(-tpots, allowed=feasible)

    def scores_batch(self, reqs, factory, now):
        # noise-free, stream untouched: the predicted TPOT both branches
        # rank is request-independent, so every row is the same vector
        tpots = self.model.predict_tpot_batch(
            factory.r_bs, factory.total_tokens,
            factory.queued_prefill_tokens, noise=1.0)
        return np.tile(np.asarray(tpots), (len(reqs), 1))


# ---------------------------------------------------------------------------
class SessionAffinityPolicy(Policy):
    """Session-centric baseline: keep every turn of a session on the
    instance that served it before.

    A session's KV$ lineage lives on whichever instance served its prior
    turns, so stickiness reuses it without consulting the prefix index.
    The escape valve is load spread: the pin holds only while the pinned
    instance is within ``spread`` batch slots of the least-loaded one:

        score_i = BS_i − (spread + ε) · 1[i == pin(session)]

    (ε keeps the pin ahead of the round-robin tie-break at the exact
    boundary); select_min re-pins to the winner.  Sessionless requests
    (``session_id == -1``) are keyed by ``class_id``, so conversation
    groups of the open-loop traces stick the same way.  Host-only
    (``batch_kind=None``): the pin map changes per decision.
    """
    name = "session-affinity"
    requires_kv = False
    batch_kind = None

    def __init__(self, spread: int = 4):
        super().__init__()
        self.spread = spread
        self.pins: dict = {}
        self.name = f"session-affinity(spread={spread})"

    @staticmethod
    def _key(req: Request):
        return (("s", req.session_id) if req.session_id >= 0
                else ("c", req.class_id))

    _PIN_EPS = 1e-6

    def route(self, req, factory, now):
        scores = factory.bs_vector().astype(np.float64)
        key = self._key(req)
        pin = self.pins.get(key)
        if pin is not None:
            scores[pin] -= self.spread + self._PIN_EPS
        iid = self._select_min(scores)
        self.pins[key] = iid
        return iid

    def scores_batch(self, reqs, factory, now):
        # per-row pin bonus against the frozen state, no re-pinning
        scores = np.tile(factory.bs_vector().astype(np.float64),
                         (len(reqs), 1))
        for j, r in enumerate(reqs):
            pin = self.pins.get(self._key(r))
            if pin is not None:
                scores[j, pin] -= self.spread + self._PIN_EPS
        return scores

    def session_pin(self, session_id):
        return self.pins.get(("s", session_id))

    def on_instance_failed(self, iid, n):
        # the dead instance's lineages are gone: drop every pin to it so
        # its sessions re-pin wherever their cold re-prefill lands
        super().on_instance_failed(iid, n)
        self.pins = {k: v for k, v in self.pins.items() if v != iid}


# ---------------------------------------------------------------------------
class LMetricPolicy(Policy):
    """THE PAPER (Fig. 17b):  route to argmin  P-token_i × (BS_i + 1).

    kv_indicator:   "ptoken" (paper) | "one_minus_hit" (§5.1 ablation)
    load_indicator: "bs" (paper) | "tokens" (§5.1 ablation) | "cost"
                    (beyond the paper: the latency model's predicted
                    decode step time at the instance's load; needs
                    ``latency_model``)
    detector: an optional two-phase KV$-hotspot detector (§5.2,
    ``repro_torch.core.hotspot.HotspotDetector``); while it names
    suspected instances, they are filtered out and the policy balances
    load alone over the rest.

    The "ptoken"/"one_minus_hit" × "bs"/"tokens" grid plans waves on the
    device; the "cost" indicator and an attached detector are host-only
    (``batch_supported`` is False), as in the reference.
    """
    name = "lmetric"
    batch_kind = "lmetric"

    def __init__(self, kv_indicator: str = "ptoken",
                 load_indicator: str = "bs", detector=None,
                 latency_model: Optional[LatencyModel] = None):
        super().__init__()
        if kv_indicator not in ("ptoken", "one_minus_hit"):
            raise ValueError(f"kv_indicator {kv_indicator!r}")
        if load_indicator not in ("bs", "tokens", "cost"):
            raise ValueError(f"load_indicator {load_indicator!r}")
        if load_indicator == "cost" and latency_model is None:
            raise ValueError("load_indicator 'cost' needs a latency_model")
        self.kv_indicator = kv_indicator
        self.load_indicator = load_indicator
        self.latency_model = latency_model
        self.detector = detector
        if kv_indicator == "ptoken" and load_indicator == "bs":
            self.name = "lmetric"
        else:
            self.name = f"lmetric[{kv_indicator}×{load_indicator}]"

    def _load(self, factory):
        if self.load_indicator == "bs":
            return factory.bs_vector() + 1.0
        if self.load_indicator == "cost":
            # physical decode-step cost at this instance's load
            return self.latency_model.step_time_batch(
                0, factory.bs_vector() + 1, factory.total_tokens) * 1e3
        return factory.total_tokens + 1.0

    def scores(self, req, factory, hits):
        hits = np.asarray(hits)
        L = max(req.prompt_len, 1)
        if self.kv_indicator == "ptoken":
            a = factory.p_tokens_for(req, hits) + 1.0
        else:
            a = 1.0 - hits / L + 1e-3
        if factory.prefill_norm is not None:
            # heterogeneous fleet: the KV$ term in seconds of prefill
            # work, not tokens (None on homogeneous fleets, which skips
            # the multiply and keeps the legacy floats)
            a = a * factory.prefill_norm
        return a * self._load(factory)

    def _batch_params(self):
        return (self.kv_indicator, self.load_indicator)

    def batch_supported(self, factory):
        if (self.detector is not None or self.load_indicator == "cost"
                or factory.prefill_norm is not None):
            # host-only, as in the reference: the detector's phase
            # machine, the latency model's arithmetic, and the hetero
            # norm (the kernel has no norm input)
            return False
        return super().batch_supported(factory)

    def scores_batch(self, reqs, factory, now):
        hits = self._hits_matrix(reqs, factory)
        plens = self._plens(reqs)
        L = np.maximum(plens, 1)[:, None]
        if self.kv_indicator == "ptoken":
            a = (factory.queued_prefill_tokens
                 + (plens[:, None] - hits)) + 1.0
        else:
            a = 1.0 - hits / L + 1e-3
        if factory.prefill_norm is not None:
            a = a * factory.prefill_norm[None, :]
        return a * self._load(factory)

    def route(self, req, factory, now):
        hits = factory.hits_for(req)
        scores = self.scores(req, factory, hits)
        excluded = set()
        if self.detector is not None:
            excluded = self.detector.observe(req, factory, hits, scores, now)
        if excluded:
            allowed = np.setdiff1d(np.arange(len(factory)),
                                   np.fromiter(excluded, np.int64,
                                               len(excluded)))
            if allowed.size == 0:
                allowed = np.arange(len(factory))
            # mitigation: balance load alone over the remainder
            return self._select_min(factory.bs_vector(), allowed=allowed)
        return self._select_min(scores)


# ---------------------------------------------------------------------------
class RouteThenBalancePolicy(Policy):
    """Two-layer baseline for a heterogeneous fleet.

    Layer 1 (a model router) picks the *hardware class* with the lowest
    mean batch size among feasible candidates: it sees load but not
    speed.  Layer 2 runs the plain (un-normalized) product within the
    chosen class, where a common constant would cancel anyway.  The
    fused normalized LMetric beats it when the layers disagree: a
    lightly loaded slow class can win layer 1 while a moderately loaded
    fast class would finish the prefill sooner.  Host-only
    (``batch_kind=None``), as in the reference.
    """
    name = "route-then-balance"
    batch_kind = None

    def _lmetric_scores(self, req, factory, hits):
        a = factory.p_tokens_for(req, hits) + 1.0
        b = factory.bs_vector() + 1.0
        return a * b

    def _candidates(self, req, factory) -> np.ndarray:
        """Feasible ∩ alive, falling back to alive (the admission gate
        sheds a request nothing can serve before it reaches a policy)."""
        ok = np.ones(len(factory), dtype=bool)
        feas = factory.feasible_mask(req.model_requirement)
        if feas is not None:
            ok &= feas
        if self.alive is not None:
            ok &= self.alive
        if not ok.any():
            ok = (np.ones(len(factory), dtype=bool)
                  if self.alive is None else self.alive.copy())
        return ok

    def route(self, req, factory, now):
        hits = factory.hits_for(req)
        ok = self._candidates(req, factory)
        cls = factory.hardware_class
        bs = factory.bs_vector()
        best_c, best_load = -1, np.inf
        for c in np.unique(cls[ok]):
            load = float(bs[ok & (cls == c)].mean())
            if load < best_load:
                best_c, best_load = int(c), load
        allowed = np.flatnonzero(ok & (cls == best_c))
        scores = self._lmetric_scores(req, factory, hits)
        return self._select_min(scores, allowed=allowed)

    def scores_batch(self, reqs, factory, now):
        # the layer-2 score every row ranks (the class restriction is a
        # candidate filter, not a score)
        hits = self._hits_matrix(reqs, factory)
        plens = self._plens(reqs)
        a = (factory.queued_prefill_tokens
             + (plens[:, None] - hits)) + 1.0
        return a * (factory.bs_vector() + 1.0)


def make_policy(name: str, latency_model: Optional[LatencyModel] = None,
                **kw) -> Policy:
    """The policy the reference's ``make_policy`` builds for ``name``;
    llm-d and PolyServe need ``latency_model``."""
    name = name.lower()
    if name in ("vllm", "jsq"):
        return JSQPolicy()
    if name in ("linear", "bailian"):
        return LinearKVPolicy(**kw)
    if name == "dynamo":
        return DynamoPolicy(**kw)
    if name in ("filter", "aibrix"):
        return FilterKVPolicy(**kw)
    if name in ("llm-d", "simulation", "polyserve"):
        if latency_model is None:
            raise ValueError(f"policy {name!r} needs a latency_model")
        cls = PolyServePolicy if name == "polyserve" else SimulationPolicy
        return cls(latency_model, **kw)
    if name == "preble":
        return PreblePolicy(**kw)
    if name == "lmetric":
        if latency_model is not None:
            kw.setdefault("latency_model", latency_model)
        return LMetricPolicy(**kw)
    if name in ("session-affinity", "smetric", "affinity"):
        return SessionAffinityPolicy(**kw)
    if name in ("route-then-balance", "rtb"):
        return RouteThenBalancePolicy(**kw)
    raise KeyError(name)
