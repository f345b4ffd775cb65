"""Global scheduler (paper Fig. 3): filter → score → route — port of
``repro.core.router``.

The router owns the indicator factory and a policy; instance engines
push state updates through the response hooks.  ``route`` decides one
request on the host.  ``route_batch`` coalesces an arrival wave: the
policy plans every assignment in one device call (``repro_torch.kernels
.route_score``) and the router commits the plan through the exact
per-request hook sequence ``route`` performs, so the batch is
bit-identical to k sequential ``route`` calls.  The one effect the
device plan cannot model is a KV$ eviction fired by a mid-wave insert;
the factory's eviction counter detects it and the rest of the wave
re-routes sequentially (the tie counter is consumed per *committed*
decision, so the fallback resumes exactly where sequential routing
would be).

``device`` (default ``"cuda"``) is where the indicator mirror lives and
the score stage runs; construction fails without a card unless
``device="cpu"`` is asked for explicitly.
"""
from __future__ import annotations

import time
from typing import List, Sequence

from .indicators import IndicatorFactory
from .pipeline import RoutingPipeline
from .policies import Policy
from .types import Request


def commit_wave_plan(factory: IndicatorFactory, reqs: Sequence[Request],
                     commit, fallback) -> List:
    """Commit a device wave plan with the mid-wave eviction guard.

    The plan's hit model is exact unless a commit's KV$ insert evicts
    (caches only grow otherwise): snapshot the factory's eviction
    counter, re-check it before every commit, and hand the rest of the
    wave to ``fallback`` (sequential routing) the moment it moves.
    """
    ev0 = factory.evictions
    out: List = []
    for j, req in enumerate(reqs):
        if factory.evictions != ev0:
            out.extend(fallback(r) for r in reqs[j:])
            return out
        out.append(commit(j, req))
    return out


class Router:
    def __init__(self, policy: Policy, n_instances: int,
                 kv_capacity_tokens: int = 1 << 62, block_size: int = 64,
                 exact_only: bool = False, insert_on_route: bool = True,
                 device="cuda"):
        self.policy = policy
        self.factory = IndicatorFactory(
            n_instances, kv_capacity_tokens=kv_capacity_tokens,
            block_size=block_size, exact_only=exact_only, device=device)
        self.insert_on_route = insert_on_route
        self.decision_ns: List[int] = []
        self.routed = 0
        self.pipeline = RoutingPipeline(self)

    @property
    def device(self):
        return self.factory.device

    # ------------------------------------------------------------------
    def route(self, req: Request, now: float) -> int:
        t0 = time.perf_counter_ns()
        iid = self.policy.route(req, self.factory, now)
        self.decision_ns.append(time.perf_counter_ns() - t0)
        inst = self.factory[iid]
        hit = inst.kv_hit(req, touch=True)
        req.sched_to = iid
        req.hit_tokens = hit
        req.t_sched = now
        inst.on_route(req, now, hit)
        if self.insert_on_route:
            # prefill will materialise this KV$ promptly; index it now so
            # follow-up requests in the same class see the hit
            inst.kv.insert(req.blocks)
        self.routed += 1
        return iid

    # ------------------------------------------------------------------
    def route_batch(self, reqs: Sequence[Request],
                    now: float) -> List[int]:
        """Route a coalesced arrival wave; bit-identical to sequential
        ``route`` calls.  A wave of one, a router without insert-on-route
        (the plan's intra-wave LCP credit would model inserts that never
        happen), and a policy or factory the device plan does not support
        (``exact_only``, a failed instance) take the sequential host
        path; a mid-wave eviction hands the rest of the wave to it.

        ``decision_ns`` records the walk + score cost amortized over the
        wave."""
        if not reqs:
            return []
        if (len(reqs) == 1 or not self.insert_on_route
                or not self.policy.batch_supported(self.factory)):
            return [self.route(r, now) for r in reqs]
        return self.pipeline.run_wave(reqs, now)

    # ---- response piggyback hooks ------------------------------------
    def on_prefill_progress(self, iid: int, n_tokens: int):
        self.factory[iid].on_prefill_progress(n_tokens)

    def on_start_running(self, iid: int, req: Request):
        self.factory[iid].on_start_running(req)

    def on_decode_token(self, iid: int):
        self.factory[iid].on_decode_token()

    def on_finish(self, iid: int, req: Request):
        self.factory[iid].on_finish(req)
        self.policy.on_finish(iid, req)

    # ------------------------------------------------------------------
    def mean_decision_us(self) -> float:
        if not self.decision_ns:
            return 0.0
        return sum(self.decision_ns) / len(self.decision_ns) / 1e3

    def mean_walk_us(self) -> float:
        """Mean host cost of one aggregated-index walk (per unique
        prompt), over both the single-request and the wave paths."""
        return self.factory.mean_walk_us()

    def stage_stats(self) -> dict:
        """Per-stage wave timings (walk/score/commit µs per wave)."""
        return self.pipeline.stage_stats()
