"""Staged routing pipeline: walk → score → commit (port of
``repro.core.pipeline``).

* **walk** — per-unique-prompt aggregated-index hit depths plus the
  pairwise-LCP matrix (``Policy.wave_inputs``, host numpy);
* **score** — the fused score→argmin→feedback loop over the device
  mirror (``Policy.plan_submit`` / ``plan_collect``, one
  ``route_score`` launch per wave on a card);
* **commit** — per-request hook commits under the mid-wave eviction
  guard (``repro_torch.core.router.commit_wave_plan``), the one stage
  that mutates factory state.

Per-stage wall times accumulate here and surface through
:meth:`RoutingPipeline.stage_stats`.  The reference's cross-wave walk
speculation is not ported: it only runs on asynchronous shard backends,
which this port does not have yet.
"""
from __future__ import annotations

import time
from typing import List, Sequence

from .types import Request


class RoutingPipeline:
    """Owns the staged wave path of one ``Router`` and its per-stage
    telemetry."""

    def __init__(self, router):
        self.router = router
        # ---- per-stage telemetry (ns totals across waves) -------------
        self.walk_ns = 0
        self.score_ns = 0
        self.commit_ns = 0
        self.waves = 0

    def run_wave(self, reqs: Sequence[Request], now: float) -> List[int]:
        """Route one coalesced arrival wave through walk → score →
        commit; bit-identical to sequential ``route`` calls."""
        from .router import commit_wave_plan
        router = self.router
        policy = router.policy
        factory = router.factory
        t0 = time.perf_counter_ns()
        wave = policy.wave_inputs(reqs, factory)
        t1 = time.perf_counter_ns()
        sel, _ = policy.plan_collect(policy.plan_submit(wave, factory))
        t2 = time.perf_counter_ns()
        self.walk_ns += t1 - t0
        self.score_ns += t2 - t1
        per_req_ns = (t2 - t0) // len(reqs)

        def commit(j, req):
            iid = int(sel[j])
            policy._next_tie()           # one tie value per commit
            router.decision_ns.append(per_req_ns)
            inst = factory[iid]
            hit = inst.kv_hit(req, touch=True)
            req.sched_to = iid
            req.hit_tokens = hit
            req.t_sched = now
            inst.on_route(req, now, hit)
            if router.insert_on_route:
                inst.kv.insert(req.blocks)
            router.routed += 1
            return iid

        out = commit_wave_plan(factory, reqs, commit,
                               lambda r: router.route(r, now))
        self.commit_ns += time.perf_counter_ns() - t2
        self.waves += 1
        return out

    def stage_stats(self) -> dict:
        """Mean per-wave stage costs in µs and the wave count."""
        w = max(self.waves, 1)
        return {
            "waves": self.waves,
            "walk_us": self.walk_ns / w / 1e3,
            "score_us": self.score_ns / w / 1e3,
            "commit_us": self.commit_ns / w / 1e3,
        }
