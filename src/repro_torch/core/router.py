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

``n_shards > 1`` shards the factory's aggregated prefix index (and the
device-mirror partition) by instance-id range, and ``walk_backend``
(``"serial"``, ``"thread"`` or ``"process"``; ``parallel_walks=True``
means ``"thread"``) picks where the per-shard walks run — decisions are
bit-identical at any shard count on any backend.  On asynchronous
backends the pipeline overlaps the next wave's walk with this wave's
score stage (``pipeline_overlap``: None = automatic).
``anti_entropy_k`` digest-verifies that many shards after every wave.
A router with worker processes must be closed (``close`` or ``with``).

``fleet`` (a ``repro_torch.core.fleet.FleetSpec``) makes the fleet
heterogeneous: a request with a ``model_requirement`` is routed over the
instances that serve it (the capability mask, intersected like the
alive mask), and a wave that carries requirements takes the sequential
host path.  ``obs`` (``repro_torch.obs.make_obs``) attaches metrics,
tracing and decision provenance; with the default ``obs=None`` none of
that code runs.  Instance churn: ``mark_failed`` (the instance's state
is lost), ``mark_drained`` (no new work) and ``mark_recovered``; while
any instance is out the policy carries an alive mask and waves take the
host path, and once the whole fleet is back the device plan resumes.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

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
                 n_shards: int = 1, parallel_walks: bool = False,
                 walk_backend: Optional[str] = None,
                 pipeline_overlap: Optional[bool] = None,
                 shard_timeout_s: Optional[float] = None,
                 anti_entropy_k: int = 0, fleet=None, obs=None,
                 device="cuda"):
        self.policy = policy
        self.factory = IndicatorFactory(
            n_instances, kv_capacity_tokens=kv_capacity_tokens,
            block_size=block_size, exact_only=exact_only,
            n_shards=n_shards, parallel_walks=parallel_walks,
            walk_backend=walk_backend, shard_timeout_s=shard_timeout_s,
            fleet=fleet, device=device)
        self.insert_on_route = insert_on_route
        self.decision_ns: List[int] = []
        self.routed = 0
        self.pipeline = RoutingPipeline(self, overlap=pipeline_overlap)
        #: anti-entropy budget: shards digest-verified (and repaired on
        #: mismatch) at the tail of every routed wave; 0 disables it
        self.anti_entropy_k = int(anti_entropy_k)
        # observability bundle (repro_torch.obs.Obs); None runs no
        # observability code anywhere in the routing stack: every hook
        # is an ``is None`` branch
        self.obs = obs
        if obs is not None and (obs.registry is not None
                                or obs.tracer is not None):
            self.factory.on_degraded_rebuild = self._on_degraded_rebuild
            self.factory.on_shard_repair = self._on_shard_repair
            self.factory.attach_backend_events(self._on_backend_event)

    @property
    def device(self):
        return self.factory.device

    # ---- lifecycle ----------------------------------------------------
    def close(self):
        """Drop any speculative walk and tear down the factory's walk
        backend (thread pools, process workers and their shared-memory
        segments).  Required for process backends; safe twice."""
        self.pipeline.drop_prefetch()
        self.factory.close()

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- observability -----------------------------------------------
    def _on_degraded_rebuild(self, n: int):
        """Exactly-once degraded-rebuild event (the factory fires it at
        the counter's increment)."""
        obs = self.obs
        if obs.registry is not None:
            obs.registry.inc("events.degraded_rebuild")
        if obs.tracer is not None:
            obs.tracer.instant("index.degraded_rebuild", args={"n": n})

    def _on_shard_repair(self, s: int, n: int):
        """Exactly-once scoped-repair event (fired at the factory's
        ``shard_repairs`` increment)."""
        obs = self.obs
        if obs.registry is not None:
            obs.registry.inc("events.index_repair")
        if obs.tracer is not None:
            obs.tracer.instant("index.shard_repair",
                               args={"shard": s, "n": n})

    def _on_backend_event(self, kind: str, shard: int, info: dict):
        """Shard-backend recovery events (``worker_restart`` /
        ``worker_timeout`` / ``shard_escalated`` / ``shard_repair``) →
        a registry counter and a tracer instant."""
        obs = self.obs
        if obs.registry is not None:
            obs.registry.inc(f"events.{kind}")
        if obs.tracer is not None:
            obs.tracer.instant(f"shard.{kind}",
                               args={"shard": shard, **info})

    def _emit_churn(self, kind: str, iid: int):
        obs = self.obs
        if obs is None:
            return
        if obs.registry is not None:
            obs.registry.inc(f"churn.{kind}")
        if obs.tracer is not None:
            obs.tracer.instant(f"churn.{kind}", args={"iid": iid})

    def metrics_snapshot(self) -> dict:
        """One registry snapshot: the attached obs registry (a fresh one
        without it) with the router's own accumulators ingested
        (``repro_torch.obs.registry.ingest_router``: factory walks,
        pipeline stages, repairs, the shard workers' fixed-slot block).
        Ingestion is ``counter_set``, so repeated calls never
        double-count."""
        from ..obs.registry import MetricsRegistry, ingest_router
        reg = (self.obs.registry if self.obs is not None
               and self.obs.registry is not None else MetricsRegistry())
        ingest_router(reg, self)
        return reg.snapshot()

    # ------------------------------------------------------------------
    def _route_masked(self, req: Request, mask, now: float) -> int:
        """Capability-masked decision: the feasibility mask is
        intersected into the policy's candidate set like the alive mask
        (a pre-score filter) and restored afterwards.  A request no live
        instance serves must be shed upstream (``AdmissionController``);
        reaching here with an empty candidate set is a caller bug."""
        pol = self.policy
        saved = pol.alive
        eff = mask if saved is None else (mask & saved)
        if not eff.any():
            raise ValueError(
                f"no live instance serves model_requirement="
                f"{req.model_requirement!r} (shed it at admission)")
        pol.alive = eff
        try:
            return pol.route(req, self.factory, now)
        finally:
            pol.alive = saved

    def route(self, req: Request, now: float) -> int:
        t0 = time.perf_counter_ns()
        mask = self.factory.feasible_mask(req.model_requirement)
        if mask is None:
            iid = self.policy.route(req, self.factory, now)
        else:
            iid = self._route_masked(req, mask, now)
        self.decision_ns.append(time.perf_counter_ns() - t0)
        obs = self.obs
        if obs is not None and obs.provenance is not None:
            # before any commit hook mutates indicators, so the record
            # holds the landscape the argmin saw
            obs.provenance.record(req, iid, self.factory, now,
                                  policy=self.policy)
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
        path, and so does a wave carrying a ``model_requirement`` on a
        fleet (each request needs its own capability mask, which the
        device plan has no input for); a mid-wave eviction hands the
        rest of the wave to it.

        ``decision_ns`` records the walk + score cost amortized over the
        wave."""
        if not reqs:
            return []
        if (len(reqs) == 1 or not self.insert_on_route
                or not self.policy.batch_supported(self.factory)
                or (self.factory.fleet is not None
                    and any(r.model_requirement for r in reqs))):
            # the scalar path mutates the index without an insert
            # capture, so any pending speculative walk is dropped first
            self.pipeline.drop_prefetch()
            return [self.route(r, now) for r in reqs]
        return self.pipeline.run_wave(reqs, now)

    # ---- overload control --------------------------------------------
    def on_retract(self, iid: int, req: Request, prefill_left: int):
        """A queued-or-prefilling request was cancelled (deadline
        blown): reverse its ``on_route`` contribution.  The KV$ insert
        made at routing stays for the LRU."""
        self.factory[iid].on_retract(req, prefill_left)

    # ---- instance churn ----------------------------------------------
    def mark_failed(self, iid: int):
        """An instance died: before the next wave commits, the failure
        reaches scoring (the policy's alive mask), the aggregated index
        (its column removed through the shard backend), the device
        mirror (the zeroed columns' range dirtied) and speculation (any
        captured walk dropped).  The churn event is emitted before the
        teardown, so an index mutation retried through a degraded
        rebuild cannot emit it twice."""
        self._emit_churn("fail", iid)
        self.pipeline.drop_prefetch()
        self.factory.on_instance_failed(iid)
        self.policy.on_instance_failed(iid, self.factory.n)

    def mark_drained(self, iid: int):
        """Graceful drain: route no new work to ``iid``; its KV$ and
        queue state stay (in-flight work completes)."""
        self._emit_churn("drain", iid)
        self.pipeline.drop_prefetch()
        self.policy.on_instance_failed(iid, self.factory.n)

    def mark_recovered(self, iid: int):
        """A failed or drained instance rejoined.  When the whole fleet
        is live again the policy drops its mask and the device wave path
        resumes."""
        self._emit_churn("recover", iid)
        self.policy.on_instance_recovered(iid)

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
    def session_pin(self, session_id: int) -> Optional[int]:
        """Session-affinity hint: the instance holding this session's
        KV$ lineage, if the policy tracks pins (None otherwise)."""
        return self.policy.session_pin(session_id)

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
        """Per-stage wave timings (walk/score/commit µs per wave) and
        the speculation counters."""
        return self.pipeline.stage_stats()

    def walk_telemetry(self) -> dict:
        """Shard-tagged walk telemetry for the host half of routing:
        ``mean_walk_us`` (per unique prompt, fan-out and the shared sort
        included), ``shards`` (one record per index shard: ``shard``,
        ``lo``/``hi``, ``walks``, ``mean_walk_us``; an unsharded factory
        reports one pseudo-shard over [0, n)), ``max_shard_us`` (the
        slowest shard's mean walk: the critical path of a parallel
        fan-out) and ``pipeline`` (:meth:`stage_stats`)."""
        shards = self.factory.shard_walk_stats()
        return {"mean_walk_us": self.factory.mean_walk_us(),
                "max_shard_us": max(s["mean_walk_us"] for s in shards),
                "shards": shards,
                "pipeline": self.pipeline.stage_stats()}
