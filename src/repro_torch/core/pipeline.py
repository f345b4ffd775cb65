"""Staged routing pipeline: walk → score → commit, with wave overlap —
port of ``repro.core.pipeline``.

* **walk** — per-unique-prompt aggregated-index hit depths plus the
  pairwise-LCP matrix (``IndicatorFactory.wave_submit`` /
  ``wave_collect``, host numpy; sharded factories fan out per shard);
* **score** — the fused score→argmin→feedback loop over the device
  mirror (``Policy.plan_submit`` / ``plan_collect``, one
  ``route_score`` launch per wave on a card);
* **commit** — per-request hook commits under the mid-wave eviction
  guard (``repro_torch.core.router.commit_wave_plan``), the one stage
  that mutates factory state.

Wave pipelining
---------------
While wave ``k``'s score stage runs on the device, wave ``k+1``'s walk
runs on the shard backend's workers: right after dispatching the score
stage, the pipeline asks ``next_wave_hint`` (the simulator wires its
event-heap peek) for the likely next wave and submits its walk.  It
speculates only where walks are asynchronous (``ShardBackend
.async_walks``: the thread and process backends), unless ``overlap``
forces it on or off.

Two things threaten bit-identity, and both are handled:

1. **The speculative walk misses wave k's commits.**  The factory
   brackets the speculation with an insert capture
   (``begin_insert_capture`` / ``end_insert_capture``), and the walk
   result is patched with ``depth[:, iid] = max(depth[:, iid],
   LCP(chain, inserted))`` — exact, because a radix tree's hit depth is
   the max over its stored chains of the LCP.  An eviction (or repair)
   during the capture cannot be patched: the wave then walks fresh.
2. **The prediction is wrong.**  The speculation is used only for the
   very same ``Request`` objects in the same order; otherwise it is
   waited out (keeping the worker protocol in sync) and discarded,
   without counting in telemetry.

Per-stage wall times and the speculation counters accumulate here and
surface through :meth:`RoutingPipeline.stage_stats` and
``Router.walk_telemetry()['pipeline']``.

Observability: with an obs bundle on the router (``Router(obs=...)``) a
wave emits the reference's span tree (``wave`` holding ``walk``,
``score`` and ``commit``, every Nth wave), the speculation instants
(``spec.submit`` / ``spec.consume`` / ``spec.discard``), per-shard walk
marks on the shard workers' tracks, the four ``pipeline.*``
histograms, and a provenance record per decision inside ``commit``,
taken before that decision's commit.  The port's own stages (the mirror
upload, the kernel's submit and collect) sit inside ``score``.  With
``obs=None`` none of it runs.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from .prefix_index import _pairwise_lcp
from .types import Request


class _NullCtx:
    """No-op context manager for the ``obs=None`` stage-span guards."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class _Speculation:
    """One outstanding speculative next-wave walk."""

    __slots__ = ("wave", "t_submit")

    def __init__(self, wave, t_submit):
        self.wave = wave            # IndicatorFactory's _WaveHandle
        self.t_submit = t_submit


class RoutingPipeline:
    """Owns the staged wave path of one ``Router``: stage execution,
    cross-wave speculation and per-stage telemetry.

    ``next_wave_hint`` is wired by the simulator to a heap peek;
    ``overlap`` is ``None`` (auto: speculate iff the shard backend's
    walks are asynchronous), ``True`` (force) or ``False`` (disable).
    """

    def __init__(self, router, overlap: Optional[bool] = None):
        self.router = router
        self.overlap = overlap
        self.next_wave_hint: Optional[Callable[[], Optional[list]]] = None
        self._spec: Optional[_Speculation] = None
        # ---- per-stage telemetry (ns totals across waves) -------------
        self.walk_ns = 0
        self.score_ns = 0
        #: the score stage's dispatch (``plan_submit``: the depth matrix
        #: packed into pinned memory, uploaded, the launch), within score
        self.submit_ns = 0
        self.commit_ns = 0
        self.waves = 0
        self.prefetches = 0
        self.prefetch_hits = 0
        #: wall time a consumed speculative walk ran off the critical
        #: path (submit → wait start; an upper bound on true overlap)
        self.spec_hidden_ns = 0
        #: wall time the routing path still blocked waiting for it
        self.spec_blocked_ns = 0

    # ------------------------------------------------------------------
    def _overlap_enabled(self) -> bool:
        if self.overlap is not None:
            return self.overlap
        backend = getattr(self.router.factory._agg, "backend", None)
        return backend is not None and backend.async_walks

    def drop_prefetch(self):
        """Discard any outstanding speculation (the wave went down a
        non-pipelined path, or the router is closing)."""
        spec, self._spec = self._spec, None
        if spec is None:
            return
        factory = self.router.factory
        try:
            factory.wave_discard(spec.wave)
        finally:
            factory.end_insert_capture()

    # ------------------------------------------------------------------
    def _patch_speculation(self, wave, h, inserted):
        """Fold commits that landed after the speculative snapshot into
        its depth matrix: ``depth[:, iid] = max(..., LCP(chain, ins))``
        — exact (see module docstring) because no eviction fired."""
        if not inserted:
            return
        depth, _, _ = wave
        chains = list(h.chains)
        u = len(chains)
        cross = _pairwise_lcp(chains + [c for _, c in inserted])
        for j, (iid, _) in enumerate(inserted):
            col = cross[:u, u + j][h.uid]       # per-request credit
            np.maximum(depth[:, iid], col, out=depth[:, iid])

    def _walk_stage(self, reqs: Sequence[Request], tracer=None):
        """Produce (depth, lcp, plen): consume a validated speculation
        (patched for post-snapshot inserts) or walk fresh."""
        factory = self.router.factory
        spec, self._spec = self._spec, None
        if spec is not None:
            h = spec.wave
            predicted = (len(h.reqs) == len(reqs)
                         and all(a is b for a, b in zip(h.reqs, reqs)))
            inserted, valid = factory.end_insert_capture()
            if predicted and valid:
                t0 = time.perf_counter_ns()
                self.spec_hidden_ns += t0 - spec.t_submit
                wave = factory.wave_collect(h)
                self.spec_blocked_ns += time.perf_counter_ns() - t0
                self.prefetch_hits += 1
                if tracer is not None:
                    tracer.instant("spec.consume",
                                   args={"k": len(reqs),
                                         "patched": len(inserted)})
                self._patch_speculation(wave, h, inserted)
                return wave
            if tracer is not None:
                tracer.instant("spec.discard",
                               args={"k": len(h.reqs),
                                     "predicted": predicted,
                                     "valid": valid})
            factory.wave_discard(h)
        return factory.wave_collect(factory.wave_submit(reqs))

    def _maybe_prefetch(self, tracer=None):
        """Between score dispatch and collect: speculatively submit the
        predicted next wave's walk (one outstanding at a time)."""
        router = self.router
        if (self._spec is not None or self.next_wave_hint is None
                or not router.policy.batch_needs_kv
                or not self._overlap_enabled()):
            return
        hint = self.next_wave_hint()
        # k <= 1 waves take the scalar path; no wave walk to hide
        if not hint or len(hint) <= 1:
            return
        factory = router.factory
        factory.begin_insert_capture()
        h = factory.wave_submit(tuple(hint))
        self._spec = _Speculation(h, time.perf_counter_ns())
        self.prefetches += 1
        if tracer is not None:
            tracer.instant("spec.submit", args={"k": len(hint)})

    # ------------------------------------------------------------------
    def run_wave(self, reqs: Sequence[Request], now: float) -> List[int]:
        """Route one coalesced arrival wave through walk → score →
        commit; bit-identical to sequential ``route`` calls, with or
        without speculation and with or without an obs bundle."""
        from .router import commit_wave_plan
        router = self.router
        policy = router.policy
        factory = router.factory
        obs = router.obs
        tr = obs.tracer if obs is not None else None
        reg = obs.registry if obs is not None else None
        wave_span = None
        if tr is not None:
            tr.wave_tick()
            wave_span = tr.span("wave", args={"k": len(reqs)})
            wave_span.__enter__()
        t0 = time.perf_counter_ns()
        with (tr.span("walk") if tr is not None else _NULL_CTX):
            if policy.batch_needs_kv:
                wave = self._walk_stage(reqs, tracer=tr)
            else:
                self.drop_prefetch()
                wave = policy.wave_inputs(reqs, factory)
        if tr is not None and tr._sampled:
            self._shard_marks(tr)
        t1 = time.perf_counter_ns()
        with (tr.span("score") if tr is not None else _NULL_CTX):
            handle = policy.plan_submit(wave, factory)
            tp0 = time.perf_counter_ns()
            self._maybe_prefetch(tracer=tr)
            tp = time.perf_counter_ns() - tp0   # prefetch is walk work
            sel, _ = policy.plan_collect(handle)
        t2 = time.perf_counter_ns()
        self.walk_ns += (t1 - t0) + tp
        self.score_ns += (t2 - t1) - tp
        self.submit_ns += tp0 - t1
        per_req_ns = (t2 - t0) // len(reqs)
        prov = obs.provenance if obs is not None else None

        def commit(j, req):
            iid = int(sel[j])
            if prov is not None:
                # the landscape before this commit, after the wave's
                # earlier ones: what sequential routing would have seen
                prov.record(req, iid, factory, now, policy=policy)
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

        with (tr.span("commit") if tr is not None else _NULL_CTX):
            out = commit_wave_plan(factory, reqs, commit,
                                   lambda r: router.route(r, now))
        t3 = time.perf_counter_ns()
        self.commit_ns += t3 - t2
        self.waves += 1
        if wave_span is not None:
            wave_span.__exit__(None, None, None)
        if reg is not None:
            reg.observe("pipeline.walk_us", ((t1 - t0) + tp) / 1e3)
            reg.observe("pipeline.score_us", ((t2 - t1) - tp) / 1e3)
            reg.observe("pipeline.commit_us", (t3 - t2) / 1e3)
            reg.observe("pipeline.wave_size", float(len(reqs)))
        # anti-entropy sweep: digest-verify the next K shards against KV
        # truth, repairing on mismatch — after this wave's commit, and
        # off at the default k = 0
        k = router.anti_entropy_k
        if k:
            factory.anti_entropy_step(k)
        return out

    def _shard_marks(self, tr):
        """Per-shard walk marks on the shard workers' pid tracks: the
        parent emits on each worker's behalf, with the cumulative walk
        count as the deterministic payload."""
        backend = getattr(self.router.factory._agg, "backend", None)
        if backend is None:
            return
        walks = backend.shard_walks
        for s in range(len(walks)):
            tr.shard_mark(s, "walk", args={"walks": int(walks[s])})

    # ------------------------------------------------------------------
    def stage_stats(self) -> dict:
        """Per-stage telemetry (``Router.walk_telemetry``'s ``pipeline``
        block): mean per-wave stage costs in µs (``submit_us`` is the
        score stage's dispatch, part of ``score_us``), wave and speculation
        counters, and the overlap fraction — the share of a consumed
        speculative walk's wall time that ran off the routing critical
        path (hidden / (hidden + blocked); an upper bound on true
        overlap, since a walk may finish early inside the hidden
        window)."""
        w = max(self.waves, 1)
        denom = self.spec_hidden_ns + self.spec_blocked_ns
        return {
            "waves": self.waves,
            "walk_us": self.walk_ns / w / 1e3,
            "score_us": self.score_ns / w / 1e3,
            "submit_us": self.submit_ns / w / 1e3,
            "commit_us": self.commit_ns / w / 1e3,
            "prefetches": self.prefetches,
            "prefetch_hits": self.prefetch_hits,
            "overlap_fraction": (self.spec_hidden_ns / denom
                                 if denom else 0.0),
        }
