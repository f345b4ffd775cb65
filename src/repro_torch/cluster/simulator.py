"""Discrete-event cluster simulator (the paper's 16-instance testbed) —
port of ``repro.cluster.simulator``.

Each instance models a PD-colocated vLLM-v1-style engine with chunked
prefill (Sarathi): every engine step batches all running decodes (one
token each) plus a FIFO prefill chunk within the token budget.  Step
duration comes from ``LatencyModel.step_time`` (ground truth).  Requests
arrive at the cluster, are routed by ``Router`` (the policy under test),
skip prefilling their KV$-hit tokens, and stream decode tokens until done.

The simulator and the latency model run on the host; the router's score
stage runs where the router's mirror lives.  Same-timestamp arrival
waves coalesce through ``Router.route_batch``: one ``route_score``
launch per wave of two or more on a card, bit-identical to sequential
routing.  Arrival times drawn from a continuous distribution rarely
coincide, so a caller that wants waves quantizes them to a scheduling
tick first.

Telemetry: per-request TTFT/TPOT, KV$ hit ratios, per-instance
prefill-seconds in 10-second windows (Fig. 10/25 imbalance profiles) and
running-batch timelines (Fig. 28).

Beyond the homogeneous fleet:

* **Heterogeneous fleets** — a router built with ``fleet=`` gives every
  instance its own spec's latency model (``make_mixed_fleet`` is the
  reference's fast/slow testbed); ``self.model`` stays the predictor the
  admission gate and retraction consult.
* **Overload control** (``overload=OverloadControl(...)``, off by
  default): the admission gate in ``_on_arrivals`` sheds requests no
  live instance can serve in time (and, on a fleet, requests no live
  instance can serve at all, with every control off); retraction
  cancels queued requests whose prefill deadline has passed.  Dropped
  requests land in ``dropped``; ``overload_stats`` counts them.
* **Instance churn** — ``fail_at`` / ``drain_at`` / ``recover_at``
  schedule events through ``Router.mark_failed`` / ``mark_drained`` /
  ``mark_recovered``; a failed instance's queue and running batch
  re-arrive at once for a cold re-prefill elsewhere (``churn_events``,
  ``churn_recovery``).
* **Observability** — with an obs bundle on the router: the tracer's
  virtual clock follows the simulator's (set at arrival waves, drops and
  churn), drops and fates reach the registry and provenance,
  ``_enqueue`` and ``_finish`` count cross-family interference, and
  ``metrics_snapshot`` merges it all.  With ``obs=None`` none of it runs.
"""
from __future__ import annotations

import collections
import heapq
import itertools
from typing import Dict, List, Optional

from ..core.latency_model import EngineSpec, LatencyModel
from ..core.overload import NO_CONTROL, AdmissionController, \
    OverloadControl
from ..core.pipeline import _NULL_CTX
from ..core.router import Router
from ..core.types import Request

WINDOW = 10.0  # seconds, for imbalance/batch telemetry


class _SimInstance:
    def __init__(self, iid: int, spec: EngineSpec, model: LatencyModel):
        self.iid = iid
        self.spec = spec
        self.model = model
        # FIFO waiting queue keyed by rid: insertion-ordered dict gives
        # O(1) removal on prefill completion
        self.waiting: Dict[int, Request] = {}
        self.prefill_left: Dict[int, int] = {}
        self.running: List[Request] = []
        self.generated: Dict[int, int] = {}
        self.busy = False
        # churn guard: bumped when the instance fails, so that step_end
        # events from before the failure are recognised as stale
        self.epoch = 0
        # telemetry: per-window accumulators flushed on window roll, so
        # the hot step loop touches plain attributes
        self.prefill_seconds: Dict[int, float] = collections.defaultdict(float)
        self.busy_seconds: Dict[int, float] = collections.defaultdict(float)
        self.bs_samples: List = []
        self._win = -1
        self._win_prefill = 0.0
        self._win_busy = 0.0

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def account_step(self, now: float, dt: float, prefill_frac: float):
        w = int(now / WINDOW)
        if w != self._win:
            self.flush_telemetry()
            self._win = w
        self._win_prefill += dt * prefill_frac
        self._win_busy += dt

    def flush_telemetry(self):
        if self._win >= 0:
            self.prefill_seconds[self._win] += self._win_prefill
            self.busy_seconds[self._win] += self._win_busy
        self._win_prefill = 0.0
        self._win_busy = 0.0

    def form_batch(self):
        """Returns (prefill_allocs [(req, tokens)], decode_bs, ctx_tokens)."""
        decode_bs = len(self.running)
        budget = max(0, self.spec.chunk_tokens - decode_bs)
        allocs = []
        for req in self.waiting.values():
            if budget <= 0:
                break
            if decode_bs + len(allocs) >= self.spec.max_batch:
                break
            left = self.prefill_left[req.rid]
            take = min(left, budget)
            allocs.append((req, take))
            budget -= take
        ctx = sum(r.prompt_len + self.generated[r.rid] for r in self.running)
        return allocs, decode_bs, ctx


def make_mixed_fleet(mix=None, chips: int = 1, **spec_kw):
    """The reference's heterogeneous testbed: a ``FleetSpec`` mixing a
    fast class (Qwen3-30B-MoE: only ~3B *active* params, so its marginal
    prefill token is ~2.3x cheaper than the dense 7B's) with a slow one
    (Qwen2-7B, dense), 8 instances each by default.  ``mix`` overrides
    with ``(model_name, hardware_class, count)`` groups (a group's
    instances are contiguous); ``spec_kw`` goes to ``spec_from_config``.
    Pass the result to ``Router(fleet=...)``, and ``ClusterSim`` picks
    the per-instance specs up from the factory."""
    from ..core.fleet import make_fleet
    if mix is None:
        mix = (("qwen3_30b_moe", "fast", 8), ("qwen2_7b", "slow", 8))
    return make_fleet(mix, chips=chips, **spec_kw)


class ClusterSim:
    def __init__(self, router: Router, spec: EngineSpec,
                 model: Optional[LatencyModel] = None,
                 overload: Optional[OverloadControl] = None):
        self.router = router
        self.spec = spec
        self.model = model or LatencyModel(spec)
        n = len(router.factory)
        fleet = router.factory.fleet
        self.fleet = fleet
        if fleet is None:
            # homogeneous: every instance shares THE model object (the
            # reference's construction without a fleet)
            self.instances = [_SimInstance(i, spec, self.model)
                              for i in range(n)]
        else:
            # heterogeneous ground truth: each instance steps under its
            # own spec's roofline, one LatencyModel per distinct spec
            # (stateless at error_std=0); self.model stays the predictor
            # of the admission gate and retraction
            models = {}
            self.instances = [
                _SimInstance(i, s, models.setdefault(id(s),
                                                     LatencyModel(s)))
                for i, s in enumerate(fleet.specs)]
        self._events: List = []
        # the arrival events still in _events, in the same (t, seq) order
        self._arrivals: List = []
        self._seq = itertools.count()
        self.now = 0.0
        self.finished: List[Request] = []
        # overload control (all off by default): admission shedding and
        # deadline retraction share one stamped deadline per request
        self.overload = overload if overload is not None else NO_CONTROL
        # a fleet needs the admission gate even with every control off:
        # its capability pre-filter sheds requests no live instance can
        # serve before the router's masked path would raise
        self._admission = (AdmissionController(self.model, self.overload)
                           if (self.overload.enabled or fleet is not None)
                           else None)
        self.dropped: List[Request] = []
        self.retractions = 0
        self.wasted_prefill_tokens = 0
        # instance churn bookkeeping (fail/drain/recover events)
        self.churn_events: List[dict] = []
        self.churn_recovery: List[float] = []
        self._orphan_fail_t: Dict[int, float] = {}
        # wave pipelining: the router's pipeline asks for the next
        # arrival wave, so that an asynchronous walk backend starts wave
        # k+1's walk while wave k's score stage runs (see
        # repro_torch.core.pipeline)
        router.pipeline.next_wave_hint = self._next_arrival_wave
        # observability: the router's obs bundle, unpacked once so that
        # a hook costs one attribute load and an is-None branch when off
        obs = router.obs
        self._obs = obs
        self._tracer = obs.tracer if obs is not None else None
        self._registry = obs.registry if obs is not None else None
        self._prov = obs.provenance if obs is not None else None

    # ------------------------------------------------------------------
    def _push(self, t: float, kind: str, payload):
        e = (t, next(self._seq), kind, payload)
        heapq.heappush(self._events, e)
        if kind == "arrival":
            heapq.heappush(self._arrivals, e)

    def run(self, requests: List[Request], until: Optional[float] = None):
        for req in requests:
            self._push(req.arrival, "arrival", req)
        while self._events:
            t, _, kind, payload = heapq.heappop(self._events)
            if kind == "arrival":
                heapq.heappop(self._arrivals)
            if until is not None and t > until:
                break
            self.now = t
            if kind == "arrival":
                # coalesce the same-timestamp arrival wave through the
                # batched routing path; only *consecutive* events are
                # merged (equal-time ordering is by sequence number, so
                # a step_end interleaved between two arrivals keeps its
                # place and event order is exactly the sequential one)
                wave = [payload]
                while (self._events and self._events[0][0] == t
                       and self._events[0][2] == "arrival"):
                    wave.append(heapq.heappop(self._events)[3])
                    heapq.heappop(self._arrivals)
                self._on_arrivals(wave)
            elif kind == "fail":
                self._on_fail(payload)
            elif kind == "drain":
                self._on_drain(payload)
            elif kind == "recover":
                self._on_recover(payload)
            else:
                self._on_step_end(payload)
        return self.finished

    # ---- fault injection ---------------------------------------------
    def fail_at(self, t: float, iid: int):
        """Schedule a hard instance failure: queue, running batch, and
        KV$ are lost; orphaned requests re-route cold elsewhere."""
        self._push(t, "fail", iid)

    def drain_at(self, t: float, iid: int):
        """Schedule a graceful drain: no new work routed to ``iid``;
        in-flight work completes and the KV$ survives."""
        self._push(t, "drain", iid)

    def recover_at(self, t: float, iid: int):
        """Schedule the instance rejoining the fleet (cold after a
        fail, warm after a drain)."""
        self._push(t, "recover", iid)

    def _peek_next_wave(self) -> Optional[List[Request]]:
        """The next arrival wave ``run`` would coalesce, or None if the
        next event isn't an arrival.  Pops the consecutive same-time
        arrival run off the heap top and pushes it straight back —
        ``(t, seq)`` keys are unique, so the pop order the run loop
        observes is unchanged.  The reference hands it to its pipeline as
        the cross-wave speculation hint; while engines are busy a step
        end is almost always at the heap top, so it is almost always
        None, and the port's hint is :meth:`_next_arrival_wave`
        instead."""
        ev = self._events
        if not ev or ev[0][2] != "arrival":
            return None
        t = ev[0][0]
        popped, wave = [], []
        while ev and ev[0][0] == t and ev[0][2] == "arrival":
            e = heapq.heappop(ev)
            popped.append(e)
            wave.append(e[3])
        for e in popped:
            heapq.heappush(ev, e)
        return wave

    def _next_arrival_wave(self) -> Optional[List[Request]]:
        """The arrival wave ``run`` will coalesce next, past any engine
        step ends before it: the same-time run at the top of the arrival
        heap, popped and pushed straight back.  The router's pipeline
        reads it as its cross-wave speculation hint (``next_wave_hint``)
        and walks that wave early on an asynchronous shard backend; step
        ends touch indicators but never the prefix index, so the walk
        stays exact, and the pipeline uses it only for the very wave it
        named."""
        arr = self._arrivals
        if not arr:
            return None
        t = arr[0][0]
        popped = []
        while arr and arr[0][0] == t:
            popped.append(heapq.heappop(arr))
        for e in popped:
            heapq.heappush(arr, e)
        return [e[3] for e in popped]

    # ------------------------------------------------------------------
    def _on_arrivals(self, reqs: List[Request]):
        if self._tracer is not None:
            # virtual clock: trace timestamps come from simulated time,
            # never wall time, so traces are byte-identical across runs;
            # the clock advances at the emitting handlers (arrival
            # waves, drops, churn), not once per heap event
            self._tracer.set_time(self.now)
        if self._admission is not None:
            # stamps deadlines (idempotent) and, with admission on, sheds
            # requests no live instance can serve in time
            tr = self._tracer
            span = (tr.span("admission", args={"k": len(reqs)})
                    if tr is not None else _NULL_CTX)
            with span:
                reqs, shed = self._admission.admit_wave(
                    self.router.factory, reqs, self.now,
                    alive=self.router.policy.alive)
            for req in shed:
                self._drop(req, "shed")
            if not reqs:
                return
        iids = self.router.route_batch(reqs, self.now)
        # per-request enqueue + step start in arrival order — identical
        # to interleaved handling (step starts never mutate indicators)
        for req, iid in zip(reqs, iids):
            self._enqueue(req, iid)

    def _on_arrival(self, req: Request):
        self._enqueue(req, self.router.route(req, self.now))

    def _enqueue(self, req: Request, iid: int):
        inst = self.instances[iid]
        reg = self._registry
        if reg is not None and inst.waiting:
            # cross-family interference: the prefill tokens already
            # queued ahead of this request displace it, counted as
            # interference.displaced_tokens.<victim>.<displacer>
            fam = req.family or "default"
            left = inst.prefill_left
            for rid2, r2 in inst.waiting.items():
                reg.inc("interference.displaced_tokens.%s.%s"
                        % (fam, r2.family or "default"), left[rid2])
        inst.waiting[req.rid] = req
        inst.prefill_left[req.rid] = max(req.new_tokens, 1)
        if not inst.busy:
            self._start_step(inst)

    def _start_step(self, inst: _SimInstance):
        if self.overload.retraction or self.overload.patience_retraction:
            self._retract_expired(inst)
        allocs, decode_bs, ctx = inst.form_batch()
        prefill_tokens = sum(t for _, t in allocs)
        if prefill_tokens == 0 and decode_bs == 0:
            inst.busy = False
            return
        # ground truth is per instance: inst.model IS self.model on a
        # homogeneous fleet and the instance's own spec's model on a
        # heterogeneous one
        dt = inst.model.step_time(prefill_tokens, decode_bs, ctx)
        inst.busy = True
        # telemetry: attribute step time to 10s windows
        total = prefill_tokens + decode_bs
        inst.account_step(self.now, dt,
                          prefill_tokens / total if total else 0.0)
        inst.bs_samples.append((self.now, len(inst.running)
                                + len(inst.waiting)))
        self._push(self.now + dt, "step_end",
                   (inst.iid, allocs, decode_bs, inst.epoch))

    def _should_retract(self, req: Request, inst: _SimInstance) -> bool:
        """Retraction predicate, hard-deadline flavour: the prefill
        deadline has passed, so the first token cannot arrive in time.
        ``ClosedLoopSim`` adds the patience-driven early variant."""
        return (self.overload.retraction and req.deadline is not None
                and req.deadline.prefill_blown(self.now))

    def _retract_expired(self, inst: _SimInstance):
        """Cancel the queued-or-prefilling requests ``_should_retract``
        condemns: their remaining prefill would be burnt on a certain
        breach.  Runs when a step forms, between steps, so no in-flight
        allocation refers to a retracted rid."""
        expired = [rid for rid, r in inst.waiting.items()
                   if self._should_retract(r, inst)]
        for rid in expired:
            req = inst.waiting.pop(rid)
            left = inst.prefill_left.pop(rid)
            burnt = max(req.new_tokens, 1) - left
            req.prefill_done = burnt
            self.retractions += 1
            self.wasted_prefill_tokens += burnt
            self.router.on_retract(inst.iid, req, left)
            self._drop(req, "retracted")

    def _drop(self, req: Request, reason: str):
        """A request leaves the system unserved (shed or retracted).
        ``ClosedLoopSim`` also feeds the drop back to its session."""
        req.drop_reason = reason
        req.t_drop = self.now
        self.dropped.append(req)
        if self._obs is not None:
            if self._registry is not None:
                self._registry.inc("events.drop.%s" % reason)
            if self._tracer is not None:
                self._tracer.set_time(self.now)
                self._tracer.instant(
                    "drop", args={"rid": req.rid, "reason": reason,
                                  "family": req.family})
            if self._prov is not None:
                self._prov.outcome(req, reason, self.now)

    # ---- instance churn ----------------------------------------------
    def _on_fail(self, iid: int):
        """Hard failure: the instance's queue, running batch and KV$ are
        gone.  ``Router.mark_failed`` takes the failure to scoring, the
        index, the mirror and speculation before anything else routes;
        the orphans re-arrive *now* (through ``_push``, so that the
        speculation hint sees them) for a cold re-prefill elsewhere."""
        inst = self.instances[iid]
        inst.epoch += 1          # the outstanding step_end becomes stale
        inst.busy = False
        orphans = list(inst.waiting.values()) + list(inst.running)
        inst.waiting.clear()
        inst.prefill_left.clear()
        inst.running = []
        inst.generated = {}
        if self._tracer is not None:
            self._tracer.set_time(self.now)
        self.router.mark_failed(iid)
        self.churn_events.append(
            {"t": self.now, "iid": iid, "kind": "fail",
             "orphans": len(orphans)})
        for req in orphans:
            # lost KV$: a cold re-prefill from scratch; the original
            # arrival time stays, so TTFT carries the failure's cost
            req.sched_to = -1
            req.hit_tokens = 0
            req.t_sched = 0.0
            req.t_first_token = 0.0
            req.retries += 1
            self._orphan_fail_t.setdefault(req.rid, self.now)
            self._push(self.now, "arrival", req)

    def _on_drain(self, iid: int):
        if self._tracer is not None:
            self._tracer.set_time(self.now)
        self.router.mark_drained(iid)
        self.churn_events.append(
            {"t": self.now, "iid": iid, "kind": "drain", "orphans": 0})

    def _on_recover(self, iid: int):
        if self._tracer is not None:
            self._tracer.set_time(self.now)
        self.router.mark_recovered(iid)
        self.churn_events.append(
            {"t": self.now, "iid": iid, "kind": "recover", "orphans": 0})

    def _on_step_end(self, payload):
        iid, allocs, decode_bs, epoch = payload
        inst = self.instances[iid]
        if epoch != inst.epoch:
            return               # a step from before the instance failed
        # prefill progress
        for req, tokens in allocs:
            inst.prefill_left[req.rid] -= tokens
            self.router.on_prefill_progress(iid, tokens)
            if inst.prefill_left[req.rid] <= 0:
                req.t_first_token = self.now            # first token emitted
                del inst.waiting[req.rid]               # O(1) by rid
                del inst.prefill_left[req.rid]
                self.router.on_start_running(iid, req)
                if req.output_len <= 1:
                    self._finish(inst, req)
                else:
                    inst.running.append(req)
                    inst.generated[req.rid] = 1
        # decode progress: each running request emitted one token
        done = []
        for req in list(inst.running):
            if inst.generated.get(req.rid) is None:
                continue
            if req.t_first_token == self.now:
                continue  # joined this step; starts decoding next step
            inst.generated[req.rid] += 1
            self.router.on_decode_token(iid)
            if inst.generated[req.rid] >= req.output_len:
                done.append(req)
        for req in done:
            inst.running.remove(req)
            del inst.generated[req.rid]
            self._finish(inst, req)
        if inst.has_work():
            self._start_step(inst)
        else:
            inst.busy = False

    def _finish(self, inst: _SimInstance, req: Request):
        req.t_finish = self.now
        self.router.on_finish(inst.iid, req)
        self.finished.append(req)
        t_fail = self._orphan_fail_t.pop(req.rid, None)
        if t_fail is not None:
            # churn recovery latency: failure -> first token elsewhere
            self.churn_recovery.append(req.t_first_token - t_fail)
            if self._registry is not None:
                self._registry.observe("churn.recovery_s",
                                       req.t_first_token - t_fail)
        if self._registry is not None:
            # per-family queue delay (schedule -> first token): the
            # latency half of the interference view
            self._registry.observe(
                "interference.queue_delay_ms.%s"
                % (req.family or "default"),
                (req.t_first_token - req.t_sched) * 1e3)
        if self._prov is not None:
            self._prov.outcome(req, "finished", self.now)

    def metrics_snapshot(self) -> Dict:
        """One merged registry snapshot of this run: the router's own
        accumulators (``repro_torch.obs.registry.ingest_router``), the
        simulator's counters (drops, retractions, churn) and the
        admission gate's.  Works with or without an obs bundle (without
        one, a fresh registry); all ingestion is ``counter_set``, so
        repeated calls never double-count."""
        from ..obs.registry import MetricsRegistry, ingest_router
        reg = (self._registry if self._registry is not None
               else MetricsRegistry())
        ingest_router(reg, self.router)
        reg.counter_set("sim.finished", len(self.finished))
        reg.counter_set("sim.dropped", len(self.dropped))
        reg.counter_set("sim.retractions", self.retractions)
        reg.counter_set("sim.wasted_prefill_tokens",
                        int(self.wasted_prefill_tokens))
        reg.counter_set("sim.churn_events", len(self.churn_events))
        if self._admission is not None:
            self._admission.metrics_into(reg)
        return reg.snapshot()

    def overload_stats(self) -> Dict:
        """Raw overload and churn counters of this run; the derived
        wasted fraction is ``cluster.metrics.overload_summary``'s."""
        return {
            "shed": sum(1 for r in self.dropped
                        if r.drop_reason == "shed"),
            "retracted": self.retractions,
            "wasted_prefill_tokens": int(self.wasted_prefill_tokens),
            "churn_events": len(self.churn_events),
            "reroutes": sum(e["orphans"] for e in self.churn_events),
            "degraded_rebuilds": self.router.factory.degraded_rebuilds,
        }

    # ------------------------------------------------------------------
    def imbalance_profile(self) -> Dict[int, List[float]]:
        """window -> per-instance prefill seconds (Fig. 10 / Fig. 25)."""
        windows = set()
        for inst in self.instances:
            inst.flush_telemetry()
            windows |= set(inst.prefill_seconds)
        out = {}
        for w in sorted(windows):
            out[w] = [inst.prefill_seconds.get(w, 0.0)
                      for inst in self.instances]
        return out

    def batch_timeline(self):
        return {inst.iid: inst.bs_samples for inst in self.instances}
