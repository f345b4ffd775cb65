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

The port simulates a homogeneous fleet with no overload control, no
instance churn and no observability bundle; those paths raise
``NotImplementedError`` naming the ROADMAP Queue A item that ports them
(5: observability, 6: fleets, 7: overload control and churn).
"""
from __future__ import annotations

import collections
import heapq
import itertools
from typing import Dict, List, Optional

from ..core.latency_model import EngineSpec, LatencyModel
from ..core.router import Router
from ..core.types import Request
from ..core.types import not_ported as _not_ported

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
    """The reference's heterogeneous testbed (a fast and a slow model
    class); needs the fleet module."""
    raise _not_ported("make_mixed_fleet", 6, "core/fleet.py")


class ClusterSim:
    def __init__(self, router: Router, spec: EngineSpec,
                 model: Optional[LatencyModel] = None,
                 overload=None):
        if overload is not None:
            raise _not_ported("overload control", 7, "core/overload.py")
        if getattr(router.factory, "fleet", None) is not None:
            raise _not_ported("a heterogeneous fleet", 6, "core/fleet.py")
        if getattr(router, "obs", None) is not None:
            raise _not_ported("a router with an observability bundle", 5,
                              "obs/")
        self.router = router
        self.spec = spec
        self.model = model or LatencyModel(spec)
        # homogeneous: every instance shares THE model object (the
        # reference's construction without a fleet)
        self.instances = [_SimInstance(i, spec, self.model)
                          for i in range(len(router.factory))]
        self._events: List = []
        # the arrival events still in _events, in the same (t, seq) order
        self._arrivals: List = []
        self._seq = itertools.count()
        self.now = 0.0
        self.finished: List[Request] = []
        # wave pipelining: the router's pipeline asks for the next
        # arrival wave, so that an asynchronous walk backend starts wave
        # k+1's walk while wave k's score stage runs (see
        # repro_torch.core.pipeline)
        router.pipeline.next_wave_hint = self._next_arrival_wave

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
            else:
                self._on_step_end(payload)
        return self.finished

    # ---- instance churn, overload and observability (not ported) -----
    def fail_at(self, t: float, iid: int):
        raise _not_ported("instance failure", 7, "the router's churn hooks")

    def drain_at(self, t: float, iid: int):
        raise _not_ported("instance drain", 7, "the router's churn hooks")

    def recover_at(self, t: float, iid: int):
        raise _not_ported("instance recovery", 7,
                          "the router's churn hooks")

    def metrics_snapshot(self) -> Dict:
        raise _not_ported("metrics_snapshot", 5, "obs/registry.py")

    def overload_stats(self) -> Dict:
        raise _not_ported("overload_stats", 7, "core/overload.py")

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
        iids = self.router.route_batch(reqs, self.now)
        # per-request enqueue + step start in arrival order — identical
        # to interleaved handling (step starts never mutate indicators)
        for req, iid in zip(reqs, iids):
            self._enqueue(req, iid)

    def _on_arrival(self, req: Request):
        self._enqueue(req, self.router.route(req, self.now))

    def _enqueue(self, req: Request, iid: int):
        inst = self.instances[iid]
        inst.waiting[req.rid] = req
        inst.prefill_left[req.rid] = max(req.new_tokens, 1)
        if not inst.busy:
            self._start_step(inst)

    def _start_step(self, inst: _SimInstance):
        allocs, decode_bs, ctx = inst.form_batch()
        prefill_tokens = sum(t for _, t in allocs)
        if prefill_tokens == 0 and decode_bs == 0:
            inst.busy = False
            return
        dt = inst.model.step_time(prefill_tokens, decode_bs, ctx)
        inst.busy = True
        # telemetry: attribute step time to 10s windows
        total = prefill_tokens + decode_bs
        inst.account_step(self.now, dt,
                          prefill_tokens / total if total else 0.0)
        inst.bs_samples.append((self.now, len(inst.running)
                                + len(inst.waiting)))
        self._push(self.now + dt, "step_end", (inst.iid, allocs, decode_bs))

    def _on_step_end(self, payload):
        iid, allocs, decode_bs = payload
        inst = self.instances[iid]
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
