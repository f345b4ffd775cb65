"""PD-disaggregated cluster simulator (paper §7 Discussion) — port of
``repro.cluster.pd_disagg``.

Prefill instances run chunked prefill only; decode instances run decode
batches only.  Routing follows the paper's §7 prescription:

* prefill pool — the unified indicator: queued new-prefill tokens after
  KV$ hits (P-token), select_min.  A same-timestamp arrival wave of two
  or more is scored in one ``route_score`` call of the ``ptoken`` kind
  over the prefill factory's mirror (a launch on a card), committed
  under ``commit_wave_plan``'s mid-wave eviction guard; it is
  bit-identical to routing the requests one by one.
* decode pool — load balance on batch size (BS), select_min.

KV$ migration: on prefill completion the request's KV$ is transferred
prefill→decode instance over the interconnect;
``transfer_s = base + tokens × kv_bytes_per_token / link_bw``.

``device`` (default ``"cuda"``) is where both pools' indicator mirrors
live; ``device="cpu"`` runs the plain version of ``route_score``.
"""
from __future__ import annotations

import collections
import heapq
import itertools
from typing import Dict, List

import numpy as np

from ..core.indicators import IndicatorFactory
from ..core.latency_model import EngineSpec, LatencyModel
from ..core.router import commit_wave_plan
from ..core.types import Request
from ..kernels import route_score

LINK_BW = 50e9          # bytes/s instance-to-instance (RDMA class)
TRANSFER_BASE = 0.002   # s


class PDDisaggSim:
    def __init__(self, n_prefill: int, n_decode: int, spec: EngineSpec,
                 kv_capacity_tokens: int = 400_000, block_size: int = 64,
                 device="cuda"):
        self.spec = spec
        self.model = LatencyModel(spec)
        self.pf = IndicatorFactory(n_prefill, kv_capacity_tokens,
                                   block_size, device=device)
        self.df = IndicatorFactory(n_decode, device=device)
        self.p_wait = [collections.deque() for _ in range(n_prefill)]
        self.p_left: Dict[int, int] = {}
        self.p_busy = [False] * n_prefill
        self.d_run: List[List[Request]] = [[] for _ in range(n_decode)]
        self.d_gen: Dict[int, int] = {}
        self.d_busy = [False] * n_decode
        self._events: List = []
        self._seq = itertools.count()
        self.now = 0.0
        self.finished: List[Request] = []

    # ------------------------------------------------------------------
    def _push(self, t, kind, payload):
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    def run(self, requests: List[Request]):
        for r in requests:
            self._push(r.arrival, "arrival", r)
        while self._events:
            t, _, kind, payload = heapq.heappop(self._events)
            self.now = t
            if kind == "arrival":
                # coalesce consecutive same-timestamp arrivals through
                # the batched prefill-pool routing path
                wave = [payload]
                while (self._events and self._events[0][0] == t
                       and self._events[0][2] == "arrival"):
                    wave.append(heapq.heappop(self._events)[3])
                self._on_arrivals(wave)
            else:
                getattr(self, "_on_" + kind)(payload)
        return self.finished

    # ---- prefill pool -------------------------------------------------
    def _on_arrivals(self, reqs: List[Request]):
        if len(reqs) > 1 and self.pf._agg is not None:
            # §7 unified indicator scored as one device wave ("ptoken"
            # kind: raw P-token, first-min selection); commit under the
            # shared mid-wave eviction guard
            depth, lcp, plen = self.pf.wave_inputs(reqs)
            rbs, qbs, qpt, tt = self.pf.device_view()
            sel, hits = route_score.route_wave(
                "ptoken", (), self.pf.block_size, rbs, qbs, qpt, tt,
                depth, lcp, plen, 0)
            commit_wave_plan(
                self.pf, reqs,
                lambda j, req: self._admit_prefill(req, int(sel[j]),
                                                   int(hits[j])),
                self._on_arrival)
        else:
            for req in reqs:
                self._on_arrival(req)

    def _on_arrival(self, req: Request):
        # §7: unified indicator = P-token (new tokens after hit + queue)
        hits = self.pf.hits_for(req)
        scores = self.pf.p_tokens_for(req, hits)
        iid = int(np.argmin(scores))
        self._admit_prefill(req, iid, int(hits[iid]))

    def _admit_prefill(self, req: Request, iid: int, hit: int):
        inst = self.pf[iid]
        req.sched_to = iid
        req.hit_tokens = hit
        req.t_sched = self.now
        inst.on_route(req, self.now, hit)
        inst.kv.insert(req.blocks)
        self.p_wait[iid].append(req)
        self.p_left[req.rid] = max(req.new_tokens, 1)
        if not self.p_busy[iid]:
            self._start_prefill(iid)

    def _start_prefill(self, iid: int):
        q = self.p_wait[iid]
        if not q:
            self.p_busy[iid] = False
            return
        budget = self.spec.chunk_tokens
        allocs = []
        for req in q:
            if budget <= 0:
                break
            take = min(self.p_left[req.rid], budget)
            allocs.append((req, take))
            budget -= take
        tokens = sum(t for _, t in allocs)
        dt = self.model.step_time(tokens, 0, 0)
        self.p_busy[iid] = True
        self._push(self.now + dt, "prefill_end", (iid, allocs))

    def _on_prefill_end(self, payload):
        iid, allocs = payload
        for req, take in allocs:
            self.p_left[req.rid] -= take
            self.pf[iid].on_prefill_progress(take)
            if self.p_left[req.rid] <= 0:
                req.t_first_token = self.now
                self.p_wait[iid].remove(req)
                del self.p_left[req.rid]
                self.pf[iid].on_start_running(req)
                self.pf[iid].on_finish(req)
                # KV$ transfer to the decode pool
                dt = TRANSFER_BASE + (req.prompt_len
                                      * self.spec.kv_bytes_per_token
                                      / LINK_BW)
                self._push(self.now + dt, "decode_admit", req)
        self._start_prefill(iid)

    # ---- decode pool ---------------------------------------------------
    def _on_decode_admit(self, req: Request):
        did = int(np.argmin(self.df.bs_vector()))     # §7: select_min(BS)
        self.df[did].on_route(req, self.now, 0)
        self.df[did].on_start_running(req)
        if req.output_len <= 1:
            self._finish(did, req)
            return
        self.d_run[did].append(req)
        self.d_gen[req.rid] = 1
        if not self.d_busy[did]:
            self._start_decode(did)

    def _start_decode(self, did: int):
        run = self.d_run[did]
        if not run:
            self.d_busy[did] = False
            return
        ctx = sum(r.prompt_len + self.d_gen[r.rid] for r in run)
        dt = self.model.step_time(0, len(run), ctx)
        self.d_busy[did] = True
        self._push(self.now + dt, "decode_end", did)

    def _on_decode_end(self, did: int):
        done = []
        for req in list(self.d_run[did]):
            self.d_gen[req.rid] += 1
            self.df[did].on_decode_token()
            if self.d_gen[req.rid] >= req.output_len:
                done.append(req)
        for req in done:
            self.d_run[did].remove(req)
            del self.d_gen[req.rid]
            self._finish(did, req)
        self._start_decode(did)

    def _finish(self, did: int, req: Request):
        req.t_finish = self.now
        self.df[did].on_finish(req)
        self.finished.append(req)
