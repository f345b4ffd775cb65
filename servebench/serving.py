"""One run of a serving cell: set-up, the measured window, and what the
window saw.

The window drives the program's own loop, ``EngineCluster.run``: the
router (``Router.route`` under ``LMetricPolicy``), then
``InstanceEngine.step``, ``Model.prefill_cached`` / ``Model.decode_step``
and their kernels.  Nothing of the program is replaced.  The benchmark
wraps each engine's ``step`` and the router's ``route`` on their
instances, to record what they did and to end the loop: the first step
of the measured ``run`` call starts the wall clock (after ``run``'s own
per-engine warm-up), and the first step that would start ``seconds``
later raises ``WindowClosed`` instead, which ends ``run``.

Times are the program's virtual time: each engine's clock is the sum of
its own steps' measured walls, and an idle engine's clock jumps to the
arrival that wakes it, as ``EngineCluster.run`` keeps them.  The
recorder keeps the same clocks from what it sees (the route's time and
whether the engine was idle, each step's wall), so it can time every
token, which the program does not record, and it checks its clocks
against the first-token times the program writes.
"""
from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import weights
from .traffic_gen import Workload


class WindowClosed(Exception):
    """Raised by a step wrapper once the window's time is up."""


# ---------------------------------------------------------------------------
def port_config(cfg: Dict):
    """The program's ``ModelConfig`` from a configuration file's ``port``
    group, held to the file's published widths."""
    from repro_torch.models.config import ModelConfig
    kw = dict(cfg["port"])
    kind = kw.pop("block_kind")
    kw["block_pattern"] = (kind,) * kw["n_layers"]
    mc = ModelConfig(**kw)
    moe = bool(cfg.get("num_experts"))
    want = {
        "n_layers": cfg["num_hidden_layers"],
        "d_model": cfg["hidden_size"],
        "n_heads": cfg["num_attention_heads"],
        "n_kv_heads": cfg["num_key_value_heads"],
        "resolved_head_dim": cfg.get("head_dim")
        or cfg["hidden_size"] // cfg["num_attention_heads"],
        "vocab_size": cfg["vocab_size"],
        "rope_theta": cfg["rope_theta"],
        "norm_eps": cfg["rms_norm_eps"],
        "tie_embeddings": cfg["tie_word_embeddings"],
        "qk_norm": cfg["model_type"].startswith("qwen3"),
        "n_experts": cfg.get("num_experts", 0),
        "top_k": cfg.get("num_experts_per_tok", 0),
        "dtype": cfg["torch_dtype"],
    }
    if moe:
        want["resolved_moe_d_ff"] = cfg["moe_intermediate_size"]
    else:
        want["d_ff"] = cfg["intermediate_size"]
    bad = {k: (getattr(mc, k), v) for k, v in want.items()
           if getattr(mc, k) != v}
    if bad:
        raise ValueError(f"{cfg['name']}: the program's config departs "
                         f"from the published one: {bad}")
    return mc


@dataclass
class Built:
    model: object
    params: Dict


def build(cfg: Dict, seed: int, device) -> Built:
    from repro_torch.models.model import Model
    mc = port_config(cfg)
    layout = Model(mc, device="meta").abstract_params()
    params = weights.make_params(layout, seed, torch.device(device))
    return Built(Model(mc, device=device), params)


def make_cluster(built: Built, serving: Dict, device):
    from repro_torch.core import LMetricPolicy
    from repro_torch.serving.engine import EngineCluster
    return EngineCluster(serving["engines"], built.model, built.params,
                         LMetricPolicy(), block_size=serving["block_size"],
                         device=device, max_batch=serving["max_batch"],
                         max_len=serving["max_len"],
                         chunk_tokens=serving["chunk_tokens"],
                         prefix_capacity=serving["prefix_capacity"])


# ---------------------------------------------------------------------------
@dataclass
class Rec:
    """One request due in the window."""
    rid: int
    arrival: float
    tokens: np.ndarray
    output_len: int
    iid: int
    req: object                            # the program's Request
    computed: int = 0                      # prompt tokens prefilled
    times: List[float] = field(default_factory=list)   # virtual, per token
    n_traced: int = 0                      # of them, from profiled steps
    out: Optional[List[int]] = None        # served tokens once finished

    @property
    def finished(self) -> bool:
        return self.out is not None


@dataclass
class Step:
    iid: int
    kind: str
    wall: float
    prefill: int                 # chunk tokens
    start: int                   # cached tokens before the chunk
    ctx: Optional[np.ndarray]    # decode: every slot's context length
    spans: list                  # (start, n) of each sequence served
    tokens: int                  # output tokens the step produced
    traced: bool


class Recorder:
    """Wraps a cluster's router and engines; see the module docstring."""

    def __init__(self, cluster, seconds: float, tracer=None,
                 trace_seconds: float = 0.0):
        self.engines = cluster.engines
        self.seconds = seconds
        self.tracer = tracer
        self.trace_seconds = trace_seconds
        self.events: List[tuple] = []     # the router reference's log
        self.decisions: List[int] = []    # the program's placements
        self.measure = False
        self.draining = False
        self.sent: List[tuple] = []
        self.clock = [0.0] * len(self.engines)
        self.recs: Dict[int, Rec] = {}
        self.steps: List[Step] = []
        self.t_start = self.t_end = None
        self.t_cut = 0.0
        route = cluster.router.route
        cluster.router.route = lambda req, now: self._route(route, req, now)
        for eng in self.engines:
            eng.step = self._stepper(eng, eng.step)

    def phase(self, sent: List[tuple], measure: bool):
        """Before each ``run`` call: the arrival list (the closed loop
        appends to it), and whether this call is the measured one."""
        self.sent = sent
        self.measure = measure
        self.clock = [0.0] * len(self.engines)
        self.t_cut = 0.0

    # ------------------------------------------------------------------
    def _route(self, route, req, now):
        with _span(self.tracer, "sb.route"):
            iid = route(req, now)
        toks = self.sent[req.rid][1]
        self.events.append(("route", toks, req.output_len))
        self.decisions.append(iid)
        if not self.engines[iid].has_work():      # was idle: clock jumps
            self.clock[iid] = max(self.clock[iid], now)
        if self.measure:
            self.recs[req.rid] = Rec(req.rid, now, toks, req.output_len, iid,
                                     req)
        self.t_cut = max(self.t_cut, now)
        return iid

    def _stepper(self, eng, step):
        def wrapped():
            return self._step(eng, step)
        return wrapped

    def _step(self, eng, step):
        iid = eng.iid
        traced = False
        # steps are popped in virtual-time order: the close is the last
        self.t_cut = max(self.t_cut, self.clock[iid])
        if self.measure:
            now = time.perf_counter()
            if self.t_start is None:
                self.t_start = now
            elif now - self.t_start >= self.seconds:
                raise WindowClosed()
            tr = self.tracer
            if tr is not None and not tr.active and \
                    now - self.t_start >= self.seconds - self.trace_seconds:
                tr.start()
            traced = tr is not None and tr.active
        head = eng.waiting[0] if eng.waiting else None
        running = list(eng.running.values())
        pos = eng._pos.copy()
        kind = "prefill" if head is not None and eng.free_slots else \
            ("decode" if running else "idle")
        if self.tracer is not None:
            self.tracer.kind = kind
        with _span(self.tracer, "sb." + kind):
            ev = step()
        if self.measure:
            self.t_end = time.perf_counter()
        self.clock[iid] += ev["wall"]
        vt = self.clock[iid]
        n = ev["prefill_tokens"]
        self.events.append(("step", iid, ev["kind"], n, len(ev["first"]),
                            len(ev["finished"])))
        recs = self.recs
        if self.draining:
            if ev["kind"] == "prefill" and head.req.rid in recs:
                recs[head.req.rid].computed += n
            for seq in ev["finished"]:
                if seq.req.rid in recs:
                    recs[seq.req.rid].out = list(seq.out_tokens)
            return ev
        if not self.measure:
            return ev
        if ev["kind"] == "prefill":
            start = head.pos - n
            rec = recs.get(head.req.rid)
            if rec is not None:
                rec.computed += n
                if any(s is head for s in ev["first"]):
                    rec.times.append(vt)
                    rec.n_traced += traced
            self.steps.append(Step(iid, "prefill", ev["wall"], n, start,
                                   None, [(start, n)], len(ev["first"]),
                                   traced))
        elif ev["kind"] == "decode":
            S = eng.max_len
            ctx = np.minimum(pos, S - 1) + 1
            spans = []
            for seq in running:
                spans.append((int(pos[seq.slot]), 1))
                rec = recs.get(seq.req.rid)
                if rec is not None:
                    rec.times.append(vt)
                    rec.n_traced += traced
            self.steps.append(Step(iid, "decode", ev["wall"], 0, 0, ctx,
                                   spans, len(running), traced))
        for seq in ev["finished"]:
            rec = recs.get(seq.req.rid)
            if rec is not None:
                rec.out = list(seq.out_tokens)
        return ev

    def check_clocks(self):
        """The recorder's first-token times against the program's."""
        for rec in self.recs.values():
            t = rec.req.t_first_token
            if rec.times and rec.times[0] != t:
                raise AssertionError(
                    f"request {rec.rid}: first token at {rec.times[0]} by "
                    f"the recorder, {t} by the program")


@contextlib.contextmanager
def _span(tracer, name):
    if tracer is not None and tracer.active:
        with torch.profiler.record_function(name):
            yield
    else:
        yield


# ---------------------------------------------------------------------------
@dataclass
class Window:
    recorder: Recorder
    seconds: float      # wall from the first step's start to the last's end
    t_cut: float        # virtual time at the close
    requests: Dict[int, Rec]


def serve(cluster, work: Workload, seconds: float, tracer=None,
          trace_seconds: float = 0.0) -> Window:
    """The warm-up requests, then the measured window."""
    rec = Recorder(cluster, seconds, tracer, trace_seconds)
    if work.warmup:
        rec.phase(list(work.warmup), measure=False)
        cluster.run(list(work.warmup))
    sent: List[tuple] = []
    feedback = None
    if work.clients:
        pending = iter(work.requests[work.clients:])
        sent.extend(work.requests[:work.clients])

        def feedback(req, now):
            nxt = next(pending, None)
            if nxt is None:
                return []
            sent.append((now, nxt[1], nxt[2]))
            return [sent[-1]]
    else:
        sent.extend(work.requests)
    rec.phase(sent, measure=True)
    try:
        cluster.run(list(sent), feedback=feedback)
    except WindowClosed:
        pass
    finally:
        if tracer is not None and tracer.active:
            tracer.stop()
    rec.check_clocks()
    return Window(rec, rec.t_end - rec.t_start, rec.t_cut, rec.recs)


def drain(cluster, window: Window, enough, seconds: float) -> float:
    """Past the close, untimed: step the engines (the program's own
    ``step``; nothing new arrives) until ``enough(requests)`` holds, so
    that the check finds the answers it samples finished, or until
    ``seconds`` of wall have passed.  A request the window left queued
    or decoding finishes here as it would have; its times are not
    recorded, and no metric reads what the drain did.  Returns the
    seconds it took."""
    rec = window.recorder
    rec.measure, rec.draining = False, True
    t0 = time.perf_counter()
    reqs = list(window.requests.values())
    while not enough(reqs) and time.perf_counter() - t0 < seconds:
        busy = [e for e in cluster.engines if e.has_work()]
        if not busy:
            break
        for eng in busy:
            eng.step()
    rec.draining = False
    return time.perf_counter() - t0


def free(cluster):
    """Drop the program's serving state (caches, stored fragments) so
    that the reference has the card."""
    for eng in cluster.engines:
        eng.cache = None
        eng.prefix_store = None
    cluster.engines = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
