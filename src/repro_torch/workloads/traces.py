"""Synthetic open-loop serving traces (port of ``repro.workloads.traces``).

Deterministic in ``seed`` and request-for-request identical to the
reference generators: the same numpy ``RandomState`` draws in the same
order.  Prompts are block-id sequences (64-token blocks): an app-level
system prefix shared across conversations of the same app, plus
per-conversation history that grows turn by turn.  ``make_hotspot_trace``
is the §5.2 adversarial workload (one long shared prefix in a burst).
``trace_stats`` and ``estimate_capacity_qps`` size a simulation's
request rate from a trace and an ``EngineSpec``.

These generators stamp every arrival when the trace is made (open
loop): turn ``t+1`` arrives on schedule even while turn ``t`` is still
queued, which flatters a bad scheduler.  ``make_trace(...,
closed_loop=True)`` returns deterministic session state machines
(``repro_torch.workloads.sessions``) instead, to drive with
``repro_torch.cluster.closed_loop.ClosedLoopSim``.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import zlib
from typing import Dict, List

import numpy as np

from ..core.radix import RadixKVIndex
from ..core.types import Request

BLOCK = 64  # tokens per block


@dataclasses.dataclass
class TraceFamily:
    name: str
    app_prefix_blocks: int        # shared system-prompt size (blocks)
    n_apps: int                   # distinct apps (zipf popularity)
    zipf_a: float                 # app popularity skew
    turns_mean: float             # conversation length (turns)
    first_input_blocks: float     # extra prompt blocks on turn 1
    turn_input_blocks: float      # new user blocks per later turn
    output_tokens_mean: float
    output_tokens_cv: float
    think_time_mean: float        # seconds between turns
    arrival_cv: float             # inter-arrival burstiness (gamma CV)
    rate_wobble: float            # sinusoidal rate fluctuation amplitude


FAMILIES: Dict[str, TraceFamily] = {
    "chatbot": TraceFamily("chatbot", app_prefix_blocks=12, n_apps=8,
                           zipf_a=1.2, turns_mean=5.0,
                           first_input_blocks=18, turn_input_blocks=4,
                           output_tokens_mean=320, output_tokens_cv=0.8,
                           think_time_mean=25.0, arrival_cv=1.0,
                           rate_wobble=0.10),
    "agent": TraceFamily("agent", app_prefix_blocks=10, n_apps=24,
                         zipf_a=1.4, turns_mean=1.6,
                         first_input_blocks=4, turn_input_blocks=2,
                         output_tokens_mean=96, output_tokens_cv=0.6,
                         think_time_mean=4.0, arrival_cv=1.3,
                         rate_wobble=0.10),
    "coder": TraceFamily("coder", app_prefix_blocks=24, n_apps=12,
                         zipf_a=1.1, turns_mean=8.0,
                         first_input_blocks=90, turn_input_blocks=20,
                         output_tokens_mean=480, output_tokens_cv=0.9,
                         think_time_mean=12.0, arrival_cv=1.8,
                         rate_wobble=0.20),
    "toolagent": TraceFamily("toolagent", app_prefix_blocks=30, n_apps=6,
                             zipf_a=1.3, turns_mean=14.0,
                             first_input_blocks=25, turn_input_blocks=8,
                             output_tokens_mean=150, output_tokens_cv=0.5,
                             think_time_mean=2.0, arrival_cv=1.2,
                             rate_wobble=0.10),
}

TRACES = tuple(FAMILIES) + ("hotspot",)


# ---------------------------------------------------------------------------
def make_trace(name: str, qps: float, duration: float,
               seed: int = 0, closed_loop: bool = False):
    """Open-loop request list for one of ``TRACES``, sorted by arrival;
    or, with ``closed_loop=True``, ``Session`` state machines whose start
    rate matches this family's session rate at ``qps`` (later turns'
    arrivals are decided by the driver's feedback loop)."""
    if closed_loop:
        from .sessions import SESSIONS, make_sessions
        if name == "hotspot":
            raise ValueError("hotspot is an open-loop adversarial trace; "
                             "closed-loop families: " +
                             "/".join(SESSIONS))
        # offered request qps to a session-start rate, by the session
        # spec's own turn count and fan-out
        conv_rate = qps / SESSIONS[name].expected_requests()
        return make_sessions(name, n_sessions=max(1, int(conv_rate
                                                         * duration)),
                             seed=seed, start_rate=conv_rate)
    if name == "hotspot":
        return make_hotspot_trace(qps, duration, seed)
    fam = FAMILIES[name]
    # stable digest, not hash(): string hashing is salted per process
    rng = np.random.RandomState(seed ^ (zlib.crc32(name.encode("utf-8"))
                                        & 0x7FFFFFFF))
    block_ids = itertools.count(1)
    rid = itertools.count(0)

    # app prefixes (block id sequences), zipf popularity
    apps = [tuple(next(block_ids) for _ in range(fam.app_prefix_blocks))
            for _ in range(fam.n_apps)]
    app_p = 1.0 / np.arange(1, fam.n_apps + 1) ** fam.zipf_a
    app_p /= app_p.sum()

    # conversation starts arrive as a (bursty) renewal process whose rate
    # is chosen so total request rate ≈ qps
    conv_rate = qps / fam.turns_mean
    requests: List[Request] = []
    conv_id = itertools.count(0)
    t = 0.0
    shape = 1.0 / (fam.arrival_cv ** 2)
    while t < duration:
        # sinusoidal wobble around the base rate (paper Fig. 5)
        rate = conv_rate * (1.0 + fam.rate_wobble
                            * math.sin(2 * math.pi * t / 300.0))
        gap = rng.gamma(shape, 1.0 / (shape * max(rate, 1e-6)))
        t += gap
        if t >= duration:
            break
        cid = next(conv_id)
        app = int(rng.choice(fam.n_apps, p=app_p))
        history = list(apps[app])
        n_turns = max(1, int(rng.poisson(fam.turns_mean)))
        turn_t = t
        for turn in range(n_turns):
            nb = fam.first_input_blocks if turn == 0 else fam.turn_input_blocks
            nb = max(1, int(rng.poisson(nb)))
            history.extend(next(block_ids) for _ in range(nb))
            out = max(2, int(rng.lognormal(
                math.log(fam.output_tokens_mean),
                fam.output_tokens_cv * 0.7)))
            prompt = tuple(history)
            requests.append(Request(
                rid=next(rid), arrival=turn_t, blocks=prompt,
                prompt_len=len(prompt) * BLOCK, output_len=out,
                class_id=cid if fam.turns_mean > 2.5 else app,
                family=name))
            # answer becomes part of the cached context of the next turn
            history.extend(next(block_ids)
                           for _ in range(max(1, out // BLOCK)))
            turn_t += max(0.5, rng.exponential(fam.think_time_mean)) \
                + out * 0.02  # generation time proxy
            if turn_t >= duration:
                break
    requests.sort(key=lambda r: r.arrival)
    for i, r in enumerate(requests):
        r.rid = i
    return requests


# ---------------------------------------------------------------------------
def make_hotspot_trace(qps: float, duration: float, seed: int = 0,
                       burst_start: float = 660.0,
                       burst_len: float = 120.0) -> List[Request]:
    """§5.2 adversarial case: agent-like background plus a burst of long
    'thinking' requests all sharing ONE common prefix, so a purely
    multiplicative score piles them onto the few instances holding it."""
    base = make_trace("agent", qps * 0.65, duration, seed)
    rng = np.random.RandomState(seed + 77)
    block_ids = itertools.count(10_000_000)
    hot_prefix = tuple(next(block_ids) for _ in range(64))  # 4096 tokens
    rid = itertools.count(len(base))
    t = burst_start
    burst_end = min(burst_start + burst_len, duration)
    hot = []
    while t < burst_end:
        t += rng.exponential(1.0 / max(qps * 0.30, 1e-6))
        if t >= burst_end:
            break
        suffix = tuple(next(block_ids) for _ in range(2))
        out = max(64, int(rng.lognormal(math.log(500), 0.4)))
        hot.append(Request(rid=next(rid), arrival=t,
                           blocks=hot_prefix + suffix,
                           prompt_len=(len(hot_prefix) + 2) * BLOCK,
                           output_len=out, class_id=999_999,
                           family="hotspot"))
    reqs = sorted(base + hot, key=lambda r: r.arrival)
    for i, r in enumerate(reqs):
        r.rid = i
    return reqs


# ---------------------------------------------------------------------------
def infinite_kv_hit_ratio(requests: List[Request]) -> float:
    """Fig. 5 bottom: KV$ hit rate assuming infinite cache, single pool."""
    kv = RadixKVIndex(block_size=BLOCK)
    hit = tot = 0
    for r in sorted(requests, key=lambda x: x.arrival):
        hit += kv.match(r.blocks, r.prompt_len)
        tot += r.prompt_len
        kv.insert(r.blocks)
    return hit / max(tot, 1)


def trace_stats(requests: List[Request]) -> Dict[str, float]:
    ins = [r.prompt_len for r in requests]
    outs = [r.output_len for r in requests]
    dur = max(r.arrival for r in requests) if requests else 0
    return {
        "n": len(requests),
        "qps": len(requests) / max(dur, 1e-9),
        "input_mean": float(np.mean(ins)),
        "input_p95": float(np.percentile(ins, 95)),
        "output_mean": float(np.mean(outs)),
        "classes": len({r.class_id for r in requests}),
        "inf_kv_hit": infinite_kv_hit_ratio(requests),
    }


# ---------------------------------------------------------------------------
def estimate_capacity_qps(spec, requests: List[Request],
                          n_instances: int) -> float:
    """Max sustainable cluster request rate (offline-profiling analogue of
    the paper's §4.1 trace scaling).  Uses the trace's infinite-KV hit
    ratio for expected prefill skip and a nominal decode batch."""
    st = trace_stats(requests)
    new_tokens = st["input_mean"] * (1.0 - 0.8 * st["inf_kv_hit"])
    prefill_cost = spec.c_flops * new_tokens + \
        spec.step_overhead * new_tokens / spec.chunk_tokens
    avg_bs = 24.0
    ctx = st["input_mean"] + st["output_mean"] / 2
    decode_cost = st["output_mean"] * (
        spec.step_overhead / avg_bs + spec.c_flops
        + spec.c_attn * ctx * avg_bs / avg_bs / avg_bs)
    per_req = prefill_cost + decode_cost
    return n_instances / per_req
