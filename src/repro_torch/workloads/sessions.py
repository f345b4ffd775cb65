"""Closed-loop session state machines (chat / API fan-out / coding agent)
— port of ``repro.workloads.sessions``; request for request the
reference's (the same ``RandomState`` draws in the same order).

The paper's workloads — chatbots, API callers, coding agents — are all
*closed-loop*: a user (or agent harness) only issues turn ``t+1`` after
turn ``t`` completes, so scheduling quality feeds back into the arrival
process.  ``workloads.traces`` pre-stamps every arrival at generation
time (open-loop), which flatters bad schedulers: queueing delay never
throttles offered load.  This module models each session as a
deterministic state machine that the closed-loop drivers
(``repro_torch.cluster.closed_loop``) advance by feeding request completions
back in; the session then emits the next turn's request(s), stamped
relative to the *observed* finish time.

Session kinds
-------------
``chat``       multi-turn conversation: one request per turn, think time
               between turns, the answer's blocks join the cached
               context of the next prompt (exactly how chat frontends
               resend history).
``api``        API fan-out: each turn issues ``fan`` parallel sub-calls
               sharing the app prefix at the *same* timestamp (an
               arrival wave for the fused batch router); the next turn
               starts only after the slowest sub-call returns (barrier).
``codeagent``  coding-agent tool loop: every iteration's prompt embeds
               the prior model output verbatim as new context blocks, so
               the shared prefix grows turn over turn exactly as real
               agent traffic grows it; think time is tool-execution
               latency, not human typing.

Determinism
-----------
Every session owns its own ``RandomState`` seeded from ``(seed, sid)``
and allocates content block ids from a private per-session range (apps
share a global per-family range), so a session's request *content* is a
pure function of ``(family, seed, sid)`` — independent of policy, of
cross-session interleaving, and of wall clock.  Only arrival *times* of
later turns depend on scheduling — that feedback is the point.  Two
closed-loop runs of the same scenario are bit-identical.

SLO abandonment
---------------
Real users hang up: each session draws a patience budget at creation and
abandons (emits no further turns) after that many consecutive
SLO-breaching turns (TTFT or TPOT above ``SLO``).  Abandonment couples
scheduling quality to *delivered* load — the goodput metrics in
``cluster.metrics`` report the other half of the story.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, List, Optional

import numpy as np

from ..core.types import DEFAULT_SLO, FAMILY_SLOS, SLO, Request, \
    slo_for_family

__all__ = ["BLOCK", "SLO", "DEFAULT_SLO", "FAMILY_SLOS", "SessionSpec",
           "SESSIONS", "Session", "abandon_hazard", "make_sessions",
           "make_mixed_sessions", "make_mixed_fleet_sessions",
           "MIXED_FLEET_REQUIREMENTS", "session_stats",
           "blocks_to_tokens"]

BLOCK = 64                 # tokens per content block (matches traces.py)
_SESSION_SPACE = 1 << 20   # private block-id range per session
_APP_SPACE = 1 << 60       # app prefixes live above every session range


def abandon_hazard(breaches: int, patience_mean: float) -> float:
    """P(a session abandons on its *next* breaching turn | it has
    survived ``breaches`` consecutive breaches so far), under the
    session patience model ``patience = 1 + Poisson(patience_mean)``:
    with ``X ~ Poisson(mean)`` and ``b = breaches`` this is
    ``P(X == b) / P(X >= b)``.  The hazard rises toward 1 as breaches
    accumulate past the mean — the signal the patience-driven
    retraction mode thresholds on (``OverloadControl
    .patience_retraction``).  Pure function of the distribution, not of
    any concrete session's hidden draw: the controller sees exactly
    what a production router could (the breach count), never the
    session's private patience sample."""
    m = float(patience_mean)
    b = max(int(breaches), 0)
    if m <= 0.0:
        return 1.0
    pmf = math.exp(-m)            # P(X == 0)
    below = 0.0                   # P(X <= b-1)
    for k in range(1, b + 1):
        below += pmf
        pmf *= m / k
    tail = max(1.0 - below, pmf)  # P(X >= b), underflow-guarded
    return min(pmf / tail, 1.0)


@dataclasses.dataclass(frozen=True)
class SessionSpec:
    kind: str                     # "chat" | "api" | "codeagent"
    family: str                   # metrics / trace-family tag
    app_prefix_blocks: int        # shared system-prompt size (blocks)
    n_apps: int                   # distinct apps (zipf popularity)
    zipf_a: float
    turns_mean: float
    first_input_blocks: float     # extra prompt blocks on turn 1
    turn_input_blocks: float      # new user/tool blocks per later turn
    output_tokens_mean: float
    output_tokens_cv: float
    think_time_mean: float        # seconds between turns (human or tool)
    fan_mean: float = 1.0         # api: parallel sub-calls per turn
    embed_output: bool = True     # next prompt embeds the answer blocks
    block_tokens: int = BLOCK     # tokens per abstract block
    patience_mean: float = 2.0    # consecutive breaching TURNS tolerated
    slo: SLO = DEFAULT_SLO
    model_requirement: str = ""   # "": any instance (capability tag)

    def expected_requests(self) -> float:
        """Mean requests one session issues if it never abandons — the
        session-rate ↔ request-qps conversion factor."""
        fan = self.fan_mean if self.kind == "api" else 1.0
        return self.turns_mean * fan


# The numbers mirror the same-named open-loop ``traces.FAMILIES`` with
# *intentional* closed-loop deltas: think time here is pure client-side
# latency (the open-loop table folds a generation-time proxy into its
# inter-turn gap), "agent" gains its real fan-out structure (parallel
# sub-calls per turn), and coder/toolagent think times are tool-exec
# latencies.  ``expected_requests()`` is the bridge for rate conversion.
# Each spec's SLO comes from ``core.types.FAMILY_SLOS`` (chat-lenient /
# agent-strict) — the same per-family table the metrics breakdown and
# the admission gate's deadlines read, so abandonment, attainment and
# shedding judge a request by one threshold.
SESSIONS: Dict[str, SessionSpec] = {
    # ChatGPT-like chat: human think time dominates the loop period
    "chatbot": SessionSpec("chat", "chatbot", app_prefix_blocks=12,
                           n_apps=8, zipf_a=1.2, turns_mean=5.0,
                           first_input_blocks=18, turn_input_blocks=4,
                           output_tokens_mean=320, output_tokens_cv=0.8,
                           think_time_mean=25.0,
                           slo=slo_for_family("chatbot")),
    # API-calling agent: short prompts, parallel sub-calls, tight loop
    "agent": SessionSpec("api", "agent", app_prefix_blocks=10,
                         n_apps=24, zipf_a=1.4, turns_mean=2.0,
                         first_input_blocks=4, turn_input_blocks=2,
                         output_tokens_mean=96, output_tokens_cv=0.6,
                         think_time_mean=2.0, fan_mean=3.0,
                         embed_output=False,
                         slo=slo_for_family("agent")),
    # coding agent: long tool loops; each iteration re-sends the whole
    # transcript, so prior output becomes shared cached prefix
    "coder": SessionSpec("codeagent", "coder", app_prefix_blocks=24,
                         n_apps=12, zipf_a=1.1, turns_mean=8.0,
                         first_input_blocks=90, turn_input_blocks=20,
                         output_tokens_mean=480, output_tokens_cv=0.9,
                         think_time_mean=3.0,
                         slo=slo_for_family("coder")),
    # Mooncake-style tool agent: very long loops, near-zero think time
    "toolagent": SessionSpec("codeagent", "toolagent",
                             app_prefix_blocks=30, n_apps=6, zipf_a=1.3,
                             turns_mean=14.0, first_input_blocks=25,
                             turn_input_blocks=8,
                             output_tokens_mean=150,
                             output_tokens_cv=0.5, think_time_mean=1.0,
                             slo=slo_for_family("toolagent")),
}


def _app_blocks(family: str, app: int, n_blocks: int) -> List[int]:
    """Deterministic global block ids for app ``app`` of ``family``."""
    base = _APP_SPACE + (zlib.crc32(family.encode()) & 0xFFFFF) * (1 << 24) \
        + app * (1 << 12)
    return [base + j for j in range(n_blocks)]


class Session:
    """One closed-loop client as a deterministic state machine.

    Drive it with ``start()`` (the first turn's request(s), stamped at
    ``start_t``) and ``on_complete(req, now)`` (feed a finished request
    back; returns the next turn's request(s), or ``[]`` while sub-calls
    are outstanding / after the final turn / after abandonment).
    Emitted requests carry ``rid=-1`` — the driver assigns log order.
    """

    def __init__(self, sid: int, spec: SessionSpec, start_t: float,
                 seed: int, app: int):
        self.sid = sid
        self.spec = spec
        self.start_t = start_t
        self.app = app
        mix = (seed * 1_000_003 + sid * 7919 + 0x9E3779B9) & 0x7FFFFFFF
        self.rng = np.random.RandomState(
            mix ^ (zlib.crc32(spec.family.encode()) & 0x7FFFFFFF))
        self.history: List[int] = list(_app_blocks(
            spec.family, app, spec.app_prefix_blocks))
        self._block_next = (sid + 1) * _SESSION_SPACE
        self.turns_total = max(1, int(self.rng.poisson(spec.turns_mean)))
        self.turn = 0
        self.outstanding = 0
        self.abandoned = False
        self.completed = False
        self.issued = 0
        self._breaches = 0            # consecutive SLO-breaching turns
        self._turn_breached = False
        self._patience = 1 + int(self.rng.poisson(spec.patience_mean))

    # ------------------------------------------------------------------
    def _fresh(self, n: int) -> List[int]:
        out = list(range(self._block_next, self._block_next + n))
        self._block_next += n
        return out

    def _request(self, arrival: float, extra: List[int]) -> Request:
        spec = self.spec
        out = max(2, int(self.rng.lognormal(
            math.log(spec.output_tokens_mean), spec.output_tokens_cv * 0.7)))
        blocks = tuple(self.history + extra)
        self.issued += 1
        return Request(rid=-1, arrival=arrival, blocks=blocks,
                       prompt_len=len(blocks) * spec.block_tokens,
                       output_len=out, class_id=self.sid,
                       session_id=self.sid, family=spec.family,
                       model_requirement=spec.model_requirement)

    def _emit_turn(self, arrival: float) -> List[Request]:
        spec = self.spec
        nb = spec.first_input_blocks if self.turn == 0 \
            else spec.turn_input_blocks
        nb = max(1, int(self.rng.poisson(nb)))
        self.history.extend(self._fresh(nb))
        fan = 1
        if spec.kind == "api":
            fan = max(1, int(self.rng.poisson(spec.fan_mean)))
        reqs = [self._request(arrival,
                              self._fresh(1) if fan > 1 else [])
                for _ in range(fan)]
        self.outstanding = fan
        return reqs

    # ------------------------------------------------------------------
    def start(self) -> List[Request]:
        """The first turn's request(s), arriving at ``start_t``."""
        return self._emit_turn(self.start_t)

    def on_complete(self, req: Request, now: float) -> List[Request]:
        """Feed a finished request back; returns follow-up arrivals.

        ``now`` is the observed finish time — the next turn is stamped
        ``now + think``, which is the closed-loop feedback edge.  With a
        fan-out in flight, returns ``[]`` until the slowest sub-call
        lands (events arrive in time order, so the final call sees the
        barrier time).
        """
        self.outstanding -= 1
        if not self.spec.slo.met(req):
            self._turn_breached = True
        if self.abandoned or self.completed:
            return []
        if self.outstanding > 0:
            return []
        # turn barrier crossed: patience is per-TURN (one slow fan-out
        # turn counts once, however many sub-calls it breached)
        if self._turn_breached:
            self._breaches += 1
        else:
            self._breaches = 0
        self._turn_breached = False
        if self._breaches >= self._patience:
            self.abandoned = True
            return []
        # grow the cached context, maybe end
        if self.spec.embed_output:
            self.history.extend(
                self._fresh(max(1, req.output_len // self.spec.block_tokens)))
        self.turn += 1
        if self.turn >= self.turns_total:
            self.completed = True
            return []
        think = max(0.1, float(self.rng.exponential(
            self.spec.think_time_mean)))
        return self._emit_turn(now + think)


# ---------------------------------------------------------------------------
def make_sessions(name: str, n_sessions: int, seed: int = 0,
                  start_rate: Optional[float] = None,
                  slo: Optional[SLO] = None,
                  sid0: int = 0) -> List[Session]:
    """Build ``n_sessions`` deterministic ``name``-family sessions.

    Session starts form a Poisson process of rate ``start_rate``
    (sessions/s; default: one per mean think time so the cluster warms
    gradually); app choice is zipf-popular as in the open-loop traces.
    Deterministic in ``seed`` — content, app choice, and start times.
    ``sid0`` offsets session ids (and therefore each session's private
    block-id range), letting several families co-reside in one
    closed-loop run without sid or block collisions.
    """
    spec = SESSIONS[name]
    if slo is not None:
        spec = dataclasses.replace(spec, slo=slo)
    rng = np.random.RandomState(
        seed ^ (zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF))
    rate = start_rate if start_rate else 1.0 / max(spec.think_time_mean, 1.0)
    app_p = 1.0 / np.arange(1, spec.n_apps + 1) ** spec.zipf_a
    app_p /= app_p.sum()
    out, t = [], 0.0
    for sid in range(n_sessions):
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        app = int(rng.choice(spec.n_apps, p=app_p))
        out.append(Session(sid0 + sid, spec, t, seed, app))
    return out


def make_mixed_sessions(mix: Dict[str, int], seed: int = 0,
                        start_rates: Optional[Dict[str, float]] = None,
                        slo: Optional[SLO] = None) -> List[Session]:
    """Several session families co-resident on one cluster.

    ``mix`` maps family name → session count; each family keeps its own
    deterministic content stream (same seed semantics as
    ``make_sessions``) and its own Poisson start process
    (``start_rates[name]``, default: that family's think-time default).
    Families get disjoint sid ranges (``sid0`` offsets in ``mix``'s
    sorted-name order), so private block-id ranges never collide and
    the closed-loop drivers' sid registry stays unambiguous.  Returned
    sessions are ordered by start time, which fixes the rid assignment
    order of the seeded first turns.
    """
    out: List[Session] = []
    sid0 = 0
    for name in sorted(mix):
        rate = (start_rates or {}).get(name)
        out.extend(make_sessions(name, mix[name], seed=seed,
                                 start_rate=rate, slo=slo, sid0=sid0))
        sid0 += mix[name]
    out.sort(key=lambda s: (s.start_t, s.sid))
    return out


#: default family → model_requirement map for the mixed-fleet scenario:
#: chatbots are fine on the small fast model, coder/toolagent loops need
#: the big one, API agents take whatever is least loaded ("" = any).
#: Keys are session-family names; values must be model names that exist
#: in the fleet (``simulator.make_mixed_fleet`` defaults).
MIXED_FLEET_REQUIREMENTS: Dict[str, str] = {
    "chatbot": "qwen2_7b",
    "coder": "qwen3_30b_moe",
    "toolagent": "qwen3_30b_moe",
    "agent": "",
}


def make_mixed_fleet_sessions(mix: Dict[str, int], seed: int = 0,
                              requirements: Optional[Dict[str, str]] = None,
                              start_rates: Optional[Dict[str, float]] = None,
                              slo: Optional[SLO] = None) -> List[Session]:
    """``make_mixed_sessions`` with per-family ``model_requirement``.

    The mixed-fleet closed-loop scenario: each family's spec is
    ``dataclasses.replace``d with its requirement from ``requirements``
    (default ``MIXED_FLEET_REQUIREMENTS``; families absent from the map
    stay unconstrained), so every request the session emits carries the
    capability tag the router's pre-score filter reads.
    Content streams are untouched — the requirement rides on the spec,
    not the RNG — so with an all-"" map this is bit-identical to
    ``make_mixed_sessions``.
    """
    reqmap = MIXED_FLEET_REQUIREMENTS if requirements is None \
        else requirements
    out: List[Session] = []
    sid0 = 0
    for name in sorted(mix):
        rate = (start_rates or {}).get(name)
        sessions = make_sessions(name, mix[name], seed=seed,
                                 start_rate=rate, slo=slo, sid0=sid0)
        want = reqmap.get(name, "")
        if want:
            for s in sessions:
                s.spec = dataclasses.replace(s.spec,
                                             model_requirement=want)
        out.extend(sessions)
        sid0 += mix[name]
    out.sort(key=lambda s: (s.start_t, s.sid))
    return out


def session_stats(sessions: List[Session]) -> Dict[str, float]:
    n = max(len(sessions), 1)
    return {
        "n_sessions": len(sessions),
        "completed": sum(1 for s in sessions if s.completed),
        "abandoned": sum(1 for s in sessions if s.abandoned),
        "abandon_rate": sum(1 for s in sessions if s.abandoned) / n,
        "requests_issued": sum(s.issued for s in sessions),
        "turns_done": sum(s.turn for s in sessions),
    }


# ---------------------------------------------------------------------------
def blocks_to_tokens(blocks, tokens_per_block: int = 16,
                     vocab: int = 500, base: int = 4) -> np.ndarray:
    """Expand abstract block ids into concrete token arrays.

    The map is a pure function of the block id, so sessions that share a
    block chain share the exact token prefix, so a real engine driven by
    abstract session state gets true prefix-cache reuse.
    """
    out = np.empty(len(blocks) * tokens_per_block, dtype=np.int32)
    span = max(vocab - base, 1)
    for i, b in enumerate(blocks):
        h = (b * 1_000_003 + 12289) & 0x7FFFFFFF
        for j in range(tokens_per_block):
            out[i * tokens_per_block + j] = base + (h + j * 97) % span
    return out
