"""Request, SLO and deadline types of the scheduling framework (port of
``repro.core.types``).

``SLO`` is the single source of truth for the SLO predicate: closed-loop
sessions abandon on it (``workloads.sessions``), ``cluster.metrics``
reports attainment and goodput against it, and the admission gate
(``core.overload``) derives each request's split prefill/decode
``Deadline`` from it (``stamp_deadline``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float                 # seconds since trace start
    blocks: Tuple[int, ...]        # prompt as block ids (block_size tokens each)
    prompt_len: int                # true prompt length in tokens
    output_len: int                # decode tokens to generate
    class_id: int = -1             # request class (shared-prefix group)
    session_id: int = -1           # closed-loop session (-1: open-loop)
    family: str = ""               # workload family tag (metrics breakdown)
    model_requirement: str = ""    # "": any instance; else capability tag

    # ---- runtime bookkeeping (filled by the router / a simulator) ----
    sched_to: int = -1
    hit_tokens: int = 0
    t_sched: float = 0.0
    t_first_token: float = 0.0
    t_finish: float = 0.0

    # ---- overload control / fault tolerance ----
    deadline: Optional["Deadline"] = None   # stamped by the admission gate
    drop_reason: str = ""          # "" | "shed" (admission) | "retracted"
    t_drop: float = 0.0            # when the drop happened
    prefill_done: int = 0          # prefill tokens burnt before a retraction
    retries: int = 0               # re-routes after instance failure

    @property
    def new_tokens(self) -> int:
        return self.prompt_len - self.hit_tokens

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.arrival

    @property
    def tpot(self) -> float:
        if self.output_len <= 1:
            return 0.0
        return (self.t_finish - self.t_first_token) / (self.output_len - 1)


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request service-level objective (seconds)."""
    ttft: float = 2.0
    tpot: float = 0.020

    def ttft_met(self, req: Request) -> bool:
        return req.ttft <= self.ttft

    def tpot_met(self, req: Request) -> bool:
        # single-token requests have no TPOT and count as meeting it
        return req.output_len <= 1 or req.tpot <= self.tpot

    def met(self, req: Request) -> bool:
        return req.t_finish > 0.0 and self.ttft_met(req) \
            and self.tpot_met(req)

    def deadline(self, arrival: float, output_len: int,
                 slack: float = 1.0) -> "Deadline":
        """Split prefill/decode deadlines (absolute times) for a request
        arriving at ``arrival``: first token by ``arrival + ttft*slack``,
        last token a further ``(output_len-1) * tpot * slack`` after
        that (retraction checks prefill and finish independently)."""
        prefill = arrival + self.ttft * slack
        finish = prefill + max(output_len - 1, 0) * self.tpot * slack
        return Deadline(prefill=prefill, finish=finish)


@dataclasses.dataclass(frozen=True)
class Deadline:
    """Absolute per-request deadlines (seconds since trace start)."""
    prefill: float     # latest acceptable first token
    finish: float      # latest acceptable last token

    def prefill_blown(self, now: float) -> bool:
        return now > self.prefill

    def finish_blown(self, now: float) -> bool:
        return now > self.finish


DEFAULT_SLO = SLO()

#: Per-family SLOs (chat-lenient / agent-strict); families not listed
#: fall back to ``DEFAULT_SLO``.
FAMILY_SLOS = {
    "chatbot": SLO(ttft=2.5, tpot=0.025),
    "agent": SLO(ttft=1.0, tpot=0.015),
    "coder": SLO(ttft=2.0, tpot=0.020),
    "toolagent": SLO(ttft=1.5, tpot=0.020),
}


def slo_for_family(family: str) -> SLO:
    """The family's SLO, or ``DEFAULT_SLO`` for unknown/untagged."""
    return FAMILY_SLOS.get(family, DEFAULT_SLO)


def stamp_deadline(req: Request, slo: Optional[SLO] = None,
                   slack: float = 1.0) -> Request:
    """Stamp ``req.deadline`` from its family SLO (or an explicit one).

    Idempotent per request object: an already-stamped request keeps its
    deadline (an orphan re-routed after an instance failure keeps the
    promise first made to its session).
    """
    if req.deadline is None:
        slo = slo if slo is not None else slo_for_family(req.family)
        req.deadline = slo.deadline(req.arrival, req.output_len, slack)
    return req
