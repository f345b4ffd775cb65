"""Request and SLO types of the scheduling framework (port of
``repro.core.types``).

Only the fields the trace generators, the router, the commit hooks, the
serving engine and ``cluster.metrics`` read or write are kept;
overload-control deadlines and fleet fields arrive with the modules that
use them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


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

    # ---- runtime bookkeeping (filled by the router / a simulator) ----
    sched_to: int = -1
    hit_tokens: int = 0
    t_sched: float = 0.0
    t_first_token: float = 0.0
    t_finish: float = 0.0

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
