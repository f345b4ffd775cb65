"""Request type of the scheduling framework (port of ``repro.core.types``).

Only the fields the trace generators, the router and the commit hooks
read or write are kept; overload-control and fleet fields arrive with
the modules that use them.
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
