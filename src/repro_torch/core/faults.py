"""Deterministic fault injection for the shard layer — port of
``repro.core.faults`` (numpy only, no ``torch``).

A :class:`FaultPlan` is a seeded, immutable schedule of shard-level
faults; a :class:`FaultInjector` replays it against per-shard event
counters so a plan fires at the same logical points regardless of
wall-clock speed, backend, or host:

* ``crash``   — the shard's worker dies (process backend: the child
  ``os._exit``\\ s; in-process backends: the walk raises
  :class:`ShardError`) at a given walk ordinal.
* ``stall``   — the shard sleeps ``seconds`` before serving a walk;
  stalls longer than the backend's walk deadline exercise the
  timeout → supervised-heal path.
* ``drop``    — a fire-and-forget mutation to the shard is discarded
  (the aggregate drifts from KV truth until anti-entropy repairs it).
* ``delay``   — the shard sleeps ``seconds`` before applying a
  mutation (ordering is preserved, so this is a processing delay,
  not a reorder).
* ``corrupt`` — one membership bit in the shard's bitset matrix is
  flipped in place (``AggregatedPrefixIndex.corrupt_bit``) without
  touching the pop cache or digest accumulator — silent corruption
  only the digest sweep can see.

Events are keyed on *per-shard ordinals*: ``at`` counts walk
submissions to that shard for crash/stall/corrupt and mutations routed
to it for drop/delay.  Each event fires exactly once (consumed).
Backends hold no injector by default and guard every hook behind
``if self._faults is not None`` — the fault-free path does no work.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

#: event kinds keyed on the shard's walk ordinal
WALK_KINDS = ("crash", "stall", "corrupt")
#: event kinds keyed on the shard's mutation ordinal
MUTATION_KINDS = ("drop", "delay")
KINDS = WALK_KINDS + MUTATION_KINDS


class ShardError(RuntimeError):
    """A single shard failed; carries ``.shard`` so recovery can stay
    scoped to that shard instead of rebuilding the whole index."""

    def __init__(self, shard: int, message: str):
        super().__init__(message)
        self.shard = int(shard)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str          #: one of :data:`KINDS`
    shard: int         #: target shard
    at: int            #: per-shard walk/mutation ordinal (0-based)
    seconds: float = 0.0   #: stall/delay duration
    seed: int = 0      #: corrupt-bit seed

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Immutable, ordered schedule of :class:`FaultEvent`."""

    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events, key=lambda e: (e.shard, e.at,
                                                     e.kind))))

    def __len__(self):
        return len(self.events)

    def for_shard(self, s: int) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.shard == s)

    @classmethod
    def seeded(cls, seed: int, n_shards: int, n_walks: int,
               crashes: int = 1, stalls: int = 1, corruptions: int = 0,
               drops: int = 0, stall_s: float = 0.05) -> "FaultPlan":
        """Draw a reproducible plan: event shards and ordinals sampled
        from ``default_rng(seed)`` over the first ``n_walks`` walk
        batches (mutation ordinals reuse the same range)."""
        rng = np.random.default_rng(seed)
        span = max(int(n_walks), 1)
        evs: List[FaultEvent] = []

        def draw(kind, count, **kw):
            for _ in range(count):
                evs.append(FaultEvent(
                    kind=kind, shard=int(rng.integers(n_shards)),
                    at=int(rng.integers(span)), **kw))

        draw("crash", crashes)
        draw("stall", stalls, seconds=float(stall_s))
        draw("corrupt", corruptions, seed=int(rng.integers(1 << 31)))
        draw("drop", drops)
        return cls(events=tuple(evs))


class FaultInjector:
    """Replays a :class:`FaultPlan` against per-shard event counters.

    Backends call :meth:`on_walk` once per walk batch submitted to a
    shard and :meth:`on_mutation` once per mutation routed to it; each
    returns the (possibly empty) list of events due at that ordinal.
    Fired events are recorded in :attr:`fired` for test assertions and
    bench accounting.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._walk_ev: Dict[int, Dict[int, List[FaultEvent]]] = {}
        self._mut_ev: Dict[int, Dict[int, List[FaultEvent]]] = {}
        for e in plan.events:
            table = (self._walk_ev if e.kind in WALK_KINDS
                     else self._mut_ev)
            table.setdefault(e.shard, {}).setdefault(e.at, []).append(e)
        self._walks: Dict[int, int] = {}
        self._muts: Dict[int, int] = {}
        self.fired: List[FaultEvent] = []

    def _due(self, table, counters, s: int) -> Sequence[FaultEvent]:
        t = counters.get(s, 0)
        counters[s] = t + 1
        by_at = table.get(s)
        if not by_at:
            return ()
        evs = by_at.pop(t, ())
        if evs:
            self.fired.extend(evs)
        return evs

    def on_walk(self, s: int) -> Sequence[FaultEvent]:
        return self._due(self._walk_ev, self._walks, s)

    def on_mutation(self, s: int) -> Sequence[FaultEvent]:
        return self._due(self._mut_ev, self._muts, s)

    @property
    def pending(self) -> int:
        return len(self.plan) - len(self.fired)

    def stats(self) -> Dict[str, int]:
        out: Dict[str, int] = {k: 0 for k in KINDS}
        for e in self.fired:
            out[e.kind] += 1
        out["pending"] = self.pending
        return out
