"""Unified observability — port of ``repro.obs``: metrics registry,
span tracer, decision provenance.  Imports numpy only (no torch).

One :class:`Obs` bundle threads through the routing stack
(``Router(..., obs=...)`` → pipeline → simulators):

* ``obs.registry`` — :class:`~repro_torch.obs.registry.MetricsRegistry`
  (counters/gauges/histograms, snapshot/merge; the process backend's
  fixed-slot worker block follows ``WORKER_SLOTS``),
* ``obs.tracer`` — :class:`~repro_torch.obs.trace.SpanTracer`
  (deterministic virtual-clock Chrome trace JSON),
* ``obs.provenance`` — :class:`~repro_torch.obs.provenance
  .ProvenanceRecorder` (per-decision top-k landscape + the
  multiplication-failure detector).

**Disabled-mode identity.**  Observability off is *no* mode: every
integration point in the routing stack is an ``obs is None`` (or
component ``is None``) branch, so with the default ``obs=None`` the
stack runs exactly the code it runs without this package.  With it on,
no routing decision changes either: the hooks read state and never
consume the tie counter or a noise stream.
"""
from __future__ import annotations

from typing import Optional

from .provenance import ProvenanceRecorder
from .registry import (MetricsRegistry, WORKER_SLOTS, N_WORKER_SLOTS,
                       ingest_router, merge_snapshots)
from .trace import (DEFAULT_SAMPLE_EVERY, ROUTER_PID, SpanTracer,
                    load_trace, shard_pid, validate_events)


class Obs:
    """Observability bundle: any component may be ``None`` (off)."""

    __slots__ = ("registry", "tracer", "provenance")

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[SpanTracer] = None,
                 provenance: Optional[ProvenanceRecorder] = None):
        self.registry = registry
        self.tracer = tracer
        self.provenance = provenance


def make_obs(metrics: bool = True, trace: bool = False,
             provenance: bool = False,
             sample_every: int = DEFAULT_SAMPLE_EVERY,
             top_k: int = 4) -> Obs:
    """Build an :class:`Obs` bundle.

    ``metrics`` is on by default (a registry alone costs a few dict
    increments per *wave*); ``trace`` and ``provenance`` are opt-in —
    tracing records the span tree for every ``sample_every``-th wave,
    provenance pays one extra walk + score row per decision.
    """
    reg = MetricsRegistry() if metrics else None
    return Obs(
        registry=reg,
        tracer=SpanTracer(sample_every=sample_every) if trace else None,
        provenance=(ProvenanceRecorder(registry=reg, top_k=top_k)
                    if provenance else None))


__all__ = [
    "Obs", "make_obs", "MetricsRegistry", "SpanTracer",
    "ProvenanceRecorder", "WORKER_SLOTS", "N_WORKER_SLOTS",
    "ingest_router", "merge_snapshots", "load_trace", "validate_events",
    "ROUTER_PID", "shard_pid", "DEFAULT_SAMPLE_EVERY",
]
