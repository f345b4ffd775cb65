"""Metrics registry — port of ``repro.obs.registry``: preallocated
counters/gauges/histograms with named scopes and deterministic
snapshot/merge semantics.

* :class:`MetricsRegistry` — counters (int64), gauges (float64), and
  :class:`Histogram` ring buffers keyed by dotted scope names
  (``pipeline.walk_us``, ``events.drop.shed`` …), O(1) record paths.
* **Snapshot/merge** — :meth:`MetricsRegistry.snapshot` freezes a
  registry into a JSON-able dict; :func:`merge_snapshots` folds many
  snapshots into one view deterministically (counters sum, gauges take
  the maximum, histogram counts/sums/maxima fold).
* **Worker slots** — process shard workers cannot share Python dicts
  with the parent, so their registry is a fixed-slot int64 row in the
  backend's shared-memory metrics block; :data:`WORKER_SLOTS` names the
  columns.  It has one definition, in ``repro_torch.core.shard_backends``
  (a spawned worker imports that module and numpy, never torch), which
  this module re-exports.  :meth:`MetricsRegistry.ingest_worker_block`
  folds an ``(S, K)`` block into per-shard scoped counters.
* :func:`ingest_router` re-homes the router's own accumulators (walks,
  pipeline stages, repairs) onto a registry through ``counter_set``, so
  re-ingesting never double-counts.

Imports numpy only.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

# the fixed-slot schema of the process workers' metrics block (one
# definition, with the backend that writes it)
from ..core.shard_backends import (  # noqa: F401
    N_WORKER_SLOTS, WORKER_SLOTS)

# histogram ring-buffer capacity: big enough for a long closed-loop run's
# per-wave samples, small enough to preallocate eagerly
_HIST_CAP = 4096


class Histogram:
    """Preallocated ring buffer of float64 samples.

    Records are O(1) writes into a fixed numpy buffer; once ``capacity``
    samples have been seen the buffer wraps (the summary keeps exact
    ``count``/``sum``/``max`` over *all* samples, percentiles come from
    the retained window).  No allocation after construction.
    """

    __slots__ = ("_buf", "_n", "count", "total", "max")

    def __init__(self, capacity: int = _HIST_CAP):
        self._buf = np.empty(capacity, dtype=np.float64)
        self._n = 0          # writes so far (may exceed capacity)
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def record(self, x: float):
        buf = self._buf
        buf[self._n % len(buf)] = x
        self._n += 1
        self.count += 1
        self.total += x
        if x > self.max:
            self.max = x

    def samples(self) -> np.ndarray:
        """Retained samples in record order (oldest first)."""
        buf, n = self._buf, self._n
        if n <= len(buf):
            return buf[:n]
        k = n % len(buf)
        return np.concatenate([buf[k:], buf[:k]])

    def percentile(self, q: float) -> float:
        s = self.samples()
        if len(s) == 0:
            return 0.0
        return float(np.percentile(s, q))

    def stats(self) -> dict:
        return {
            "count": int(self.count),
            "sum": float(self.total),
            "max": float(self.max),
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Named counters, gauges, and histograms for one process/component.

    Names are dotted scopes (``pipeline.walk_ns``); :meth:`scope`
    returns a view that prefixes every name, so a subsystem can be
    handed ``registry.scope("overload")`` and stay oblivious to where
    it sits in the cluster-wide namespace.
    """

    def __init__(self):
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, Histogram] = {}

    # ---- record paths -------------------------------------------------
    def inc(self, name: str, v: int = 1):
        self.counters[name] = self.counters.get(name, 0) + int(v)

    def counter_set(self, name: str, v: int):
        """Overwrite a counter from an external accumulator (the
        exactly-once ingestion path: the source owns the count, the
        registry mirrors it — re-ingesting can never double)."""
        self.counters[name] = int(v)

    def gauge(self, name: str, v: float):
        self.gauges[name] = float(v)

    def observe(self, name: str, x: float, capacity: int = _HIST_CAP):
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram(capacity)
        h.record(x)

    def scope(self, prefix: str) -> "_Scope":
        return _Scope(self, prefix)

    # ---- worker-slot ingestion ----------------------------------------
    def ingest_worker_block(self, block: np.ndarray,
                            prefix: str = "shard"):
        """Fold an ``(S, K)`` int64 fixed-slot block (one row per shard
        worker) into scoped counters — ``shard.3.walk_ns`` … — plus the
        per-slot totals (``shard.walk_ns``).  Deterministic: rows in
        shard order, slot names from :data:`WORKER_SLOTS`.  Uses
        ``counter_set`` so re-ingesting an updated block replaces rather
        than double-counts."""
        block = np.asarray(block)
        k = min(block.shape[1], N_WORKER_SLOTS) if block.ndim == 2 else 0
        for j in range(k):
            slot = WORKER_SLOTS[j]
            for s in range(block.shape[0]):
                self.counter_set(f"{prefix}.{s}.{slot}",
                                 int(block[s, j]))
            self.counter_set(f"{prefix}.{slot}",
                             int(block[:, j].sum()))

    # ---- snapshot/merge -----------------------------------------------
    def snapshot(self) -> dict:
        """Freeze into a JSON-able dict (sorted keys — diffable)."""
        return {
            "counters": {k: int(v)
                         for k, v in sorted(self.counters.items())},
            "gauges": {k: float(v)
                       for k, v in sorted(self.gauges.items())},
            "hists": {k: h.stats()
                      for k, h in sorted(self.hists.items())},
        }

    def merge_snapshot(self, snap: dict):
        """Fold a snapshot produced elsewhere into this registry:
        counters sum, gauges max, histogram stats fold count/sum/max
        exactly and keep the larger window's percentiles (sample
        buffers do not cross snapshot boundaries)."""
        for k, v in snap.get("counters", {}).items():
            self.inc(k, v)
        for k, v in snap.get("gauges", {}).items():
            self.gauges[k] = max(self.gauges.get(k, float("-inf")), v)
        for k, st in snap.get("hists", {}).items():
            h = self.hists.get(k)
            if h is None:
                h = self.hists[k] = Histogram()
            # exact fold for count/sum/max; percentile window: record a
            # representative pair so an empty local hist still reports
            h.count += st["count"]
            h.total += st["sum"]
            h.max = max(h.max, st["max"])
            if st["count"] and h._n == 0:
                h.record(st["p50"])
                h.count -= 1
                h.total -= st["p50"]


class _Scope:
    """Name-prefixing view over a registry (shared storage)."""

    __slots__ = ("_reg", "_prefix")

    def __init__(self, reg: MetricsRegistry, prefix: str):
        self._reg = reg
        self._prefix = prefix.rstrip(".") + "."

    def inc(self, name: str, v: int = 1):
        self._reg.inc(self._prefix + name, v)

    def gauge(self, name: str, v: float):
        self._reg.gauge(self._prefix + name, v)

    def observe(self, name: str, x: float):
        self._reg.observe(self._prefix + name, x)


def merge_snapshots(snaps: Iterable[dict]) -> dict:
    """Deterministically merge snapshots (in argument order) into one
    cluster view: counters sum, gauges max, histogram counts fold."""
    out = MetricsRegistry()
    for s in snaps:
        out.merge_snapshot(s)
    return out.snapshot()


# ---------------------------------------------------------------------------
# ingestion from the live routing stack (compat-shim direction)
# ---------------------------------------------------------------------------
def ingest_router(reg: MetricsRegistry, router) -> MetricsRegistry:
    """Re-home the router's legacy telemetry onto ``reg``.

    Reads every accumulator the stack keeps on its own — the factory's
    ``walk_ns``/``walks``/``degraded_rebuilds``/``evictions``, the
    pipeline's per-stage ns totals and speculation counters, the shard
    backend's fixed-slot worker block — and mirrors them as scoped
    counters via ``counter_set`` (source-owned counts: ingestion is
    idempotent, never double-counting).  ``Router.metrics_snapshot``
    calls this; ``walk_telemetry``/``stage_stats`` remain as
    compatibility shims over the same underlying accumulators.
    """
    f = router.factory
    reg.counter_set("index.walk_ns", f.walk_ns)
    reg.counter_set("index.walks", f.walks)
    reg.counter_set("index.degraded_rebuilds", f.degraded_rebuilds)
    reg.counter_set("index.evictions", f.evictions)
    p = router.pipeline
    reg.counter_set("pipeline.walk_ns", p.walk_ns)
    reg.counter_set("pipeline.score_ns", p.score_ns)
    reg.counter_set("pipeline.commit_ns", p.commit_ns)
    reg.counter_set("pipeline.waves", p.waves)
    reg.counter_set("pipeline.prefetches", p.prefetches)
    reg.counter_set("pipeline.prefetch_hits", p.prefetch_hits)
    reg.counter_set("pipeline.spec_hidden_ns", p.spec_hidden_ns)
    reg.counter_set("pipeline.spec_blocked_ns", p.spec_blocked_ns)
    reg.counter_set("router.routed", router.routed)
    reg.counter_set("router.decisions", len(router.decision_ns))
    # self-healing accumulators: the factory's anti-entropy counters
    # plus the shard backend's recovery counters (getattr-guarded so
    # exact_only factories ingest cleanly)
    reg.counter_set("index.shard_repairs",
                    getattr(f, "shard_repairs", 0))
    reg.counter_set("index.verify_mismatches",
                    getattr(f, "verify_mismatches", 0))
    backend = getattr(f._agg, "backend", None)
    if backend is not None:
        reg.counter_set("shard.timeouts", getattr(backend, "timeouts", 0))
        reg.counter_set("shard.heals", getattr(backend, "heals", 0))
        reg.counter_set("shard.escalations",
                        getattr(backend, "escalations", 0))
    block = None
    if backend is not None:
        wm = getattr(backend, "worker_metrics", None)
        block = wm() if wm is not None else None
    if block is not None:
        reg.ingest_worker_block(block)
    return reg
