"""Sharded aggregated prefix index — port of
``repro.core.sharded_index`` (numpy only, no ``torch``): the router's
host path past a few thousand instances.

The instance-id space ``[0, n)`` splits into ``S`` contiguous ranges
(``shard_bounds``), and each range gets its **own complete flat
index** — own node arrays, child dicts, free list and walk-state reuse —
over only its local instances.  Instance ``i``'s hit depth depends only
on instance ``i``'s own radix tree, so the partition is exact: shard
``s`` reproduces columns ``[lo_s, hi_s)`` of the unsharded hit matrix
bit-for-bit, and the full-width matrix ``route_score`` consumes is the
plain concatenation of the per-shard blocks.  Each shard keeps the flat
index's subset invariant (a lineage held only by instances of shard 2
dead-ends at the root of every other shard) and its LCP-chained walk
reuse; the lexicographic sort and adjacent-LCP array are computed once
by the caller and shared by every shard.

*Where* the per-shard work runs is a pluggable ``ShardBackend``
(``repro_torch.core.shard_backends``): ``serial``, ``thread``
(``parallel=True`` maps here) or ``process`` (one spawn worker per
shard, masks in shared memory).  Shard ``s`` writes only its own column
slice, so the merge is independent of completion order.  Asynchronous
backends expose ``submit_many`` → ``WalkHandle``, the hook the routing
pipeline's cross-wave speculation rides on.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .prefix_index import (AggregatedPrefixIndex, _sorted_lcp,
                           shard_bounds, shard_owner)
from .shard_backends import ShardBackend, WalkHandle, make_backend


class ShardedPrefixIndex:
    """Instance-id-range partition of the flat bitset prefix index.

    Drop-in for ``AggregatedPrefixIndex`` everywhere the factory uses
    it: same mutation protocol (``add`` / ``remove_leaf`` /
    ``remove_instance`` with **global** instance ids), same query
    surface (``match_depths`` / ``match_depths_many`` returning
    full-width ``(n,)`` / ``(k, n)`` depth arrays).  Mutations route to
    the owning shard only; queries fan out to all shards, each writing
    its own column slice of the output.

    ``backend`` selects the execution strategy (``"serial"`` /
    ``"thread"`` / ``"process"`` or a prebuilt ``ShardBackend``);
    ``parallel=True`` means ``backend="thread"``.
    """

    def __init__(self, n_instances: int, n_shards: int,
                 capacity: int = 256, parallel: bool = False,
                 backend=None, timeout_s: Optional[float] = None):
        if not 1 <= n_shards <= n_instances:
            raise ValueError(
                f"n_shards must be in [1, n_instances]: {n_shards} vs "
                f"{n_instances}")
        self.n = n_instances
        self.n_shards = n_shards
        self.bounds = shard_bounds(n_instances, n_shards)
        self._owner = shard_owner(n_instances, n_shards)
        if backend is None:
            backend = "thread" if parallel else "serial"
        if isinstance(backend, str):
            backend = make_backend(backend, n_instances, n_shards,
                                   capacity=capacity,
                                   timeout_s=timeout_s)
        self.backend: ShardBackend = backend

    @property
    def parallel(self) -> bool:
        """True when fan-out runs concurrently (thread/process)."""
        return self.backend.name != "serial"

    @property
    def shards(self) -> Optional[List[AggregatedPrefixIndex]]:
        """The in-process shard objects (None for process backends —
        those shards live in worker address spaces)."""
        return self.backend.shards

    @property
    def shard_walk_ns(self) -> np.ndarray:
        return self.backend.shard_walk_ns

    @property
    def shard_walks(self) -> np.ndarray:
        return self.backend.shard_walks

    @property
    def n_nodes(self) -> int:
        """Live nodes across all shards (roots excluded)."""
        return self.backend.n_nodes()

    # ---- mutation (RadixKVIndex callback protocol, global ids) --------
    def _local(self, iid: int) -> Tuple[int, int]:
        s = int(self._owner[iid])
        return s, iid - self.bounds[s][0]

    def add(self, iid: int, blocks: Sequence[int]):
        s, li = self._local(iid)
        self.backend.mutate(s, "add", li, blocks)

    def remove_leaf(self, iid: int, path: Sequence[int]):
        s, li = self._local(iid)
        self.backend.mutate(s, "remove_leaf", li, path)

    def remove_instance(self, iid: int):
        s, li = self._local(iid)
        self.backend.mutate(s, "remove_instance", li)

    # ---- queries ------------------------------------------------------
    def match_depths(self, blocks: Sequence[int],
                     out: Optional[np.ndarray] = None) -> np.ndarray:
        """Full-width per-instance cached-prefix depths for ``blocks``:
        the concatenation of every shard's local depth vector."""
        if out is None:
            out = np.zeros(self.n, dtype=np.int64)
        self.backend.submit_walk(blocks, out).wait()
        return out

    def match_depths_many(self, chains: Sequence[Sequence[int]],
                          order: Optional[Sequence[int]] = None,
                          adj: Optional[np.ndarray] = None) -> np.ndarray:
        """``match_depths`` for a wave of chains: one LCP-chained walk
        per shard per lineage, per-shard ``(k, hi-lo)`` blocks written
        into the full ``(k, n)`` matrix.  The lexicographic sort + the
        adjacent-LCP array are computed once here (or passed in from
        ``_sorted_lcp``) and shared by every shard's walk reuse."""
        out, handle = self.submit_many(chains, order=order, adj=adj)
        handle.wait()
        return out

    def submit_many(self, chains: Sequence[Sequence[int]],
                    order: Optional[Sequence[int]] = None,
                    adj: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, WalkHandle]:
        """Asynchronous ``match_depths_many``: returns the ``(k, n)``
        output matrix plus a :class:`WalkHandle`; the matrix is valid
        only after ``wait()``.  On asynchronous backends the walk runs
        while the caller does other host/device work — the routing
        pipeline's wave-overlap hook."""
        k = len(chains)
        out = np.zeros((k, self.n), dtype=np.int64)
        if k == 0:
            return out, WalkHandle()
        if order is None:
            order, adj = _sorted_lcp(chains)
        return out, self.backend.submit_walk_many(chains, order, adj,
                                                  out)

    # ---- self-healing / anti-entropy ---------------------------------
    def attach_faults(self, injector):
        """Arm deterministic fault injection on the backend
        (``repro_torch.core.faults.FaultInjector``; None disarms)."""
        self.backend.attach_faults(injector)

    def set_chains_provider(self, provider):
        """``provider(s) -> [(local_iid, chain), …]`` canonical truth;
        arms supervised worker recovery on the process backend and is
        what ``repair_shard`` callers replay."""
        self.backend.set_chains_provider(provider)

    def shard_digest(self, s: int):
        """``(incremental, rescan)`` digest triples for shard ``s``."""
        return self.backend.shard_digest(s)

    def repair_shard(self, s: int, pairs):
        """Rebuild shard ``s`` — and only shard ``s`` — from canonical
        ``(local_iid, chain)`` pairs.  Healthy shards are untouched."""
        self.backend.repair_shard(s, pairs)

    # ---- lifecycle ----------------------------------------------------
    def close(self):
        """Tear down the backend: thread pools shut down, process
        workers exit and unlink their shared-memory segments.  Serial
        indexes stay usable; concurrent backends must not be queried
        after close."""
        self.backend.close()

    def __del__(self):
        # bound worker lifetime to the index's: a sweep that rebuilds
        # parallel factories must not accumulate idle pools/processes
        try:
            self.close()
        except Exception:
            pass

    # ---- telemetry ----------------------------------------------------
    def shard_stats(self) -> List[dict]:
        """Per-shard walk telemetry: instance range, walks served, and
        mean per-walk host cost.  The max over shards of
        ``mean_walk_us`` is the critical path a parallel router tier
        pays per wave (serial fan-out pays the sum)."""
        walk_ns = self.shard_walk_ns
        walks = self.shard_walks
        return [{"shard": s, "lo": lo, "hi": hi,
                 "walks": int(walks[s]),
                 "mean_walk_us": float(walk_ns[s])
                 / max(int(walks[s]), 1) / 1e3}
                for s, (lo, hi) in enumerate(self.bounds)]

    def worker_metrics(self) -> Optional[np.ndarray]:
        """The backend's fixed-slot metrics block (``(S,
        N_WORKER_SLOTS)`` int64 copy; columns named by
        ``shard_backends.WORKER_SLOTS``)."""
        return self.backend.worker_metrics()
