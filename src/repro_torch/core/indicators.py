"""Indicator factory (paper §3, Fig. 4) — port of ``repro.core.indicators``.

The factory exposes the direct system indicators of the paper's Fig. 2
as contiguous numpy int64 arrays, one slot per instance, updated in
place by the instance hooks:

  ``factory.r_bs``                    running batch sizes
  ``factory.q_bs``                    queued batch sizes
  ``factory.queued_prefill_tokens``   queued new-prefill tokens
  ``factory.total_tokens``            resident context tokens
  ``factory.hits_for(req)``           per-instance KV$ hit tokens

The host half is numpy, exactly as in the reference: the flat bitset
``AggregatedPrefixIndex`` and the LCP helpers the wave path uses (in
the torch-free ``repro_torch.core.prefix_index``, re-exported here), and
the per-instance ``RadixKVIndex`` trees that own LRU clocks and eviction
and keep the aggregate coherent through their callbacks.  ``exact_only``
factories fall back to per-instance walks, which the aggregate cannot
model.

Past a few thousand instances the factory shards the aggregate by
instance-id range: ``n_shards > 1`` (or any ``walk_backend``) builds a
``repro_torch.core.sharded_index.ShardedPrefixIndex`` whose per-shard
depth blocks concatenate into the same full-width matrices, bit-identical
to the flat index, walked by a serial, thread or process shard backend.
The factory is the canonical chains provider of that index: a failed
walk or mutation is healed by rebuilding one shard (or, failing that,
the whole index) from the per-instance trees (degraded mode), and
``anti_entropy_step`` digest-verifies shards against those trees and
repairs any that drifted.

Device mirror & dirty-flag sync contract
----------------------------------------
``device_view()`` returns ``(r_bs, q_bs, queued_prefill_tokens,
total_tokens)`` as int64 torch tensors on ``factory.device``.  The
mirror is partitioned by the same ``shard_bounds`` ranges as the index,
one dirty flag per range: ``mark_dirty(iid)`` flips only the range that
owns ``iid``, a bare ``mark_dirty()`` flips all, and ``device_view``
re-uploads only the dirty ranges (adjacent ones coalesced).  On a CUDA
device the four columns live in one persistent ``(4, n)`` tensor.  A
dirty run ``[lo, hi)`` is packed as a ``(4, hi - lo)`` block into words
``[4 lo, 4 hi)`` of a pinned staging buffer and goes up in one
non-blocking copy on the current stream: straight into the mirror when
the run is the whole of it, else into the same words of a device buffer
and from there, on the device, into the mirror's four column ranges
(measured faster than one copy per row, and than one strided copy).  An
event recorded after the last copy is waited on before the staging
buffer is rewritten.  The CUDA mirror is updated in place (kernels
launched earlier on the stream read it before the copies); on the CPU
each refresh returns a new tensor.
Every built-in mutation path stays an in-place numpy write followed by
``mark_dirty``; code that writes the arrays directly must call
``mark_dirty()`` itself.  Device code never writes indicators back:
decisions return to the host and are committed through the same hooks,
so the numpy arrays remain the single source of truth.

``evictions`` counts per-instance KV$ leaf evictions and full clears
(and index repairs).  The wave plan models intra-wave cache growth
exactly but not a mid-wave eviction; the router watches this counter
and falls back to sequential host routing the moment it moves, and the
pipeline's speculative walks are voided by it.

Preble's routed-window rings: every committed decision appends
``(now, prompt_len - hit)`` to its instance's row of two ``(n, cap)``
ring matrices (``log_routed``); ``window_stats`` trims every row's
leading run of entries older than the window and sums what is left in
one vectorized pass.  A full row is first trimmed to ``LOG_HORIZON_S``
and the whole matrix doubles only if that frees nothing.

Heterogeneous fleets: ``IndicatorFactory(fleet=...)`` (a
``repro_torch.core.fleet.FleetSpec``) carries the immutable columns
``model_id``, ``hardware_class`` and ``prefill_norm`` (the per-instance
marginal prefill cost the hetero LMetric score multiplies in; None when
the fleet's costs are constant, so a homogeneous fleet keeps the legacy
path), ``feasible_mask(requirement)`` (cached per requirement) and
``device_hetero_view()`` (the three columns on ``factory.device``,
uploaded once; no routing path reads it — the hetero score is host-only,
as in the reference).

Instance failure (``on_instance_failed``) zeroes the instance's four
columns and its routed-window ring, dirties the mirror range that holds
it — so the next ``device_view`` re-uploads the zeroed columns — and
clears its radix tree, whose ``on_clear`` removes its column from the
aggregated index through the shard backend.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .prefix_index import (  # noqa: F401  (re-exported names)
    AggregatedPrefixIndex, _lcp_block, _pairwise_lcp, _sorted_lcp,
    digest_from_chains, shard_bounds, shard_owner)
from .radix import RadixKVIndex
from .types import Request


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on.  ``"cuda"`` (the
    default everywhere in the port) needs a card; only an explicit
    ``"cpu"`` runs the plain PyTorch versions of the kernels."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch version")
        if dev.index is None:
            # the device a tensor made on "cuda" reports, so that devices
            # compare equal to tensors' devices
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


class InstanceState:
    """Per-instance view over one column of the factory's arrays;
    attribute reads and writes hit the shared numpy arrays in place."""

    __slots__ = ("iid", "_f", "kv")

    def __init__(self, iid: int, factory: "IndicatorFactory",
                 kv: RadixKVIndex):
        self.iid = iid
        self._f = factory
        self.kv = kv

    # ---- indicator reads/writes (array-backed) ---------------------------
    @property
    def r_bs(self) -> int:
        return int(self._f.r_bs[self.iid])

    @r_bs.setter
    def r_bs(self, v: int):
        self._f.r_bs[self.iid] = v
        self._f.mark_dirty(self.iid)

    @property
    def q_bs(self) -> int:
        return int(self._f.q_bs[self.iid])

    @q_bs.setter
    def q_bs(self, v: int):
        self._f.q_bs[self.iid] = v
        self._f.mark_dirty(self.iid)

    @property
    def queued_prefill_tokens(self) -> int:
        return int(self._f.queued_prefill_tokens[self.iid])

    @queued_prefill_tokens.setter
    def queued_prefill_tokens(self, v: int):
        self._f.queued_prefill_tokens[self.iid] = v
        self._f.mark_dirty(self.iid)

    @property
    def total_tokens(self) -> int:
        return int(self._f.total_tokens[self.iid])

    @total_tokens.setter
    def total_tokens(self, v: int):
        self._f.total_tokens[self.iid] = v
        self._f.mark_dirty(self.iid)

    @property
    def routed_log(self) -> List:
        """(time, p_tokens) of windowed routed requests, oldest first,
        read from the factory's ring."""
        return self._f.routed_window(self.iid)

    @property
    def bs(self) -> int:
        return self.r_bs + self.q_bs

    def kv_hit(self, req: Request, touch: bool = False) -> int:
        return self.kv.match(req.blocks, req.prompt_len, touch=touch)

    def p_token(self, req: Request, hit: Optional[int] = None) -> int:
        """Paper Fig. 17(b): queued new-prefill tokens if routed here."""
        if hit is None:
            hit = self.kv_hit(req)
        return self.queued_prefill_tokens + (req.prompt_len - hit)

    # ---- update hooks (called by router / engine / simulator) ------------
    def on_route(self, req: Request, now: float, hit: int):
        f, i = self._f, self.iid
        f.q_bs[i] += 1
        f.queued_prefill_tokens[i] += req.prompt_len - hit
        f.total_tokens[i] += req.prompt_len
        f.mark_dirty(i)
        f.log_routed(i, now, req.prompt_len - hit)

    def on_prefill_progress(self, n_tokens: int):
        f, i = self._f, self.iid
        left = f.queued_prefill_tokens[i] - n_tokens
        f.queued_prefill_tokens[i] = left if left > 0 else 0
        f.mark_dirty(i)

    def on_retract(self, req: Request, prefill_left: int):
        """Reverse ``on_route`` for a cancelled queued-or-prefilling
        request; the KV$ entry routing inserted stays for the LRU."""
        f, i = self._f, self.iid
        if f.q_bs[i] > 0:
            f.q_bs[i] -= 1
        left = f.queued_prefill_tokens[i] - prefill_left
        f.queued_prefill_tokens[i] = left if left > 0 else 0
        left = f.total_tokens[i] - req.prompt_len
        f.total_tokens[i] = left if left > 0 else 0
        f.mark_dirty(i)

    def on_start_running(self, req: Request):
        f, i = self._f, self.iid
        if f.q_bs[i] > 0:
            f.q_bs[i] -= 1
        f.r_bs[i] += 1
        f.mark_dirty(i)

    def on_decode_token(self):
        f = self._f
        f.total_tokens[self.iid] += 1
        f.mark_dirty(self.iid)

    def on_finish(self, req: Request):
        f, i = self._f, self.iid
        if f.r_bs[i] > 0:
            f.r_bs[i] -= 1
        left = f.total_tokens[i] - req.prompt_len - req.output_len
        f.total_tokens[i] = left if left > 0 else 0
        f.mark_dirty(i)

    def trim_log(self, now: float, window: float):
        self._f.trim_routed(self.iid, now - window)


class _WaveHandle:
    """In-flight wave walk: everything ``wave_collect`` needs to finish
    the host half of a wave — the requests, their unique chains, the
    shared lexicographic sort, the per-unique-chain depth matrix and the
    (possibly asynchronous) shard backend's walk handle.  The routing
    pipeline holds one of these across a speculative prefetch."""

    __slots__ = ("reqs", "uid", "chains", "order", "adj", "depth_u",
                 "handle", "submit_ns")

    def __init__(self, reqs, uid, chains, order, adj, depth_u, handle,
                 submit_ns):
        self.reqs = reqs
        self.uid = uid
        self.chains = chains
        self.order = order
        self.adj = adj
        self.depth_u = depth_u
        self.handle = handle
        self.submit_ns = submit_ns


class IndicatorFactory:
    _LOG_CAP0 = 256   # initial per-instance routed-window ring capacity

    def __init__(self, n_instances: int, kv_capacity_tokens: int = 1 << 62,
                 block_size: int = 64, exact_only: bool = False,
                 n_shards: int = 1, parallel_walks: bool = False,
                 walk_backend: Optional[str] = None,
                 shard_timeout_s: Optional[float] = None,
                 fleet=None, device="cuda"):
        self.n = n_instances
        self.block_size = block_size
        self.exact_only = exact_only
        self.walk_backend = walk_backend
        self.parallel_walks = parallel_walks
        self.shard_timeout_s = shard_timeout_s
        self.device = resolve_device(device)
        # --- heterogeneous fleet columns ---------------------------------
        # written once here and never mutated, so the mirror's dirty
        # flags have nothing to re-upload for them; prefill_norm is None
        # without a fleet or when the fleet's costs are constant
        # (FleetSpec.norm_or_none): the collapse that keeps homogeneous
        # configurations on the legacy path
        self.fleet = fleet
        if fleet is not None:
            if fleet.n != n_instances:
                raise ValueError(f"fleet describes {fleet.n} instances, "
                                 f"factory has {n_instances}")
            self.model_id = fleet.model_codes.copy()
            self.hardware_class = fleet.class_codes.copy()
            self.prefill_norm = fleet.norm_or_none()
        else:
            self.model_id = np.zeros(n_instances, dtype=np.int64)
            self.hardware_class = np.zeros(n_instances, dtype=np.int64)
            self.prefill_norm = None
        self._dev_hetero = None
        self._feasible_cache = {}
        # degraded-mode telemetry: walk-backend deaths survived by
        # rebuilding (one shard of) the index from the per-instance radix
        # trees; on_degraded_rebuild(n) fires once per increment, never
        # again when the triggering walk or mutation is retried
        self.degraded_rebuilds = 0
        self.on_degraded_rebuild = None
        # anti-entropy telemetry: scoped repairs performed, digest
        # mismatches seen, the sweep cursor and per-repair wall cost;
        # on_shard_repair(s, n) fires exactly once per repair
        self.shard_repairs = 0
        self.verify_mismatches = 0
        self.repair_ns: List[int] = []
        self.on_shard_repair = None
        self._sweep_cursor = 0
        self._fault_injector = None
        self.on_backend_event = None
        # shard count for the aggregated index AND the device-mirror
        # partition (same shard_bounds cut); 1 = the unsharded flat index
        self.n_shards = max(1, min(int(n_shards), n_instances))
        # --- the array contract (see module docstring) -------------------
        self.r_bs = np.zeros(n_instances, dtype=np.int64)
        self.q_bs = np.zeros(n_instances, dtype=np.int64)
        self.queued_prefill_tokens = np.zeros(n_instances, dtype=np.int64)
        self.total_tokens = np.zeros(n_instances, dtype=np.int64)
        self._hit_depths = np.zeros(n_instances, dtype=np.int64)
        # device mirror (see docstring): one dirty flag per shard range;
        # _dev caches the four row views until a flag is set
        self._mirror_bounds = shard_bounds(n_instances, self.n_shards)
        self._mirror_owner = shard_owner(n_instances, self.n_shards)
        self._dirty = np.ones(self.n_shards, dtype=bool)
        #: per-range re-upload counts (``device_view`` telemetry)
        self.mirror_uploads = np.zeros(self.n_shards, dtype=np.int64)
        self._mirror = None           # (4, n) int64 on self.device
        self._staging = None          # pinned (4n,) packed runs (cuda)
        self._packed = None           # device twin of _staging (cuda)
        self._staged = None           # event: last upload left _staging
        self._dev = None
        # mid-wave plan invalidation signal for Router.route_batch
        self.evictions = 0
        # host-walk telemetry: aggregated-index walk time / walk count
        # (per unique prompt), surfaced by Router.mean_walk_us
        self.walk_ns = 0
        self.walks = 0
        # Preble routed-window rings (time, p_tokens), one row per instance
        cap = self._LOG_CAP0
        self._log_t = np.zeros((n_instances, cap), dtype=np.float64)
        self._log_p = np.zeros((n_instances, cap), dtype=np.int64)
        self._log_start = np.zeros(n_instances, dtype=np.int64)
        self._log_len = np.zeros(n_instances, dtype=np.int64)
        # speculative-walk insert capture (see begin_insert_capture)
        self._capture = None
        self._capture_ev0 = 0
        # exact_only hit semantics (deepest snapshot boundary) cannot be
        # read off chain membership alone -> scalar per-instance fallback
        if exact_only:
            self._agg = None
        elif self.n_shards == 1 and walk_backend is None:
            self._agg = AggregatedPrefixIndex(n_instances)
        else:
            # an explicit walk backend always builds the sharded index
            # (even at one shard) so backend sweeps compare like with
            # like; decisions are bit-identical either way
            from .sharded_index import ShardedPrefixIndex
            self._agg = ShardedPrefixIndex(n_instances, self.n_shards,
                                           parallel=parallel_walks,
                                           backend=walk_backend,
                                           timeout_s=shard_timeout_s)
        self.instances = []
        for i in range(n_instances):
            kv = RadixKVIndex(block_size=block_size,
                              capacity_tokens=kv_capacity_tokens,
                              exact_only=exact_only)
            if self._agg is not None:
                kv.on_insert = (lambda blocks, _i=i:
                                self._on_insert(_i, blocks))
                kv.on_evict = (lambda path, _i=i:
                               self._on_evict(_i, path))
                kv.on_clear = (lambda _i=i: self._on_clear(_i))
            self.instances.append(InstanceState(i, self, kv))
        self._wire_agg()

    def _wire_agg(self):
        """Arm the aggregated index's self-healing hooks: the factory
        is the canonical chains provider (supervised worker recovery
        rebuilds only from it), and an attached fault injector and
        backend-event hook carry over to replacement backends."""
        agg = self._agg
        if agg is None:
            return
        sp = getattr(agg, "set_chains_provider", None)
        if sp is not None:
            sp(self._shard_chains)
        if self._fault_injector is not None:
            af = getattr(agg, "attach_faults", None)
            if af is not None:
                af(self._fault_injector)
        if self.on_backend_event is not None:
            backend = getattr(agg, "backend", None)
            if backend is not None:
                backend.on_event = self.on_backend_event

    def attach_backend_events(self, cb):
        """Wire ``cb(kind, shard, info)`` to the shard backend's
        recovery events (restart / timeout / escalation / repair);
        survives degraded rebuilds.  None disarms."""
        self.on_backend_event = cb
        agg = self._agg
        backend = getattr(agg, "backend", None) if agg is not None \
            else None
        if backend is not None:
            backend.on_event = cb

    def _mutate_recover(self, e, op, *args):
        """A routed mutation failed: scoped repair when the error names
        a shard, full rebuild otherwise, then re-apply the mutation —
        all three index mutations are idempotent, so re-applying after
        a repair that already replayed it is a no-op."""
        shard = getattr(e, "shard", None)
        self._rebuild_index(shard=shard)
        if shard is not None:
            try:
                getattr(self._agg, op)(*args)
            except (RuntimeError, OSError):
                self._rebuild_index()

    def _on_insert(self, iid: int, blocks):
        try:
            self._agg.add(iid, blocks)
        except (RuntimeError, OSError) as e:
            self._mutate_recover(e, "add", iid, blocks)
            # the rebuild/repair replays the tree, this insert included
        if self._capture is not None:
            self._capture.append((iid, blocks))

    def _on_evict(self, iid: int, path):
        self.evictions += 1
        try:
            self._agg.remove_leaf(iid, path)
        except (RuntimeError, OSError) as e:
            self._mutate_recover(e, "remove_leaf", iid, path)

    def _on_clear(self, iid: int):
        self.evictions += 1
        try:
            self._agg.remove_instance(iid)
        except (RuntimeError, OSError) as e:
            self._mutate_recover(e, "remove_instance", iid)

    # ---- lifecycle -------------------------------------------------------
    def close(self):
        """Tear down the aggregated index's execution backend (thread
        pools, process workers + their shared-memory segments).  Serial
        factories are unaffected; any factory is safe to close twice.
        ``with IndicatorFactory(...) as f:`` closes on exit."""
        agg = self._agg
        if agg is not None and hasattr(agg, "close"):
            agg.close()

    def __enter__(self) -> "IndicatorFactory":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ---- speculative-walk insert capture ---------------------------------
    def begin_insert_capture(self):
        """Start recording ``(iid, blocks)`` aggregate inserts.

        The routing pipeline brackets a speculative next-wave walk with
        begin/end: every chain inserted between the walk's snapshot and
        its use is captured, and the walk result is patched with the
        exact cross-wave LCP credit (a tree's hit depth is the max over
        its stored chains of the LCP, so ``max(old_depth, lcp(chain,
        inserted))`` is the depth a fresh walk would return).  An
        eviction, clear or repair invalidates the capture — it cannot be
        credited — and the pipeline walks fresh instead.
        """
        self._capture = []
        self._capture_ev0 = self.evictions

    def end_insert_capture(self):
        """Stop recording; returns ``(inserts, valid)`` where ``valid``
        is False if any eviction/clear fired during the capture."""
        cap, self._capture = self._capture, None
        if cap is None:
            return [], False
        return cap, self.evictions == self._capture_ev0

    # ---- instance churn (the factory's half) -----------------------------
    def on_instance_failed(self, iid: int):
        """An instance died with its KV$: zero its indicator columns
        (dirtying the mirror range that holds it), forget its routed
        window, and clear its radix tree — the ``on_clear`` callback
        removes its aggregated-index column through the shard backend
        and bumps the eviction counter, which also voids any in-flight
        speculative insert capture."""
        self.r_bs[iid] = 0
        self.q_bs[iid] = 0
        self.queued_prefill_tokens[iid] = 0
        self.total_tokens[iid] = 0
        self._log_start[iid] = 0
        self._log_len[iid] = 0
        self.mark_dirty(iid)
        self.instances[iid].kv.clear()

    # ---- degraded mode (walk-backend death) ------------------------------
    def _rebuild_index(self, shard: Optional[int] = None):
        """A walk backend died mid-query.  When the error named a shard
        (``ShardError.shard``) and the surviving backend can repair in
        place, rebuild **only that shard's range** from the per-instance
        radix trees — healthy shards' node arrays are untouched.
        Otherwise tear the broken index down, build a replacement (same
        sharded flavour with fresh workers; a serial flat index when the
        respawn fails too), and repopulate it from KV truth.  Either way
        bumps the eviction counter so any in-flight wave plan or
        speculative capture is invalidated."""
        self.degraded_rebuilds += 1
        cb = self.on_degraded_rebuild
        if cb is not None:
            # fire exactly here — the one place the counter increments —
            # so a retried walk or mutation cannot double-emit; observer
            # faults must never break the rebuild itself
            try:
                cb(self.degraded_rebuilds)
            except Exception:
                pass
        self.evictions += 1
        if shard is not None and self._repair_in_place(shard):
            return
        old, self._agg = self._agg, None
        if old is not None and hasattr(old, "close"):
            try:
                old.close()
            except Exception:
                pass                      # the backend is already broken
        agg = None
        if self.walk_backend is not None or self.n_shards > 1:
            from .sharded_index import ShardedPrefixIndex
            try:
                agg = ShardedPrefixIndex(self.n, self.n_shards,
                                         parallel=self.parallel_walks,
                                         backend=self.walk_backend,
                                         timeout_s=self.shard_timeout_s)
            except Exception:
                agg = None                # respawn failed: go serial
        if agg is None:
            agg = AggregatedPrefixIndex(self.n)
        for inst in self.instances:
            for chain in inst.kv.chains():
                agg.add(inst.iid, chain)
        # the kv callbacks close over self._agg dynamically, so the
        # swap retargets every future insert/evict/clear
        self._agg = agg
        self._wire_agg()

    def _walk_retry(self, e, fn):
        """Bounded degraded-mode retry for a failed walk: scoped repair
        when the error names a shard, full rebuild otherwise, then re-run
        the walk.  Bounded by shards + 1 attempts — each repair heals one
        shard, so a plan injecting consecutive crashes on every shard
        still converges instead of looping."""
        for _ in range(self._index_shards() + 1):
            self._rebuild_index(shard=getattr(e, "shard", None))
            try:
                return fn()
            except (RuntimeError, OSError) as e2:
                e = e2
        raise e

    def _repair_in_place(self, s: int) -> bool:
        """Try the scoped repair; False falls back to the full rebuild
        (no ``repair_shard`` on the index, backend already torn down,
        or the repair itself failed)."""
        agg = self._agg
        if agg is None or not hasattr(agg, "repair_shard"):
            return False
        backend = getattr(agg, "backend", None)
        if backend is not None and getattr(backend, "_closed", False):
            return False
        try:
            self.repair_shard(s, _count_rebuild=False)
        except Exception:
            return False
        return True

    # ---- anti-entropy ----------------------------------------------------
    def _index_shards(self) -> int:
        """Shard count of the live aggregated index (1 for the flat
        unsharded index, 0 for exact_only factories)."""
        agg = self._agg
        return getattr(agg, "n_shards", 1) if agg is not None else 0

    def _shard_chains(self, s: int) -> List[Tuple[int, list]]:
        """Canonical truth for shard ``s``: every ``(local_iid, chain)``
        in its instance range, read from the per-instance radix trees."""
        lo, hi = shard_bounds(self.n, self._index_shards())[s]
        pairs = []
        for iid in range(lo, hi):
            for chain in self.instances[iid].kv.chains():
                pairs.append((iid - lo, chain))
        return pairs

    def attach_faults(self, injector):
        """Arm deterministic fault injection
        (``repro_torch.core.faults.FaultInjector``) on the aggregated
        index's backend; survives degraded rebuilds.  None disarms."""
        self._fault_injector = injector
        agg = self._agg
        if agg is not None:
            af = getattr(agg, "attach_faults", None)
            if af is not None:
                af(injector)

    def verify_shard(self, s: int) -> bool:
        """True iff shard ``s``'s aggregated index agrees with KV truth:
        the incremental digest, a rescan of the bitset rows, and a
        replay of ``RadixKVIndex.chains()`` all produce the same digest
        triple.  Counts mismatches; never mutates."""
        agg = self._agg
        if agg is None:
            return True
        truth = digest_from_chains(self._shard_chains(s))
        sd = getattr(agg, "shard_digest", None)
        if sd is not None:
            inc, scan = sd(s)
        else:
            inc, scan = agg.digest, agg.rescan_digest()
        ok = tuple(inc) == truth and tuple(scan) == truth
        if not ok:
            self.verify_mismatches += 1
        return ok

    def repair_shard(self, s: int, _count_rebuild: bool = True):
        """Rebuild shard ``s`` — and only shard ``s`` — from canonical
        KV truth, leaving healthy shards' node arrays untouched.  Bumps
        the eviction counter (a repaired shard may answer differently,
        so in-flight plans and speculative captures are invalid) and
        fires ``on_shard_repair`` exactly once."""
        agg = self._agg
        if agg is None:
            return
        t0 = time.perf_counter_ns()
        rp = getattr(agg, "repair_shard", None)
        if rp is not None:
            rp(s, self._shard_chains(s))
        else:
            # flat unsharded index: shard 0 is the whole index
            agg.reset()
            for li, chain in self._shard_chains(0):
                agg.add(li, chain)
        self.repair_ns.append(time.perf_counter_ns() - t0)
        self.shard_repairs += 1
        if _count_rebuild:
            self.evictions += 1
        cb = self.on_shard_repair
        if cb is not None:
            try:
                cb(s, self.shard_repairs)
            except Exception:
                pass

    def anti_entropy_step(self, k: int = 1) -> int:
        """Budgeted background sweep: verify the next ``k`` shards in
        cursor order, repairing any whose digests disagree with KV
        truth.  Returns the number of repairs performed — callers run it
        once per wave with small ``k``."""
        if self._agg is None or k <= 0:
            return 0
        S = self._index_shards()
        repaired = 0
        for _ in range(min(int(k), S)):
            s = self._sweep_cursor % S
            self._sweep_cursor += 1
            if not self.verify_shard(s):
                self.repair_shard(s)
                repaired += 1
        return repaired

    def __len__(self):
        return self.n

    def __iter__(self):
        return iter(self.instances)

    def __getitem__(self, i) -> InstanceState:
        return self.instances[i]

    # ---- vectorized reads ------------------------------------------------
    def bs_vector(self) -> np.ndarray:
        return self.r_bs + self.q_bs

    def hits_for(self, req: Request) -> np.ndarray:
        """Per-instance KV$ hit tokens (capped at the prompt length)."""
        if self._agg is not None:
            t0 = time.perf_counter_ns()
            try:
                depths = self._agg.match_depths(req.blocks,
                                                out=self._hit_depths)
            except (RuntimeError, OSError) as e:
                # degraded: scoped repair (or full rebuild) + retry
                depths = self._walk_retry(
                    e, lambda: self._agg.match_depths(
                        req.blocks, out=self._hit_depths))
            self.walk_ns += time.perf_counter_ns() - t0
            self.walks += 1
            hits = depths * self.block_size
            np.minimum(hits, req.prompt_len, out=hits)
            return hits
        return np.array([inst.kv_hit(req) for inst in self.instances],
                        dtype=np.int64)

    def p_tokens_for(self, req: Request,
                     hits: Optional[np.ndarray] = None) -> np.ndarray:
        """Vectorized Fig. 17(b) P-token: queued prefill + new tokens."""
        if hits is None:
            hits = self.hits_for(req)
        return self.queued_prefill_tokens + (req.prompt_len - hits)

    def mean_walk_us(self) -> float:
        """Mean host cost of one aggregated-index walk (per unique
        prompt), from the ``walk_ns``/``walks`` telemetry.  On a sharded
        factory a "walk" is the full fan-out across every shard
        (including the shared lexicographic sort); ``shard_walk_stats``
        breaks the same work down per shard."""
        return self.walk_ns / max(self.walks, 1) / 1e3

    def shard_walk_stats(self) -> List[dict]:
        """Per-shard host-walk telemetry: one record per shard with its
        instance range ``[lo, hi)``, walks served, and mean per-walk
        cost in µs.  An unsharded (or ``exact_only``) factory reports a
        single pseudo-shard covering ``[0, n)``; the max over shards is
        the critical path a parallel walk fan-out pays per wave."""
        stats = getattr(self._agg, "shard_stats", None)
        if stats is not None:
            return stats()
        return [{"shard": 0, "lo": 0, "hi": self.n,
                 "walks": int(self.walks),
                 "mean_walk_us": self.mean_walk_us()}]

    # ---- device mirror (dirty-flag sync contract, see docstring) ---------
    def mark_dirty(self, iid: Optional[int] = None):
        """Invalidate the device mirror after an in-place indicator
        write.  ``mark_dirty(iid)`` flips only the mirror range that
        owns instance ``iid`` (what every built-in hook passes); a bare
        ``mark_dirty()`` flips every range and is always safe for
        callers that batch-write slices of ``factory.r_bs`` and friends."""
        if iid is None:
            self._dirty[:] = True
        else:
            self._dirty[self._mirror_owner[iid]] = True
        self._dev = None

    def _dirty_runs(self) -> List[List[int]]:
        """The dirty mirror ranges as ``[lo, hi)`` runs, adjacent
        ranges coalesced."""
        runs: List[List[int]] = []
        for s in np.flatnonzero(self._dirty).tolist():
            lo, hi = self._mirror_bounds[s]
            if runs and runs[-1][1] == lo:
                runs[-1][1] = hi
            else:
                runs.append([lo, hi])
        return runs

    def device_view(self) -> Tuple[torch.Tensor, ...]:
        """(r_bs, q_bs, queued_prefill_tokens, total_tokens) as int64
        tensors on ``self.device``; only the mirror ranges a hook
        dirtied since the last call are re-uploaded.  Read-only by
        contract."""
        if self._dev is not None:
            return self._dev
        cols = (self.r_bs, self.q_bs, self.queued_prefill_tokens,
                self.total_tokens)
        runs = self._dirty_runs()
        on_card = self.device.type == "cuda"
        if self._mirror is None:
            self._mirror = torch.empty((4, self.n), dtype=torch.int64,
                                       device=self.device)
            self._staging = torch.empty(4 * self.n, dtype=torch.int64,
                                        pin_memory=on_card)
            # on the CPU the packed runs are copied from the staging itself
            self._packed = (torch.empty(4 * self.n, dtype=torch.int64,
                                        device=self.device)
                            if on_card else self._staging)
            self._staged = torch.cuda.Event() if on_card else None
        elif on_card:
            # the previous non-blocking copies must have left the
            # staging buffer before any of it is overwritten
            self._staged.synchronize()
        # the CUDA mirror is refreshed in place, the CPU one is a copy
        mirror = self._mirror if on_card else self._mirror.clone()
        host = self._staging.numpy()
        for lo, hi in runs:
            w = hi - lo
            block = host[4 * lo:4 * hi].reshape(4, w)
            for r, c in enumerate(cols):
                block[r] = c[lo:hi]
            if w == self.n:
                mirror.view(-1).copy_(self._staging, non_blocking=True)
                continue
            packed = self._packed[4 * lo:4 * hi]
            if on_card:
                packed.copy_(self._staging[4 * lo:4 * hi],
                             non_blocking=True)
            mirror[:, lo:hi].copy_(packed.view(4, w))
        if on_card:
            self._staged.record()
        self._mirror = mirror
        self.mirror_uploads[self._dirty] += 1
        self._dirty[:] = False
        self._dev = tuple(self._mirror.unbind(0))
        return self._dev

    # ---- heterogeneous fleet reads ---------------------------------------
    def feasible_mask(self, requirement: str):
        """Boolean capability mask for a ``model_requirement``, or None
        when there is nothing to filter (no fleet, or an empty
        requirement).  Callers intersect it into the policy's candidate
        set like the alive mask, so a None keeps the legacy path.  Cached
        per requirement string (the fleet is immutable)."""
        if self.fleet is None or not requirement:
            return None
        m = self._feasible_cache.get(requirement)
        if m is None:
            m = self.fleet.feasible_mask(requirement)
            self._feasible_cache[requirement] = m
        return m

    def device_hetero_view(self):
        """(model_id, hardware_class, prefill_norm) as tensors on
        ``self.device`` (int64, int64, float64); the norm slot is None
        when ``prefill_norm`` collapsed.  The columns never change, so
        one upload serves every call.  No routing path reads it: the
        ``route_score`` kernel has no norm input, and the hetero score
        takes the host path."""
        if self._dev_hetero is None:
            self._dev_hetero = (
                torch.from_numpy(self.model_id).to(self.device),
                torch.from_numpy(self.hardware_class).to(self.device),
                None if self.prefill_norm is None
                else torch.from_numpy(self.prefill_norm).to(self.device))
        return self._dev_hetero

    def snapshot(self) -> Dict[str, List]:
        """The indicator columns (and the fleet's code columns) as lists."""
        snap = {
            "r_bs": self.r_bs.tolist(),
            "q_bs": self.q_bs.tolist(),
            "bs": self.bs_vector().tolist(),
            "queued_prefill_tokens": self.queued_prefill_tokens.tolist(),
            "total_tokens": self.total_tokens.tolist(),
            "kv_tokens": [i.kv.tokens_stored for i in self.instances],
        }
        if self.fleet is not None:
            snap["model_id"] = self.model_id.tolist()
            snap["hardware_class"] = self.hardware_class.tolist()
        return snap

    # ---- wave inputs (host half of the batch routing path) ---------------
    def wave_submit(self, reqs: Sequence[Request]) -> _WaveHandle:
        """Start the walk stage for an arrival wave: dedup to unique
        chains, compute the shared lexicographic sort, and submit one
        LCP-chained aggregated-index walk per unique prompt.  On
        asynchronous backends (thread/process shard fan-out) the walk
        runs while the caller does other work; ``wave_collect`` blocks
        for the result.  Requires the aggregated index."""
        k = len(reqs)
        uid = np.empty(k, dtype=np.int64)
        uniq: Dict[tuple, int] = {}
        for j, r in enumerate(reqs):
            u = uniq.setdefault(r.blocks, len(uniq))
            uid[j] = u
        chains = [None] * len(uniq)
        for blocks, u in uniq.items():
            chains[u] = blocks
        t0 = time.perf_counter_ns()
        order, adj = _sorted_lcp(chains)
        submit = getattr(self._agg, "submit_many", None)
        try:
            if submit is not None:
                depth_u, handle = submit(chains, order=order, adj=adj)
            else:
                depth_u = self._agg.match_depths_many(chains, order=order,
                                                      adj=adj)
                handle = None
        except (RuntimeError, OSError) as e:
            # walk backend died on dispatch: repair (scoped to the
            # failed shard when the error names one) and run this
            # wave's walk on the healed index
            depth_u = self._walk_retry(
                e, lambda: self._agg.match_depths_many(chains,
                                                       order=order,
                                                       adj=adj))
            handle = None
        return _WaveHandle(tuple(reqs), uid, chains, order, adj,
                           depth_u, handle,
                           time.perf_counter_ns() - t0)

    def wave_collect(self, h: _WaveHandle, with_lcp: bool = True):
        """Finish a submitted wave walk: wait for the depth matrix,
        account walk telemetry (submit cost + blocked wait — the host
        time the walk actually held up routing), and derive the
        pairwise-LCP matrix from the shared sort."""
        t0 = time.perf_counter_ns()
        if h.handle is not None:
            try:
                h.handle.wait()
            except (RuntimeError, OSError) as e:
                # a shard worker died mid-query (degraded mode): repair
                # and recompute this wave's walk — the wave proceeds
                # instead of raising
                h.depth_u = self._walk_retry(
                    e, lambda: self._agg.match_depths_many(
                        h.chains, order=h.order, adj=h.adj))
                h.handle = None
        self.walk_ns += h.submit_ns + (time.perf_counter_ns() - t0)
        self.walks += len(h.chains)
        k = len(h.reqs)
        lcp = (_pairwise_lcp(h.chains, order=h.order, adj=h.adj)
               [np.ix_(h.uid, h.uid)] if with_lcp else None)
        plen = np.fromiter((r.prompt_len for r in h.reqs), np.int64, k)
        return h.depth_u[h.uid], lcp, plen

    def wave_discard(self, h: _WaveHandle):
        """Wait out a submitted walk without consuming it (mispredicted
        speculation).  The wait keeps asynchronous backends' protocol
        in sync; nothing is added to walk telemetry — no routed wave
        was served by this walk."""
        if h.handle is not None:
            try:
                h.handle.wait()
            except (RuntimeError, OSError) as e:
                # the speculation is being dropped anyway; just heal
                # the broken shard (or replace the backend) so the
                # next wave has an index
                self._rebuild_index(shard=getattr(e, "shard", None))

    def wave_inputs(self, reqs: Sequence[Request], with_lcp: bool = True):
        """(depth (k,n), lcp (k,k) | None, plen (k,)) for an arrival wave:
        one LCP-chained aggregated-index walk per unique prompt plus the
        pairwise block-chain LCP matrix the device loop needs to credit
        intra-wave inserts.  ``wave_submit`` + ``wave_collect`` in one
        breath."""
        return self.wave_collect(self.wave_submit(reqs),
                                 with_lcp=with_lcp)

    # ---- Preble routed-window rings --------------------------------------
    #: entries older than this are expendable when a ring fills: every
    #: windowed consumer (Preble's 3-minute fallback) looks back far
    #: less, and horizon-trimming a full row beats doubling the whole
    #: (n, cap) matrix for one hot instance
    LOG_HORIZON_S = 3600.0

    def log_routed(self, iid: int, t: float, p_tokens: int):
        if self._log_len[iid] == self._log_t.shape[1]:
            self.trim_routed(iid, t - self.LOG_HORIZON_S)
        if self._log_len[iid] == self._log_t.shape[1]:
            self._grow_log()
        cap = self._log_t.shape[1]
        idx = (self._log_start[iid] + self._log_len[iid]) % cap
        self._log_t[iid, idx] = t
        self._log_p[iid, idx] = p_tokens
        self._log_len[iid] += 1

    def _grow_log(self):
        cap = self._log_t.shape[1]
        nt = np.zeros((self.n, 2 * cap), dtype=np.float64)
        npv = np.zeros((self.n, 2 * cap), dtype=np.int64)
        idx = (self._log_start[:, None] + np.arange(cap)[None, :]) % cap
        rows = np.arange(self.n)[:, None]
        nt[:, :cap] = self._log_t[rows, idx]
        npv[:, :cap] = self._log_p[rows, idx]
        self._log_t, self._log_p = nt, npv
        self._log_start[:] = 0

    def _log_view(self):
        """(times, ptokens, valid) in logical (oldest-first) order."""
        cap = self._log_t.shape[1]
        idx = (self._log_start[:, None] + np.arange(cap)[None, :]) % cap
        rows = np.arange(self.n)[:, None]
        valid = np.arange(cap)[None, :] < self._log_len[:, None]
        return self._log_t[rows, idx], self._log_p[rows, idx], valid

    def trim_routed(self, iid: int, cut: float):
        """Drop the leading run of entries older than ``cut`` (only the
        front is scanned: a later entry older than ``cut`` stays)."""
        cap = self._log_t.shape[1]
        start, ln = int(self._log_start[iid]), int(self._log_len[iid])
        k = 0
        while k < ln and self._log_t[iid, (start + k) % cap] < cut:
            k += 1
        if k:
            self._log_start[iid] = (start + k) % cap
            self._log_len[iid] = ln - k

    def routed_window(self, iid: int) -> List:
        """Instance ``iid``'s ring as ``[(time, p_tokens), ...]``, oldest
        first."""
        cap = self._log_t.shape[1]
        start, ln = int(self._log_start[iid]), int(self._log_len[iid])
        idx = (start + np.arange(ln)) % cap
        return [(float(t), int(p)) for t, p in
                zip(self._log_t[iid, idx], self._log_p[iid, idx])]

    def window_stats(self, now: float, window: float,
                     trim: bool = True):
        """Vectorized trim + (sum p_tokens, count) over every instance's
        window: Preble's fallback in one pass.  ``trim=False`` computes
        the same stats without advancing the ring cursors (the
        side-effect-free inspection of ``scores_batch``)."""
        cut = now - window
        times, pts, valid = self._log_view()
        drop = np.cumprod(valid & (times < cut), axis=1).sum(axis=1)
        if drop.any():
            if trim:
                cap = self._log_t.shape[1]
                self._log_start[:] = (self._log_start + drop) % cap
                self._log_len[:] = self._log_len - drop
            keep = valid & (np.arange(times.shape[1])[None, :]
                            >= drop[:, None])
        else:
            keep = valid
        return (np.where(keep, pts, 0).sum(axis=1),
                keep.sum(axis=1).astype(np.int64))
