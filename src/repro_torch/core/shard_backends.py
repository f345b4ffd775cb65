"""Pluggable execution backends for ``ShardedPrefixIndex`` — port of
``repro.core.shard_backends`` (numpy only: a process-backend worker
imports this module, ``faults`` and ``prefix_index``, and no ``torch``).

The deterministic-merge contract: each shard of the aggregated prefix
index owns a contiguous instance-id range, mutations route to the
owning shard only, and every query writes exactly the disjoint column
slice ``out[:, lo_s:hi_s]`` it owns — so the merged result is
independent of *where* and *in what order* the per-shard work runs.
Three backends implement it:

``SerialBackend``
    One Python object per shard, walked in-line.  The reference
    execution; zero concurrency, zero overhead.

``ThreadBackend``
    A thread pool: one ``ThreadPoolExecutor`` task per shard per
    query.  Python-level walk steps hold the GIL, so
    threads mostly interleave; the numpy word ops overlap.  Walk
    submission is asynchronous (``submit_walk_many`` returns a
    :class:`WalkHandle`), which is what the routing pipeline's wave
    overlap rides on.  Mutations drain in-flight walks first so a
    speculative walk never observes a torn tree.

``ProcessBackend``
    One **worker process per shard** (``multiprocessing`` spawn
    context — fork would duplicate the parent's CUDA and thread state).  Each worker
    owns a complete flat index whose ``(capacity, ceil(n/64))`` uint64
    bitset matrix lives in a ``multiprocessing.shared_memory`` segment
    (:class:`_ShmPrefixIndex`); walks escape the GIL entirely and run
    in true parallel.  Mutations are fire-and-forget messages routed to
    the owning worker's pipe; per-worker FIFO ordering makes a walk
    submitted before a mutation observe exactly the pre-mutation tree —
    the same snapshot semantics the in-process backends give.  Query
    output crosses back through a persistent shared-memory scratch each
    worker writes its column slice into (the column-slice merge,
    verbatim); the segment is reused across walks and grown on demand,
    so the walk hot path pays no per-call segment create/attach.

Self-healing
------------
When a **chains provider** is attached (``set_chains_provider`` — the
indicator factory wires its per-shard ``RadixKVIndex.chains()`` truth),
the process backend *supervises* its workers instead of fail-stopping:
a worker that dies (EOF) or goes stuck (walk deadline exceeded) is
restarted with capped exponential backoff, only that shard's index is
rebuilt from canonical truth (``reload``), and the in-flight walk is
re-sent to the healed shard; after ``max_restarts`` failed restarts the
shard **escalates** to a serial in-parent fallback index so one broken
shard can never kill the cluster.  Without a provider the legacy
fail-stop behaviour is preserved exactly: any worker error, timeout, or
EOF tears the whole backend down (segments unlinked) before raising.
A worker that *answers* with ``("err", …)`` also keeps the legacy
teardown — that is an application error, not a liveness failure.

Every backend takes ``timeout_s`` (falling back to
``REPRO_SHARD_TIMEOUT_S``, then a low pytest default) and derives a
scale-aware ``walk_deadline`` from its per-shard instance width.  Seeded
fault injection (``repro_torch.core.faults``) hooks every backend's
walk/mutation paths behind ``if self._faults is not None`` — zero work
when absent.

Shared-memory lifetime: every segment — per-shard mask matrices, the
per-backend fixed-slot metrics block, the walk output scratch — is
closed AND unlinked by the owner on ``close()`` and on the error paths
(worker exception, parent timeout, mid-query failure, supervised
restart).  Every segment of one process backend is named with its
``shm_prefix``, so the parent can unlink a killed worker's segments
(whatever it grew them to) and a leak check can look at its own
segments only.

Worker protocol (one duplex pipe per shard)::

    ("add", li, blocks)              no ack   — routed mutation
    ("remove_leaf", li, path)        no ack
    ("remove_instance", li)          no ack
    ("walk", name, n, blocks)        ("ok",)  — match_depths slice
    ("walk_many", name, shape,
     chains, order, adj)             ("ok",)  — match_depths_many slice
    ("nodes",)                       ("ok", n_nodes)
    ("digest",)                      ("ok", digest, rescan_digest)
    ("reload", pairs)                ("ok",)  — reset + replay truth
    ("ping",)                        ("ok",)
    ("stall", seconds)               no ack   — injected stall
    ("corrupt", seed)                no ack   — injected bit flip
    ("die",)                         —        — injected crash (exits)
    ("boom",)                        ("err", …) — test hook (mid-query
                                     failure injection)
    ("close",)                       ("bye",)  — unlink masks and exit

Worker exceptions answer ``("err", repr)`` (the parent raises and tears
the backend down); every parent receive polls with the walk deadline so
a hung worker heals — or, unsupervised, raises — instead of
deadlocking the router.
"""
from __future__ import annotations

import os
import secrets
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .faults import FaultInjector, ShardError
from .prefix_index import AggregatedPrefixIndex, _WORD, shard_bounds

#: columns of a shard's row in the fixed-slot metrics block (a process
#: worker cannot grow a dict across shared memory, so the set is closed
#: at spawn time); 0/1 are the walk telemetry pair every backend keeps
WORKER_SLOTS = ("walk_ns", "walks", "walk_batches", "mutations", "errors")
N_WORKER_SLOTS = len(WORKER_SLOTS)

#: default parent-side walk deadline base (seconds) outside pytest
DEFAULT_TIMEOUT_S = 60.0
#: low default under pytest so a wedged worker fails the test, not CI
PYTEST_TIMEOUT_S = 15.0


def resolve_timeout(timeout_s: Optional[float] = None) -> float:
    """Effective backend timeout: explicit argument, else the
    ``REPRO_SHARD_TIMEOUT_S`` environment override, else a low default
    when running under pytest, else :data:`DEFAULT_TIMEOUT_S`."""
    if timeout_s is not None:
        return float(timeout_s)
    env = os.environ.get("REPRO_SHARD_TIMEOUT_S")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if "PYTEST_CURRENT_TEST" in os.environ:
        return PYTEST_TIMEOUT_S
    return DEFAULT_TIMEOUT_S


class _WorkerDown(Exception):
    """Internal: shard ``s``'s worker is dead or stuck and the backend
    is supervised — callers heal instead of tearing down."""

    def __init__(self, shard: int, reason: str):
        super().__init__(reason)
        self.shard = shard
        self.reason = reason


class WalkHandle:
    """Completion token for a submitted fan-out walk.

    ``wait()`` blocks until every shard has written its column slice
    (propagating worker errors); calling it again is a no-op.  Serial
    walks return an already-complete handle.
    """

    __slots__ = ("_wait",)

    def __init__(self, wait=None):
        self._wait = wait

    def wait(self):
        if self._wait is not None:
            w, self._wait = self._wait, None
            w()


class ShardBackend:
    """Execution strategy for a set of prefix-index shards.

    Mutations take **local** instance ids (the owning shard ``s`` is
    resolved by the caller); walks fan out to every shard, each writing
    only the disjoint ``out`` column slice it owns.  ``async_walks``
    advertises whether ``submit_walk_many`` returns before the walk
    completes — the routing pipeline only speculates on backends where
    waiting can overlap useful host work.
    """

    name = "base"
    async_walks = False
    #: in-process backends expose their shard objects; process-backed
    #: shards live in worker address spaces and report None
    shards: Optional[List[AggregatedPrefixIndex]] = None

    def __init__(self, n_instances: int, n_shards: int,
                 capacity: int = 256, timeout_s: Optional[float] = None):
        self.n = n_instances
        self.n_shards = n_shards
        self.bounds = shard_bounds(n_instances, n_shards)
        self.capacity = capacity
        self.timeout_s = resolve_timeout(timeout_s)
        self._faults: Optional[FaultInjector] = None
        self._chains: Optional[Callable[[int], list]] = None
        #: recovery counters (all backends; the in-process ones only
        #: ever bump ``timeouts``)
        self.timeouts = 0
        self.heals = 0
        self.escalations = 0
        #: per-heal/repair wall cost (ns) for time-to-repair benches
        self.repair_ns: List[int] = []
        #: optional ``cb(kind, shard, info_dict)`` recovery-event hook
        #: (``IndicatorFactory.attach_backend_events``)
        self.on_event = None

    @property
    def walk_deadline(self) -> float:
        """Scale-aware receive deadline: the configured timeout,
        stretched linearly once per-shard width exceeds the 64k
        instances one worker is sized for."""
        per = max(self.n // max(self.n_shards, 1), 1)
        return self.timeout_s * max(1.0, per / 65536.0)

    # ---- self-healing hooks -------------------------------------------
    def attach_faults(self, injector: Optional[FaultInjector]):
        """Arm deterministic fault injection (None disarms)."""
        self._faults = injector

    def set_chains_provider(self, provider):
        """``provider(s) -> [(local_iid, chain), …]`` — the canonical
        KV truth for shard ``s``.  Arms supervised recovery on backends
        that support it; repairs rebuild only from this."""
        self._chains = provider

    @property
    def supervised(self) -> bool:
        return self._chains is not None

    def _emit(self, kind: str, shard: int, **info):
        cb = self.on_event
        if cb is not None:
            try:
                cb(kind, shard, info)
            except Exception:
                pass

    def _mut_faults(self, s: int) -> bool:
        """Apply due mutation faults for shard ``s``; True = drop the
        mutation.  Parent-side for every backend so semantics match."""
        drop = False
        for ev in self._faults.on_mutation(s):
            if ev.kind == "drop":
                drop = True
            elif ev.kind == "delay":
                time.sleep(ev.seconds)
        return drop

    # ---- mutation (local ids, owner resolved by the caller) -----------
    def mutate(self, s: int, op: str, *args):
        raise NotImplementedError

    # ---- queries ------------------------------------------------------
    def submit_walk(self, blocks: Sequence[int],
                    out: np.ndarray) -> WalkHandle:
        raise NotImplementedError

    def submit_walk_many(self, chains, order, adj,
                         out: np.ndarray) -> WalkHandle:
        raise NotImplementedError

    def n_nodes(self) -> int:
        raise NotImplementedError

    # ---- anti-entropy -------------------------------------------------
    def shard_digest(self, s: int):
        """``(incremental_digest, rescan_digest)`` triples for shard
        ``s`` (see ``AggregatedPrefixIndex.digest``)."""
        raise NotImplementedError

    def repair_shard(self, s: int, pairs):
        """Rebuild shard ``s`` — and only shard ``s`` — from the
        canonical ``(local_iid, chain)`` pairs."""
        raise NotImplementedError

    # ---- telemetry ----------------------------------------------------
    @property
    def shard_walk_ns(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def shard_walks(self) -> np.ndarray:
        raise NotImplementedError

    def worker_metrics(self) -> Optional[np.ndarray]:
        """The fixed-slot metrics block: an ``(n_shards,
        N_WORKER_SLOTS)`` int64 copy, one row per shard, columns named
        by :data:`WORKER_SLOTS`."""
        return None

    # ---- lifecycle ----------------------------------------------------
    def close(self):
        raise NotImplementedError

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _InProcessBackend(ShardBackend):
    """Shared machinery for the serial and thread backends: a list of
    in-process flat indexes plus numpy telemetry accumulators."""

    def __init__(self, n_instances, n_shards, capacity=256,
                 timeout_s=None):
        super().__init__(n_instances, n_shards, capacity,
                         timeout_s=timeout_s)
        self.shards = [AggregatedPrefixIndex(hi - lo, capacity=capacity)
                       for lo, hi in self.bounds]
        # fixed-slot metrics block (WORKER_SLOTS); the walk telemetry
        # pair is columns 0/1, as views
        self._slots = np.zeros((n_shards, N_WORKER_SLOTS),
                               dtype=np.int64)
        self._walk_ns = self._slots[:, 0]
        self._walks = self._slots[:, 1]

    @property
    def shard_walk_ns(self):
        return self._walk_ns

    @property
    def shard_walks(self):
        return self._walks

    def worker_metrics(self):
        return np.array(self._slots)

    def mutate(self, s, op, *args):
        if self._faults is not None and self._mut_faults(s):
            return
        getattr(self.shards[s], op)(*args)
        self._slots[s, 3] += 1               # mutations slot

    def n_nodes(self):
        return sum(sh.n_nodes for sh in self.shards)

    def _walk_faults(self, s):
        for ev in self._faults.on_walk(s):
            if ev.kind == "stall":
                time.sleep(ev.seconds)
            elif ev.kind == "corrupt":
                self.shards[s].corrupt_bit(ev.seed)
            elif ev.kind == "crash":
                self._slots[s, 4] += 1       # errors slot
                raise ShardError(
                    s, f"prefix-shard {s}: injected crash")

    def _walk_task(self, s, lo, hi, blocks, out):
        if self._faults is not None:
            self._walk_faults(s)
        t0 = time.perf_counter_ns()
        self.shards[s].match_depths(blocks, out=out[lo:hi])
        self._walk_ns[s] += time.perf_counter_ns() - t0
        self._walks[s] += 1
        self._slots[s, 2] += 1               # walk_batches slot

    def _walk_many_task(self, s, lo, hi, chains, order, adj, out):
        if self._faults is not None:
            self._walk_faults(s)
        t0 = time.perf_counter_ns()
        self.shards[s].match_depths_many(chains, order=order, adj=adj,
                                         out=out[:, lo:hi])
        self._walk_ns[s] += time.perf_counter_ns() - t0
        self._walks[s] += len(chains)
        self._slots[s, 2] += 1               # walk_batches slot

    # ---- anti-entropy -------------------------------------------------
    def _quiesce(self):
        pass

    def shard_digest(self, s):
        self._quiesce()
        idx = self.shards[s]
        return (idx.digest, idx.rescan_digest())

    def repair_shard(self, s, pairs):
        self._quiesce()
        lo, hi = self.bounds[s]
        t0 = time.perf_counter_ns()
        idx = AggregatedPrefixIndex(hi - lo, capacity=self.capacity)
        for li, chain in pairs:
            idx.add(li, chain)
        self.shards[s] = idx
        self.repair_ns.append(time.perf_counter_ns() - t0)
        self._emit("shard_repair", s)

    def close(self):
        pass


class SerialBackend(_InProcessBackend):
    """In-line fan-out — one shard after another on the calling thread.
    The reference execution every other backend must match bit-for-bit."""

    name = "serial"

    def submit_walk(self, blocks, out):
        for s, (lo, hi) in enumerate(self.bounds):
            self._walk_task(s, lo, hi, blocks, out)
        return WalkHandle()

    def submit_walk_many(self, chains, order, adj, out):
        for s, (lo, hi) in enumerate(self.bounds):
            self._walk_many_task(s, lo, hi, chains, order, adj, out)
        return WalkHandle()


class ThreadBackend(_InProcessBackend):
    """Thread-pool fan-out (``parallel=True`` maps here).

    Walk submission is asynchronous; ``mutate`` drains in-flight walks
    first so a speculative walk submitted by the routing pipeline never
    races the commit stage's tree mutations — the drain makes the walk
    complete *before* the mutation, which is exactly the snapshot the
    insert-capture patch assumes.
    """

    name = "thread"
    async_walks = True

    def __init__(self, n_instances, n_shards, capacity=256,
                 timeout_s=None):
        super().__init__(n_instances, n_shards, capacity,
                         timeout_s=timeout_s)
        self._pool = None
        self._inflight: List = []

    def _ensure_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self.n_shards,
                thread_name_prefix="prefix-shard")
        return self._pool

    def _result(self, s, f):
        """Bounded drain of one shard's walk future: a worker thread
        stuck past the walk deadline raises a :class:`ShardError`
        naming the shard and elapsed time instead of wedging the router
        forever — the factory repairs that one shard and retries."""
        from concurrent.futures import TimeoutError as _FutTimeout
        deadline = self.walk_deadline
        t0 = time.monotonic()
        try:
            return f.result(timeout=deadline)
        except _FutTimeout:
            self.timeouts += 1
            elapsed = time.monotonic() - t0
            self._emit("worker_timeout", s, elapsed_s=elapsed)
            raise ShardError(
                s, f"prefix-shard {s} walk stuck on thread backend "
                   f"(no result within {elapsed:.1f}s, walk deadline "
                   f"{deadline:.1f}s)") from None

    def _drain(self):
        if self._inflight:
            pending, self._inflight = self._inflight, []
            for s, f in pending:
                self._result(s, f)

    def mutate(self, s, op, *args):
        self._drain()
        super().mutate(s, op, *args)

    def _quiesce(self):
        try:
            self._drain()
        except ShardError:
            pass                 # the repair that follows supersedes it

    def _submit(self, tasks):
        pool = self._ensure_pool()
        futures = [(s, pool.submit(t)) for s, t in enumerate(tasks)]
        self._inflight.extend(futures)

        def wait():
            # drain every shard even when one errors: leaving a sibling
            # task running would race the caller's retry walk on the
            # shared out buffer
            err = None
            try:
                for s, f in futures:
                    try:
                        self._result(s, f)
                    except ShardError as e:
                        if err is None:
                            err = e
            finally:
                done = {f for _, f in futures}
                self._inflight = [p for p in self._inflight
                                  if p[1] not in done]
            if err is not None:
                raise err
        return WalkHandle(wait)

    def submit_walk(self, blocks, out):
        return self._submit([
            (lambda s=s, lo=lo, hi=hi:
             self._walk_task(s, lo, hi, blocks, out))
            for s, (lo, hi) in enumerate(self.bounds)])

    def submit_walk_many(self, chains, order, adj, out):
        return self._submit([
            (lambda s=s, lo=lo, hi=hi:
             self._walk_many_task(s, lo, hi, chains, order, adj, out))
            for s, (lo, hi) in enumerate(self.bounds)])

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        self._inflight = []


# ---------------------------------------------------------------------------
# process backend: shared-memory shards in spawn workers
# ---------------------------------------------------------------------------
class _ShmPrefixIndex(AggregatedPrefixIndex):
    """Flat index whose bitset matrix lives in a SharedMemory segment.

    The ``(capacity, ceil(n/64))`` uint64 layout is one contiguous
    array, so moving it into shared memory is a buffer swap — every
    mask op, scatter, and the walk hot path are unchanged.  ``_grow``
    allocates a doubled segment and unlinks the old one; ``close``
    detaches and unlinks (idempotent), and the worker calls it from a
    ``finally`` so segments never outlive the worker.  Segments are
    named ``{prefix}_{generation}``.
    """

    __slots__ = ("_shm", "_prefix", "_gen")

    def __init__(self, n_instances: int, capacity: int = 256,
                 prefix: str = "rps"):
        self._shm = None
        self._prefix = prefix
        self._gen = 0
        super().__init__(n_instances, capacity=capacity)
        self._move_masks()

    def _move_masks(self):
        from multiprocessing import shared_memory
        src, old = self._masks, self._shm
        shm = shared_memory.SharedMemory(
            name=f"{self._prefix}_{self._gen}", create=True,
            size=max(src.nbytes, 8))
        self._gen += 1
        arr = np.ndarray(src.shape, dtype=_WORD, buffer=shm.buf)
        arr[:] = src
        self._masks = arr
        self._shm = shm
        if old is not None:
            old.close()
            old.unlink()

    def _grow(self):
        super()._grow()          # plain numpy double-and-copy
        self._move_masks()       # …then back into a fresh segment

    @property
    def shm_name(self) -> str:
        return self._shm.name

    def close(self):
        shm, self._shm = self._shm, None
        if shm is None:
            return
        # detach the ndarray before closing or SharedMemory raises
        # BufferError on the exported buffer
        self._masks = np.zeros((1, self.words), dtype=_WORD)
        shm.close()
        shm.unlink()


def _shard_worker(conn, lo: int, hi: int, capacity: int,
                  telem_name: str, row: int, n_shards: int, prefix: str):
    """Spawn entry point: serve one shard's command loop.

    Owns a :class:`_ShmPrefixIndex` over the local instance range
    ``[lo, hi)`` (its mask segments named ``{prefix}_{generation}``)
    and attaches to the backend's fixed-slot metrics block, where its
    row is the worker's whole metrics record (:data:`WORKER_SLOTS`).
    The ``finally`` unlinks the mask segment on *every* exit path —
    clean close, EOF (parent died), or an escaping exception.
    """
    from multiprocessing import shared_memory
    idx = _ShmPrefixIndex(hi - lo, capacity=capacity, prefix=prefix)
    telem_shm = shared_memory.SharedMemory(name=telem_name)
    telem = np.ndarray((n_shards, N_WORKER_SLOTS), dtype=np.int64,
                       buffer=telem_shm.buf)
    # the parent reuses one persistent output scratch across walks
    # (grown on demand, new name); cache the attachment so the walk hot
    # path pays no per-call SharedMemory open
    scratch = {}

    def _attach(name):
        shm = scratch.get(name)
        if shm is None:
            for stale in list(scratch):     # grown → old segment is gone
                scratch.pop(stale).close()
            shm = shared_memory.SharedMemory(name=name)
            scratch[name] = shm
        return shm

    try:
        conn.send(("ready", idx.shm_name))
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                break
            cmd = msg[0]
            try:
                if cmd == "add":
                    idx.add(msg[1], msg[2])
                    telem[row, 3] += 1          # mutations slot
                elif cmd == "remove_leaf":
                    idx.remove_leaf(msg[1], msg[2])
                    telem[row, 3] += 1
                elif cmd == "remove_instance":
                    idx.remove_instance(msg[1])
                    telem[row, 3] += 1
                elif cmd == "walk":
                    _, name, n, blocks = msg
                    t0 = time.perf_counter_ns()
                    out = np.ndarray((n,), dtype=np.int64,
                                     buffer=_attach(name).buf)
                    idx.match_depths(blocks, out=out[lo:hi])
                    del out
                    telem[row, 0] += time.perf_counter_ns() - t0
                    telem[row, 1] += 1
                    telem[row, 2] += 1          # walk_batches slot
                    conn.send(("ok",))
                elif cmd == "walk_many":
                    _, name, shape, chains, order, adj = msg
                    t0 = time.perf_counter_ns()
                    out = np.ndarray(shape, dtype=np.int64,
                                     buffer=_attach(name).buf)
                    idx.match_depths_many(chains, order=order,
                                          adj=adj,
                                          out=out[:, lo:hi])
                    del out
                    telem[row, 0] += time.perf_counter_ns() - t0
                    telem[row, 1] += len(chains)
                    telem[row, 2] += 1          # walk_batches slot
                    conn.send(("ok",))
                elif cmd == "nodes":
                    conn.send(("ok", idx.n_nodes))
                elif cmd == "digest":
                    conn.send(("ok", idx.digest, idx.rescan_digest()))
                elif cmd == "reload":
                    idx.reset()
                    for li, chain in msg[1]:
                        idx.add(li, chain)
                    conn.send(("ok",))
                elif cmd == "ping":
                    conn.send(("ok",))
                elif cmd == "stall":
                    time.sleep(msg[1])          # injected stall, no ack
                elif cmd == "corrupt":
                    idx.corrupt_bit(msg[1])     # injected flip, no ack
                elif cmd == "die":
                    # injected crash: no goodbye, but never leak the
                    # mask segment (the parent backstop-unlinks too)
                    idx.close()
                    os._exit(1)
                elif cmd == "boom":
                    raise RuntimeError("injected shard-worker failure")
                elif cmd == "close":
                    conn.send(("bye",))
                    break
                else:
                    raise ValueError(f"unknown shard command {cmd!r}")
            except Exception as e:  # answer, let the parent decide
                telem[row, 4] += 1              # errors slot
                try:
                    conn.send(("err", repr(e)))
                except OSError:
                    break
    finally:
        idx.close()
        for shm in scratch.values():
            shm.close()
        del telem
        telem_shm.close()
        conn.close()


class ProcessBackend(ShardBackend):
    """One spawn worker per shard; masks in shared memory, walks in
    true process parallelism (no GIL on the walk's Python hot path).

    Mutations are fire-and-forget pipe messages to the owning worker;
    per-worker FIFO ordering sequences them against walks exactly like
    serial execution.  Walk output crosses back through a persistent
    SharedMemory scratch (each worker writes its column slice — the
    deterministic merge; one walk in flight at a time); per-shard
    metrics accumulate in an ``(S, N_WORKER_SLOTS)`` int64 shared
    fixed-slot block (:data:`WORKER_SLOTS`) the parent reads without a
    round trip.  ``spawn_s`` is the wall time the constructor took to
    start every worker and receive its ready message.

    With a chains provider attached the backend is **supervised**: a
    dead or stuck worker is healed in place (restart + per-shard reload
    from truth + walk retry, escalating to an in-parent fallback index
    after ``max_restarts``).  Without one — or when a worker answers
    ``("err", …)`` — the legacy fail-stop teardown applies: segments
    unlinked, workers joined or terminated, then raise.
    """

    name = "process"
    async_walks = True
    #: failed restarts per shard before escalating to in-parent serial
    max_restarts = 3
    #: capped exponential backoff between restarts (seconds)
    backoff_base = 0.05
    backoff_cap = 1.0

    def __init__(self, n_instances, n_shards, capacity=256,
                 timeout_s=None):
        super().__init__(n_instances, n_shards, capacity,
                         timeout_s=timeout_s)
        import multiprocessing as mp
        from multiprocessing import shared_memory
        t0 = time.perf_counter()
        self._closed = False
        self._conns: List = []
        self._procs: List = []
        self._mask_names: List[str] = []
        #: every segment of this backend is named ``{shm_prefix}_...``
        self.shm_prefix = f"rps{os.getpid():x}_{secrets.token_hex(4)}"
        # persistent walk-output scratch, grown on demand; one walk in
        # flight at a time (submitters drain the previous one first)
        self._out_shm = None
        self._out_cap = 0
        self._out_gen = 0
        self._pending: Optional[WalkHandle] = None
        # shards healed while a walk was in flight: the old incarnation
        # took the walk message to its grave, so collect must re-send
        # instead of waiting out the deadline on the fresh worker
        self._lost: set = set()
        # supervision state: per-shard restart counts and the escalated
        # in-parent fallback indexes
        self._restarts = [0] * n_shards
        self._fallback: Dict[int, AggregatedPrefixIndex] = {}
        # spawn: never fork a process that may hold CUDA or thread state
        self._ctx = mp.get_context("spawn")
        self._telem_shm = shared_memory.SharedMemory(
            name=f"{self.shm_prefix}_t", create=True,
            size=n_shards * N_WORKER_SLOTS * 8)
        self._telem = np.ndarray((n_shards, N_WORKER_SLOTS),
                                 dtype=np.int64,
                                 buffer=self._telem_shm.buf)
        self._telem[:] = 0
        try:
            for s in range(n_shards):
                parent, p = self._spawn(s)
                self._conns.append(parent)
                self._procs.append(p)
            for s, conn in enumerate(self._conns):
                msg = self._recv(conn, s, heal=False,
                                 deadline=self.spawn_deadline)
                self._mask_names.append(msg[1])
        except BaseException:
            self.close()
            raise
        self.spawn_s = time.perf_counter() - t0

    @property
    def spawn_deadline(self) -> float:
        """Ready-handshake deadline for a (re)spawned worker: spawn
        cost (interpreter boot + imports) is independent of the walk
        deadline, so a tight walk deadline must not make every restart
        look dead on arrival."""
        return max(self.walk_deadline, PYTEST_TIMEOUT_S)

    def _spawn(self, s):
        lo, hi = self.bounds[s]
        parent, child = self._ctx.Pipe()
        p = self._ctx.Process(
            target=_shard_worker,
            args=(child, lo, hi, self.capacity,
                  self._telem_shm.name, s, self.n_shards,
                  f"{self.shm_prefix}_m{s}_{self._restarts[s]}"),
            daemon=True, name=f"prefix-shard-{s}")
        p.start()
        child.close()
        return parent, p

    # ---- plumbing -----------------------------------------------------
    def _recv(self, conn, s, heal=True, deadline=None):
        """Receive one message from shard ``s``'s worker.  A timeout or
        EOF raises :class:`_WorkerDown` on a supervised backend (the
        caller heals) and tears the backend down otherwise; an ``err``
        answer always tears down (legacy fail-stop for application
        errors)."""
        if deadline is None:
            deadline = self.walk_deadline
        t0 = time.monotonic()
        if not conn.poll(deadline):
            self.timeouts += 1
            elapsed = time.monotonic() - t0
            self._emit("worker_timeout", s, elapsed_s=elapsed)
            reason = (f"prefix-shard {s} worker stuck (no answer "
                      f"within {elapsed:.1f}s, walk deadline "
                      f"{deadline:.1f}s)")
            if heal and self.supervised:
                raise _WorkerDown(s, reason)
            self.close()
            raise RuntimeError(reason)
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            if heal and self.supervised:
                raise _WorkerDown(s, f"prefix-shard {s} worker died")
            self.close()
            raise RuntimeError(f"prefix-shard {s} worker died")
        if msg[0] == "err":
            self.close()
            raise RuntimeError(
                f"prefix-shard {s} worker failed: {msg[1]}")
        return msg

    def _send(self, s, msg):
        try:
            self._conns[s].send(msg)
        except (OSError, ValueError):
            if self.supervised and not self._closed:
                raise _WorkerDown(
                    s, f"prefix-shard {s} worker pipe is closed")
            self.close()
            raise RuntimeError(
                f"prefix-shard {s} worker pipe is closed")

    # ---- supervision --------------------------------------------------
    def _unlink_mask(self, s):
        """Backstop: unlink shard ``s``'s mask segments, every size and
        incarnation of them (a killed worker never ran its finally)."""
        known = self._mask_names[s:s + 1]
        _unlink_segments(f"{self.shm_prefix}_m{s}_", known)

    def _build_local(self, s, pairs):
        lo, hi = self.bounds[s]
        idx = AggregatedPrefixIndex(hi - lo, capacity=self.capacity)
        for li, chain in pairs:
            idx.add(li, chain)
        return idx

    def _truth(self, s):
        return self._chains(s) if self._chains is not None else []

    def _heal(self, s, reason):
        """Supervised recovery for shard ``s``: reap the worker,
        backstop-unlink its mask segment, then restart (backoff) and
        reload from canonical truth — or escalate to an in-parent
        fallback once the restart budget is spent.  Only shard ``s`` is
        touched; the other workers keep their state."""
        if self._closed or s in self._fallback:
            return
        if self._pending is not None:
            # the in-flight walk died with the old incarnation — flag
            # it so collect re-sends instead of waiting out the deadline
            self._lost.add(s)
        conn, proc = self._conns[s], self._procs[s]
        try:
            conn.close()
        except OSError:
            pass
        if proc.is_alive():
            proc.terminate()
        proc.join(timeout=5.0)
        self._unlink_mask(s)
        self._restarts[s] += 1
        self.heals += 1
        pairs = self._truth(s)
        t0 = time.perf_counter_ns()
        if self._restarts[s] > self.max_restarts:
            self._fallback[s] = self._build_local(s, pairs)
            self.escalations += 1
            self.repair_ns.append(time.perf_counter_ns() - t0)
            self._emit("shard_escalated", s,
                       restarts=self._restarts[s], reason=reason)
            return
        time.sleep(min(self.backoff_base * (2 ** (self._restarts[s] - 1)),
                       self.backoff_cap))
        parent, p = self._spawn(s)
        self._conns[s], self._procs[s] = parent, p
        try:
            if not parent.poll(self.spawn_deadline):
                raise EOFError
            self._mask_names[s] = parent.recv()[1]
            parent.send(("reload", pairs))
            if not parent.poll(self.spawn_deadline):
                raise EOFError
            if parent.recv()[0] != "ok":
                raise EOFError
        except (EOFError, OSError):
            # the replacement failed too — burn another restart (and
            # eventually escalate) rather than tearing the cluster down
            self._heal(s, f"{reason}; restart failed")
            return
        self.repair_ns.append(time.perf_counter_ns() - t0)
        self._emit("worker_restart", s, restarts=self._restarts[s],
                   reason=reason)

    def _request(self, s, msg):
        """Round-trip ``msg`` to shard ``s`` with supervised retry;
        returns the answer, or None once the shard has escalated (the
        caller serves from the fallback index)."""
        while s not in self._fallback:
            try:
                self._send(s, msg)
                return self._recv(self._conns[s], s)
            except _WorkerDown as wd:
                self._heal(s, wd.reason)
        return None

    # ---- fault injection ----------------------------------------------
    def _walk_faults(self, s):
        fb = self._fallback.get(s)
        for ev in self._faults.on_walk(s):
            if ev.kind == "stall":
                if fb is not None:
                    time.sleep(ev.seconds)
                else:
                    self._send(s, ("stall", ev.seconds))
            elif ev.kind == "corrupt":
                if fb is not None:
                    fb.corrupt_bit(ev.seed)
                else:
                    self._send(s, ("corrupt", ev.seed))
            elif ev.kind == "crash":
                if fb is not None:
                    self._fallback[s] = self._build_local(
                        s, self._truth(s))
                else:
                    self._send(s, ("die",))

    # ---- mutation -----------------------------------------------------
    def mutate(self, s, op, *args):
        if self._faults is not None and self._mut_faults(s):
            return
        fb = self._fallback.get(s)
        if fb is not None:
            getattr(fb, op)(*args)
            self._telem[s, 3] += 1
            return
        try:
            self._send(s, (op,) + args)
        except _WorkerDown as wd:
            # the mutation already landed in the owning RadixKVIndex
            # (callbacks fire after the tree mutation), so the heal's
            # reload-from-truth includes it — nothing to replay
            self._heal(s, wd.reason)

    # ---- queries ------------------------------------------------------
    def _drain_pending(self):
        """Only one walk may be in flight: its per-worker acks would
        otherwise interleave with the next command's answers, and the
        shared output scratch is a single buffer."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.wait()
        self._lost.clear()   # stale flags from a discarded wave

    def _scratch(self, shape):
        """The persistent output segment, grown (fresh name — workers
        re-attach lazily) when the wave outgrows it."""
        from multiprocessing import shared_memory
        size = 8
        for d in shape:
            size *= d
        if self._out_shm is None or size > self._out_cap:
            self._drop_scratch()
            cap = 1 << (max(size, 4096) - 1).bit_length()
            self._out_shm = shared_memory.SharedMemory(
                name=f"{self.shm_prefix}_o{self._out_gen}", create=True,
                size=cap)
            self._out_gen += 1
            self._out_cap = cap
        return self._out_shm

    def _drop_scratch(self):
        shm, self._out_shm = self._out_shm, None
        self._out_cap = 0
        if shm is not None:
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                pass

    def _collect(self, shm, shape, out, resend, local):
        """Build the walk handle: drain every live worker's ack (healing
        and re-sending on supervised failures), copy the scratch into
        ``out``, then run escalated shards' walks in-parent over their
        fallback indexes (they write the same disjoint slices)."""
        def wait():
            for s in range(self.n_shards):
                # a heal mid-wave (e.g. on the mutation path) lost the
                # in-flight walk with the old worker — re-send first
                # instead of waiting out the deadline for an answer
                # that can never come
                lost = s in self._lost
                self._lost.discard(s)
                while s not in self._fallback:
                    try:
                        if lost:
                            lost = False
                            resend(s)
                        self._recv(self._conns[s], s)
                        break
                    except _WorkerDown as wd:
                        self._heal(s, wd.reason)
                        lost = True
                self._lost.discard(s)
            buf = np.ndarray(shape, dtype=np.int64, buffer=shm.buf)
            np.copyto(out, buf)
            del buf
            for s in sorted(self._fallback):
                local(s)
        handle = WalkHandle(wait)
        self._pending = handle
        return handle

    def _fanout(self, s, msg):
        """Send one shard its walk message, applying due walk faults
        first and healing a broken pipe in place."""
        try:
            if self._faults is not None:
                self._walk_faults(s)
            if s not in self._fallback:
                self._send(s, msg)
        except _WorkerDown as wd:
            self._heal(s, wd.reason)
            if s not in self._fallback:
                try:
                    self._send(s, msg)
                except _WorkerDown as wd2:
                    self._heal(s, wd2.reason)

    def submit_walk(self, blocks, out):
        self._drain_pending()
        shm = self._scratch((self.n,))
        msg = ("walk", shm.name, self.n, blocks)
        for s in range(self.n_shards):
            self._fanout(s, msg)

        def local(s):
            lo, hi = self.bounds[s]
            t0 = time.perf_counter_ns()
            self._fallback[s].match_depths(blocks, out=out[lo:hi])
            self._telem[s, 0] += time.perf_counter_ns() - t0
            self._telem[s, 1] += 1
            self._telem[s, 2] += 1
        return self._collect(shm, (self.n,), out,
                             lambda s: self._send(s, msg), local)

    def submit_walk_many(self, chains, order, adj, out):
        self._drain_pending()
        shape = out.shape
        shm = self._scratch(shape)
        msg = ("walk_many", shm.name, shape, tuple(chains),
               list(order), np.asarray(adj))
        for s in range(self.n_shards):
            self._fanout(s, msg)

        def local(s):
            lo, hi = self.bounds[s]
            t0 = time.perf_counter_ns()
            self._fallback[s].match_depths_many(
                msg[3], order=msg[4], adj=msg[5], out=out[:, lo:hi])
            self._telem[s, 0] += time.perf_counter_ns() - t0
            self._telem[s, 1] += len(chains)
            self._telem[s, 2] += 1
        return self._collect(shm, shape, out,
                             lambda s: self._send(s, msg), local)

    def n_nodes(self):
        self._drain_pending()
        total = 0
        for s in range(self.n_shards):
            ans = self._request(s, ("nodes",))
            total += (ans[1] if ans is not None
                      else self._fallback[s].n_nodes)
        return total

    # ---- anti-entropy -------------------------------------------------
    def shard_digest(self, s):
        self._drain_pending()
        fb = self._fallback.get(s)
        if fb is None:
            ans = self._request(s, ("digest",))
            if ans is not None:
                return (tuple(ans[1]), tuple(ans[2]))
            fb = self._fallback[s]
        return (fb.digest, fb.rescan_digest())

    def repair_shard(self, s, pairs):
        self._drain_pending()
        t0 = time.perf_counter_ns()
        if s in self._fallback:
            self._fallback[s] = self._build_local(s, pairs)
        elif self._request(s, ("reload", list(pairs))) is None:
            self._fallback[s] = self._build_local(s, pairs)
        self.repair_ns.append(time.perf_counter_ns() - t0)
        self._emit("shard_repair", s)

    # ---- telemetry ----------------------------------------------------
    @property
    def shard_walk_ns(self):
        return np.asarray(self._telem[:, 0])

    @property
    def shard_walks(self):
        return np.asarray(self._telem[:, 1])

    def worker_metrics(self):
        return np.array(self._telem)

    # ---- test hook ----------------------------------------------------
    def inject_failure(self, s: int = 0):
        """Make shard ``s``'s worker answer the next receive with an
        error — the mid-query failure path the cleanup tests pin."""
        self._send(s, ("boom",))

    # ---- lifecycle ----------------------------------------------------
    def close(self):
        if getattr(self, "_closed", True):
            return
        self._closed = True
        self._pending = None
        self._fallback = {}
        self._drop_scratch()
        for conn in self._conns:
            try:
                conn.send(("close",))
            except (OSError, ValueError):
                pass
            # drain stale acks until the goodbye (or give up quickly)
            try:
                deadline = time.monotonic() + 5.0
                while conn.poll(max(deadline - time.monotonic(), 0)):
                    if conn.recv()[0] == "bye":
                        break
            except (EOFError, OSError):
                pass
            try:
                conn.close()
            except OSError:
                pass
        for p in self._procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        # freeze telemetry into a plain array, then drop the segment
        final = np.array(self._telem)
        self._telem = final
        self._telem_shm.close()
        try:
            self._telem_shm.unlink()
        except FileNotFoundError:
            pass
        # backstop: a worker whose finally never ran (terminated, or
        # killed earlier) leaves masks behind — unlink every segment of
        # this backend that is still there
        _unlink_segments(self.shm_prefix, self._mask_names)


def own_segments(prefix: str) -> List[str]:
    """Names of the live shared-memory segments that start with
    ``prefix`` (Linux ``/dev/shm``; empty where it cannot be listed)."""
    try:
        return sorted(n for n in os.listdir("/dev/shm")
                      if n.startswith(prefix))
    except FileNotFoundError:
        return []


def _unlink_segments(prefix: str, known: Sequence[str] = ()):
    """Unlink every segment named ``prefix*`` (and the ``known`` names,
    where ``/dev/shm`` cannot be listed)."""
    from multiprocessing import shared_memory
    for name in set(own_segments(prefix)) | set(known):
        try:
            seg = shared_memory.SharedMemory(name=name)
        except FileNotFoundError:
            continue
        seg.close()
        try:
            seg.unlink()
        except FileNotFoundError:
            pass


_BACKENDS = {"serial": SerialBackend, "thread": ThreadBackend,
             "process": ProcessBackend}


def make_backend(name: str, n_instances: int, n_shards: int,
                 capacity: int = 256,
                 timeout_s: Optional[float] = None) -> ShardBackend:
    """Build a backend by name (``serial`` / ``thread`` / ``process``)."""
    try:
        cls = _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown shard backend {name!r}; expected one of "
            f"{sorted(_BACKENDS)}") from None
    return cls(n_instances, n_shards, capacity=capacity,
               timeout_s=timeout_s)
