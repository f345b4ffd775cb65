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
``AggregatedPrefixIndex`` (one walk down a prompt yields every
instance's hit depth), the LCP helpers the wave path uses, and the
per-instance ``RadixKVIndex`` trees that own LRU clocks and eviction and
keep the aggregate coherent through their callbacks.  ``exact_only``
factories fall back to per-instance walks, which the aggregate cannot
model.

Device mirror & dirty-flag sync contract
----------------------------------------
``device_view()`` returns ``(r_bs, q_bs, queued_prefill_tokens,
total_tokens)`` as int64 torch tensors on ``factory.device``.  On a CUDA
device the four columns go up through one pinned ``(4, n)`` staging
buffer with a non-blocking copy on the current stream, and only when a
hook has marked the factory dirty since the last call; otherwise the
cached tensors are returned.  Every built-in mutation path stays an
in-place numpy write followed by ``mark_dirty``; code that writes the
arrays directly must call ``mark_dirty()`` itself.  Device code never
writes indicators back: decisions return to the host and are committed
through the same hooks, so the numpy arrays remain the single source of
truth.

``evictions`` counts per-instance KV$ leaf evictions and full clears.
The wave plan models intra-wave cache growth exactly but not a mid-wave
eviction; the router watches this counter and falls back to sequential
host routing the moment it moves.

Left out of this port so far: the sharded index and its shard backends,
fault injection and anti-entropy digests, heterogeneous-fleet columns
and the Preble routed-window rings.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .radix import RadixKVIndex
from .types import Request

_WORD_BITS = 64
#: bitset word dtype pinned to little-endian so the ``view(np.uint8)``
#: decode in the scatters is platform-independent
_WORD = np.dtype("<u8")


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


class AggregatedPrefixIndex:
    """Flat, array-backed cross-instance prefix index.

    A node is an integer row id; child lookup is one hash probe in the
    node's ``block_key -> child_row_id`` dict and freed rows are
    recycled through a free list.  Per-node instance membership is one
    row of the ``(capacity, ceil(n/64))`` uint64 matrix ``_masks``: bit
    ``i`` of row ``nid`` (little-endian within and across words) is set
    iff instance ``i``'s own radix tree holds the chain ending at
    ``nid``.

    The walk-reuse invariant: every per-instance chain is prefix-closed,
    so a child's mask is a subset of its parent's.  The live set at
    depth ``d`` of a walk is therefore the mask of the node at depth
    ``d``, narrowing shows as a change of the cached popcount, and a
    walk's state after ``d`` blocks depends only on those blocks — which
    lets ``match_depths_many`` walk a wave's chains in lexicographic
    order and resume each from its predecessor's shared-prefix frontier.
    Mutate only through the ``RadixKVIndex`` callback protocol.
    """

    __slots__ = ("n", "words", "_masks", "_pop", "_parent", "_live",
                 "_key", "_kids", "_free", "_top")

    def __init__(self, n_instances: int, capacity: int = 256):
        self.n = n_instances
        self.words = (n_instances + _WORD_BITS - 1) // _WORD_BITS
        full = np.zeros(self.words, dtype=_WORD)
        nfull, rem = divmod(n_instances, _WORD_BITS)
        full[:nfull] = np.uint64(0xFFFFFFFFFFFFFFFF)
        if rem:
            full[nfull] = np.uint64((1 << rem) - 1)
        cap = max(int(capacity), 2)
        # masks are the one vectorized structure; the scalar per-node
        # metadata lives in plain lists (a list index is cheaper than a
        # numpy scalar read on the walk's hot path)
        self._masks = np.zeros((cap, self.words), dtype=_WORD)
        self._pop: List[int] = [0] * cap
        self._parent: List[int] = [-1] * cap
        self._live: List[bool] = [False] * cap
        self._key: List = [None] * cap
        # per-node child dict (block key -> child row id); None = freed
        self._kids: List[Optional[Dict[int, int]]] = [None] * cap
        self._free: List[int] = []
        # row 0 is the root, pinned to the full instance set so the
        # popcount narrowing check works from the very first block
        self._top = 1
        self._masks[0] = full
        self._pop[0] = n_instances
        self._live[0] = True
        self._kids[0] = {}

    # ---- storage ------------------------------------------------------
    def _grow(self):
        cap = self._masks.shape[0]
        masks = np.zeros((2 * cap, self.words), dtype=_WORD)
        masks[:cap] = self._masks
        self._masks = masks
        self._pop.extend([0] * cap)
        self._parent.extend([-1] * cap)
        self._live.extend([False] * cap)
        self._key.extend([None] * cap)
        self._kids.extend([None] * cap)

    def _alloc(self, parent: int, key) -> int:
        if self._free:
            nid = self._free.pop()
        else:
            nid = self._top
            if nid == self._masks.shape[0]:
                self._grow()
            self._top += 1
        self._masks[nid] = 0
        self._pop[nid] = 0
        self._parent[nid] = parent
        self._live[nid] = True
        self._key[nid] = key
        self._kids[nid] = {}
        return nid

    def _free_node(self, nid: int) -> int:
        """Recycle a dead node; returns its parent id."""
        parent = self._parent[nid]
        del self._kids[parent][self._key[nid]]
        self._live[nid] = False
        self._parent[nid] = -1
        self._key[nid] = None
        self._kids[nid] = None
        self._free.append(nid)
        return parent

    # ---- mutation (RadixKVIndex callback protocol) --------------------
    def add(self, iid: int, blocks: Sequence[int]):
        """Mark the whole chain as present on instance ``iid``."""
        if not blocks:
            return
        kids = self._kids
        cur_kids = kids[0]
        node = 0
        path: List[int] = []
        append = path.append
        for b in blocks:
            child = cur_kids.get(b)
            if child is None:
                child = self._alloc(node, b)
                cur_kids[b] = child
            append(child)
            node = child
            cur_kids = kids[child]
        w = iid >> 6
        mbit = 1 << (iid & 63)
        mitem = self._masks.item       # bound after _alloc may have grown
        # subset invariant: the nodes already holding the bit form a
        # prefix of the path — binary-search the boundary
        lo, hi = 0, len(path)
        while lo < hi:
            mid = (lo + hi) // 2
            if mitem(path[mid], w) & mbit:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(path):
            fresh = path[lo:]
            ids = np.fromiter(fresh, np.int64, len(fresh))
            self._masks[ids, w] |= np.uint64(mbit)
            pop = self._pop
            for nid in fresh:
                pop[nid] += 1

    def remove_leaf(self, iid: int, path: Sequence[int]):
        """Instance ``iid`` evicted the leaf at ``path`` (root→leaf keys).
        Only the final node loses the bit (radix eviction removes leaves
        only, so chains stay prefix-closed)."""
        kids = self._kids
        node = 0
        for b in path:
            node = kids[node].get(b)
            if node is None:
                return
        w = iid >> 6
        mbit = 1 << (iid & 63)
        v = self._masks.item(node, w)
        if v & mbit:
            self._masks[node, w] = np.uint64(v & ~mbit)
            self._pop[node] -= 1
        # prune the freed tail: no instance holds it, nothing hangs off
        pop = self._pop
        while node and not pop[node] and not kids[node]:
            node = self._free_node(node)

    def remove_instance(self, iid: int):
        """Instance ``iid`` cleared its whole cache: one vectorized
        column clear over every live row, then a cascade prune."""
        w = iid >> 6
        bit = np.uint64(1 << (iid & 63))
        top = self._top
        col = self._masks[:top, w]
        pop, kids, live = self._pop, self._kids, self._live
        # row 0 (the pinned full root) is excluded; freed rows keep
        # stale masks until recycled, so filter by liveness
        hits = [nid for nid in np.flatnonzero((col & bit) != 0).tolist()
                if nid and live[nid]]
        if not hits:
            return
        col[np.fromiter(hits, np.int64, len(hits))] &= ~bit
        stack = []
        for nid in hits:
            pop[nid] -= 1
            if not pop[nid] and not kids[nid]:
                stack.append(nid)
        while stack:
            nid = stack.pop()
            if not live[nid] or pop[nid] or kids[nid]:
                continue
            parent = self._free_node(nid)
            if parent and not pop[parent] and not kids[parent]:
                stack.append(parent)

    # ---- queries ------------------------------------------------------
    def _scatter(self, words: np.ndarray, depth: int, out: np.ndarray):
        bits = np.unpackbits(words.view(np.uint8), bitorder="little",
                             count=self.n)
        out[bits.astype(bool)] = depth

    def match_depths(self, blocks: Sequence[int],
                     out: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-instance cached-prefix depth (in blocks) for ``blocks``."""
        if out is None:
            out = np.zeros(self.n, dtype=np.int64)
        else:
            out[:] = 0
        kids = self._kids
        pop = self._pop
        masks = self._masks
        node = 0
        cur_kids = kids[0]
        cur = self.n                 # popcount of the live set (= node's)
        d = 0
        segs: List[Tuple[np.ndarray, int]] = []
        alive = True
        for b in blocks:
            child = cur_kids.get(b)
            if child is None:
                break
            pc = pop[child]
            if pc != cur:            # subset invariant: strict narrowing
                if d:
                    segs.append((masks[node] & ~masks[child], d))
                if not pc:
                    alive = False
                    break
                cur = pc
            node = child
            cur_kids = kids[child]
            d += 1
        for words, dep in segs:
            self._scatter(words, dep, out)
        if alive and d:
            self._scatter(masks[node], d, out)
        return out

    def match_depths_many(self, chains: Sequence[Sequence[int]],
                          order: Optional[Sequence[int]] = None,
                          adj: Optional[np.ndarray] = None,
                          out: Optional[np.ndarray] = None) -> np.ndarray:
        """``match_depths`` for a whole wave of chains at once, walking
        them in lexicographic order and resuming each walk from the
        shared-prefix frontier of its predecessor.  Pass ``(order, adj)``
        from :func:`_sorted_lcp` to share the sort with the pairwise-LCP
        matrix."""
        k = len(chains)
        if out is None:
            out = np.zeros((k, self.n), dtype=np.int64)
        else:
            out[:] = 0
        if k == 0:
            return out
        if order is None:
            order, adj = _sorted_lcp(chains)
        kids = self._kids
        pop = self._pop
        masks = self._masks
        rows: List[int] = []
        seg_words: List[np.ndarray] = []
        seg_depths: List[int] = []
        nodes = [0]      # frame stack: nodes[d] = node after d blocks
        # (descend_depth, lost_words, matched_depth) along current path
        loss: List[Tuple[int, np.ndarray, int]] = []
        for t, r in enumerate(order):
            blocks = chains[r]
            p = int(adj[t]) if t else 0
            if p > len(nodes) - 1:
                p = len(nodes) - 1
            del nodes[p + 1:]
            while loss and loss[-1][0] > p:
                loss.pop()
            node = nodes[p]
            cur_kids = kids[node]
            cur = pop[node]
            d = p
            empty = False
            for b in blocks[d:]:
                child = cur_kids.get(b)
                if child is None:
                    break
                pc = pop[child]
                if pc != cur:
                    if d:
                        loss.append(
                            (d + 1, masks[node] & ~masks[child], d))
                    if not pc:
                        empty = True
                        break
                    cur = pc
                node = child
                cur_kids = kids[child]
                nodes.append(child)
                d += 1
            for _, words, md in loss:
                rows.append(r)
                seg_words.append(words)
                seg_depths.append(md)
            if not empty and d:
                rows.append(r)
                seg_words.append(masks[node])
                seg_depths.append(d)
        if rows:
            buf = np.empty((len(seg_words), self.words), dtype=_WORD)
            for i, wds in enumerate(seg_words):
                buf[i] = wds
            bits = np.unpackbits(buf.view(np.uint8), axis=1,
                                 bitorder="little",
                                 count=self.n).astype(bool)
            # a handful of disjoint segments per chain: masked row
            # assignment
            for i, r in enumerate(rows):
                out[r][bits[i]] = seg_depths[i]
        return out


def _lcp_block(chains: Sequence[Sequence[int]], out: np.ndarray,
               idxs: Sequence[int], max_elems: int = 4_000_000):
    """Brute-force pairwise LCP of ``chains[idxs]`` scattered into
    ``out``, row-tiled to bound the (rows, g, L) temporary.  O(g²·L):
    the differential reference of :func:`_pairwise_lcp`."""
    g = len(idxs)
    lens = np.fromiter((len(chains[i]) for i in idxs), np.int64, g)
    L = int(lens.max())
    B = np.zeros((g, L), dtype=np.int64)
    for row, i in enumerate(idxs):
        B[row, : len(chains[i])] = chains[i]
    has = np.arange(L)[None, :] < lens[:, None]
    idxs = np.asarray(idxs)
    step = max(1, max_elems // max(g * L, 1))
    for r0 in range(0, g, step):
        r1 = min(r0 + step, g)
        eq = (B[r0:r1, None, :] == B[None, :, :]) \
            & has[r0:r1, None, :] & has[None, :, :]
        out[np.ix_(idxs[r0:r1], idxs)] = np.cumprod(
            eq, axis=2, dtype=np.int8).sum(axis=2, dtype=np.int64)


def _lcp_pair(a: Sequence[int], b: Sequence[int]) -> int:
    """LCP of two chains by galloping + binary search over C-level
    tuple-slice equality (no per-element Python arithmetic)."""
    m = min(len(a), len(b))
    if m == 0 or a[0] != b[0]:
        return 0
    lo, k = 1, 2                        # a[:lo] == b[:lo] holds
    while k < m and a[:k] == b[:k]:
        lo, k = k, 2 * k
    if k >= m:
        if a[:m] == b[:m]:
            return m
        hi = m
    else:
        hi = k
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if a[:mid] == b[:mid]:
            lo = mid
        else:
            hi = mid
    return lo


def _sorted_lcp(chains: Sequence[Sequence[int]]
                ) -> Tuple[List[int], np.ndarray]:
    """Lexicographic sort order + adjacent-LCP array for a wave:
    ``order[t]`` indexes chains in sorted order, ``adj[t]`` is the LCP
    (in blocks) of sorted chains ``t-1`` and ``t`` (``adj[0] = 0``)."""
    u = len(chains)
    order = sorted(range(u), key=chains.__getitem__)
    adj = np.zeros(u, dtype=np.int64)
    for t in range(1, u):
        adj[t] = _lcp_pair(chains[order[t - 1]], chains[order[t]])
    return order, adj


def _pairwise_lcp(chains: Sequence[Sequence[int]],
                  order: Optional[Sequence[int]] = None,
                  adj: Optional[np.ndarray] = None) -> np.ndarray:
    """Pairwise longest-common-prefix (in blocks) of block-id chains,
    reconstructed from the sorted adjacent-LCP array: for sorted chains
    ``LCP(t, t') = min(adj[t+1..t'])`` — u running-minimum sweeps."""
    u = len(chains)
    if u == 0:
        return np.zeros((0, 0), dtype=np.int64)
    if order is None:
        order, adj = _sorted_lcp(chains)
    M = np.zeros((u, u), dtype=np.int64)
    for t in range(u - 1):
        M[t, t + 1:] = np.minimum.accumulate(adj[t + 1:])
    M += M.T
    lens = np.fromiter((len(chains[i]) for i in order), np.int64, u)
    np.fill_diagonal(M, lens)
    rank = np.empty(u, dtype=np.int64)
    rank[np.fromiter(order, np.int64, u)] = np.arange(u)
    return M[np.ix_(rank, rank)]


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


class _WaveHandle:
    """A wave's walk stage: the requests, their unique chains, the shared
    lexicographic sort and the per-unique-chain depth matrix."""

    __slots__ = ("reqs", "uid", "chains", "order", "adj", "depth_u",
                 "submit_ns")

    def __init__(self, reqs, uid, chains, order, adj, depth_u, submit_ns):
        self.reqs = reqs
        self.uid = uid
        self.chains = chains
        self.order = order
        self.adj = adj
        self.depth_u = depth_u
        self.submit_ns = submit_ns


class IndicatorFactory:
    def __init__(self, n_instances: int, kv_capacity_tokens: int = 1 << 62,
                 block_size: int = 64, exact_only: bool = False,
                 device="cuda"):
        self.n = n_instances
        self.block_size = block_size
        self.exact_only = exact_only
        self.device = resolve_device(device)
        # --- the array contract (see module docstring) -------------------
        self.r_bs = np.zeros(n_instances, dtype=np.int64)
        self.q_bs = np.zeros(n_instances, dtype=np.int64)
        self.queued_prefill_tokens = np.zeros(n_instances, dtype=np.int64)
        self.total_tokens = np.zeros(n_instances, dtype=np.int64)
        self._hit_depths = np.zeros(n_instances, dtype=np.int64)
        # device mirror: None = dirty (re-upload on the next device_view)
        self._dev = None
        self._staging = None          # pinned (4, n) upload buffer (cuda)
        self._staged = None           # event: last upload left _staging
        # mid-wave plan invalidation signal for Router.route_batch
        self.evictions = 0
        # host-walk telemetry: aggregated-index walk time / walk count
        # (per unique prompt), surfaced by Router.mean_walk_us
        self.walk_ns = 0
        self.walks = 0
        # exact_only hit semantics (deepest snapshot boundary) cannot be
        # read off chain membership alone -> scalar per-instance fallback
        self._agg = None if exact_only else AggregatedPrefixIndex(n_instances)
        self.instances = []
        for i in range(n_instances):
            kv = RadixKVIndex(block_size=block_size,
                              capacity_tokens=kv_capacity_tokens,
                              exact_only=exact_only)
            if self._agg is not None:
                kv.on_insert = (lambda blocks, _i=i:
                                self._agg.add(_i, blocks))
                kv.on_evict = (lambda path, _i=i: self._on_evict(_i, path))
                kv.on_clear = (lambda _i=i: self._on_clear(_i))
            self.instances.append(InstanceState(i, self, kv))

    def _on_evict(self, iid: int, path):
        self.evictions += 1
        self._agg.remove_leaf(iid, path)

    def _on_clear(self, iid: int):
        self.evictions += 1
        self._agg.remove_instance(iid)

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
            depths = self._agg.match_depths(req.blocks, out=self._hit_depths)
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
        prompt), from the ``walk_ns``/``walks`` telemetry."""
        return self.walk_ns / max(self.walks, 1) / 1e3

    # ---- device mirror (dirty-flag sync contract, see docstring) ---------
    def mark_dirty(self, iid: Optional[int] = None):
        """Invalidate the device mirror after an in-place indicator
        write.  ``iid`` names the touched instance; with one mirror
        partition every write dirties the whole mirror."""
        self._dev = None

    def device_view(self) -> Tuple[torch.Tensor, ...]:
        """(r_bs, q_bs, queued_prefill_tokens, total_tokens) as int64
        tensors on ``self.device``, re-uploaded only if a hook wrote
        since the last call.  Read-only by contract."""
        if self._dev is not None:
            return self._dev
        cols = (self.r_bs, self.q_bs, self.queued_prefill_tokens,
                self.total_tokens)
        if self.device.type == "cpu":
            mirror = torch.from_numpy(np.stack(cols))     # a copy
        else:
            if self._staging is None:
                self._staging = torch.empty((4, self.n), dtype=torch.int64,
                                            pin_memory=True)
                self._staged = torch.cuda.Event()
            else:
                # the previous non-blocking upload must have left the
                # staging buffer before it is overwritten
                self._staged.synchronize()
            np.stack(cols, out=self._staging.numpy())
            mirror = self._staging.to(self.device, non_blocking=True)
            self._staged.record()
        self._dev = tuple(mirror.unbind(0))
        return self._dev

    # ---- wave inputs (host half of the batch routing path) ---------------
    def wave_submit(self, reqs: Sequence[Request]) -> _WaveHandle:
        """Start the walk stage for an arrival wave: dedup to unique
        chains, compute the shared lexicographic sort, and run one
        LCP-chained aggregated-index walk per unique prompt.  Requires
        the aggregated index."""
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
        depth_u = self._agg.match_depths_many(chains, order=order, adj=adj)
        return _WaveHandle(tuple(reqs), uid, chains, order, adj, depth_u,
                           time.perf_counter_ns() - t0)

    def wave_collect(self, h: _WaveHandle, with_lcp: bool = True):
        """Finish a wave walk: account walk telemetry and derive the
        pairwise-LCP matrix from the shared sort."""
        self.walk_ns += h.submit_ns
        self.walks += len(h.chains)
        k = len(h.reqs)
        lcp = (_pairwise_lcp(h.chains, order=h.order, adj=h.adj)
               [np.ix_(h.uid, h.uid)] if with_lcp else None)
        plen = np.fromiter((r.prompt_len for r in h.reqs), np.int64, k)
        return h.depth_u[h.uid], lcp, plen

    def wave_inputs(self, reqs: Sequence[Request], with_lcp: bool = True):
        """(depth (k,n), lcp (k,k) | None, plen (k,)) for an arrival wave:
        one LCP-chained walk per unique prompt plus the pairwise
        block-chain LCP matrix the device loop needs to credit intra-wave
        inserts.  ``wave_submit`` + ``wave_collect`` in one breath."""
        return self.wave_collect(self.wave_submit(reqs), with_lcp=with_lcp)
