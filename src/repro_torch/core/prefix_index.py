"""The flat cross-instance prefix index and its helpers — the numpy half
of ``repro.core.indicators``, kept free of ``torch``.

``AggregatedPrefixIndex`` (bitset rows, one walk gives every instance's
hit depth), the LCP helpers of the wave path (``_sorted_lcp``,
``_pairwise_lcp``), the instance-range partition the sharded index and
the device mirror share (``shard_bounds`` / ``shard_owner``) and the
anti-entropy digests live here, so that a process-backend shard worker
(``repro_torch.core.shard_backends``) imports numpy and nothing heavier.
``repro_torch.core.indicators`` re-exports every name.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_WORD_BITS = 64
#: bitset word dtype pinned to little-endian so the ``view(np.uint8)``
#: decode in the scatters is platform-independent (the frozen bigint
#: reference uses explicit little-endian ``int.to_bytes``); on LE hosts
#: this is bit-for-bit the native uint64
_WORD = np.dtype("<u8")


def shard_bounds(n_instances: int, n_shards: int) -> List[Tuple[int, int]]:
    """Contiguous instance-id ranges ``[lo, hi)``, one per shard, sizes
    within one of each other.  The single definition both the sharded
    prefix index and the factory's device-mirror partition use, so hit
    vectors and indicator slices always cut at the same boundaries."""
    return [((s * n_instances) // n_shards,
             ((s + 1) * n_instances) // n_shards)
            for s in range(n_shards)]


def shard_owner(n_instances: int, n_shards: int) -> np.ndarray:
    """``owner[i]`` = shard covering instance ``i`` under
    :func:`shard_bounds` — built here once so the sharded index's
    mutation routing and the factory's ``mark_dirty(iid)`` mirror
    partition can never disagree about ownership."""
    owner = np.empty(n_instances, dtype=np.int64)
    for s, (lo, hi) in enumerate(shard_bounds(n_instances, n_shards)):
        owner[lo:hi] = s
    return owner


# ---------------------------------------------------------------------------
# Anti-entropy digests.  A shard's content digest is the
# commutative sum (mod 2^64) of one mixed hash per *membership bit* —
# pair (node chain-hash, local instance id) — over every live non-root
# node, plus the live node count and total bit count.  Each node's
# chain-hash is a pure function of its root→node block-key path
# (splitmix64 chaining), so three independent computations of the same
# logical state agree exactly: the incremental accumulator maintained
# by add/remove, a rescan of the bitset rows, and a replay of the
# canonical ``RadixKVIndex.chains()`` truth (``digest_from_chains``).
# Commutativity makes the incremental update O(changed bits) per
# mutation — the same asymptotics as the mutation itself.

_M64 = (1 << 64) - 1
#: arbitrary odd constant seeding the root's chain-hash
_ROOT_H = 0x27220A95FE1EADB5
#: odd multiplier for the per-bit digest term — a single multiply over
#: two already-mixed inputs keeps mutation-path upkeep to a few int ops
#: per changed bit (detection only needs commutative sums not to cancel,
#: not a full finalizer)
_PHI = 0x9E3779B97F4A7C15


def _mix64(x: int) -> int:
    """splitmix64 finalizer over arbitrary Python ints (numpy scalars
    coerced — a bare ``int64 & _M64`` would overflow)."""
    x = int(x) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _chain_step(h: int, key: int) -> int:
    """One chain-hash round (root→node path hash): a single multiply +
    xorshift over the already-finalized parent hash — runs once per
    node *allocation* on the KV-insert path, so it must stay cheap.
    Kept in lockstep with the inlined copy in
    ``AggregatedPrefixIndex._alloc``."""
    x = ((h ^ key) * 0xBF58476D1CE4E5B9) & _M64
    return x ^ (x >> 31)


_IHASH_CACHE: Dict[int, int] = {}


def _ihash(iid: int) -> int:
    """Per-(local) instance-id hash, memoized — ids are small and dense
    so the cache stays bounded by the widest shard ever built."""
    h = _IHASH_CACHE.get(iid)
    if h is None:
        h = _mix64((iid + 1) * 0x9E3779B97F4A7C15)
        _IHASH_CACHE[iid] = h
    return h


def digest_from_chains(pairs) -> Tuple[int, int, int]:
    """Digest of the index a from-scratch rebuild over ``pairs`` —
    iterable of ``(local_iid, block_chain)`` from the per-instance
    ``RadixKVIndex.chains()`` truth — would produce.  Same triple as
    ``AggregatedPrefixIndex.digest``: (bit-sum, live nodes, total bits)."""
    acc, bits, nodes = 0, set(), set()
    for li, chain in pairs:
        h = _ROOT_H
        ih = _ihash(li)
        for b in chain:
            h = _chain_step(h, b)
            nodes.add(h)
            k = (h, li)
            if k not in bits:
                bits.add(k)
                acc = (acc + ((h ^ ih) * _PHI & _M64)) & _M64
    return (acc, len(nodes), len(bits))


class AggregatedPrefixIndex:
    """Flat, array-backed cross-instance prefix index.

    Nodes live in contiguous structure-of-arrays storage — a node is an
    integer row id, child lookup is one hash probe in the node's
    ``block_key -> child_row_id`` dict (``_kids[row]``, single-int
    hashing on the walk's hot path), and freed rows are recycled
    through a free list — so the index has no per-node Python objects
    and no arbitrary-precision mask arithmetic.

    Bitset layout
    -------------
    Per-node instance membership is one row of the ``(capacity,
    ceil(n/64))`` uint64 matrix ``_masks``: bit ``i`` of row ``nid``
    (little-endian within and across words) is set iff instance ``i``'s
    own radix tree contains the block chain ending at node ``nid``.
    Mask AND/ANDNOT and the ``match_depths`` scatter are vectorized
    numpy word ops, ``remove_instance`` is a single column clear.

    The walk-reuse invariant
    ------------------------
    Because every per-instance chain is prefix-closed, a child's mask is
    always a **subset** of its parent's (``add`` marks whole chains;
    ``remove_leaf`` only ever clears a node that is a leaf *for that
    instance*, so no descendant still carries the bit).  Two
    consequences the fast paths lean on:

    * the live instance set at depth ``d`` of a walk is exactly the
      mask of the node at depth ``d`` (no running intersection), and
      mask *narrowing* is detected by comparing cached popcounts — one
      scalar read per step instead of an O(n/64) word op;
    * a walk's state at depth ``d`` — (node id, live set) — is a pure
      function of the first ``d`` blocks, so ``match_depths_many`` can
      sort a wave's chains lexicographically and resume each walk from
      the shared-prefix frontier of its predecessor (frame stack +
      narrowing-segment stack), paying one deep walk per *lineage*
      instead of one per chain.

    Callers must therefore only mutate through the ``RadixKVIndex``
    callback protocol (or preserve prefix-closure themselves).
    """

    __slots__ = ("n", "words", "_full", "_masks", "_pop", "_parent",
                 "_live", "_key", "_kids", "_free", "_top",
                 "_chash", "_dig", "_bits", "_dig_on")

    def __init__(self, n_instances: int, capacity: int = 256):
        self.n = n_instances
        self.words = (n_instances + _WORD_BITS - 1) // _WORD_BITS
        full = np.zeros(self.words, dtype=_WORD)
        nfull, rem = divmod(n_instances, _WORD_BITS)
        full[:nfull] = np.uint64(0xFFFFFFFFFFFFFFFF)
        if rem:
            full[nfull] = np.uint64((1 << rem) - 1)
        self._full = full
        cap = max(int(capacity), 2)
        # masks are the one vectorized structure; the scalar per-node
        # metadata lives in plain Python lists — the walk reads one pop
        # per step, and a list index is ~3x cheaper than a numpy scalar
        # read on that hot path
        self._masks = np.zeros((cap, self.words), dtype=_WORD)
        self._pop: List[int] = [0] * cap
        self._parent: List[int] = [-1] * cap
        self._live: List[bool] = [False] * cap
        self._key: List = [None] * cap
        # per-node child dict (block key -> child row id), indexed by
        # row id — hash-addressed lookup with single-int hashing on the
        # walk's hot path; None marks a freed row
        self._kids: List[Optional[Dict[int, int]]] = [None] * cap
        self._free: List[int] = []
        # per-node chain-hash (pure function of the root→node key path)
        # plus the incremental anti-entropy accumulator: sum of
        # mixed (chain-hash, iid) pairs over every membership bit.
        # Both are LAZY — zero mutation-path upkeep until the first
        # digest read reconstructs them (``_enable_digest``), then
        # maintained incrementally
        self._chash: List[int] = [0] * cap
        self._chash[0] = _ROOT_H
        self._dig = 0
        self._bits = 0
        self._dig_on = False
        # row 0 is the root, pinned to the full instance set so the
        # popcount narrowing check works from the very first block
        self._top = 1
        self._masks[0] = full
        self._pop[0] = n_instances
        self._live[0] = True
        self._kids[0] = {}

    @property
    def n_nodes(self) -> int:
        """Live nodes, excluding the root."""
        return sum(self._live) - 1

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
        self._chash.extend([0] * cap)

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
        if self._dig_on:
            # inlined ``_chain_step`` (keep in lockstep) — on the
            # KV-insert path once per node allocation
            x = ((self._chash[parent] ^ key) * 0xBF58476D1CE4E5B9) & _M64
            self._chash[nid] = x ^ (x >> 31)
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
        # prefix of the path — binary-search the boundary instead of
        # reading every node's mask
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
            if self._dig_on:
                chash, ih = self._chash, _ihash(iid)
                dig = self._dig
                for nid in fresh:
                    pop[nid] += 1
                    dig += (chash[nid] ^ ih) * _PHI & _M64
                self._dig = dig & _M64
                self._bits += len(fresh)
            else:
                for nid in fresh:
                    pop[nid] += 1

    def remove_leaf(self, iid: int, path: Sequence[int]):
        """Instance ``iid`` evicted the leaf at ``path`` (root→leaf keys).

        Only the final node loses the bit — ancestors are still cached
        (radix eviction removes leaves only, so chains stay prefix-closed
        and the subset invariant holds).
        """
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
            if self._dig_on:
                self._dig = (self._dig - ((self._chash[node]
                                           ^ _ihash(iid))
                                          * _PHI & _M64)) & _M64
                self._bits -= 1
        # prune the freed tail: no instance holds it, nothing hangs off
        pop = self._pop
        while node and not pop[node] and not kids[node]:
            node = self._free_node(node)

    def remove_instance(self, iid: int):
        """Instance ``iid`` cleared its whole cache: one vectorized
        column clear over every live row, then a cascade prune of the
        rows the clear killed."""
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
        if self._dig_on:
            chash, ih, dig = self._chash, _ihash(iid), self._dig
            for nid in hits:
                pop[nid] -= 1
                dig -= (chash[nid] ^ ih) * _PHI & _M64
                if not pop[nid] and not kids[nid]:
                    stack.append(nid)
            self._dig = dig & _M64
            self._bits -= len(hits)
        else:
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

    # ---- anti-entropy ---------------------------------------------------
    def _enable_digest(self):
        """Deferred digest bring-up: chain hashes and the accumulator
        are reconstructed from the live tree on the first digest read,
        then maintained incrementally.  Mutations before that read pay
        zero digest upkeep — the Contract 5 discipline applied to
        anti-entropy: an index that is never verified must execute the
        exact pre-digest instruction sequence."""
        chash, kids = self._chash, self._kids
        stack = [0]
        while stack:
            nid = stack.pop()
            h = chash[nid]
            for key, child in kids[nid].items():
                x = ((h ^ key) * 0xBF58476D1CE4E5B9) & _M64
                chash[child] = x ^ (x >> 31)
                stack.append(child)
        self._dig_on = True
        dig, _, bits = self.rescan_digest()
        self._dig, self._bits = dig, bits

    @property
    def digest(self) -> Tuple[int, int, int]:
        """Incrementally-maintained content digest: ``(bit-sum mod 2^64,
        live non-root nodes, total membership bits)``.  Matches
        :meth:`rescan_digest` iff no mask word was corrupted *after the
        first digest read* (upkeep starts lazily — ``_enable_digest``),
        and :func:`digest_from_chains` over the KV truth iff no mutation
        was ever dropped or misapplied, before or after."""
        if not self._dig_on:
            self._enable_digest()
        return (self._dig, self.n_nodes, self._bits)

    def rescan_digest(self) -> Tuple[int, int, int]:
        """Recompute the digest triple from the live bitset rows (not
        the incremental accumulator) — a mismatch against ``digest``
        means a mask bit changed without going through add/remove."""
        if not self._dig_on:
            self._enable_digest()
        acc, bits, nodes = 0, 0, 0
        masks, chash = self._masks, self._chash
        for nid in range(1, self._top):
            if not self._live[nid]:
                continue
            nodes += 1
            row = masks[nid]
            if not row.any():
                continue
            idxs = np.flatnonzero(np.unpackbits(
                row.view(np.uint8), bitorder="little",
                count=self.n)).tolist()
            h = chash[nid]
            for i in idxs:
                acc += (h ^ _ihash(i)) * _PHI & _M64
            bits += len(idxs)
        return (acc & _M64, nodes, bits)

    def reset(self):
        """Drop every node (root stays pinned full) without reallocating
        the mask matrix — the in-place half of ``repair``: callers
        re-``add`` the canonical chains afterwards."""
        cap = self._masks.shape[0]
        self._masks[:] = 0
        self._pop = [0] * cap
        self._parent = [-1] * cap
        self._live = [False] * cap
        self._key = [None] * cap
        self._kids = [None] * cap
        self._free = []
        self._chash = [0] * cap
        self._chash[0] = _ROOT_H
        self._dig = 0
        self._bits = 0
        self._top = 1
        self._masks[0] = self._full
        self._pop[0] = self.n
        self._live[0] = True
        self._kids[0] = {}

    def corrupt_bit(self, seed: int) -> Optional[Tuple[int, int]]:
        """Fault-injection hook: deterministically flip one membership
        bit in a live non-root row *without* updating the pop cache or
        the digest accumulator — exactly the silent corruption the
        anti-entropy sweep exists to catch.  Returns ``(nid, iid)`` or
        None if the index is empty."""
        live = [nid for nid in range(1, self._top)
                if self._live[nid] and self._pop[nid]]
        if not live or not self.n:
            return None
        r = _mix64(seed ^ 0xB17F11B5)
        nid = live[r % len(live)]
        iid = (r >> 17) % self.n
        w = iid >> 6
        v = int(self._masks.item(nid, w)) ^ (1 << (iid & 63))
        self._masks[nid, w] = np.uint64(v)
        return (nid, iid)

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
        """``match_depths`` for a whole wave of chains at once, with
        LCP-chained walk reuse.

        Chains are walked in lexicographic order; each walk resumes from
        the shared-prefix frontier of its predecessor (frame stack of
        node ids plus the stack of narrowing segments emitted along the
        current path), so a wave of requests sharing long lineages pays
        one deep walk instead of k.  Pass precomputed ``(order, adj)``
        from :func:`_sorted_lcp` to share the sort with the pairwise-LCP
        matrix; segment scatters batch into one ``unpackbits`` exactly
        like the per-chain version.  ``out`` (shape ``(k, n)``, zeroed
        here) lets the sharded index scatter each shard's result
        straight into its column slice of the full-width matrix instead
        of allocating and copying a per-shard temporary.
        """
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
            # a handful of segments per chain: masked row assignment
            # (disjoint masks) beats ufunc.at and broadcast-multiply
            # reductions by ~10x
            for i, r in enumerate(rows):
                out[r][bits[i]] = seg_depths[i]
        return out


def _lcp_block(chains: Sequence[Sequence[int]], out: np.ndarray,
               idxs: Sequence[int], max_elems: int = 4_000_000):
    """Brute-force pairwise LCP of ``chains[idxs]`` scattered into
    ``out``: pad to (g, L), compare all pairs, count the leading run of
    equal positions, row-tiled to bound the (rows, g, L) temporary.

    O(g²·L): the differential reference of :func:`_pairwise_lcp`.
    """
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
    tuple-slice equality — O(lcp·log) pointer compares, no per-element
    Python arithmetic (chains carry ~2^60 block ids, so element-wise
    Python loops and numpy int conversion both cost more than slice
    compares)."""
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
    """Lexicographic sort order + adjacent-LCP array for a wave.

    ``order[t]`` indexes chains in sorted order; ``adj[t]`` is the LCP
    (in blocks) of sorted chains ``t-1`` and ``t`` (``adj[0] = 0``).
    Sorting makes each chain's LCP with its predecessor maximal over all
    earlier chains — the property both the walk reuse and the pairwise
    running-minimum reconstruction rely on.
    """
    u = len(chains)
    order = sorted(range(u), key=chains.__getitem__)
    adj = np.zeros(u, dtype=np.int64)
    for t in range(1, u):
        adj[t] = _lcp_pair(chains[order[t - 1]], chains[order[t]])
    return order, adj


def _pairwise_lcp(chains: Sequence[Sequence[int]],
                  order: Optional[Sequence[int]] = None,
                  adj: Optional[np.ndarray] = None) -> np.ndarray:
    """Pairwise longest-common-prefix (in blocks) of block-id chains.

    Reconstructed from the sorted adjacent-LCP array: for sorted chains,
    ``LCP(t, t') = min(adj[t+1..t'])``, so the matrix is u running-
    minimum sweeps (O(u²) total) instead of the old padded all-pairs
    compare (O(u²·L)).  Pass the ``(order, adj)`` pair from
    :func:`_sorted_lcp` to share the sort with ``match_depths_many``.
    """
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

