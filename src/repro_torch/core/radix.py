"""Block-granular prefix (radix) tree — the per-instance KV$ index
(port of ``repro.core.radix``; pure Python, no device code).

A prompt is a sequence of block ids, each standing for ``block_size``
tokens; ``tokens_to_blocks`` derives them from token arrays with a
rolling chain hash, so identical blocks under different prefixes get
distinct ids.  Eviction is LRU over leaf blocks under a token-capacity
budget.  ``exact_only`` gives recurrent-state semantics: a snapshot is
reusable only on an exact full-prefix boundary.

Coherence callbacks: ``on_insert(blocks)`` fires after every ``insert``,
``on_evict(path)`` after every leaf eviction (``path`` is the root→leaf
key chain) and ``on_clear()`` after ``clear``.  ``IndicatorFactory``
uses them to keep its aggregated cross-instance index in sync.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Optional, Sequence


def tokens_to_blocks(tokens: Sequence[int], block_size: int) -> List[int]:
    """Chain-hash full token blocks into block ids (engine-side helper)."""
    out = []
    h = 0
    for i in range(0, len(tokens) - block_size + 1, block_size):
        h = hash((h,) + tuple(tokens[i:i + block_size]))
        out.append(h)
    return out


class _Node:
    __slots__ = ("children", "parent", "key", "last_use", "terminal")

    def __init__(self, parent: Optional["_Node"], key):
        self.children: Dict[int, "_Node"] = {}
        self.parent = parent
        self.key = key
        self.last_use = 0
        self.terminal = False   # explicit snapshot point (exact_only mode)


class RadixKVIndex:
    def __init__(self, block_size: int = 64,
                 capacity_tokens: int = 1 << 62,
                 exact_only: bool = False):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = block_size
        self.capacity_tokens = capacity_tokens
        self.exact_only = exact_only
        self.root = _Node(None, None)
        self._clock = itertools.count(1)
        self._n_blocks = 0
        # coherence hooks (see module docstring); None = disabled
        self.on_insert = None
        self.on_evict = None
        self.on_clear = None

    # ------------------------------------------------------------------
    def match(self, blocks: Sequence[int], prompt_len: Optional[int] = None,
              touch: bool = True) -> int:
        """Cached-prefix length in TOKENS for a prompt given as block ids,
        capped at ``prompt_len`` when given."""
        node = self.root
        depth = 0
        term_depth = 0
        now = next(self._clock) if touch else 0
        for b in blocks:
            child = node.children.get(b)
            if child is None:
                break
            node = child
            depth += 1
            if node.terminal:
                term_depth = depth
            if touch:
                node.last_use = now
        if self.exact_only:
            # recurrent-state semantics: only resumable from an explicit
            # snapshot boundary (deepest terminal node on the path)
            depth = term_depth
        hit = depth * self.block_size
        if prompt_len is not None:
            hit = min(hit, prompt_len)
        return hit

    # ------------------------------------------------------------------
    def insert(self, blocks: Sequence[int]) -> int:
        """Insert prefix blocks; returns number of newly-added tokens."""
        node = self.root
        now = next(self._clock)
        added = 0
        for b in blocks:
            child = node.children.get(b)
            if child is None:
                child = _Node(node, b)
                node.children[b] = child
                self._n_blocks += 1
                added += 1
            child.last_use = now
            node = child
        if node is not self.root:
            node.terminal = True    # snapshot saved at this boundary
        if self.on_insert is not None and blocks:
            self.on_insert(blocks)
        if added and self.tokens_stored > self.capacity_tokens:
            self._evict_to_capacity()
        return added * self.block_size

    # ------------------------------------------------------------------
    def _evict_to_capacity(self):
        # collect leaves once, heapify by last_use, pop until under budget;
        # promote parents that become leaves.
        leaves = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root and not n.children:
                leaves.append((n.last_use, id(n), n))
            stack.extend(n.children.values())
        heapq.heapify(leaves)
        while self.tokens_stored > self.capacity_tokens and leaves:
            _, _, leaf = heapq.heappop(leaves)
            if leaf.children or leaf.parent is None:
                continue  # stale entry
            parent = leaf.parent
            if self.on_evict is not None:
                path, n = [], leaf
                while n.parent is not None:
                    path.append(n.key)
                    n = n.parent
                path.reverse()
                self.on_evict(path)
            del parent.children[leaf.key]
            leaf.parent = None
            self._n_blocks -= 1
            if parent is not self.root and not parent.children:
                heapq.heappush(leaves, (parent.last_use, id(parent), parent))

    # ------------------------------------------------------------------
    def chains(self):
        """Yield every root→leaf key path (the tree's maximal chains);
        inserting them all into an empty tree rebuilds the same node
        set."""
        stack = [(self.root, [])]
        while stack:
            node, path = stack.pop()
            if not node.children:
                if path:
                    yield path
                continue
            for key, child in node.children.items():
                stack.append((child, path + [key]))

    @property
    def tokens_stored(self) -> int:
        return self._n_blocks * self.block_size

    @property
    def n_blocks(self) -> int:
        return self._n_blocks

    def clear(self):
        self.root = _Node(None, None)
        self._n_blocks = 0
        if self.on_clear is not None:
            self.on_clear()
