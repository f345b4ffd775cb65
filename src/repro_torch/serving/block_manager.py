"""Paged KV-cache block manager — port of
``repro.serving.block_manager`` (pure Python, copied as it is).

vLLM-style block tables with refcounted prefix sharing: sequences own
lists of fixed-size KV pages; pages holding a shared prompt prefix are
reference-counted and shared between sequences (a KV$ hit costs zero new
pages and zero prefill compute for the shared span); decode pages are
private.  The produced (block_table, context_len) pairs are exactly the
inputs of ``repro_torch.kernels.paged_attention``.

Eviction: freed pages go to an LRU free pool but remain content-addressed
(``cached_blocks``) until reused, so recently-finished prefixes can be
resurrected without recompute.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple


class BlockError(RuntimeError):
    pass


class _Page:
    __slots__ = ("pid", "refs", "content_key", "filled")

    def __init__(self, pid: int):
        self.pid = pid
        self.refs = 0
        self.content_key: Optional[Tuple] = None   # (chain hash) when full
        self.filled = 0                            # tokens written


class BlockManager:
    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be >= 1")
        self.page_size = page_size
        self.pages = [_Page(i) for i in range(n_pages)]
        # free pool is LRU-ordered; free pages may still carry cached
        # content until reallocated
        self.free: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict((i, None) for i in range(n_pages))
        self.cached_blocks: Dict[Tuple, int] = {}     # content_key -> pid
        self.tables: Dict[int, List[int]] = {}        # seq id -> page ids
        self.lens: Dict[int, int] = {}                # seq id -> tokens

    # ------------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self.free)

    def _take_page(self) -> _Page:
        if not self.free:
            raise BlockError("out of KV pages")
        pid, _ = self.free.popitem(last=False)
        page = self.pages[pid]
        if page.content_key is not None:
            self.cached_blocks.pop(page.content_key, None)
            page.content_key = None
        page.filled = 0
        page.refs = 1
        return page

    def _ref(self, pid: int):
        page = self.pages[pid]
        if page.refs == 0:
            # resurrect a cached page out of the free pool
            self.free.pop(pid, None)
        page.refs += 1

    def _unref(self, pid: int):
        page = self.pages[pid]
        page.refs -= 1
        assert page.refs >= 0
        if page.refs == 0:
            self.free[pid] = None   # LRU tail; content stays addressable

    # ------------------------------------------------------------------
    def allocate(self, sid: int, prompt_chain: Sequence[Tuple]) -> int:
        """Allocate a sequence for a prompt given as a list of per-block
        content keys (chain-hashed, from ``radix.tokens_to_blocks``).
        Shares any cached prefix pages; returns the shared-token count
        (the KV$ hit — these pages need NO prefill compute)."""
        if sid in self.tables:
            raise BlockError(f"sequence {sid} already allocated")
        table: List[int] = []
        shared_tokens = 0
        sharing = True
        for key in prompt_chain:
            pid = self.cached_blocks.get(key) if sharing else None
            if pid is not None and self.pages[pid].content_key == key:
                self._ref(pid)
                table.append(pid)
                shared_tokens += self.page_size
            else:
                sharing = False
                page = self._take_page()
                page.filled = self.page_size
                page.content_key = key
                self.cached_blocks[key] = page.pid
                table.append(page.pid)
        self.tables[sid] = table
        self.lens[sid] = len(prompt_chain) * self.page_size
        return shared_tokens

    def append_token(self, sid: int):
        """Grow a sequence by one decode token, allocating a page at
        boundaries.  Decode pages are private (copy-on-write semantics:
        shared pages are never written past ``filled``)."""
        table = self.tables[sid]
        L = self.lens[sid]
        if L % self.page_size == 0:
            page = self._take_page()
            table.append(page.pid)
        else:
            page = self.pages[table[-1]]
            if page.refs > 1:
                # copy-on-write: fork the partially-filled tail page
                fork = self._take_page()
                fork.filled = page.filled
                self._unref(page.pid)
                table[-1] = fork.pid
                page = fork
        page.filled = L % self.page_size + 1
        self.lens[sid] = L + 1

    def free_seq(self, sid: int):
        for pid in self.tables.pop(sid):
            self._unref(pid)
        del self.lens[sid]

    # ------------------------------------------------------------------
    def block_table(self, sid: int, pad_to: Optional[int] = None):
        t = list(self.tables[sid])
        if pad_to is not None:
            assert len(t) <= pad_to
            t = t + [0] * (pad_to - len(t))
        return t

    def context_len(self, sid: int) -> int:
        return self.lens[sid]

    def stats(self) -> Dict[str, int]:
        used = sum(1 for p in self.pages if p.refs > 0)
        shared = sum(1 for p in self.pages if p.refs > 1)
        return {"pages": len(self.pages), "used": used, "free": self.n_free,
                "shared": shared, "cached": len(self.cached_blocks)}
