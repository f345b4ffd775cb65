"""Plain reference of the paper's router (LMetric, Fig. 17b) and of the
engines' bookkeeping that feeds it.

Router: a request goes to the instance where ``(P-token + 1) * (BS + 1)``
is least, ties within 1e-9 taken round-robin by one counter over all
decisions.

* KV$ hit on instance i: the longest run of whole ``block``-token blocks
  at the start of the prompt that some request routed to i earlier
  began with (the router indexes a prompt when it routes it; nothing is
  evicted, the index's capacity being unbounded), capped at the prompt.
* P-token: the instance's queued prefill tokens plus the request's
  prompt less its hit.  Routing adds the prompt less the hit; every
  prefill chunk the engine runs takes its tokens off, down to 0.
* BS: requests routed there and not finished (queued ones count from
  routing, running ones from their first token until they finish).

Engine (``EngineModel``), worked out from the arrivals and the serving
set-up alone: requests are served first come first served; while some
of the ``max_batch`` slots is free, a step prefills a chunk (at most
``chunk`` tokens) of the head of the queue, which takes a slot at its
first chunk and keeps it; while none is free (the head may hold the
last one, stalled part-way), the running requests decode, one token
each a step.  On taking a slot the head restores the longest stored
prompt whose whole blocks begin its own, leaving at least one token to
prefill; a prompt is stored once its prefill ends, in an LRU store of
``capacity`` prompts per instance.  A request has its first token when
its prefill ends and finishes at its output length (or at ``max_len``
rows).

``replay`` takes the program's event log in its order (which requests
came, and on which instance each engine step ran: the program's clocks
decide that interleaving), works out every step's kind, prefill tokens,
first tokens and finishes itself, feeds the router from its own
numbers, and makes every decision itself.  It returns the decisions and
the number of steps whose kind or counts the program reported otherwise;
the caller compares the decisions with the program's.  A block is keyed
by a digest of the whole token prefix it ends, independent of the
program's hashing.  Imports nothing of the program.
"""
from __future__ import annotations

import collections
import hashlib
from typing import Dict, Iterable, List, Tuple

import numpy as np

EPS = 1e-9


def prefix_keys(tokens: np.ndarray, block: int) -> List[bytes]:
    """One key per whole block: a digest chained over the blocks, so key
    j stands for tokens[: (j + 1) * block]."""
    keys, h = [], b""
    data = np.ascontiguousarray(tokens, dtype=np.int64)
    for j in range(len(data) // block):
        h = hashlib.blake2b(h + data[j * block:(j + 1) * block].tobytes(),
                            digest_size=16).digest()
        keys.append(h)
    return keys


class LMetricReference:
    def __init__(self, n: int, block: int):
        self.block = block
        self.index = [set() for _ in range(n)]
        self.queued_prefill = np.zeros(n, np.int64)
        self.q_bs = np.zeros(n, np.int64)
        self.r_bs = np.zeros(n, np.int64)
        self.ties = 0

    def route(self, tokens: np.ndarray, keys=None) -> int:
        keys = prefix_keys(tokens, self.block) if keys is None else keys
        plen = len(tokens)
        hits = np.zeros(len(self.index), np.int64)
        for i, idx in enumerate(self.index):
            d = 0
            while d < len(keys) and keys[d] in idx:
                d += 1
            hits[i] = min(d * self.block, plen)
        score = ((self.queued_prefill + (plen - hits)) + 1.0) \
            * ((self.r_bs + self.q_bs) + 1.0)
        ties = np.flatnonzero(score <= score.min() + EPS)
        iid = int(ties[self.ties % len(ties)])
        self.ties += 1
        self.q_bs[iid] += 1
        self.queued_prefill[iid] += plen - hits[iid]
        self.index[iid].update(keys)
        return iid

    def step(self, iid: int, prefill_tokens: int, first: int,
             finished: int):
        if prefill_tokens:
            self.queued_prefill[iid] = max(
                0, self.queued_prefill[iid] - prefill_tokens)
        for _ in range(first):
            if self.q_bs[iid] > 0:
                self.q_bs[iid] -= 1
            self.r_bs[iid] += 1
        for _ in range(finished):
            if self.r_bs[iid] > 0:
                self.r_bs[iid] -= 1


class _Req:
    __slots__ = ("keys", "plen", "out_len", "pos", "gen", "slot")

    def __init__(self, keys, plen, out_len):
        self.keys, self.plen, self.out_len = keys, plen, out_len
        self.pos = self.gen = 0
        self.slot = False


class EngineModel:
    """One instance's queue, slots and prompt store; see the module
    docstring."""

    def __init__(self, max_batch: int, max_len: int, chunk: int,
                 block: int, capacity: int):
        self.free = max_batch
        self.max_len, self.chunk = max_len, chunk
        self.block, self.capacity = block, capacity
        self.waiting: collections.deque = collections.deque()
        self.running: List[_Req] = []
        self.store: "collections.OrderedDict[bytes, None]" = \
            collections.OrderedDict()

    def submit(self, keys, plen: int, out_len: int):
        self.waiting.append(_Req(keys, plen, out_len))

    def _restore(self, r: _Req):
        for L in range(len(r.keys), 0, -1):
            if r.keys[L - 1] in self.store:
                self.store.move_to_end(r.keys[L - 1])
                r.pos = max(0, min(L * self.block, r.plen - 1))
                return

    def step(self) -> Tuple[str, int, int, int]:
        """(kind, prefill tokens, first tokens, finishes) of the next
        step."""
        head = self.waiting[0] if self.waiting else None
        if head is not None and self.free:
            if not head.slot:
                head.slot = True
                self.free -= 1
                self._restore(head)
            n = min(self.chunk, head.plen - head.pos,
                    self.max_len - head.pos)
            head.pos += n
            if head.pos < min(head.plen, self.max_len):
                return "prefill", n, 0, 0
            self.waiting.popleft()
            head.gen = 1
            if head.keys:
                self.store[head.keys[-1]] = None
                self.store.move_to_end(head.keys[-1])
                while len(self.store) > self.capacity:
                    self.store.popitem(last=False)
            if head.gen >= head.out_len:
                self.free += 1
                return "prefill", n, 1, 1
            self.running.append(head)
            return "prefill", n, 1, 0
        if self.running:
            done = 0
            for r in list(self.running):
                r.gen += 1
                r.pos = min(r.pos + 1, self.max_len - 1)
                if r.gen >= r.out_len or r.pos >= self.max_len - 1:
                    self.running.remove(r)
                    self.free += 1
                    done += 1
            return "decode", 0, 0, done
        return "idle", 0, 0, 0


def replay(serving: Dict, events: Iterable[Tuple]) -> Tuple[List[int], int]:
    """(decisions, steps reported otherwise) for an event log of
    ``("route", tokens, output_len)`` and ``("step", iid, kind,
    prefill_tokens, first, finished)`` entries, the step's numbers as the
    program reported them.  ``serving`` is the configuration's serving
    set-up."""
    n, block = serving["engines"], serving["block_size"]
    ref = LMetricReference(n, block)
    engines = [EngineModel(serving["max_batch"], serving["max_len"],
                           serving["chunk_tokens"], block,
                           serving["prefix_capacity"]) for _ in range(n)]
    out, differing = [], 0
    for ev in events:
        if ev[0] == "route":
            keys = prefix_keys(ev[1], block)
            iid = ref.route(ev[1], keys)
            engines[iid].submit(keys, len(ev[1]), ev[2])
            out.append(iid)
        else:
            iid, reported = ev[1], tuple(ev[2:])
            mine = engines[iid].step()
            differing += mine != reported
            ref.step(iid, *mine[1:])
    return out, differing
