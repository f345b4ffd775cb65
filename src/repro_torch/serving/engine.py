"""Serving engine: continuous batching, chunked prefill and prefix-cache KV$
reuse under the LMetric router — port of ``repro.serving.engine``.

One ``InstanceEngine`` owns a slot-based cache (``max_batch`` slots:
``max_len`` K/V rows per ``attn`` layer, a ring per ``swa`` layer, a state
per recurrent layer), runs chunked prefill through
``Model.prefill_cached`` (the ``flash_prefill``, ``rglru_scan`` and
``mlstm_chunk`` kernels) and one batched decode step over all slots
through ``Model.decode_step`` (the ``paged_attention`` kernel).  A
host-side ``PrefixStore`` keeps fragments keyed by block-hash chains: on
a KV$ hit the fragment is copied into the slot and only the suffix tokens
are prefilled — the paper's compute skip, for real.  A fragment is the
slot after the whole prompt, stored with the length of the prompt's full
blocks, gathered into one flat buffer: of each ``attn`` leaf the rows
below that length (the only rows a hit reads before prefill or decode
writes them), every other leaf whole (an ``swa`` ring's rows and a
recurrent state are not positions).  The reference stores the whole
slot.  The buffer stays on the engine's device when the stores of every
engine on the card fit there beside a reserve (``place_fragments``),
else it is copied to host memory in one copy.  The decode step runs all
``max_batch`` slots.  For a recurrent layer the fragment is the state
after the whole prompt, so a hit on a prompt that does not end on a
block boundary, or on the whole of a stored prompt, runs the stored
tail's tokens through the state a second time; the port keeps that
reference behaviour (ROADMAP Queue C.9).

Slot surgery is done in place over every leaf of the cache: admitting a
request zeroes its slot (``zero_``) and a hit copies the fragment into it
(``copy_``); the model's cached entry points write the cache in place
too.  The reference rebuilds immutable cache pytrees instead.  A decode
step while the head of the queue is stalled part-way through its
prefill (admission waits for a free slot, as in the reference) puts
that request's slot back afterwards; the reference lets the step write
it (ROADMAP Queue C.17).

``EngineCluster`` wires N engines to the port's ``core.Router`` under the
reference's virtual-time event loop, whose step durations are the
measured wall times of the engine steps (each ending in a device
synchronisation, since the host reads the sampled tokens).

The served path is instrumented for an operator and for a device trace:

* each step stamps its requests (``Request.t_admit``, ``token_times``,
  ``restore_s``, ``snapshot_s``, ``frag_bytes``; ``EngineCluster.run``
  writes the virtual times), and each engine keeps plain accumulators
  (snapshots, those kept on the device, restores, their host walls and
  bytes, holds, prefill and decode steps and rows), which
  ``EngineCluster.metrics_snapshot``
  ingests (``obs.registry.ingest_engine``);
* the steps run inside ``torch.profiler`` ranges of fixed names
  (``engine.step`` holding ``engine.admit`` > ``engine.restore``,
  ``engine.prefill``, ``engine.snapshot``, ``engine.decode`` >
  ``engine.hold`` / ``engine.decode.inputs`` / ``engine.decode.forward``
  / ``engine.sample`` / ``engine.decode.commit``; ``cluster.route`` and
  ``cluster.hooks`` in ``EngineCluster.run``; ``model.moe`` in
  ``moe_apply``), entered only while a profiler is on
  (``repro_torch.profiling``).  They are profiler ranges, not the
  ``obs`` bundle's ``SpanTracer`` events: that tracer keeps a virtual
  clock, which cannot line up with the card's activity, and the bundle
  stays the routing stack's.  A step keeps its two ``time.perf_counter``
  reads, whose difference is its wall; the copies are timed with
  ``perf_counter_ns``.

``device`` (default ``"cuda"``) must be the model's device; only an
explicit ``"cpu"`` runs the kernels' plain versions.  An encoder-decoder
(Whisper) is refused, as the reference's engine refuses it; it runs at
model level.
"""
from __future__ import annotations

import collections
import heapq
import itertools
import time
from time import perf_counter_ns
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.indicators import resolve_device
from ..core.radix import tokens_to_blocks
from ..core.router import Router
from ..core.types import Request
from ..models.model import Model
from ..profiling import span


# Share of the card's memory left free beside a store of fragments on
# it: the store is reckoned at whole-slot size, but prefill's activations,
# the MoE layer's expert buffers and the allocator's rounding need memory
# that the reckoning does not count, and a card that runs out fails the
# run.
STORE_RESERVE = 0.10


def store_fits(store_bytes: int, free_bytes: int, total_bytes: int) -> bool:
    """Whether a fragment store of ``store_bytes`` goes on a card that has
    ``free_bytes`` of its ``total_bytes`` free: the store and a reserve of
    ``STORE_RESERVE`` of the card both fit."""
    return store_bytes + STORE_RESERVE * total_bytes <= free_bytes


def place_fragments(engines) -> None:
    """Where the fragments of ``engines`` (one device, caches allocated)
    live: on the device when their stores fit there (``store_fits``),
    each reckoned at whole-slot size for its capacity and one more, the
    snapshot taken before the store evicts; else in host memory.  On the
    CPU the host is the device.  A store placed on a card is reserved in
    the caching allocator (each engine's share allocated, then freed), so
    that a snapshot's buffer comes out of that reservation rather than
    from a ``cudaMalloc`` of its own, which blocks the host."""
    dev = engines[0].device
    if dev.type != "cuda":
        for e in engines:
            e.frag_device = dev
        return
    shares = [(e.prefix_store.capacity + 1) * e._frag_bytes(e.max_len)
              for e in engines]
    free, total = torch.cuda.mem_get_info(dev)
    # memory the allocator holds unused is free to the store too
    free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    on = store_fits(sum(shares), free, total)
    for e in engines:
        e.frag_device = dev if on else torch.device("cpu")
    if on:
        held = [torch.empty(n, dtype=torch.uint8, device=dev) for n in shares]
        del held


class PrefixStore:
    """LRU store of per-slot cache fragments keyed by block-id chains."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._store: "collections.OrderedDict[Tuple, Tuple]" = \
            collections.OrderedDict()

    def lookup(self, blocks: Tuple[int, ...]):
        """Longest stored chain that is a prefix of ``blocks``."""
        for L in range(len(blocks), 0, -1):
            key = blocks[:L]
            if key in self._store:
                self._store.move_to_end(key)
                frag, length = self._store[key]
                return key, frag, length
        return None, None, 0

    def insert(self, blocks: Tuple[int, ...], frag, length: int):
        if not blocks:
            return
        self._store[tuple(blocks)] = (frag, length)
        self._store.move_to_end(tuple(blocks))
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)


# ---------------------------------------------------------------------------

class _Seq:
    __slots__ = ("req", "tokens", "slot", "pos", "generated", "out_tokens",
                 "prefill_done")

    def __init__(self, req: Request, tokens: np.ndarray, slot: int):
        self.req = req
        self.tokens = tokens
        self.slot = slot
        self.pos = 0                 # tokens already in cache
        self.generated = 0
        self.out_tokens: List[int] = []
        self.prefill_done = False


class InstanceEngine:
    def __init__(self, model: Model, params, iid: int = 0,
                 max_batch: int = 8, max_len: int = 512,
                 chunk_tokens: int = 128, block_size: int = 16,
                 prefix_capacity: int = 64, device="cuda"):
        if model.cfg.is_encdec:
            # as the reference's engine: Whisper is held at model level
            raise ValueError(f"{model.cfg.name}: the engine does not serve "
                             "an encoder-decoder")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.params = params
        self.iid = iid
        self.max_batch = max_batch
        self.max_len = max_len
        self.chunk = chunk_tokens
        self.block_size = block_size
        self.cache = model.init_cache(max_batch, max_len)
        # a fragment's layout: first every leaf kept whole (an ``swa``
        # ring, a recurrent state: its rows are not positions), each at a
        # 16-byte aligned offset, as (leaf index in ``_leaves`` order,
        # offset, bytes, dtype, shape); then, in the cache's dtype, the
        # kept rows of the ``attn`` leaves (their indices), row by row, as
        # (rows, leaves, KV heads, head dim), so a fragment's size gives
        # its rows
        self._frag_whole, self._frag_attn, self._frag_head = [], [], 0
        kinds = [kind for kind, entry in zip(model.cfg.block_pattern,
                                             self.cache) for _ in entry]
        for i, (kind, t) in enumerate(zip(kinds, self._leaves())):
            if kind == "attn":
                self._frag_attn.append(i)
                continue
            n = t[0].numel() * t.element_size()
            self._frag_whole.append((i, self._frag_head, n, t.dtype,
                                     tuple(t.shape[1:])))
            self._frag_head += -(-n // 16) * 16
        self._frag_row = len(self._frag_attn) * model.cfg.n_kv_heads * \
            model.cfg.resolved_head_dim * model.dtype.itemsize
        self.prefix_store = PrefixStore(prefix_capacity)
        self.waiting: collections.deque = collections.deque()
        self.running: Dict[int, _Seq] = {}      # slot -> seq
        self.free_slots = list(range(max_batch))
        self._last_tokens = np.zeros(max_batch, np.int64)
        self._pos = np.zeros(max_batch, np.int64)
        # plain accumulators over this engine's steps, mirrored onto a
        # registry by ``obs.registry.ingest_engine``: fragment snapshots
        # and restores with their host walls and the bytes they moved,
        # decode steps that put a stalled slot back, prefill steps and
        # the prompt tokens they computed, decode steps and the requests
        # they served
        self.snapshots = self.snapshot_ns = self.device_snapshots = 0
        self.restores = self.restore_ns = 0
        self.holds = self.copied_bytes = 0
        self.prefill_steps = self.prefill_tokens = 0
        self.decode_steps = self.decode_rows = 0
        place_fragments([self])

    # ------------------------------------------------------------------
    def _leaves(self):
        for entry in self.cache:
            yield from entry.values()

    def _slot_view(self, b: int):
        return [{name: t[b:b + 1] for name, t in entry.items()}
                for entry in self.cache]

    def _frag_bytes(self, rows: int) -> int:
        """The bytes of a fragment that keeps ``rows`` rows."""
        return self._frag_head + rows * self._frag_row

    def _frag_body(self, flat: torch.Tensor) -> torch.Tensor:
        """The ``attn`` rows of the fragment ``flat``, as many as its size
        holds: (rows, leaves · KV heads, head dim) in the cache's dtype."""
        cfg = self.model.cfg
        rows = (flat.numel() - self._frag_head) // max(self._frag_row, 1)
        return flat[self._frag_head:].view(self.model.dtype).view(
            rows, len(self._frag_attn) * cfg.n_kv_heads,
            cfg.resolved_head_dim)

    def _frag_whole_views(self, flat: torch.Tensor):
        """(leaf index, view) of each leaf the fragment ``flat`` keeps
        whole."""
        return [(i, flat[off:off + n].view(dtype).view(shape))
                for i, off, n, dtype, shape in self._frag_whole]

    def _frag_attn_views(self, flat: torch.Tensor):
        """(leaf index, view) of each ``attn`` leaf's rows in the fragment
        ``flat``."""
        body = self._frag_body(flat).unflatten(
            1, (len(self._frag_attn), self.model.cfg.n_kv_heads))
        return list(zip(self._frag_attn, body.unbind(1)))

    def _frag_views(self, flat: torch.Tensor):
        """Each cache leaf's kept part, in ``_leaves`` order, as a view of
        the fragment ``flat``: a whole leaf, or an ``attn`` leaf's rows (as
        many as the fragment keeps)."""
        return [view for _, view in sorted(
            self._frag_whole_views(flat) + self._frag_attn_views(flat),
            key=lambda iv: iv[0])]

    def _snapshot(self, b: int, length: int) -> torch.Tensor:
        """Slot ``b`` as a fragment of a prompt whose full blocks hold
        ``length`` rows: the whole leaves copied and the ``attn`` leaves'
        first rows concatenated into one new flat buffer on the device (a
        copy, so the fragment never aliases the slot that the next request
        overwrites), then, where fragments live in host memory, one copy to
        the host."""
        with span("engine.snapshot"):
            rows = min(length, self.max_len)
            flat = torch.empty(self._frag_bytes(rows), dtype=torch.uint8,
                               device=self.device)
            leaves = list(self._leaves())
            for i, view in self._frag_whole_views(flat):
                view.copy_(leaves[i][b])
            if self._frag_attn:
                torch.cat([leaves[i][b, :rows] for i in self._frag_attn],
                          dim=1, out=self._frag_body(flat))
            return flat.to(self.frag_device)

    def _restore(self, b: int, frag: torch.Tensor):
        """Copy a fragment into slot ``b`` (one copy to the device first
        where it lives in host memory), each leaf's kept part from its
        view; an ``attn`` leaf's rows past the fragment's stay zero."""
        with span("engine.restore"):
            flat = frag.to(self.device)
            leaves = list(self._leaves())
            for i, view in self._frag_whole_views(flat):
                leaves[i][b].copy_(view)
            for i, view in self._frag_attn_views(flat):
                leaves[i][b, :len(view)].copy_(view)

    def _prefill(self, tokens: np.ndarray, start: int, b: int
                 ) -> torch.Tensor:
        """One chunk of slot ``b`` at positions ``start ..``; returns the
        last position's logits (1, V)."""
        toks = torch.from_numpy(np.asarray(tokens, np.int64)[None]).to(
            self.device)
        positions = torch.arange(start, start + len(tokens),
                                 device=self.device)[None]
        logits, _ = self.model.prefill_cached(
            self.params, toks, positions, self._slot_view(b), [start],
            last_only=True)
        return logits[:, -1]

    def _decode(self, tokens: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        """One decode step of every slot; returns logits (max_batch, V)."""
        with span("engine.decode.inputs"):
            toks = torch.from_numpy(tokens[:, None]).to(self.device)
            pos = torch.from_numpy(pos).to(self.device)
        with span("engine.decode.forward"):
            logits, _ = self.model.decode_step(self.params, toks, pos,
                                               self.cache)
        return logits[:, -1]

    # ------------------------------------------------------------------
    def submit(self, req: Request, tokens: np.ndarray):
        self.waiting.append(_Seq(req, tokens, -1))

    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.running)

    # ------------------------------------------------------------------
    def _try_admit(self, events):
        if not self.waiting or not self.free_slots:
            return None
        seq = self.waiting[0]
        if seq.slot >= 0:
            return seq
        with span("engine.admit"):
            slot = self.free_slots.pop(0)
            seq.slot = slot
            events["admitted"].append(seq)
            for t in self._leaves():
                t[slot].zero_()
            # prefix-cache hit: inject fragment, skip its compute
            blocks = tuple(tokens_to_blocks(seq.tokens.tolist(),
                                            self.block_size))
            key, frag, length = self.prefix_store.lookup(blocks)
            if frag is not None:
                # always leave >=1 token to prefill (logits source); a
                # full-prompt hit re-processes just the final token
                usable = min(length, len(seq.tokens) - 1)
                if usable > 0:
                    t0 = perf_counter_ns()
                    self._restore(slot, frag)
                    dt = perf_counter_ns() - t0
                    seq.req.restore_s += dt * 1e-9
                    seq.req.frag_bytes += frag.nbytes
                    self.restores += 1
                    self.restore_ns += dt
                    self.copied_bytes += frag.nbytes
                    seq.pos = usable
                    seq.req.hit_tokens = usable
        return seq

    def step(self) -> Dict:
        """One engine step: a prefill chunk (head-of-queue) OR a batched
        decode step for all running slots.  Returns events + wall time:
        the step's ``kind``, ``prefill_tokens`` and ``decode_bs``, and
        the sequences it ``admitted`` (gave a slot), gave their ``first``
        token, ``served`` (gave a token, first ones included) and
        ``finished``."""
        with span("engine.step"):
            t0 = time.perf_counter()
            events = {"admitted": [], "first": [], "served": [],
                      "finished": [], "kind": "idle", "prefill_tokens": 0,
                      "decode_bs": 0}
            seq = self._try_admit(events)
            if seq is not None and not seq.prefill_done:
                self._prefill_step(seq, events)
            elif self.running:
                self._decode_step(events)
            events["wall"] = time.perf_counter() - t0
            return events

    def _prefill_step(self, seq: _Seq, events):
        events["kind"] = "prefill"
        n = min(self.chunk, len(seq.tokens) - seq.pos,
                self.max_len - seq.pos)
        with span("engine.prefill"):
            logits = self._prefill(seq.tokens[seq.pos: seq.pos + n],
                                   seq.pos, seq.slot)
            first = int(logits[0].argmax())
        events["prefill_tokens"] = n
        self.prefill_steps += 1
        self.prefill_tokens += n
        seq.pos += n
        if seq.pos >= min(len(seq.tokens), self.max_len):
            # prefill complete -> first token
            seq.prefill_done = True
            seq.out_tokens.append(first)
            seq.generated = 1
            self.waiting.popleft()
            self.running[seq.slot] = seq
            self._last_tokens[seq.slot] = first
            self._pos[seq.slot] = seq.pos
            events["first"].append(seq)
            events["served"].append(seq)
            # save the prompt's KV as a reusable prefix fragment
            blocks = tuple(tokens_to_blocks(
                seq.tokens.tolist(), self.block_size))
            if blocks:
                length = len(blocks) * self.block_size
                t0 = perf_counter_ns()
                frag = self._snapshot(seq.slot, length)
                dt = perf_counter_ns() - t0
                seq.req.snapshot_s += dt * 1e-9
                seq.req.frag_bytes += frag.nbytes
                self.snapshots += 1
                self.device_snapshots += int(self.frag_device == self.device)
                self.snapshot_ns += dt
                self.copied_bytes += frag.nbytes
                self.prefix_store.insert(blocks, frag, length)
            if seq.generated >= seq.req.output_len:
                self._finish(seq, events)

    def _decode_step(self, events):
        events["kind"] = "decode"
        events["decode_bs"] = len(self.running)
        self.decode_steps += 1
        self.decode_rows += len(self.running)
        with span("engine.decode"):
            held = self._hold_stalled()
            logits = self._decode(self._last_tokens, self._pos)
            with span("engine.sample"):
                nxt = logits.argmax(dim=-1).cpu().numpy()
            if held is not None:
                b, saved = held
                with span("engine.hold"):
                    for t, x in zip(self._leaves(), saved):
                        t[b].copy_(x)
            with span("engine.decode.commit"):
                for slot, seq in list(self.running.items()):
                    tok = int(nxt[slot])
                    seq.out_tokens.append(tok)
                    seq.generated += 1
                    events["served"].append(seq)
                    self._last_tokens[slot] = tok
                    self._pos[slot] = min(self._pos[slot] + 1,
                                          self.max_len - 1)
                    if seq.generated >= seq.req.output_len or \
                            self._pos[slot] >= self.max_len - 1:
                        self._finish(seq, events)

    def _hold_stalled(self):
        """(slot, copies of its leaves) of a head-of-queue request stalled
        part-way through its prefill (it holds the last slot, so admission
        waits for a free one while the running slots decode), else None.
        The decode step runs every slot and writes each at its position,
        which for the stalled slot is its previous occupant's and may lie
        among the rows already prefilled; the step then puts the copies
        back.  The reference does not, so there its stalled request and
        the fragment stored from it are corrupted (ROADMAP Queue C.17)."""
        if not self.waiting or self.waiting[0].slot < 0:
            return None
        b = self.waiting[0].slot
        self.holds += 1
        with span("engine.hold"):
            return b, [t[b].clone() for t in self._leaves()]

    def _finish(self, seq: _Seq, events):
        events["finished"].append(seq)
        if seq.slot in self.running:
            del self.running[seq.slot]
        self.free_slots.append(seq.slot)

    def warmup(self):
        """Build the kernels and warm the device libraries, so measured
        step times are steady-state; the cache is zeroed afterwards."""
        n = min(self.chunk, 8)
        self._prefill(np.zeros(n, np.int64), 0, 0)
        self._decode(np.zeros(self.max_batch, np.int64),
                     np.zeros(self.max_batch, np.int64)).argmax(-1).cpu()
        for t in self._leaves():
            t.zero_()


# ---------------------------------------------------------------------------

class EngineCluster:
    """N real engines + the paper's router under virtual time."""

    def __init__(self, n_instances: int, model: Model, params, policy,
                 block_size: int = 16, kv_capacity_tokens: int = 1 << 62,
                 device="cuda", **engine_kw):
        self.engines = [InstanceEngine(model, params, iid=i,
                                       block_size=block_size, device=device,
                                       **engine_kw)
                        for i in range(n_instances)]
        place_fragments(self.engines)
        exact_only = not model.cfg.has_kv_blocks
        self.router = Router(policy, n_instances,
                             kv_capacity_tokens=kv_capacity_tokens,
                             block_size=block_size, exact_only=exact_only,
                             device=device)
        self.block_size = block_size

    def run(self, arrivals: List[Tuple[float, np.ndarray, int]],
            verbose: bool = False, feedback=None) -> List[Request]:
        """arrivals: (time, prompt_tokens, max_new_tokens[, session_id]).

        ``feedback(req, now)`` (optional) closes the loop: called on
        every finish with the completed request and its virtual finish
        time, it returns follow-up arrival tuples (same shape) that are
        pushed into the live event heap.
        """
        for e in self.engines:
            e.warmup()
        finished: List[Request] = []
        heap: List = []
        seqno = itertools.count()
        rids = itertools.count()

        def push(t, toks, out, sid=-1):
            toks = np.asarray(toks)
            blocks = tuple(tokens_to_blocks(list(toks), self.block_size))
            req = Request(rid=next(rids), arrival=t, blocks=blocks,
                          prompt_len=len(toks), output_len=out,
                          session_id=sid)
            heapq.heappush(heap, (t, next(seqno), "arrival", (req, toks)))

        for entry in arrivals:
            push(*entry)
        engine_time = [0.0] * len(self.engines)
        while heap:
            t, _, kind, payload = heapq.heappop(heap)
            if kind == "arrival":
                req, toks = payload
                with span("cluster.route"):
                    iid = self.router.route(req, t)
                eng = self.engines[iid]
                was_idle = not eng.has_work()
                eng.submit(req, np.asarray(toks))
                if was_idle:
                    # an idle engine has no pending step event; resume it
                    # at max(arrival, its virtual clock) — feedback
                    # arrivals can land behind an engine that ran ahead
                    engine_time[iid] = max(engine_time[iid], t)
                    heapq.heappush(heap, (engine_time[iid], next(seqno),
                                          "step", iid))
            else:
                iid = payload
                eng = self.engines[iid]
                if not eng.has_work():
                    continue
                ev = eng.step()
                began = engine_time[iid]
                now = began + ev["wall"]
                engine_time[iid] = now
                for seq in ev["admitted"]:
                    seq.req.t_admit = began
                for seq in ev["served"]:
                    seq.req.token_times.append(now)
                with span("cluster.hooks"):
                    if ev["prefill_tokens"]:
                        self.router.on_prefill_progress(
                            iid, ev["prefill_tokens"])
                    for seq in ev["first"]:
                        seq.req.t_first_token = now
                        self.router.on_start_running(iid, seq.req)
                    if ev["kind"] == "decode":
                        for _ in range(ev["decode_bs"]):
                            self.router.on_decode_token(iid)
                    for seq in ev["finished"]:
                        seq.req.t_finish = now
                        self.router.on_finish(iid, seq.req)
                        finished.append(seq.req)
                        if feedback is not None:
                            for entry in feedback(seq.req, now):
                                push(*entry)
                        if verbose:
                            print(f"[{now:8.3f}] inst{iid} "
                                  f"rid={seq.req.rid} "
                                  f"hit={seq.req.hit_tokens} "
                                  f"out={len(seq.out_tokens)}")
                if eng.has_work():
                    heapq.heappush(heap, (now, next(seqno), "step", iid))
        return finished

    def metrics_snapshot(self) -> dict:
        """One registry snapshot: the router's
        (``Router.metrics_snapshot``) with every engine's accumulators
        ingested beside it (``obs.registry.ingest_engine``:
        ``engine.<iid>.<name>`` and the totals ``engine.<name>``).
        Ingestion is ``counter_set``, so repeated calls never
        double-count."""
        from ..obs.registry import (MetricsRegistry, ingest_engine,
                                    ingest_router)
        obs = self.router.obs
        reg = obs.registry if obs is not None and \
            obs.registry is not None else MetricsRegistry()
        ingest_router(reg, self.router)
        ingest_engine(reg, self.engines)
        return reg.snapshot()
