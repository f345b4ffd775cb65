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
are prefilled — the paper's compute skip, for real.  As in the reference
a fragment is the whole slot (every leaf of every layer) after the whole
prompt, gathered into one flat buffer and copied to host memory in one
copy, stored with the length of the prompt's full blocks, and the decode
step runs all ``max_batch`` slots.  For a recurrent layer the fragment
is the state after the whole prompt, so a hit on a prompt that does not
end on a block boundary, or on the whole of a stored prompt, runs the
stored tail's tokens through the state a second time; the port keeps
that reference behaviour (ROADMAP Queue C.9).

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
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.indicators import resolve_device
from ..core.radix import tokens_to_blocks
from ..core.router import Router
from ..core.types import Request
from ..models.model import Model


class PrefixStore:
    """Host-side LRU store of per-slot cache fragments keyed by block-id
    chains."""

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
        self.prefix_store = PrefixStore(prefix_capacity)
        self.waiting: collections.deque = collections.deque()
        self.running: Dict[int, _Seq] = {}      # slot -> seq
        self.free_slots = list(range(max_batch))
        self._last_tokens = np.zeros(max_batch, np.int64)
        self._pos = np.zeros(max_batch, np.int64)

    # ------------------------------------------------------------------
    def _leaves(self):
        for entry in self.cache:
            yield from entry.values()

    def _slot_view(self, b: int):
        return [{name: t[b:b + 1] for name, t in entry.items()}
                for entry in self.cache]

    def _frag_views(self, flat: torch.Tensor):
        """Each cache leaf's slot as a view of the flat byte buffer
        ``flat``, every leaf at a 16-byte aligned offset."""
        views, off = [], 0
        for t in self._leaves():
            n = t[0].numel() * t.element_size()
            views.append(flat[off:off + n].view(t.dtype).view(t.shape[1:]))
            off += -(-n // 16) * 16
        return views

    def _snapshot(self, b: int) -> torch.Tensor:
        """Slot ``b`` as one host buffer: every leaf gathered into one flat
        buffer on the device, then one copy to the host (the gather is a
        copy, so on the CPU too the fragment never aliases the slot that
        the next request overwrites)."""
        n = sum(-(-t[0].numel() * t.element_size() // 16) * 16
                for t in self._leaves())
        flat = torch.empty(n, dtype=torch.uint8, device=self.device)
        for view, t in zip(self._frag_views(flat), self._leaves()):
            view.copy_(t[b])
        return flat.cpu()

    def _restore(self, b: int, frag: torch.Tensor):
        """Copy a fragment into slot ``b``: one copy to the device, then
        each leaf from its view."""
        flat = frag.to(self.device)
        for view, t in zip(self._frag_views(flat), self._leaves()):
            t[b].copy_(view)

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
        toks = torch.from_numpy(tokens[:, None]).to(self.device)
        logits, _ = self.model.decode_step(
            self.params, toks, torch.from_numpy(pos).to(self.device),
            self.cache)
        return logits[:, -1]

    # ------------------------------------------------------------------
    def submit(self, req: Request, tokens: np.ndarray):
        self.waiting.append(_Seq(req, tokens, -1))

    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.running)

    # ------------------------------------------------------------------
    def _try_admit(self):
        if not self.waiting or not self.free_slots:
            return None
        seq = self.waiting[0]
        if seq.slot >= 0:
            return seq
        slot = self.free_slots.pop(0)
        seq.slot = slot
        for t in self._leaves():
            t[slot].zero_()
        # prefix-cache hit: inject fragment, skip its compute
        blocks = tuple(tokens_to_blocks(seq.tokens.tolist(),
                                        self.block_size))
        key, frag, length = self.prefix_store.lookup(blocks)
        if frag is not None:
            # always leave >=1 token to prefill (logits source); a full-
            # prompt hit re-processes just the final token
            usable = min(length, len(seq.tokens) - 1)
            if usable > 0:
                self._restore(slot, frag)
                seq.pos = usable
                seq.req.hit_tokens = usable
        return seq

    def step(self) -> Dict:
        """One engine step: a prefill chunk (head-of-queue) OR a batched
        decode step for all running slots.  Returns events + wall time."""
        t0 = time.perf_counter()
        events = {"first": [], "finished": [], "kind": "idle",
                  "prefill_tokens": 0, "decode_bs": 0}
        seq = self._try_admit()
        if seq is not None and not seq.prefill_done:
            events["kind"] = "prefill"
            n = min(self.chunk, len(seq.tokens) - seq.pos,
                    self.max_len - seq.pos)
            logits = self._prefill(seq.tokens[seq.pos: seq.pos + n],
                                   seq.pos, seq.slot)
            first = int(logits[0].argmax())
            events["prefill_tokens"] = n
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
                # save the prompt's KV as a reusable prefix fragment
                blocks = tuple(tokens_to_blocks(
                    seq.tokens.tolist(), self.block_size))
                if blocks:
                    self.prefix_store.insert(
                        blocks, self._snapshot(seq.slot),
                        len(blocks) * self.block_size)
                if seq.generated >= seq.req.output_len:
                    self._finish(seq, events)
        elif self.running:
            events["kind"] = "decode"
            events["decode_bs"] = len(self.running)
            held = self._hold_stalled()
            nxt = self._decode(self._last_tokens, self._pos).argmax(
                dim=-1).cpu().numpy()
            if held is not None:
                b, saved = held
                for t, x in zip(self._leaves(), saved):
                    t[b].copy_(x)
            for slot, seq in list(self.running.items()):
                tok = int(nxt[slot])
                seq.out_tokens.append(tok)
                seq.generated += 1
                self._last_tokens[slot] = tok
                self._pos[slot] = min(self._pos[slot] + 1, self.max_len - 1)
                if seq.generated >= seq.req.output_len or \
                        self._pos[slot] >= self.max_len - 1:
                    self._finish(seq, events)
        events["wall"] = time.perf_counter() - t0
        return events

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
                now = engine_time[iid] + ev["wall"]
                engine_time[iid] = now
                if ev["prefill_tokens"]:
                    self.router.on_prefill_progress(iid,
                                                    ev["prefill_tokens"])
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
                        print(f"[{now:8.3f}] inst{iid} rid={seq.req.rid} "
                              f"hit={seq.req.hit_tokens} "
                              f"out={len(seq.out_tokens)}")
                if eng.has_work():
                    heapq.heappush(heap, (now, next(seqno), "step", iid))
        return finished
