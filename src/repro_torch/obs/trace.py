"""Structured span tracer → Chrome trace-event JSON (Perfetto-loadable)
— port of ``repro.obs.trace``; imports nothing but the standard library.

One :class:`SpanTracer` per run records nestable spans over the routing
pipeline's stages (walk → score → commit), speculation consume/discard,
admission gating, retraction, and churn/recovery, and serializes them in
the Chrome ``traceEvents`` format (``B``/``E`` duration pairs, ``i``
instants, ``M`` metadata) that chrome://tracing and Perfetto load
directly.

**Determinism contract.**  Timestamps are *virtual*: the simulator feeds
its event clock through :meth:`set_time`, and every event gets the next
microsecond tick at-or-after that virtual time (a lamport-style cursor
breaks ties in emission order).  Nothing in the trace depends on wall
time, so two runs of the same deterministic scenario emit byte-identical
trace JSON — traces are diffable artifacts, and the round-trip test pins
exactly that.  Wall-clock stage *durations* deliberately do not live
here; they are histogram samples in the metrics registry
(``pipeline.walk_us`` …), which a reader joins with the trace
timeline.

**Pid/tid mapping.**  The router/simulator tier is ``pid 0``; shard
worker ``s`` is ``pid 1 + s`` (one process per shard under the process
backend — the mapping every backend shares so traces are comparable
across backends).  :meth:`process_name` emits the ``process_name``
metadata rows Perfetto uses for track labels.

**Sampling.**  ``sample_every=N`` records the span tree for every Nth
wave only (``wave_tick`` advances the counter); instant events — drops,
retractions, churn — are rare and always recorded.  Sampling is the
overhead knob the ≤5 % enabled-mode budget is enforced against.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

#: pid of the router/simulator tier; shard worker ``s`` is ``1 + s``
ROUTER_PID = 0

#: default wave-sampling stride (every Nth wave gets a span tree)
DEFAULT_SAMPLE_EVERY = 8


def shard_pid(s: int) -> int:
    """The trace pid assigned to shard worker ``s``."""
    return 1 + s


class _Span:
    """Context manager emitting a B/E pair (or nothing when unsampled)."""

    __slots__ = ("_tr", "_name", "_pid", "_tid", "_args")

    def __init__(self, tr, name, pid, tid, args):
        self._tr = tr
        self._name = name
        self._pid = pid
        self._tid = tid
        self._args = args

    def __enter__(self):
        tr = self._tr
        if tr is not None:
            tr._emit("B", self._name, self._pid, self._tid, self._args)
        return self

    def __exit__(self, *exc):
        tr = self._tr
        if tr is not None:
            tr._emit("E", self._name, self._pid, self._tid, None)
        return False


_NULL_SPAN = _Span(None, "", 0, 0, None)


class SpanTracer:
    def __init__(self, sample_every: int = DEFAULT_SAMPLE_EVERY,
                 max_events: int = 1 << 20):
        self.sample_every = max(int(sample_every), 1)
        self.max_events = max_events
        self.events: List[dict] = []
        self._ts = 0            # microsecond cursor (virtual, monotonic)
        self._wave = 0
        self._sampled = True
        self._named_pids: Dict[int, str] = {}
        self.process_name(ROUTER_PID, "router")

    # ---- virtual clock ------------------------------------------------
    def set_time(self, t_seconds: float):
        """Advance the virtual clock (simulator event time).  The
        cursor never rewinds — ties within one event timestamp keep
        emission order via +1 µs lamport ticks."""
        us = int(t_seconds * 1e6)
        if us > self._ts:
            self._ts = us

    # ---- sampling -----------------------------------------------------
    def wave_tick(self) -> bool:
        """Advance the wave counter; returns whether this wave's span
        tree is recorded (every ``sample_every``-th wave)."""
        self._sampled = (self._wave % self.sample_every) == 0
        self._wave += 1
        return self._sampled

    # ---- emission -----------------------------------------------------
    def _emit(self, ph, name, pid, tid, args):
        if len(self.events) >= self.max_events:
            return
        self._ts += 1
        ev = {"name": name, "ph": ph, "ts": self._ts,
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def span(self, name: str, pid: int = ROUTER_PID, tid: int = 0,
             args: Optional[dict] = None) -> _Span:
        """Nestable duration span (no-op on unsampled waves)."""
        if not self._sampled:
            return _NULL_SPAN
        return _Span(self, name, pid, tid, args)

    def instant(self, name: str, pid: int = ROUTER_PID, tid: int = 0,
                args: Optional[dict] = None):
        """Point event (drops, retractions, churn) — always recorded,
        independent of wave sampling."""
        if len(self.events) >= self.max_events:
            return
        self._ts += 1
        ev = {"name": name, "ph": "i", "ts": self._ts,
              "pid": pid, "tid": tid, "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def shard_mark(self, s: int, name: str, args: Optional[dict] = None):
        """Per-shard-worker event on the shard's own pid track (the
        parent emits on the worker's behalf — worker processes cannot
        append to this list)."""
        pid = shard_pid(s)
        if pid not in self._named_pids:
            self.process_name(pid, f"prefix-shard-{s}")
        if not self._sampled:
            return
        self._emit("i", name, pid, 0, args)

    def process_name(self, pid: int, name: str):
        self._named_pids[pid] = name
        self.events.append({"name": "process_name", "ph": "M",
                            "ts": 0, "pid": pid, "tid": 0,
                            "args": {"name": name}})

    # ---- export -------------------------------------------------------
    def to_json(self) -> dict:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def export(self, path: str):
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, sort_keys=True)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------
def validate_events(events: List[dict]):
    """Validate a ``traceEvents`` list: required keys, known phases,
    balanced B/E nesting per (pid, tid) track (strict stack
    discipline), monotonic non-metadata timestamps, and every pid
    carrying a ``process_name`` metadata row.  Raises ``ValueError``
    with a diagnostic on the first violation."""
    named = set()
    stacks: Dict[tuple, List[str]] = {}
    last_ts = 0
    for i, ev in enumerate(events):
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i} missing {key!r}: {ev}")
        ph = ev["ph"]
        if ph not in ("B", "E", "X", "i", "M"):
            raise ValueError(f"event {i} unknown phase {ph!r}")
        if ph == "M":
            if ev["name"] == "process_name":
                named.add(ev["pid"])
            continue
        if ev["ts"] < last_ts:
            raise ValueError(
                f"event {i} ts {ev['ts']} rewinds (< {last_ts})")
        last_ts = ev["ts"]
        if ev["pid"] not in named:
            raise ValueError(
                f"event {i} pid {ev['pid']} has no process_name "
                f"metadata")
        track = (ev["pid"], ev["tid"])
        stack = stacks.setdefault(track, [])
        if ph == "B":
            stack.append(ev["name"])
        elif ph == "E":
            if not stack:
                raise ValueError(
                    f"event {i} E {ev['name']!r} with empty stack on "
                    f"track {track}")
            top = stack.pop()
            if top != ev["name"]:
                raise ValueError(
                    f"event {i} E {ev['name']!r} closes {top!r} on "
                    f"track {track} (bad nesting)")
    open_tracks = {t: s for t, s in stacks.items() if s}
    if open_tracks:
        raise ValueError(f"unclosed spans at end of trace: {open_tracks}")


def load_trace(path: str) -> List[dict]:
    """Load + validate a trace file; returns the event list."""
    with open(path) as fh:
        doc = json.load(fh)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents list")
    validate_events(events)
    return events
