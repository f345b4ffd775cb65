"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

``Tracer`` profiles the CPU and the card over the last part of the
window (``serving.Recorder`` starts it between two steps).  ``summary``
reduces the raw Kineto events to what the per-layer metrics read:

* ``busy_s``: the union of every device operation's interval (kernels,
  copies, sets); ``window_s``: the host's time from start to stop;
* ``kernel_s``: device seconds and launches by operation name;
* ``annotated_s``: device seconds of the operations launched inside each
  of the benchmark's own ranges (``record_function`` names starting with
  ``sb.``; nested ranges each count them), found by the launching CPU
  operation's start time;
* ``idle_gaps``: the device's idle time between operations, summed by
  what the host was doing: the benchmark's innermost range at the gap's
  start and the CPU operation that launched the operation ending it;
* ``device_ops``: the ten operations that took most device time.
"""
from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Tuple

import torch

PREFIX = "sb."


class Tracer:
    def __init__(self):
        self.prof = None
        self.active = False
        self.kind = "idle"          # the step in progress (set by serving)
        self.launches0: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.launches0 = kernel_launches()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.active = True
        self.t0 = time.perf_counter()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.active = False
        end = kernel_launches()
        self.launches = {k: end[k] - self.launches0[k] for k in end}

    def summary(self) -> Dict:
        return summarize(self.prof.profiler.kineto_results.events(),
                         self.t1 - self.t0)


def kernel_launches() -> Dict[str, int]:
    """The program's own launch counters of its attention kernels."""
    from repro_torch.kernels import paged_attention, prefill_attention
    return {"paged_attention": paged_attention.LAUNCHES,
            "prefill_attention": prefill_attention.LAUNCHES}


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Ranges:
    """The benchmark's host ranges, one sorted list per name (ranges of
    one name never overlap: they are sequential calls)."""

    def __init__(self, ranges: List[Tuple[int, int, str]]):
        by: Dict[str, List[Tuple[int, int]]] = collections.defaultdict(list)
        for a, b, name in ranges:
            by[name].append((a, b))
        self.lists = {n: sorted(v) for n, v in by.items()}
        self.starts = {n: [a for a, _ in v] for n, v in self.lists.items()}

    def covering(self, t: int) -> List[Tuple[int, str]]:
        """(start, name) of every range that holds time ``t``."""
        out = []
        for name, lst in self.lists.items():
            i = bisect.bisect_right(self.starts[name], t) - 1
            if i >= 0 and lst[i][1] >= t:
                out.append((lst[i][0], name))
        return out

    def innermost(self, t: int):
        cov = self.covering(t)
        return max(cov)[1] if cov else None


def summarize(events, window_s: float) -> Dict:
    dev = []             # (start, end, name, linked correlation id)
    cpu_start: Dict[int, Tuple[int, str]] = {}
    ranges = []          # the benchmark's ranges on the host
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name.startswith(PREFIX):
                continue                 # the range's device-side shadow
            s = e.start_ns()
            dev.append((s, s + e.duration_ns(), name,
                        e.linked_correlation_id()))
        elif name.startswith(PREFIX):
            s = e.start_ns()
            ranges.append((s, s + e.duration_ns(), name))
        else:
            cpu_start[e.correlation_id()] = (e.start_ns(), name)
    ranges = _Ranges(ranges)
    kernel_s: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0.0, 0])
    annotated: Dict[str, float] = collections.defaultdict(float)
    for s, t, name, corr in dev:
        k = kernel_s[name]
        k[0] += (t - s) * 1e-9
        k[1] += 1
        launch = cpu_start.get(corr)
        if launch is not None:
            for _, where in ranges.covering(launch[0]):
                annotated[where] += (t - s) * 1e-9
    busy = _union([(s, t) for s, t, _, _ in dev])
    by_start = {}
    for s, t, name, corr in dev:
        by_start.setdefault(s, corr)
    gaps: Dict[str, float] = collections.defaultdict(float)
    for (_, b), (a2, _) in zip(busy, busy[1:]):
        host = ranges.innermost(b) or "loop"
        launch = cpu_start.get(by_start.get(a2, -1))
        gaps[f"{host} > {launch[1] if launch else 'host'}"] += (a2 - b) * 1e-9
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-9,
        "window_s": window_s,
        "kernel_s": {k: tuple(v) for k, v in kernel_s.items()},
        "annotated_s": dict(annotated),
        "device_ops": [[k[:160], v[0]] for k, v in ops[:10]],
        "idle_gaps": [[k[:160], v] for k, v in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    }
