"""Device-idle time inside the program's ``engine.decode`` ranges (the
whole decode branch of ``InstanceEngine.step``), per range, in ms, over
the profiled part of the window: each range's host interval less the
union of the device operations inside it.  Device work is every CUDA
event of the profile but a range's device-side copy (an event named like
the benchmark's or the program's ranges).  The ranges have to number the
profiled decode steps, or the reader raises.  None where the program has
no such range, or no device operation was profiled (the CPU)."""
import bisect

import torch

from servebench.trace import PREFIX, _union

#: range names: the benchmark's and the program's
RANGES = (PREFIX, "engine.", "cluster.", "model.")


def read(ctx):
    tracer = ctx.window.recorder.tracer
    if tracer is None or tracer.prof is None:
        return None
    ranges, dev = [], []
    for e in tracer.prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not name.startswith(RANGES):
                dev.append((s, s + e.duration_ns()))
        elif name == "engine.decode":
            ranges.append((s, s + e.duration_ns()))
    if not ranges:
        return None
    n = sum(1 for s in ctx.traced_steps() if s.kind == "decode")
    if len(ranges) != n:
        raise AssertionError(f"engine.decode: {len(ranges)} ranges in the "
                             f"profiled part, {n} decode steps")
    if not dev:
        return None
    busy = _union(dev)
    starts = [a for a, _ in busy]
    idle = 0
    for a, b in ranges:
        covered = 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(busy) and busy[i][0] < b:
            covered += max(0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
        idle += (b - a) - covered
    return idle * 1e-6 / len(ranges)
