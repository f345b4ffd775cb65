"""Mean wall of a decode step (all slots), outside the profiled part of
the window."""


def read(ctx):
    walls = [s.wall for s in ctx.host_steps() if s.kind == "decode"]
    return sum(walls) / len(walls) * 1e3 if walls else None
