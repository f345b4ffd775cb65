"""Wall of the prefill steps over the prompt tokens they computed, per
1000 tokens; a step's wall includes its fragment restore and snapshot.
Steps outside the profiled part of the window only."""


def read(ctx):
    steps = [s for s in ctx.host_steps() if s.kind == "prefill"]
    tok = sum(s.prefill for s in steps)
    return sum(s.wall for s in steps) * 1e3 / (tok / 1e3) if tok else None
