"""Model operations of every step outside the profiled part of the
window (``servebench/flops.py``: what each step does for the requests it
serves) over that part's wall and the card's dense bf16 peak."""
from servebench import flops


def read(ctx):
    steps = ctx.host_steps()
    if not steps:
        return None
    ops = sum(flops.step_flops(ctx.shape, s.kind, s.spans) for s in steps)
    return 100.0 * ops / (ctx.host_window_s * flops.PEAK_BF16_FLOPS)
