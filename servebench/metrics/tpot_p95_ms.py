"""95th percentile, over every request with two or more output tokens in
the window, of its mean gap between output tokens (virtual time);
requests still decoding at the close count over the tokens they got.
Tokens of the profiled part of a ``--trace 1`` window are left out."""
import numpy as np


def read(ctx):
    xs = []
    for r in ctx.window.requests.values():
        t = r.times[:len(r.times) - r.n_traced]
        if len(t) >= 2:
            xs.append((t[-1] - t[0]) / (len(t) - 1) * 1e3)
    return float(np.percentile(xs, 95)) if xs else None
