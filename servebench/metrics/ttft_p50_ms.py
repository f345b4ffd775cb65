"""Median time to first token over every request due in the window, in
the engines' virtual time (``ttft_p95_ms.py``'s sample: a request with no
first token at the close enters at close less due time)."""
import numpy as np


def read(ctx):
    w = ctx.window
    xs = [((r.times[0] if r.times else w.t_cut) - r.arrival) * 1e3
          for r in w.requests.values()]
    return float(np.percentile(xs, 50)) if xs else None
