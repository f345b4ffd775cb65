"""95th percentile of time to first token over every request due in the
window, in the engines' virtual time: first token less due time; a
request with no first token at the close enters at (close - due time),
a lower bound, so a stall still shows."""
import numpy as np


def read(ctx):
    w = ctx.window
    xs = [((r.times[0] if r.times else w.t_cut) - r.arrival) * 1e3
          for r in w.requests.values()]
    return float(np.percentile(xs, 95)) if xs else None
