"""Median time a request waited for an engine slot, over every request
due in the window, in the engines' virtual time: the program's own
admission stamp (``Request.t_admit``, the start of the step that gave
the request its slot) less due time.  A request not admitted by the
close enters at close less due time, as in the TTFT readers.  None where
the program keeps no admission stamp."""
import numpy as np


def read(ctx):
    w = ctx.window
    xs = []
    for r in w.requests.values():
        t = getattr(r.req, "t_admit", None)
        if t is None:
            return None
        xs.append(((t if t >= 0 else w.t_cut) - r.arrival) * 1e3)
    return float(np.percentile(xs, 50)) if xs else None
