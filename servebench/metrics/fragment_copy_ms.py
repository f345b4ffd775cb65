"""Mean host wall of a request's fragment copies, in ms: the program's
own stamps of its restore and its snapshot (``Request.restore_s +
snapshot_s``; a copy through pageable memory blocks the host, so this is
part of the request's TTFT), over the requests whose prefill finished
before the profiled part of the window began.  None where the program
keeps no such stamps."""


def read(ctx):
    done = [r.req for r in ctx.window.requests.values()
            if len(r.times) > r.n_traced]
    if not done or not hasattr(done[0], "snapshot_s"):
        return None
    return sum(q.restore_s + q.snapshot_s for q in done) / len(done) * 1e3
