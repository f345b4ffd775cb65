"""Share of prompt tokens not prefilled (restored from a stored
fragment), over the requests whose prefill finished in the window."""


def read(ctx):
    done = [r for r in ctx.window.requests.values() if r.times]
    total = sum(len(r.tokens) for r in done)
    if not total:
        return None
    return 100.0 * (total - sum(r.computed for r in done)) / total
