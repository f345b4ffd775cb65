"""Share of the profiled window in which no operation ran on the card."""


def read(ctx):
    tr = ctx.trace
    if not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
