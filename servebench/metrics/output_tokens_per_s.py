"""Output tokens the engines produced in the window (first tokens and
decode tokens) over the window's wall seconds: the card's throughput."""


def read(ctx):
    w = ctx.window
    return sum(s.tokens for s in w.recorder.steps) / w.seconds
