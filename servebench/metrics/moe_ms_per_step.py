"""Device time of the kernels launched inside ``moe_apply`` during decode
steps (the benchmark's ``sb.moe.decode`` range), per traced decode
step."""


def read(ctx):
    n = sum(1 for s in ctx.traced_steps() if s.kind == "decode")
    t = ctx.trace["annotated_s"].get("sb.moe.decode") if ctx.trace else None
    return t * 1e3 / n if n and t else None
