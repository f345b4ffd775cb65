"""The paged decode attention kernel's least time over its device time,
over the profiled decode steps: per launch the larger of its bytes at
the HBM rate and its operations at the bf16 rate (``flops.paged_bound``
of every slot's context, pages of 16 rows), one launch per layer and
step."""
from servebench import flops

KERNELS = ("paged_kernel",)
PAGE = 16


def read(ctx):
    m = ctx.shape
    steps = [s for s in ctx.traced_steps() if s.kind == "decode"]
    dev = ctx.kernel_seconds(KERNELS)
    if not steps or not dev:
        return None
    ctx.expect_launches("paged_attention", len(steps) * m["n_layers"])
    least = sum(flops.min_seconds(*flops.paged_bound(
        s.ctx.tolist(), PAGE, m["n_heads"], m["n_kv_heads"], m["head_dim"]))
        for s in steps) * m["n_layers"]
    return 100.0 * least / dev
