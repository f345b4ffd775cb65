"""The prefill attention kernel's least time over its device time, over
the profiled steps: per launch the larger of its bytes at the HBM rate
and its operations at the bf16 rate (``flops.prefill_bound`` of the
chunk and its cached keys), one launch per layer and chunk."""
from servebench import flops

KERNELS = ("prefill_wgmma", "prefill_kernel")


def read(ctx):
    m = ctx.shape
    steps = [s for s in ctx.traced_steps() if s.kind == "prefill"]
    dev = ctx.kernel_seconds(KERNELS)
    if not steps or not dev:
        return None
    ctx.expect_launches("prefill_attention", len(steps) * m["n_layers"])
    least = sum(flops.min_seconds(*flops.prefill_bound(
        s.prefill, s.start, m["n_heads"], m["n_kv_heads"], m["head_dim"]))
        for s in steps) * m["n_layers"]
    return 100.0 * least / dev
