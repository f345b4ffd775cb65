"""PyTorch/CUDA port of the LMetric scheduling stack (``repro``).

Layout mirrors ``repro``: ``core`` (types, radix KV$ index, indicator
factory with a torch device mirror, policies, pipeline, router, state
carry-across), ``kernels`` (``route_score``: a hand-written CUDA kernel
for Hopper plus its plain PyTorch version) and ``workloads`` (trace
generators).  The port imports ``torch`` and ``numpy`` and nothing of
``jax`` or ``repro``.
"""
