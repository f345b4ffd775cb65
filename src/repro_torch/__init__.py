"""PyTorch/CUDA port of the LMetric scheduling stack (``repro``).

Layout mirrors ``repro``: ``core`` (types, radix KV$ index, indicator
factory with a torch device mirror, policies, pipeline, router, state
carry-across), ``kernels`` (hand-written CUDA kernels for Hopper —
``route_score``, ``prefill_attention``, ``paged_attention`` — each beside
its plain PyTorch version), ``models`` and ``configs`` (the dense
attention-only models the engine serves), ``serving`` (block manager,
serving engine), ``cluster`` (serving metrics, the discrete-event
cluster simulator and the PD-disaggregated simulator) and ``workloads``
(trace generators).  The port imports ``torch`` and ``numpy`` and nothing of
``jax`` or ``repro``.
"""
