"""PyTorch/CUDA port of the LMetric scheduling stack (``repro``).

Layout mirrors ``repro``: ``core`` (types, radix KV$ index, the flat and
the sharded prefix index with serial, thread and process shard backends,
fault injection and anti-entropy digests, indicator factory with a
per-shard torch device mirror, policies, pipeline with cross-wave walk
speculation, router, state carry-across), ``kernels`` (hand-written CUDA
kernels for Hopper — ``route_score``, ``prefill_attention``,
``paged_attention``, ``rglru_scan``, ``mlstm_cell`` — each beside its
plain PyTorch version), ``models`` and ``configs`` (every model of the
reference, Whisper's encoder-decoder included; ``forward_train``),
``training`` (AdamW, the train step and loop, checkpoints), ``data``
(the synthetic token pipeline), ``launch`` (the single-device training
launcher), ``serving`` (block manager, serving engine), ``cluster``
(serving metrics, the discrete-event cluster simulator and the
PD-disaggregated simulator) and ``workloads`` (trace generators).  The
port imports ``torch`` and ``numpy`` and nothing of ``jax`` or
``repro``.
"""
