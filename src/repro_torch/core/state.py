"""Carry a router's state across from plain numpy/list data.

For this system the state is what weights are to a model: the indicator
columns, each instance's KV$ block chains and the policy's tie counter
decide every later routing decision.  ``router_from_numpy_state`` builds
a port ``Router`` from that state as any other implementation can
export it — for instance the reference ``repro.core`` router's factory
arrays and ``RadixKVIndex.chains()`` — without importing that
implementation.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from .policies import Policy
from .router import Router

COLUMNS = ("r_bs", "q_bs", "queued_prefill_tokens", "total_tokens")


def router_from_numpy_state(policy: Policy, n: int,
                            arrays: Mapping[str, np.ndarray],
                            chains: Sequence[Sequence[Sequence[int]]],
                            tie: int, **router_kw) -> Router:
    """A port ``Router`` over ``n`` instances holding the given state.

    ``arrays`` maps each of ``COLUMNS`` to an (n,) integer array;
    ``chains[i]`` lists instance ``i``'s root→leaf block chains, which
    are inserted into its radix tree in the order given (the aggregated
    index follows through the insert hooks); ``tie`` becomes the
    policy's round-robin tie counter.  ``router_kw`` goes to ``Router``
    (``kv_capacity_tokens``, ``block_size``, ``device``, ...).

    LRU recency is rebuilt from insertion order, not copied: after the
    carry-across, chains inserted later count as more recently used, so
    a later eviction can pick another leaf than the source router would
    have.  ``exact_only`` snapshot boundaries are likewise rebuilt only
    at each chain's end.
    """
    if len(chains) != n:
        raise ValueError(f"chains lists {len(chains)} instances, not {n}")
    router = Router(policy, n, **router_kw)
    f = router.factory
    for i, inst_chains in enumerate(chains):
        kv = f[i].kv
        for chain in inst_chains:
            kv.insert(tuple(chain))
    for name in COLUMNS:
        col = np.asarray(arrays[name])
        if col.shape != (n,):
            raise ValueError(f"{name} must have shape ({n},), "
                             f"got {col.shape}")
        getattr(f, name)[:] = col
    f.mark_dirty()
    policy._tie_n = int(tie)
    return router
