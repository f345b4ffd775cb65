"""What one step ran on the card, from a ``torch.profiler`` trace — the
port's counterpart of ``repro.launch.hlo``.

The reference parses the compiled HLO text of its step (post-SPMD, one
device's shapes) for the collectives' wire bytes and an estimate of the
memory traffic.  The port compiles no HLO: its step is eager PyTorch, so
this module reads what the card actually ran instead, the device events
of a profiler trace of one step (``analyze``): how many device ops, the
device time and count per category (the port's five kernels by their
CUDA functions, GEMMs, collectives, copies and memsets, other), each
port kernel's launches, and the share of the traced wall the device was
busy.

It keeps the reference's ring factors (``_wire_bytes``), with which
``launch.dryrun`` reckons the collectives of a sharded step from its
specs: on one card no collective runs, so none can be traced.

No trip-count correction is needed.  The reference walks XLA's while
loops and multiplies each body by its trip count, because
``cost_analysis`` counts a scanned layer body once; the port's layers
are a Python loop, so the profiler records every op as often as it runs.
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple

import torch

#: bytes per element of each tensor dtype
DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.bfloat16: 2, torch.float16: 2, torch.int32: 4, torch.float32: 4,
    torch.int64: 8, torch.float64: 8, torch.complex64: 8,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: the port's kernels by the names of their CUDA functions, as the
#: profiler reports them (the f32 mlstm_cell runs four)
PORT_KERNELS = {"route_score": ("route_wave", "route_warp", "route_cluster"),
                "prefill_attention": ("prefill_kernel", "prefill_wgmma"),
                "paged_attention": ("paged_kernel",),
                "rglru_scan": ("rglru_kernel",),
                "mlstm_cell": ("cell_wgmma", "gates_kernel", "scores_kernel",
                               "out_kernel", "state_kernel")}

#: the other device categories, tried in this order after the kernels:
#: cuBLAS / cuBLASLt / CUTLASS products, NCCL, copies and memsets
CATEGORIES = (("gemm", re.compile(r"gemm|cutlass|xmma|nvjet|cublas",
                                  re.IGNORECASE)),
              ("collective", re.compile(r"nccl", re.IGNORECASE)),
              ("copy", re.compile(r"memcpy|memset", re.IGNORECASE)))


def _wire_bytes(op: str, size: int, g: int) -> float:
    """Bytes one device sends for a ring collective over ``g`` devices
    whose result is ``size`` bytes on each (the reference's factors)."""
    if g <= 1:
        return 0.0
    if op == "all-gather":
        return size * (g - 1) / g
    if op == "all-reduce":
        return 2.0 * size * (g - 1) / g
    if op == "reduce-scatter":
        return size * (g - 1)
    if op == "all-to-all":
        return size * (g - 1) / g
    return float(size)   # collective-permute


class Event(NamedTuple):
    """One traced activity: device (a kernel, copy or memset on a card,
    ``device`` its index) or host (``device`` None); times in µs."""
    name: str
    device: object
    start_us: float
    dur_us: float


def events(prof) -> List[Event]:
    """The activities of a finished ``torch.profiler.profile``: from the
    raw Kineto events, which keep device activities the profiler could not
    tie to a host call, else from its event list."""
    from torch.autograd import DeviceType
    try:
        raw = prof.profiler.kineto_results.events()
        return [Event(e.name(), e.device_index()
                      if e.device_type() == DeviceType.CUDA else None,
                      e.start_ns() / 1e3, e.duration_ns() / 1e3)
                for e in raw]
    except AttributeError:
        return [Event(e.name, e.device_index
                      if e.device_type == DeviceType.CUDA else None,
                      e.time_range.start, e.time_range.elapsed_us())
                for e in prof.events()]


def category(name: str) -> str:
    """A device activity's category: a port kernel's name, ``gemm``,
    ``collective``, ``copy`` or ``other``."""
    for kernel, fns in PORT_KERNELS.items():
        if any(re.search(rf"(^|[\s:]){f}[<(]", name) for f in fns):
            return kernel
    for cat, pat in CATEGORIES:
        if pat.search(name):
            return cat
    return "other"


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def analyze(prof, n_devices: int) -> Dict:
    """What a trace of one step ran on the card.  ``prof`` is a finished
    ``torch.profiler.profile`` or a list of ``Event``; ``n_devices`` the
    cards the step runs on (a trace of one process sees its own card
    only: events on more cards than that raise).

    Returns ``device_ops`` (device activities counted: the counterpart
    of the reference's ``hlo_ops``), ``categories`` ({category: {"us",
    "count"}} over the port's kernels, ``gemm``, ``collective``,
    ``copy`` and ``other``), ``launches`` (each port kernel's device
    launches, 0 if none), ``device_us`` (summed), ``busy_us`` (the union
    of the device intervals), ``wall_us`` (from the first traced
    activity, host or device, to the end of the last) and
    ``busy_share`` (busy over wall; None for an empty trace)."""
    evs = prof if isinstance(prof, list) else events(prof)
    dev = [e for e in evs if e.device is not None]
    cards = {e.device for e in dev}
    if len(cards) > n_devices:
        raise ValueError(f"device events on cards {sorted(cards)}, more than "
                         f"the step's {n_devices}")
    cats = {k: {"us": 0.0, "count": 0} for k in
            (*PORT_KERNELS, *(c for c, _ in CATEGORIES), "other")}
    for e in dev:
        c = cats[category(e.name)]
        c["us"] += e.dur_us
        c["count"] += 1
    wall = (max(e.start_us + e.dur_us for e in evs)
            - min(e.start_us for e in evs)) if evs else 0.0
    busy = _union_us((e.start_us, e.start_us + e.dur_us) for e in dev)
    return {"device_ops": len(dev), "categories": cats,
            "launches": {k: cats[k]["count"] for k in PORT_KERNELS},
            "device_us": sum(e.dur_us for e in dev), "busy_us": busy,
            "wall_us": wall, "busy_share": busy / wall if wall else None}
