"""Fused batch-routing score loop: one arrival wave, one device call.

Port of ``repro.kernels.route_score``.  A wave of ``k`` requests is
routed over ``n`` instances as a *sequential argmin with feedback*:
request ``j``'s score depends on the indicator updates (``q_bs``,
``queued_prefill_tokens``, ``total_tokens``) and on the KV$ blocks that
requests ``0..j-1`` of the same wave will insert, so the loop runs in
order — but it runs entirely on the device over the factory's mirrored
indicator columns.

Inputs: the mirror columns ``rbs``/``qbs``/``qpt``/``tt`` (n,), the
pre-wave aggregated-index hit depths ``depth`` (k, n), the pairwise
intra-wave LCP matrix ``lcp`` (k, k) of the wave's block chains, the
prompt lengths ``plen`` (k,) and the policy's tie counter ``tie0`` for
the wave's first request (request ``j`` uses ``tie0 + j``; the counter
itself is consumed by the router, one value per committed decision).
After request ``j'`` is assigned to instance ``i``, later requests see
``depth[j, i] = max(depth[j, i], lcp[j, j'])`` — exactly what the radix
walk would return once ``j'``'s chain is inserted, provided no eviction
fires mid-wave (the router guards that).

Every kind scores in float64 with the exact operation order of the
numpy policies in ``repro_torch.core.policies``, so decisions are
bit-identical to sequential host routing — on the card too, since the
H100 has native float64 and the kernel is built with ``-fmad=false``.

Policy kinds
------------
``jsq``      4*Q-BS + R-BS                                 (vLLM Fig. 6a)
``linear``   λ(1 − hit/L) + (1−λ)(BS/max BS)               (Fig. 6b)
``filter``   BS-range filter then max-hit candidates       (Fig. 13)
``lmetric``  (P-token + 1) × (BS + 1) and §5.1 ablations   (Fig. 17b)
``ptoken``   raw P-token, first-min selection (PD-disagg prefill pool)

All five run in one templated CUDA kernel (``csrc/route_score.cu``), one
launch per wave, for mirror tensors on a CUDA device.  ``route_wave_ref``
is the plain PyTorch loop over ``j`` — the kernel's yardstick, and what
the wrapper runs when the mirror lies on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

_EPS = 1e-9  # keep in sync with repro_torch.core.policies._EPS

KINDS = ("jsq", "linear", "filter", "lmetric", "ptoken")
_LMETRIC_KV = ("ptoken", "one_minus_hit")
_LMETRIC_LOAD = ("bs", "tokens")

#: kernel launches since the last reset — one per wave routed on a card
LAUNCHES = 0


def _check_params(kind: str, params: tuple):
    if kind not in KINDS:
        raise ValueError(f"unknown route_score kind {kind!r}")
    if kind == "lmetric":
        if (len(params) != 2 or params[0] not in _LMETRIC_KV
                or params[1] not in _LMETRIC_LOAD):
            raise ValueError(f"lmetric params must be (kv, load) in "
                             f"{_LMETRIC_KV} x {_LMETRIC_LOAD}, got {params}")
    elif kind in ("linear", "filter"):
        if len(params) != 1:
            raise ValueError(f"{kind} takes one parameter, got {params}")
    elif params:
        raise ValueError(f"{kind} takes no parameters, got {params}")


def _pack_aux(lcp, plen, tie0) -> np.ndarray:
    """(lcp | plen | tie) as one (k, k+2) int64 buffer — one transfer
    for all per-request wave data (lcp None packs zeros)."""
    k = len(plen)
    aux = np.zeros((k, k + 2), dtype=np.int64)
    if lcp is not None:
        aux[:, :k] = np.asarray(lcp)
    aux[:, k] = np.asarray(plen)
    aux[:, k + 1] = tie0 + np.arange(k)
    return aux


def _columns(rbs, qbs, qpt, tt):
    """The four mirror columns as int64 tensors on one device (numpy
    arrays are taken as CPU tensors)."""
    cols = tuple(torch.as_tensor(c) for c in (rbs, qbs, qpt, tt))
    n = cols[0].shape[0] if cols[0].dim() == 1 else -1
    for c in cols:
        if c.dtype != torch.int64 or c.dim() != 1 or c.shape[0] != n:
            raise ValueError("rbs/qbs/qpt/tt must be int64 vectors of one "
                             f"length, got {c.dtype} {tuple(c.shape)}")
        if c.device != cols[0].device:
            raise ValueError("rbs/qbs/qpt/tt lie on different devices")
        if not c.is_contiguous():
            raise ValueError("rbs/qbs/qpt/tt must be contiguous")
    return cols


def _check_wave(kind: str, k: int, n: int, depth, lcp):
    """Shapes of the wave inputs.  jsq scores no hits, so it may be given
    no depth matrix and no lcp (None)."""
    if (depth is None or lcp is None) and kind != "jsq":
        raise ValueError(f"{kind} scores KV$ hits: depth and lcp are "
                         "required")
    if depth is not None and tuple(depth.shape) != (k, n):
        raise ValueError(f"depth must be ({k}, {n}), got "
                         f"{tuple(depth.shape)}")
    if lcp is not None and tuple(np.shape(lcp)) != (k, k):
        raise ValueError(f"lcp must be ({k}, {k}), got {np.shape(lcp)}")


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU tensors, tests, the kernel's yardstick)
# ---------------------------------------------------------------------------
def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64)


def _pick(scores, allowed, tie, eps):
    """argmin with epsilon-tie round-robin over an allowed mask: the
    ``(tie mod count)``-th tie in ascending index order."""
    if allowed is None:
        best = scores.min()
        ties = scores <= best + eps
    else:
        best = torch.where(allowed, scores, torch.inf).min()
        ties = allowed & (scores <= best + eps)
    csum = torch.cumsum(ties.to(torch.int64), 0)
    r = torch.remainder(tie, csum[-1])
    return torch.argmax((ties & (csum == r + 1)).to(torch.int32))


def route_wave_ref(kind: str, params: tuple, block_size: int,
                   rbs, qbs, qpt, tt, depth, lcp, plen, tie0: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The wave loop as plain PyTorch ops on the device of ``rbs`` (the
    CPU for numpy input), mirroring the reference ``_wave_step`` step by
    step.  ``depth`` and ``lcp`` may be None for jsq, which scores no
    hits.  Returns (assignments, hit tokens) as numpy int64 arrays."""
    _check_params(kind, params)
    rbs, qbs, qpt, tt = _columns(rbs, qbs, qpt, tt)
    dev = rbs.device
    k, n = len(plen), rbs.shape[0]
    _check_wave(kind, k, n, depth, lcp)
    aux = torch.as_tensor(_pack_aux(lcp, plen, tie0), device=dev)
    lcp_t, plen_t, tie_t = aux[:, :k], aux[:, k], aux[:, k + 1]
    needs_hits = kind != "jsq"
    needs_qpt = kind == "ptoken" or (kind == "lmetric"
                                     and params[0] == "ptoken")
    needs_tt = kind == "lmetric" and params[1] == "tokens"
    qbs, qpt, tt = qbs.clone(), qpt.clone(), tt.clone()
    if needs_hits:
        depth = torch.as_tensor(depth, dtype=torch.int64, device=dev)
        cred = torch.zeros((k, n), dtype=torch.int64, device=dev)
    sel = torch.full((k,), -1, dtype=torch.int64, device=dev)
    hit = torch.zeros((k,), dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(k):
        plen_j = plen_t[j]
        if needs_hits:
            d = torch.maximum(depth[j], cred[j])
            hits = torch.minimum(d * block_size, plen_j)
        else:
            hits = zero
        bs = rbs + qbs
        allowed = None
        eps = _EPS
        if kind == "jsq":
            scores = 4.0 * _f64(qbs) + _f64(rbs)
        elif kind == "linear":
            (lam,) = params
            max_bs = torch.clamp_min(bs.max(), 1)
            L = torch.clamp_min(plen_j, 1)
            scores = lam * (1.0 - _f64(hits) / _f64(L)) \
                + (1.0 - lam) * (_f64(bs) / _f64(max_bs))
        elif kind == "filter":
            (bs_range,) = params
            imbalanced = (bs.max() - bs.min()) > bs_range
            allowed = imbalanced | (hits >= hits.max())
            scores = _f64(bs)
        elif kind == "lmetric":
            kv_indicator, load_indicator = params
            if kv_indicator == "ptoken":
                a = _f64(qpt + (plen_j - hits)) + 1.0
            else:                                     # "one_minus_hit"
                L = torch.clamp_min(plen_j, 1)
                a = 1.0 - _f64(hits) / _f64(L) + 1e-3
            if load_indicator == "bs":
                b = _f64(bs) + 1.0
            else:                                     # "tokens"
                b = _f64(tt) + 1.0
            scores = a * b
        else:                                         # "ptoken"
            scores = _f64(qpt + (plen_j - hits))
            eps = 0.0
        tie_j = zero if kind == "ptoken" else tie_t[j]
        sel_j = _pick(scores, allowed, tie_j, eps)
        hit_j = hits[sel_j] if needs_hits else zero
        qbs[sel_j] += 1
        if needs_qpt:
            qpt[sel_j] += plen_j - hit_j
        if needs_tt:
            tt[sel_j] += plen_j
        if needs_hits:
            cred[:, sel_j] = torch.maximum(cred[:, sel_j], lcp_t[:, j])
            hit[j] = hit_j
        sel[j] = sel_j
    return sel.cpu().numpy(), hit.cpu().numpy()


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/route_score.cu)
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.load("route_score")
    fn = lib.route_score_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [_P] * 9
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_double, ctypes.c_longlong, _P])
        fn.restype = ctypes.c_int
    return lib


def _to_device(x, dev: torch.device) -> torch.Tensor:
    """Host int64 array → ``dev`` through pinned memory, non-blocking (a
    tensor already on ``dev`` passes through; the launch validates it)."""
    if isinstance(x, torch.Tensor) and x.device == dev:
        return x
    t = torch.as_tensor(np.ascontiguousarray(x, dtype=np.int64))
    return t.pin_memory().to(dev, non_blocking=True)


class _Pending:
    """Handle of a submitted wave: host outputs plus the event that says
    they are filled (None when the plain version already ran)."""

    __slots__ = ("sel", "hit", "event")

    def __init__(self, sel, hit, event: Optional[torch.cuda.Event]):
        self.sel = sel
        self.hit = hit
        self.event = event


def route_wave_device(kind: str, params: tuple, block_size: int,
                      cols, depth: Optional[torch.Tensor],
                      aux: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on wave inputs already on the card: ``cols`` are
    the four mirror columns, ``depth`` the (k, n) depth matrix (None for
    jsq) and ``aux`` the (k, k+2) packed buffer of ``_pack_aux``.  Returns
    the (sel, hit) device tensors; nothing is synchronised."""
    global LAUNCHES
    _check_params(kind, params)
    rbs = cols[0]
    dev = rbs.device
    if dev.type != "cuda":
        raise ValueError(f"route_wave_device launches on CUDA tensors, "
                         f"got {dev}")
    k, n = aux.shape[0], rbs.shape[0]
    for t in (*cols, aux) + (() if kind == "jsq" else (depth,)):
        if (t.device != dev or t.dtype != torch.int64
                or not t.is_contiguous()):
            raise ValueError("route_score inputs must be contiguous int64 "
                             f"tensors on {dev}")
    if tuple(aux.shape) != (k, k + 2) or (
            kind != "jsq" and tuple(depth.shape) != (k, n)):
        raise ValueError("route_score: aux must be (k, k+2) and depth "
                         "(k, n)")
    if n >= 2 ** 31 or k >= 2 ** 31:
        raise ValueError(f"wave too large for the kernel: k={k}, n={n}")
    fn = _lib().route_score_launch
    lam = float(params[0]) if kind == "linear" else 0.0
    bs_range = int(params[0]) if kind == "filter" else 0
    kv_ptoken = int(kind == "lmetric" and params[0] == "ptoken")
    load_tokens = int(kind == "lmetric" and params[1] == "tokens")
    with torch.cuda.device(dev):
        # qbs/qpt/tt working copies, the credit row and the score row
        work = torch.empty((5, n), dtype=torch.int64, device=dev)
        sel = torch.empty(k, dtype=torch.int64, device=dev)
        hit = torch.empty(k, dtype=torch.int64, device=dev)
        rc = fn(KINDS.index(kind), kv_ptoken, load_tokens,
                *(c.data_ptr() for c in cols),
                None if kind == "jsq" else depth.data_ptr(),
                aux.data_ptr(), work.data_ptr(), sel.data_ptr(),
                hit.data_ptr(), k, n, int(block_size), lam, bs_range,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"route_score kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    return sel, hit


def _launch(kind, params, block_size, cols, depth, lcp, plen, tie0
            ) -> _Pending:
    dev = cols[0].device
    k = len(plen)
    if k == 0:
        empty = np.zeros(0, dtype=np.int64)
        return _Pending(empty, empty, None)
    with torch.cuda.device(dev):
        aux = _to_device(_pack_aux(lcp, plen, tie0), dev)
        # jsq scores no hits: its depth matrix is never uploaded
        depth_d = None if kind == "jsq" else _to_device(depth, dev)
        sel, hit = route_wave_device(kind, params, block_size, cols,
                                     depth_d, aux)
        stream = torch.cuda.current_stream(dev)
        sel_h = torch.empty(k, dtype=torch.int64, pin_memory=True)
        hit_h = torch.empty(k, dtype=torch.int64, pin_memory=True)
        sel_h.copy_(sel, non_blocking=True)
        hit_h.copy_(hit, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return _Pending(sel_h, hit_h, done)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def route_wave_submit(kind: str, params: tuple, block_size: int,
                      rbs, qbs, qpt, tt, depth, lcp, plen, tie0: int
                      ) -> _Pending:
    """Start a wave and return a handle — the score-stage boundary.

    jsq may pass ``depth`` and ``lcp`` as None (it scores no hits).
    With the mirror columns on a CUDA device this uploads ``depth`` (not
    for jsq) and the packed ``(lcp | plen | tie)`` buffer through pinned
    memory, launches the kernel on the current stream, queues the copy
    of the results into pinned host memory and records an event; it
    returns without waiting, so host work can run before
    :func:`route_wave_collect`.  With the columns on the CPU the plain
    version runs here and the handle is already complete."""
    _check_params(kind, params)
    cols = _columns(rbs, qbs, qpt, tt)
    k, n = len(plen), cols[0].shape[0]
    _check_wave(kind, k, n, depth, lcp)
    dev = cols[0].device
    if dev.type == "cpu":
        return _Pending(*route_wave_ref(kind, params, block_size, *cols,
                                        depth, lcp, plen, tie0), None)
    if dev.type != "cuda":
        raise ValueError(f"route_score runs on cuda or cpu, not {dev}")
    return _launch(kind, params, block_size, cols, depth, lcp, plen, tie0)


def route_wave_collect(handle: _Pending) -> Tuple[np.ndarray, np.ndarray]:
    """Wait for a :func:`route_wave_submit` handle; returns the wave's
    (assignments, hit tokens) as host numpy arrays."""
    if handle.event is not None:
        handle.event.synchronize()
        return handle.sel.numpy(), handle.hit.numpy()
    return handle.sel, handle.hit


def route_wave(kind: str, params: tuple, block_size: int,
               rbs, qbs, qpt, tt, depth, lcp, plen, tie0: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Route a whole wave; submit + collect in one breath."""
    return route_wave_collect(route_wave_submit(
        kind, params, block_size, rbs, qbs, qpt, tt, depth, lcp, plen,
        tie0))
