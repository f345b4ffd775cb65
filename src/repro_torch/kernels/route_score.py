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

All five run in templated CUDA kernels (``csrc/route_score.cu``), one
launch per wave, for mirror tensors on a CUDA device: one warp for waves
over at most 32 instances, else a thread-block cluster of up to 8 CTAs
(:func:`launch_plan`).  ``route_wave_ref`` is the plain PyTorch loop over
``j`` — the kernel's yardstick, and what the wrapper runs when the mirror
lies on the CPU; ``route_wave_split_ref`` spells the cluster's exchange
(per-part min, tie count and rank search in part order) in plain PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

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


def _pack_aux(lcp, plen, tie0, out: Optional[np.ndarray] = None
              ) -> np.ndarray:
    """(lcp | plen | tie) as one (k, k+2) int64 buffer — one transfer
    for all per-request wave data (lcp None packs zeros).  ``out``, a
    (k, k+2) int64 array, is filled in place instead of a new one."""
    k = len(plen)
    if out is None:
        aux = np.zeros((k, k + 2), dtype=np.int64)
    else:
        aux = out
        if lcp is None:
            aux[:, :k] = 0
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


#: the launch regimes of ``csrc/route_score.cu``: one warp up to
#: WARP_MAX instances (lane i holds instance i); else a cluster of up to
#: CLUSTER_MAX CTAs (the portable size), one more CTA for every
#: CTA_INSTANCES instances, of at most MAX_THREADS threads each
WARP_MAX = 32
CLUSTER_MAX = 8
CTA_INSTANCES = 1024
MAX_THREADS = 512
#: instances per thread the cluster kernel keeps in registers: up to 4 in
#: a CTA of up to MAX_THREADS threads (128 registers a thread), up to
#: REG_IPT in one of 256 (255 registers); a CTA's instances beyond that
#: keep their working copies in global scratch
REG_IPT = 16


def launch_plan(k: int, n: int) -> Tuple[int, int, int]:
    """(cluster size, threads per CTA, instances per thread) of the
    kernel launch for a wave of ``k`` requests over ``n`` instances.

    n <= WARP_MAX: (1, 32, 1), the warp path.  Otherwise C =
    ceil(n / CTA_INSTANCES) CTAs, at most CLUSTER_MAX; CTA c owns the
    contiguous instances [c*P, min((c+1)*P, n)) with P = ceil(n / C),
    and each of its threads owns ceil(P / threads) of them, strided by
    the thread count: P rounded up to a warp, at most MAX_THREADS, while
    that leaves at most 4 a thread, else 256 threads.  The plan does not
    depend on ``k``: the wave's length only decides, inside the launch,
    whether its (k, k+2) aux buffer is staged in shared memory."""
    if k < 0 or n < 0:
        raise ValueError(f"wave shape must be non-negative, got k={k}, "
                         f"n={n}")
    if n <= WARP_MAX:
        return 1, 32, 1
    c = min(CLUSTER_MAX, -(-n // CTA_INSTANCES))
    part = -(-n // c)
    threads = (min(MAX_THREADS, -(-part // 32) * 32)
               if part <= 4 * MAX_THREADS else 256)
    return c, threads, -(-part // threads)


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


def route_wave_split_ref(kind: str, params: tuple, block_size: int,
                         rbs, qbs, qpt, tt, depth, lcp, plen, tie0: int,
                         parts: int) -> Tuple[np.ndarray, np.ndarray]:
    """The wave loop with the cluster kernel's exchange, in plain PyTorch.

    The instances are cut into ``parts`` contiguous ranges of
    ceil(n / parts) (the last shorter, or empty), as the CTAs of a
    cluster own them, and every step combines per-part results in part
    order: for linear and filter the parts' largest and least
    ``rbs + qbs`` and largest hit; then each part's least score; then
    each part's count of (allowed) scores at or under the global least +
    eps.  The (tie mod total)-th tie lies in the first part whose running
    count passes it, where it is found in ascending index order.  ptoken
    (eps 0, tie 0) takes one round: the least (score, index) pair over
    the parts' first least scores.  Feedback as in :func:`route_wave_ref`,
    whose results this must equal for any ``parts``."""
    _check_params(kind, params)
    if parts < 1:
        raise ValueError(f"parts must be >= 1, got {parts}")
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
    size = -(-n // parts)
    ranges = [(min(c * size, n), min((c + 1) * size, n))
              for c in range(parts)]
    ranges = [(lo, hi) for lo, hi in ranges if hi > lo]
    sel = np.full(k, -1, dtype=np.int64)
    hit = np.zeros(k, dtype=np.int64)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    eps = 0.0 if kind == "ptoken" else _EPS
    for j in range(k):
        plen_j = plen_t[j]
        if needs_hits:
            hits = torch.minimum(torch.maximum(depth[j], cred[j])
                                 * block_size, plen_j)
        else:
            hits = torch.zeros(n, dtype=torch.int64, device=dev)
        bs = rbs + qbs
        # round 1 (linear, filter): the parts' extremes in part order
        if kind in ("linear", "filter"):
            mx = max(int(bs[lo:hi].max()) for lo, hi in ranges)
            mn = min(int(bs[lo:hi].min()) for lo, hi in ranges)
            mh = max(int(hits[lo:hi].max()) for lo, hi in ranges)
        allowed = None
        if kind == "jsq":
            scores = 4.0 * _f64(qbs) + _f64(rbs)
        elif kind == "linear":
            (lam,) = params
            L = torch.clamp_min(plen_j, 1)
            scores = lam * (1.0 - _f64(hits) / _f64(L)) \
                + (1.0 - lam) * (_f64(bs) / float(max(mx, 1)))
        elif kind == "filter":
            (bs_range,) = params
            allowed = (hits >= mh) | ((mx - mn) > bs_range)
            scores = _f64(bs)
        elif kind == "lmetric":
            kv_indicator, load_indicator = params
            if kv_indicator == "ptoken":
                a = _f64(qpt + (plen_j - hits)) + 1.0
            else:
                L = torch.clamp_min(plen_j, 1)
                a = 1.0 - _f64(hits) / _f64(L) + 1e-3
            b = _f64(bs) + 1.0 if load_indicator == "bs" else _f64(tt) + 1.0
            scores = a * b
        else:
            scores = _f64(qpt + (plen_j - hits))
        if allowed is not None:
            scores = torch.where(allowed, scores, torch.inf)
        # round 2: each part's least score (ptoken: its first least)
        if kind == "ptoken":
            pairs = [(float(scores[lo:hi].min()),
                      lo + int(torch.argmin(scores[lo:hi])))
                     for lo, hi in ranges]
            sel_j = min(pairs)[1]
        else:
            best = min(float(scores[lo:hi].min()) for lo, hi in ranges)
            ties = scores <= best + eps
            # round 3: each part's tie count, then the rank-r tie
            counts = [int(ties[lo:hi].sum()) for lo, hi in ranges]
            r = int(tie_t[j]) % sum(counts)
            for (lo, hi), cnt in zip(ranges, counts):
                if r < cnt:
                    sel_j = lo + int(torch.nonzero(ties[lo:hi])[r, 0])
                    break
                r -= cnt
        hit_j = hits[sel_j] if needs_hits else zero
        qbs[sel_j] += 1
        if needs_qpt:
            qpt[sel_j] += plen_j - hit_j
        if needs_tt:
            tt[sel_j] += plen_j
        if needs_hits:
            cred[:, sel_j] = torch.maximum(cred[:, sel_j], lcp_t[:, j])
            hit[j] = int(hit_j)
        sel[j] = sel_j
    return sel, hit


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
                          ctypes.c_double, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_int, _P])
        fn.restype = ctypes.c_int
    return lib


def _scratch_words(k: int, n: int, cluster: int) -> int:
    """int64 words of the kernel's global scratch: working copies, two
    credit rows and a score row of the instances a CTA keeps off chip
    (6 x n), and one list of its own selections per CTA (k pairs of int32
    each), used where it does not fit in shared memory."""
    return 6 * n + cluster * k


class _Pending:
    """Handle of a submitted wave: host outputs plus the event that says
    they are filled (None once they are copied out of the shared pinned
    buffer, or when the plain version already ran)."""

    __slots__ = ("sel", "hit", "event")

    def __init__(self, sel, hit, event: Optional[torch.cuda.Event]):
        self.sel = sel
        self.hit = hit
        self.event = event

    def settle(self):
        """Wait for the wave and copy its results out of the pinned
        buffer that the next wave on its stream reuses."""
        if self.event is not None:
            self.event.synchronize()
            self.sel = self.sel.numpy().copy()
            self.hit = self.hit.numpy().copy()
            self.event = None


class _Buffers:
    """The launch path's buffers on one (device, stream), grown on demand
    and reused by every wave: pinned staging of the upload (aux, then
    depth) and of the results, their device twins, the kernel's scratch,
    and the last wave's handle and event, which guard the reuse."""

    __slots__ = ("up_host", "up_dev", "out_host", "out_dev", "work",
                 "event", "last")

    def __init__(self):
        self.up_host = self.up_dev = self.out_host = self.out_dev = None
        self.work = None
        self.event = torch.cuda.Event()
        self.last: Optional[_Pending] = None


_BUFFERS: Dict[Tuple[torch.device, int], _Buffers] = {}


def _buffers(dev: torch.device, stream) -> _Buffers:
    key = (dev, stream.cuda_stream)
    b = _BUFFERS.get(key)
    if b is None:
        b = _BUFFERS[key] = _Buffers()
    return b


def _grown(t: Optional[torch.Tensor], words: int,
           dev: Optional[torch.device] = None) -> torch.Tensor:
    """``t`` if it holds ``words`` int64, else a new flat buffer of at
    least that many and twice the old (pinned host memory when ``dev`` is
    None, else memory on ``dev``)."""
    if t is not None and t.numel() >= words:
        return t
    words = max(words, 2 * (0 if t is None else t.numel()), 1)
    if dev is None:
        return torch.empty(words, dtype=torch.int64, pin_memory=True)
    return torch.empty(words, dtype=torch.int64, device=dev)


def route_wave_device(kind: str, params: tuple, block_size: int,
                      cols, depth: Optional[torch.Tensor],
                      aux: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on wave inputs already on the card: ``cols`` are
    the four mirror columns, ``depth`` the (k, n) depth matrix (None for
    jsq) and ``aux`` the (k, k+2) packed buffer of ``_pack_aux``.
    Launches with :func:`launch_plan`'s regime on the current stream,
    with the scratch cached for that stream.  Returns the (sel, hit)
    device tensors; nothing is synchronised."""
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
    out = torch.empty((2, k), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev)
    _kernel(kind, params, block_size, cols, depth, aux, out, k, n, stream,
            _buffers(dev, stream))
    return out[0], out[1]


def _kernel(kind, params, block_size, cols, depth, aux, out, k, n, stream,
            b: _Buffers):
    """One counted launch on ``stream`` with ``b``'s scratch; the inputs
    are already checked.  Raises if the launch is refused."""
    global LAUNCHES
    cluster, threads, _ = launch_plan(k, n)
    b.work = _grown(b.work, _scratch_words(k, n, cluster), aux.device)
    lam = float(params[0]) if kind == "linear" else 0.0
    bs_range = int(params[0]) if kind == "filter" else 0
    kv_ptoken = int(kind == "lmetric" and params[0] == "ptoken")
    load_tokens = int(kind == "lmetric" and params[1] == "tokens")
    res = out.data_ptr()
    rc = _lib().route_score_launch(
        KINDS.index(kind), kv_ptoken, load_tokens,
        *(c.data_ptr() for c in cols),
        None if kind == "jsq" else depth.data_ptr(), aux.data_ptr(),
        b.work.data_ptr(), res, res + 8 * k, k, n, int(block_size), lam,
        bs_range, cluster, threads, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"route_score kernel launch failed: "
                           f"cudaError {rc} (k={k}, n={n}, cluster "
                           f"{cluster} x {threads} threads)")
    LAUNCHES += 1


def _launch(kind, params, block_size, cols, depth, lcp, plen, tie0
            ) -> _Pending:
    """One pinned upload of (aux | depth), the launch, one copy of (sel |
    hit) back into pinned memory and an event, all on buffers cached for
    the current stream.  The previous wave on that stream is settled
    first (waited for and its results copied out), since its staging and
    outputs are reused."""
    dev = cols[0].device
    k, n = len(plen), cols[0].shape[0]
    if k == 0:
        empty = np.zeros(0, dtype=np.int64)
        return _Pending(empty, empty, None)
    if n >= 2 ** 31 or k >= 2 ** 31:
        raise ValueError(f"wave too large for the kernel: k={k}, n={n}")
    # jsq scores no hits: its depth matrix is never uploaded; one already
    # on the card is used where it lies
    staged = kind != "jsq" and not (isinstance(depth, torch.Tensor)
                                    and depth.device == dev)
    if kind != "jsq" and not staged and (depth.dtype != torch.int64
                                         or not depth.is_contiguous()):
        raise ValueError("route_score: a depth matrix on the card must be "
                         "a contiguous int64 tensor")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        b = _buffers(dev, stream)
        if b.last is not None:
            b.last.settle()
            b.last = None
        na, nd = k * (k + 2), k * n if staged else 0
        b.up_host = _grown(b.up_host, na + nd)
        b.up_dev = _grown(b.up_dev, na + nd, dev)
        b.out_host = _grown(b.out_host, 2 * k)
        b.out_dev = _grown(b.out_dev, 2 * k, dev)
        host = b.up_host.numpy()
        _pack_aux(lcp, plen, tie0, out=host[:na].reshape(k, k + 2))
        if staged:
            host[na:na + nd].reshape(k, n)[...] = np.asarray(depth)
        up = b.up_dev[:na + nd]
        up.copy_(b.up_host[:na + nd], non_blocking=True)
        depth_d = (None if kind == "jsq" else
                   up[na:].view(k, n) if staged else depth)
        out = b.out_dev[:2 * k]
        _kernel(kind, params, block_size, cols, depth_d, up[:na], out, k, n,
                stream, b)
        res = b.out_host[:2 * k]
        res.copy_(out, non_blocking=True)
        b.event.record(stream)
        b.last = _Pending(res[:k], res[k:], b.event)
    return b.last


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def route_wave_submit(kind: str, params: tuple, block_size: int,
                      rbs, qbs, qpt, tt, depth, lcp, plen, tie0: int
                      ) -> _Pending:
    """Start a wave and return a handle — the score-stage boundary.

    jsq may pass ``depth`` and ``lcp`` as None (it scores no hits).
    With the mirror columns on a CUDA device this packs ``(lcp | plen |
    tie)`` and ``depth`` (not for jsq) into one pinned buffer and uploads
    it in one copy, launches the kernel on the current stream, queues one
    copy of (sel | hit) into pinned host memory and records an event; it
    returns without waiting, so host work can run before
    :func:`route_wave_collect`.  The buffers are cached per device and
    stream, so a second submit on the same stream first waits for the
    outstanding wave and copies its results out.  With the columns on
    the CPU the plain version runs here and the handle is already
    complete."""
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
    (assignments, hit tokens) as host numpy arrays of its own."""
    handle.settle()
    return handle.sel, handle.hit


def route_wave(kind: str, params: tuple, block_size: int,
               rbs, qbs, qpt, tt, depth, lcp, plen, tie0: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Route a whole wave; submit + collect in one breath."""
    return route_wave_collect(route_wave_submit(
        kind, params, block_size, rbs, qbs, qpt, tt, depth, lcp, plen,
        tie0))
