"""RG-LRU linear recurrence — port of ``repro.kernels.rglru_scan``
(``rglru_scan``).

``h_t = a_t * h_{t-1} + x_t`` over the sequence, per (batch, channel),
from a given ``h0``, in float32.  Returns every ``h_t`` and the carry at
the true last position.  The RG-LRU block's prefill (``models.recurrent.
rglru_prefill``) runs it with ``h0`` taken from the block's state.

For tensors on a CUDA device :func:`rglru_scan` launches the
hand-written kernel ``csrc/rglru_scan.cu``, a sequence-parallel scan in
one launch: each block owns a tile of channels and the whole sequence,
split into segments that are scanned from 0, chained in order through
shared memory and rescanned from their true carry-in
(:func:`segment_plan` picks the tile and the segments;
:func:`rglru_scan_segmented_plain` is that arithmetic in plain PyTorch).
For CPU tensors it runs :func:`rglru_scan_plain`, the sequential f32 scan
of the reference's oracle ``ref.rglru_scan_ref`` as plain PyTorch ops —
the kernel's yardstick on the card and the CPU tests' subject.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, forward_only

#: kernel launches since the last reset (CUDA tensors only)
LAUNCHES = 0

#: threads per block, and positions a thread holds in registers
#: (``csrc/rglru_scan.cu``)
THREADS = 256
SEGMAX = 16
#: channel groups per block to choose from, widest tile first
_GROUPS = (16, 8, 4, 2)


def _check(a, x, h0):
    if a.dim() != 3 or tuple(x.shape) != tuple(a.shape):
        raise ValueError("rglru_scan: a and x must be one (B, S, D) shape, "
                         f"got {tuple(a.shape)}, {tuple(x.shape)}")
    B, _, D = a.shape
    if tuple(h0.shape) != (B, D):
        raise ValueError(f"rglru_scan: h0 must be (B, D) = {(B, D)}, got "
                         f"{tuple(h0.shape)}")
    if not (a.device == x.device == h0.device):
        raise ValueError("rglru_scan: inputs lie on different devices")


def rglru_scan_plain(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The function as plain PyTorch ops: one f32 step per position."""
    a, x = a.float(), x.float()
    h = h0.float()
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + x[:, t]
        out[:, t] = h
    return out, h


def segment_plan(B: int, S: int, D: int, n_sm: int, aligned: bool = True
                 ) -> dict:
    """The kernel's launch plan for (B, S, D) on a card of ``n_sm`` SMs.

    ``vec`` channels per thread (4, one 16-byte load, when D % 4 == 0 and
    every tensor is 16-byte aligned; else 1); ``groups`` channel groups x
    ``P`` segments = ``THREADS`` threads per block; ``CT = groups * vec``
    channels per block; ``seg`` positions per segment, at most ``SEGMAX``
    (a longer sequence runs in ``windows`` of ``P * seg``); the grid
    (channel tiles, B).  The widest tile whose grid still covers 3/4 of
    the SMs is taken, since fewer segments make a shorter carry chain;
    else the narrowest."""
    vec = 4 if D % 4 == 0 and aligned else 1
    groups = _GROUPS[-1]
    for g in _GROUPS:
        if 4 * B * -(-D // (g * vec)) >= 3 * n_sm:
            groups = g
            break
    P = THREADS // groups
    seg = max(1, min(SEGMAX, -(-S // P)))
    CT = groups * vec
    return dict(vec=vec, groups=groups, P=P, seg=seg, CT=CT,
                windows=-(-S // (P * seg)), grid=(-(-D // CT), B))


def rglru_scan_segmented_plain(a: torch.Tensor, x: torch.Tensor,
                               h0: torch.Tensor, P: int,
                               seg: Optional[int] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's order of arithmetic as plain PyTorch ops (f32).

    The sequence runs in windows of ``P * seg`` positions (``seg``
    defaults to ceil(S / P): one window), each cut into ``P`` segments.
    Each segment is scanned from 0, keeping (prod a, h_local); the
    carries are chained in segment order from the window's carry-in; each
    segment is rescanned from its carry-in.  The next window's carry-in
    is the rescanned h at this window's last position."""
    a, x = a.float(), x.float()
    B, S, D = a.shape
    seg = seg or max(1, -(-S // P))
    out = torch.empty_like(a)
    carry = h0.float().clone()
    for w0 in range(0, S, P * seg):
        n = min(P * seg, S - w0)
        pad = P * seg - n
        aw = torch.cat([a[:, w0:w0 + n], a.new_ones((B, pad, D))],
                       1).view(B, P, seg, D)
        xw = torch.cat([x[:, w0:w0 + n], x.new_zeros((B, pad, D))],
                       1).view(B, P, seg, D)
        prod = a.new_ones((B, P, D))
        loc = a.new_zeros((B, P, D))
        for u in range(seg):
            loc = aw[:, :, u] * loc + xw[:, :, u]
            prod = prod * aw[:, :, u]
        cin = torch.empty_like(loc)
        c = carry
        for p in range(P):
            cin[:, p] = c
            c = prod[:, p] * c + loc[:, p]
        hw = torch.empty_like(aw)
        hh = cin
        for u in range(seg):
            hh = aw[:, :, u] * hh + xw[:, :, u]
            hw[:, :, u] = hh
        hw = hw.reshape(B, P * seg, D)[:, :n]
        out[:, w0:w0 + n] = hw
        carry = hw[:, -1]
    return out, carry


_P = ctypes.c_void_p


def _fn():
    fn = _build.load("rglru_scan").rglru_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [ctypes.c_int] * 7 + [_P]
        fn.restype = ctypes.c_int
    return fn


_N_SM = {}


def _n_sm(device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _N_SM:
        _N_SM[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _N_SM[idx]


def launch_plan(a: torch.Tensor) -> dict:
    """The :func:`segment_plan` the wrapper takes for ``a`` (and for
    tensors as aligned as ``a``) on its card."""
    B, S, D = a.shape
    return segment_plan(B, S, D, _n_sm(a.device), a.data_ptr() % 16 == 0)


def _launch(a, x, h0):
    global LAUNCHES
    B, S, D = a.shape
    for name, t in (("a", a), ("x", x), ("h0", h0)):
        if t.dtype != torch.float32:
            raise ValueError(f"rglru_scan kernel: {name} must be float32, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan kernel: {name} must be "
                             "contiguous")
    if B * S * D >= 2 ** 31:
        raise ValueError("rglru_scan kernel: tensors too large")
    h = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    ptrs = (a.data_ptr(), x.data_ptr(), h0.data_ptr(), h.data_ptr(),
            h_last.data_ptr())
    plan = segment_plan(B, S, D, _n_sm(a.device),
                        aligned=all(p % 16 == 0 for p in ptrs))
    with torch.cuda.device(a.device):
        rc = _fn()(*ptrs, B, S, D, plan["vec"], plan["groups"], plan["P"],
                   plan["seg"],
                   torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: cudaError "
                           f"{rc}")
    LAUNCHES += 1
    return h, h_last


def rglru_scan(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, x: (B, S, D); h0: (B, D).  Returns (h (B, S, D), h_last (B, D))
    in float32.

    CUDA tensors launch the kernel (contiguous float32 only); CPU tensors
    run :func:`rglru_scan_plain`."""
    _check(a, x, h0)
    if a.device.type == "cpu":
        return rglru_scan_plain(a, x, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda or cpu, not {a.device}")
    forward_only("rglru_scan", a, x, h0)
    return _launch(a, x, h0)
