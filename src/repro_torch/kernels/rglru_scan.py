"""RG-LRU linear recurrence — port of ``repro.kernels.rglru_scan``
(``rglru_scan``).

``h_t = a_t * h_{t-1} + x_t`` over the sequence, per (batch, channel),
from a given ``h0``, in float32.  Returns every ``h_t`` and the carry at
the true last position.  The RG-LRU block's prefill (``models.recurrent.
rglru_prefill``) runs it with ``h0`` taken from the block's state.

For tensors on a CUDA device :func:`rglru_scan` launches the
hand-written kernel ``csrc/rglru_scan.cu``; for CPU tensors it runs
:func:`rglru_scan_plain`, the sequential f32 scan of the reference's
oracle ``ref.rglru_scan_ref`` as plain PyTorch ops — the kernel's
yardstick on the card and the CPU tests' subject.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

#: kernel launches since the last reset (CUDA tensors only)
LAUNCHES = 0


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


_P = ctypes.c_void_p


def _fn():
    fn = _build.load("rglru_scan").rglru_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [ctypes.c_int] * 3 + [_P]
        fn.restype = ctypes.c_int
    return fn


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
    with torch.cuda.device(a.device):
        rc = _fn()(a.data_ptr(), x.data_ptr(), h0.data_ptr(), h.data_ptr(),
                   h_last.data_ptr(), B, S, D,
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
    return _launch(a, x, h0)
