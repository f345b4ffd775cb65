"""Chunked-prefill causal flash attention — port of
``repro.kernels.prefill_attention`` (``flash_prefill``).

The engine's prefill hot path with the KV$-hit compute skip: ``q`` holds
only the chunk's new tokens, at absolute positions ``kv_offset[b] + i``,
while ``k``/``v`` span the cached prefix plus the chunk.  Row ``i`` of
sequence ``b`` attends key ``j`` iff ``j <= kv_offset[b] + i`` (and, with
a window, ``kv_offset[b] + i - j < window``); a cached prefix removes
query rows, not just masks them.

For tensors on a CUDA device :func:`flash_prefill` launches the
hand-written kernel ``csrc/prefill_attention.cu``: for bf16 a
warp-specialised wgmma kernel fed by TMA (f32 accumulation), for f32 the
first mma.sync kernel with each input split into two bf16 halves; for
CPU tensors it runs :func:`flash_prefill_plain`, the same function as
plain PyTorch ops — the kernel's yardstick on the card and the CPU
tests' subject.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build, forward_only

NEG_INF = -1e30

#: kernel launches since the last reset (CUDA tensors only)
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128, 256)


def _check(q, k, v, kv_offset, window):
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError("flash_prefill: q must be (B, Sq, H, hd) and k, v "
                         f"one (B, Sk, KV, hd) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"flash_prefill: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (batch, head dim, H % KV)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_prefill: q, k, v must share one dtype of "
                         f"float32/bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if tuple(kv_offset.shape) != (B,) or kv_offset.dtype != torch.int32:
        raise ValueError("flash_prefill: kv_offset must be (B,) int32, got "
                         f"{kv_offset.dtype} {tuple(kv_offset.shape)}")
    if not (q.device == k.device == v.device == kv_offset.device):
        raise ValueError("flash_prefill: inputs lie on different devices")
    if window is not None and window < 1:
        raise ValueError(f"flash_prefill: window must be >= 1, got {window}")


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_offset: torch.Tensor,
                        window: Optional[int] = None,
                        soft_cap: float = 0.0) -> torch.Tensor:
    """The function as plain PyTorch ops: f32 scores (soft-capped to
    ``soft_cap * tanh(s / soft_cap)`` when ``soft_cap`` > 0) and softmax
    over the whole (Sq, Sk) square, masked on absolute positions."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    if soft_cap:
        s = torch.tanh(s / soft_cap) * soft_cap
    qpos = (kv_offset.long()[:, None]
            + torch.arange(Sq, device=q.device)[None])            # (B, Sq)
    kpos = torch.arange(Sk, device=q.device)
    mask = qpos[:, :, None] >= kpos[None, None]                   # (B,Sq,Sk)
    if window is not None:
        mask &= (qpos[:, :, None] - kpos[None, None]) < window
    s = torch.where(mask[:, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


_P = ctypes.c_void_p


def _fn():
    fn = _build.load("prefill_attention").prefill_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [_P] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                          ctypes.c_float, _P])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, kv_offset, window, soft_cap=0.0):
    global LAUNCHES
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return _launch(q, k, v, kv_offset, window, soft_cap)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_prefill kernel takes head dims "
                         f"{_KERNEL_HEAD_DIMS}, got {hd}")
    if not q.is_contiguous() or not kv_offset.is_contiguous():
        raise ValueError("flash_prefill kernel: q and kv_offset must be "
                         "contiguous")
    inner = (KV * hd, hd, 1)
    if (k.stride()[1:] != inner or v.stride() != k.stride()
            or k.data_ptr() % 16 or v.data_ptr() % 16
            or k.stride(0) * k.element_size() % 16):
        raise ValueError("flash_prefill kernel: k and v need contiguous "
                         "(Sk, KV, hd) rows, one stride and 16-byte "
                         "aligned starts and batch strides")
    if max(B * Sq * H, B * Sk * KV) * hd >= 2 ** 31:
        raise ValueError("flash_prefill kernel: tensors too large")
    out = torch.empty_like(q)
    # the current stream's raw handle, without building a Stream object
    rc = _fn()(_DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), kv_offset.data_ptr(), out.data_ptr(), B, Sq, Sk,
               H, KV, k.stride(0), window or 0, 1.0 / math.sqrt(hd),
               soft_cap, torch._C._cuda_getCurrentRawStream(q.device.index))
    if rc != 0:
        why = {-2: "libcuda's cuTensorMapEncodeTiled was not found",
               -3: "libcuda refused the K/V tensor maps"}.get(
                   rc, f"cudaError {rc}")
        raise RuntimeError(f"prefill_attention kernel launch failed: {why}")
    LAUNCHES += 1
    return out


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_offset: torch.Tensor, window: Optional[int] = None,
                  soft_cap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd) new-token chunk; k/v: (B, Sk, KV, hd) cached
    prefix + chunk; kv_offset: (B,) int32 cached-prefix lengths; window:
    sliding window or None; soft_cap: scores become ``soft_cap *
    tanh(s / soft_cap)`` when > 0.  Returns (B, Sq, H, hd) in
    ``q.dtype``.

    CUDA tensors launch the kernel (head dims 64, 128 and 256; k/v may be a
    batch-strided view such as a slice of a longer cache); CPU tensors
    run :func:`flash_prefill_plain`."""
    _check(q, k, v, kv_offset, window)
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, kv_offset, window, soft_cap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill runs on cuda or cpu, not "
                         f"{q.device}")
    forward_only("flash_prefill", q, k, v)
    return _launch(q, k, v, kv_offset, window, soft_cap)
