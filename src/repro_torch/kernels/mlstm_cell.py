"""Fused mLSTM chunk cell — port of ``repro.kernels.mlstm_cell``
(``mlstm_chunk``).

One stabilised chunkwise-parallel mLSTM step per (batch, head): the
(L, L) intra-chunk decay and score matrix, the inter-chunk term from the
carried matrix memory ``C``, ``n`` and ``m``, and the end-of-chunk state
update.  ``models.recurrent.mlstm_prefill`` chains it over the chunks of
a prompt, exactly like the reference's chunkwise scan.

For tensors on a CUDA device :func:`mlstm_chunk` launches the
hand-written kernel ``csrc/mlstm_cell.cu``.  With bf16 q/k/v (the serving
path) that is one launch of a tensor-core kernel: output blocks (a slab
of positions x value columns) recompute their slab's q k^T and never
write the (L, L) scores to device memory, state blocks update tiles of C;
each product with an f32 operand (the decayed scores S, C0, k * w_src)
splits it into bf16 hi + lo and takes two passes, which
:func:`mlstm_chunk_split_plain` spells out in plain PyTorch.  With f32
q/k/v it is the first version: four kernels on one stream with f32
CUDA-core products and an (L, L) scratch (one launch of the wrapper
counts once).  For CPU tensors it runs :func:`mlstm_chunk_plain`, the
reference's oracle ``ref.mlstm_chunk_ref`` as plain PyTorch ops.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build, forward_only

NEG_INF = -1e30

#: kernel launches since the last reset (CUDA tensors only)
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: every block keeps the chunk's gates in shared memory
_MAX_L = 4096
#: the bf16 kernel keeps a 64-row slab of q and a 64-key tile of k in
#: shared memory
_MAX_HD_BF16 = 512

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check(q, k, v, ilog, flog, C0, n0, m0):
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) \
            or tuple(v.shape) != tuple(q.shape):
        raise ValueError("mlstm_chunk: q, k, v must be one (B, L, H, hd) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, L, H, hd = q.shape
    want = {"ilog": (ilog, (B, L, H)), "flog": (flog, (B, L, H)),
            "C0": (C0, (B, H, hd, hd)), "n0": (n0, (B, H, hd)),
            "m0": (m0, (B, H))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"mlstm_chunk: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    if len({t.device for t in (q, k, v, ilog, flog, C0, n0, m0)}) != 1:
        raise ValueError("mlstm_chunk: inputs lie on different devices")


def mlstm_chunk_plain(q, k, v, ilog, flog, C0, n0, m0
                      ) -> Tuple[torch.Tensor, State]:
    """The function as plain PyTorch ops (``ref.mlstm_chunk_ref``).
    Returns h (B, L, H, hd) in ``q.dtype`` and the f32 state (C, n, m)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    ilog, flog = ilog.float(), flog.float()
    C0, n0, m0 = C0.float(), n0.float(), m0.float()
    b = torch.cumsum(flog, dim=1)                             # (B, L, H)
    dmat = b[:, :, None] - b[:, None, :, :] + ilog[:, None, :, :]
    L = dmat.shape[1]
    tidx = torch.arange(L, device=q.device)
    causal = (tidx[:, None] >= tidx[None, :])[None, :, :, None]
    dmat = torch.where(causal, dmat, NEG_INF)                 # (B, L, L, H)
    inter = b + m0[:, None]
    m_t = torch.maximum(inter, dmat.amax(dim=2))
    w_intra = torch.exp(dmat - m_t[:, :, None])
    w_inter = torch.exp(inter - m_t)
    scores = torch.einsum("blhd,bshd->blsh", qf, kf) * w_intra
    h_num = (torch.einsum("blsh,bshd->blhd", scores, vf)
             + torch.einsum("blhd,bhde->blhe", qf, C0) * w_inter[..., None])
    denom = (scores.sum(dim=2)
             + torch.einsum("blhd,bhd->blh", qf, n0) * w_inter)
    denom = torch.maximum(denom.abs(), torch.exp(-m_t))
    h = h_num / denom[..., None]
    bL = b[:, -1]
    m_new = torch.maximum(bL + m0, (bL[:, None] - b + ilog).amax(dim=1))
    w_old = torch.exp(bL + m0 - m_new)
    w_src = torch.exp(bL[:, None] - b + ilog - m_new[:, None])
    C = (C0 * w_old[..., None, None]
         + torch.einsum("blh,blhd,blhe->bhde", w_src, kf, vf))
    n = n0 * w_old[..., None] + torch.einsum("blh,blhd->bhd", w_src, kf)
    return h.to(q.dtype), (C, n, m_new)


def _hi_lo(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (f32) as hi + lo, each rounded to bf16 (returned as f32)."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def mlstm_chunk_split_plain(q, k, v, ilog, flog, C0, n0, m0,
                            split_kw: bool = True
                            ) -> Tuple[torch.Tensor, State]:
    """The bf16 kernel's arithmetic as plain PyTorch ops.

    As :func:`mlstm_chunk_plain`, except where the kernel's tensor cores
    take bf16 operands: each product with an f32 operand (the decayed
    scores S in S v, C0 in q C0, k * w_src in (k w_src)^T v) splits it
    into bf16 hi + lo and sums both products in f32; q, k and v are
    already bf16.  m_t is the kernel's prefix max, b_t + max_{s<=t}(i_s -
    b_s).  ``split_kw=False`` rounds k * w_src to bf16 once, with no lo
    part, which shows why the kernel splits it."""
    qf, kf, vf = q.float(), k.float(), v.float()
    ilog, flog = ilog.float(), flog.float()
    C0, n0, m0 = C0.float(), n0.float(), m0.float()
    b = torch.cumsum(flog, dim=1)                             # (B, L, H)
    L = b.shape[1]
    inter = b + m0[:, None]
    m_t = torch.maximum(inter, b + torch.cummax(ilog - b, dim=1).values)
    m_t[:, :L - 1] = m_t[:, :L - 1].clamp(min=NEG_INF)
    dmat = b[:, :, None] - b[:, None, :, :] + ilog[:, None, :, :]
    tidx = torch.arange(L, device=q.device)
    causal = (tidx[:, None] >= tidx[None, :])[None, :, :, None]
    dmat = torch.where(causal, dmat, NEG_INF)                 # (B, L, L, H)
    w_intra = torch.exp(dmat - m_t[:, :, None])
    w_inter = torch.exp(inter - m_t)
    scores = torch.einsum("blhd,bshd->blsh", qf, kf) * w_intra
    s_hi, s_lo = _hi_lo(scores)
    c_hi, c_lo = _hi_lo(C0)
    qc = (torch.einsum("blhd,bhde->blhe", qf, c_hi)
          + torch.einsum("blhd,bhde->blhe", qf, c_lo))
    h_num = (qc * w_inter[..., None]
             + torch.einsum("blsh,bshd->blhd", s_hi, vf)
             + torch.einsum("blsh,bshd->blhd", s_lo, vf))
    denom = (scores.sum(dim=2)
             + torch.einsum("blhd,bhd->blh", qf, n0) * w_inter)
    denom = torch.maximum(denom.abs(), torch.exp(-m_t))
    h = h_num / denom[..., None]
    bL = b[:, -1]
    m_new = torch.maximum(bL + m0, (bL[:, None] - b + ilog).amax(dim=1))
    w_old = torch.exp(bL + m0 - m_new)
    w_src = torch.exp(bL[:, None] - b + ilog - m_new[:, None])
    kw = kf * w_src[..., None]                                # (B, L, H, hd)
    kw_hi, kw_lo = _hi_lo(kw)
    upd = torch.einsum("blhd,blhe->bhde", kw_hi, vf)
    if split_kw:
        upd = upd + torch.einsum("blhd,blhe->bhde", kw_lo, vf)
    C = C0 * w_old[..., None, None] + upd
    n = n0 * w_old[..., None] + kw.sum(dim=1)
    return h.to(q.dtype), (C, n, m_new)


_P = ctypes.c_void_p


def _fn():
    fn = _build.load("mlstm_cell").mlstm_cell_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [_P] * 14 + [ctypes.c_int] * 5
                       + [_P])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, ilog, flog, C0, n0, m0):
    global LAUNCHES
    B, L, H, hd = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("mlstm_chunk kernel: q, k, v must share one dtype "
                         f"of float32/bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    f32 = {"ilog": ilog, "flog": flog, "C0": C0, "n0": n0, "m0": m0}
    for name, t in f32.items():
        if t.dtype != torch.float32:
            raise ValueError(f"mlstm_chunk kernel: {name} must be float32, "
                             f"got {t.dtype}")
    for name, t in dict(q=q, k=k, v=v, **f32).items():
        if not t.is_contiguous():
            raise ValueError(f"mlstm_chunk kernel: {name} must be "
                             "contiguous")
    if L > _MAX_L:
        raise ValueError(f"mlstm_chunk kernel takes chunks of at most "
                         f"{_MAX_L} positions, got {L}")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and hd > _MAX_HD_BF16:
        raise ValueError(f"mlstm_chunk kernel takes a bfloat16 head dim of "
                         f"at most {_MAX_HD_BF16}, got {hd}")
    if max(B * L * H * hd, B * H * hd * hd,
           0 if bf16 else B * H * L * L) >= 2 ** 31:
        raise ValueError("mlstm_chunk kernel: tensors too large")
    h = torch.empty_like(q)
    C = torch.empty_like(C0)
    n = torch.empty_like(n0)
    m = torch.empty_like(m0)
    ptrs = [t.data_ptr() for t in (q, k, v, ilog, flog, C0, n0, m0, h, C, n,
                                   m)]
    if bf16:
        # one launch, no scratch
        scratch = (0, 0)
        vec = int(hd % 8 == 0 and all(p % 16 == 0 for p in ptrs))
    else:
        rows = torch.empty(B * H * (4 * L + 1), dtype=torch.float32,
                           device=q.device)
        S = torch.empty((B, H, L, L), dtype=torch.float32, device=q.device)
        scratch = (rows.data_ptr(), S.data_ptr())
        vec = 0
    with torch.cuda.device(q.device):
        rc = _fn()(_DTYPES[q.dtype], *ptrs, *scratch, B, L, H, hd, vec,
                   torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mlstm_cell kernel launch failed: cudaError "
                           f"{rc}")
    LAUNCHES += 1
    return h, (C, n, m)


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                ilog: torch.Tensor, flog: torch.Tensor, C0: torch.Tensor,
                n0: torch.Tensor, m0: torch.Tensor
                ) -> Tuple[torch.Tensor, State]:
    """q, k, v: (B, L, H, hd); ilog, flog: (B, L, H); C0: (B, H, hd, hd);
    n0: (B, H, hd); m0: (B, H).  Returns (h (B, L, H, hd) in ``q.dtype``,
    (C, n, m) in float32).

    CUDA tensors launch the kernel (contiguous; q/k/v float32 or bfloat16,
    the gates and the state float32); CPU tensors run
    :func:`mlstm_chunk_plain`."""
    _check(q, k, v, ilog, flog, C0, n0, m0)
    if q.device.type == "cpu":
        return mlstm_chunk_plain(q, k, v, ilog, flog, C0, n0, m0)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunk runs on cuda or cpu, not {q.device}")
    forward_only("mlstm_chunk", q, k, v, ilog, flog, C0, n0, m0)
    return _launch(q, k, v, ilog, flog, C0, n0, m0)
