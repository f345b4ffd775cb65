"""Paged decode attention — port of ``repro.kernels.paged_attention``
(``paged_attention``).

The serving engine's decode hot path: one query token per sequence
attends over a block-table-paged KV cache.  Sequence ``b`` holds its
keys in pages ``block_tables[b, 0..]`` of ``k_pages``/``v_pages``; the
first ``context_lens[b]`` of them are valid.  A sequence with
``context_lens[b] == 0`` gets 0, as the TPU kernel gives (it skips every
page), where the gather-then-softmax oracle ``paged_attention_ref`` of
the reference would give the mean of its values.

For tensors on a CUDA device :func:`paged_attention` launches the
hand-written kernel ``csrc/paged_attention.cu``; for CPU tensors it runs
:func:`paged_attention_plain`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30

#: kernel launches since the last reset (CUDA tensors only)
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128, 256)


def _check(q, k_pages, v_pages, block_tables, context_lens):
    if (q.dim() != 3 or k_pages.dim() != 4
            or tuple(k_pages.shape) != tuple(v_pages.shape)):
        raise ValueError("paged_attention: q must be (B, H, hd) and the "
                         "pages one (n_pages, page, KV, hd) shape, got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    B, H, hd = q.shape
    if k_pages.shape[3] != hd or H % k_pages.shape[2]:
        raise ValueError(f"paged_attention: pages {tuple(k_pages.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if (q.dtype not in _DTYPES or k_pages.dtype != q.dtype
            or v_pages.dtype != q.dtype):
        raise ValueError("paged_attention: q and pages must share one dtype "
                         f"of float32/bfloat16, got {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}")
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or block_tables.dtype != torch.int32):
        raise ValueError("paged_attention: block_tables must be (B, pages) "
                         f"int32, got {block_tables.dtype} "
                         f"{tuple(block_tables.shape)}")
    if tuple(context_lens.shape) != (B,) or context_lens.dtype != torch.int32:
        raise ValueError("paged_attention: context_lens must be (B,) int32, "
                         f"got {context_lens.dtype} "
                         f"{tuple(context_lens.shape)}")
    if not (q.device == k_pages.device == v_pages.device
            == block_tables.device == context_lens.device):
        raise ValueError("paged_attention: inputs lie on different devices")


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          context_lens: torch.Tensor) -> torch.Tensor:
    """The function as plain PyTorch ops: gather every page of the table,
    masked f32 softmax over the first ``context_lens[b]`` keys."""
    B, H, hd = q.shape
    _, page, KV, _ = k_pages.shape
    G = H // KV
    n_pages = block_tables.shape[1]
    S = n_pages * page
    idx = block_tables.long()
    k = k_pages[idx].reshape(B, S, KV, hd).float()
    v = v_pages[idx].reshape(B, S, KV, hd).float()
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k) / math.sqrt(hd)
    ctx = context_lens.long()
    mask = torch.arange(S, device=q.device)[None] < ctx[:, None]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", w, v)
    o = torch.where((ctx > 0)[:, None, None, None], o, 0.0)
    return o.reshape(B, H, hd).to(q.dtype)


_P = ctypes.c_void_p


def _fn():
    fn = _build.load("paged_attention").paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [_P] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, _P])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k_pages, v_pages, block_tables, context_lens):
    global LAUNCHES
    B, H, hd = q.shape
    n_total, page, KV, _ = k_pages.shape
    if hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_attention kernel takes head dims "
                         f"{_KERNEL_HEAD_DIMS}, got {hd}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention kernel: {name} must be "
                             "contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention kernel: pages must start 16-byte "
                         "aligned")
    if n_total * page * KV * hd >= 2 ** 62 or B * H * hd >= 2 ** 31:
        raise ValueError("paged_attention kernel: tensors too large")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _fn()(_DTYPES[q.dtype], hd, q.data_ptr(), k_pages.data_ptr(),
                   v_pages.data_ptr(), block_tables.data_ptr(),
                   context_lens.data_ptr(), out.data_ptr(), B, H, KV, page,
                   block_tables.shape[1], 1.0 / math.sqrt(hd),
                   torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    return out


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    context_lens: torch.Tensor) -> torch.Tensor:
    """q: (B, H, hd); k_pages/v_pages: (n_total_pages, page_size, KV, hd);
    block_tables: (B, pages_per_seq) int32; context_lens: (B,) int32.
    Returns (B, H, hd) in ``q.dtype``.

    CUDA tensors launch the kernel (head dims 64, 128 and 256; the block
    table's entries must index ``k_pages``, which the kernel does not
    check); CPU tensors run :func:`paged_attention_plain`."""
    _check(q, k_pages, v_pages, block_tables, context_lens)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     context_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k_pages, v_pages, block_tables, context_lens)
