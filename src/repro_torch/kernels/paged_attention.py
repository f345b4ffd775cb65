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
hand-written kernel ``csrc/paged_attention.cu``, which splits each
context across blocks (split-K, :func:`split_count`) and merges the
partial softmax states in split order inside the same launch; for CPU
tensors it runs :func:`paged_attention_plain`.
:func:`paged_attention_split_plain` spells the kernel's split arithmetic
in plain PyTorch for the CPU tests.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build, forward_only

NEG_INF = -1e30

#: kernel launches since the last reset (CUDA tensors only)
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128, 256)

#: the kernel's split-K constants (``csrc/paged_attention.cu``): keys per
#: tile (split boundaries fall on tiles), tiles per split at least (one per
#: warp), splits at most, and the blocks per SM that ``split_count`` aims at
KEY_TILE, MIN_TILES, MAX_SPLITS, BLOCKS_PER_SM = 16, 4, 64, 2
#: splits merged by one block, and counters per 16-row tile
MERGE_GROUP, COUNTERS_PER_TILE = 8, 16


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
                          context_lens: torch.Tensor,
                          soft_cap: float = 0.0) -> torch.Tensor:
    """The function as plain PyTorch ops: gather every page of the table,
    masked f32 softmax over the first ``context_lens[b]`` keys (scores
    soft-capped to ``soft_cap * tanh(s / soft_cap)`` when > 0)."""
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
    if soft_cap:
        s = torch.tanh(s / soft_cap) * soft_cap
    ctx = context_lens.long()
    mask = torch.arange(S, device=q.device)[None] < ctx[:, None]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", w, v)
    o = torch.where((ctx > 0)[:, None, None, None], o, 0.0)
    return o.reshape(B, H, hd).to(q.dtype)


def split_count(B: int, KV: int, G: int, max_ctx: int, n_sm: int) -> int:
    """Blocks per (sequence, kv head, 16-row tile) for a decode call:
    about ``BLOCKS_PER_SM`` blocks on each of ``n_sm`` SMs (above
    ``MERGE_GROUP``, rounded down to whole merge groups: a group of one
    split costs a merge level for nothing), but no split of the largest
    context ``max_ctx`` narrower than ``MIN_TILES`` tiles, and at most
    ``MAX_SPLITS``.  ``max_ctx`` is the block table's capacity (pages per
    sequence x page), so choosing needs no read of the context lengths
    from the card."""
    base = B * KV * -(-G // 16)
    widest = min(MAX_SPLITS, -(-max_ctx // KEY_TILE) // MIN_TILES)
    want = -(-BLOCKS_PER_SM * n_sm // max(base, 1))
    if want > MERGE_GROUP:
        want -= want % MERGE_GROUP
    return max(1, min(want, widest))


def split_bounds(ctx: int, splits: int):
    """The key ranges ``[lo, hi)`` that the kernel's ``splits`` blocks of
    one sequence take of its ``ctx`` keys: ``per`` = max(``MIN_TILES``,
    ceil(tiles / splits)) whole tiles each, in order, the last ones
    possibly empty."""
    tiles = -(-ctx // KEY_TILE)
    per = max(MIN_TILES, -(-tiles // splits))
    out = []
    for s in range(splits):
        lo = min(tiles, s * per)
        hi = min(tiles, lo + per)
        out.append((min(ctx, lo * KEY_TILE), min(ctx, hi * KEY_TILE)))
    return out


def _merge_partials(parts, KV, G, hd):
    """Partials (m, l, o or None) merged in order into one: M = max m,
    w = e^(m - M) (0 where l = 0), L = sum l w, O = sum o w."""
    M = torch.stack([m for m, _, _ in parts]).max(0).values
    L = torch.zeros(KV, G)
    O = torch.zeros(KV, G, hd)
    for m, l, o in parts:
        w = torch.where(l > 0, torch.exp(m - M), torch.zeros(()))
        L = L + l * w
        if o is not None:
            O = O + o * w[..., None]
    return M, L, O


def paged_attention_split_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                block_tables: torch.Tensor,
                                context_lens: torch.Tensor,
                                splits: int) -> torch.Tensor:
    """The kernel's split-K arithmetic as plain PyTorch ops, in f32: each
    of ``splits`` key ranges (:func:`split_bounds`) gives a partial
    (m, l, o) -- max score, sum of e^(s - m), the values weighted by it --
    or (-1e30, 0, none) if it holds no key; the partials are merged in
    order by groups of ``MERGE_GROUP`` and, if there is more than one
    group, the groups' partials in order; a keyless partial weighs 0; the
    result is normalised by max(l, 1e-30)."""
    B, H, hd = q.shape
    _, page, KV, _ = k_pages.shape
    G = H // KV
    S = block_tables.shape[1] * page
    idx = block_tables.long()
    k = k_pages[idx].reshape(B, S, KV, hd).float()
    v = v_pages[idx].reshape(B, S, KV, hd).float()
    qg = q.reshape(B, KV, G, hd).float()
    out = torch.zeros(B, KV, G, hd)
    for b in range(B):
        ctx = max(0, min(int(context_lens[b]), S))
        s = torch.einsum("kgh,skh->kgs", qg[b], k[b]) / math.sqrt(hd)
        parts = []
        for lo, hi in split_bounds(ctx, splits):
            if hi <= lo:
                parts.append((torch.full((KV, G), NEG_INF),
                              torch.zeros(KV, G), None))
                continue
            m = s[..., lo:hi].max(-1).values
            p = torch.exp(s[..., lo:hi] - m[..., None])
            parts.append((m, p.sum(-1),
                          torch.einsum("kgs,skh->kgh", p, v[b, lo:hi])))
        groups = [_merge_partials(parts[i:i + MERGE_GROUP], KV, G, hd)
                  for i in range(0, splits, MERGE_GROUP)]
        if len(groups) > 1:
            groups = [_merge_partials(groups, KV, G, hd)]
        _, L, O = groups[0]
        out[b] = O / torch.clamp_min(L, 1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


_P = ctypes.c_void_p
#: per (device index, stream): the partials' scratch and the split counters
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
#: launch_config's answers by (device, B, H, KV, page, pages per sequence,
#: forced splits)
_CONFIG: Dict[tuple, Tuple[int, tuple]] = {}


def _fn():
    fn = _build.load("paged_attention").paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [_P] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_int, _P])
        fn.restype = ctypes.c_int
    return fn


def launch_config(q: torch.Tensor, k_pages: torch.Tensor,
                  block_tables: torch.Tensor,
                  splits: Optional[int] = None) -> Tuple[int, tuple]:
    """The split count and grid ``(splits, ceil(G/16) * KV, B)`` of a
    kernel launch on these inputs (``splits`` forces the count)."""
    B, H, _ = q.shape
    _, page, KV, _ = k_pages.shape
    dev = q.device.index
    key = (dev, B, H, KV, page, block_tables.shape[1], splits)
    cfg = _CONFIG.get(key)
    if cfg is None:
        G = H // KV
        n = splits
        if n is None:
            n = split_count(B, KV, G, block_tables.shape[1] * page,
                            torch.cuda.get_device_properties(
                                dev).multi_processor_count)
        if not 1 <= n <= MAX_SPLITS:
            raise ValueError(f"paged_attention kernel: splits must be 1 .. "
                             f"{MAX_SPLITS}, got {n}")
        cfg = _CONFIG[key] = (n, (n, -(-G // 16) * KV, B))
    return cfg


def _scratch(q, stream, n_part, n_count):
    """The partials' scratch (f32) and the zeroed split counters of this
    device and stream, grown when a call needs more; the kernel leaves
    the counters zero, so they are zeroed only when allocated."""
    key = (q.device.index, stream)
    part, count = _SCRATCH.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(max(n_part, 1), dtype=torch.float32,
                           device=q.device)
    if count is None or count.numel() < n_count:
        count = torch.zeros(n_count, dtype=torch.int32, device=q.device)
    _SCRATCH[key] = (part, count)
    return part, count


def _launch(q, k_pages, v_pages, block_tables, context_lens, splits=None,
            soft_cap=0.0):
    """Launch the kernel on checked CUDA inputs; ``splits`` forces the
    split count (the card tests' way to reach every merge path)."""
    global LAUNCHES
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return _launch(q, k_pages, v_pages, block_tables, context_lens,
                           splits, soft_cap)
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
    splits, grid = launch_config(q, k_pages, block_tables, splits)
    out = torch.empty_like(q)
    # the current stream's raw handle, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    tiles = grid[1] * B
    partials = splits + -(-splits // MERGE_GROUP)
    part, count = _scratch(q, stream, tiles * partials * 16 * (hd + 2),
                           tiles * COUNTERS_PER_TILE)
    rc = _fn()(_DTYPES[q.dtype], hd, q.data_ptr(), k_pages.data_ptr(),
               v_pages.data_ptr(), block_tables.data_ptr(),
               context_lens.data_ptr(), out.data_ptr(), part.data_ptr(),
               count.data_ptr(), B, H, KV, page, block_tables.shape[1],
               1.0 / math.sqrt(hd), soft_cap, splits, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    return out


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    context_lens: torch.Tensor,
                    soft_cap: float = 0.0) -> torch.Tensor:
    """q: (B, H, hd); k_pages/v_pages: (n_total_pages, page_size, KV, hd);
    block_tables: (B, pages_per_seq) int32; context_lens: (B,) int32;
    soft_cap: scores become ``soft_cap * tanh(s / soft_cap)`` when > 0.
    Returns (B, H, hd) in ``q.dtype``.

    CUDA tensors launch the kernel (head dims 64, 128 and 256; the block
    table's entries must index ``k_pages``, which the kernel does not
    check; :func:`split_count` picks its split count); CPU tensors run
    :func:`paged_attention_plain`."""
    _check(q, k_pages, v_pages, block_tables, context_lens)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     context_lens, soft_cap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    forward_only("paged_attention", q, k_pages, v_pages)
    return _launch(q, k_pages, v_pages, block_tables, context_lens,
                   soft_cap=soft_cap)
