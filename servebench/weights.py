"""Random weights from ``--seed``, made on the device in the layout the
program's ``Model`` takes.

The layout (every leaf's path, shape and dtype) is read from a ``Model``
built on the ``meta`` device, which allocates nothing.  The draws are a
few large calls: one flat buffer per dtype is filled from a
``torch.Generator`` on the device, in chunks, in the dtype it is served
in; each leaf is then a view of its buffer, scaled as ``Model.init``
scales it (``1/sqrt(fan_in)`` for a matrix, 0.02 for the embedding), and
norm scales are ones.  The same tensors go to the program and to the
plain reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

#: elements per draw; each leaf starts on a 256-byte boundary
CHUNK = 1 << 30
ALIGN = 256


def _leaves(tree, path=()) -> List[Tuple[tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree) for x in _leaves(t, path + (i,))]
    return [(path, tree)]


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


def make_params(layout: Dict, seed: int, device) -> Dict:
    """A tree shaped as ``layout`` (meta tensors) with drawn weights."""
    leaves = _leaves(layout)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & 0x7FFF_FFFF_FFFF_FFFF)
    out = _skeleton(layout)
    for dtype in sorted({t.dtype for _, t in leaves}, key=str):
        group = [(p, t) for p, t in leaves if t.dtype == dtype]
        align = ALIGN // torch.empty((), dtype=dtype).element_size()
        offs, total = [], 0
        for _, t in group:
            offs.append(total)
            total += -(-t.numel() // align) * align
        buf = torch.empty(total, dtype=dtype, device=device)
        for lo in range(0, total, CHUNK):
            buf[lo:lo + CHUNK].normal_(generator=gen)
        for (path, t), off in zip(group, offs):
            view = buf[off:off + t.numel()].view(t.shape)
            if path[-1] == "scale":
                view.fill_(1.0)
            elif path[-1] == "bias":
                view.zero_()
            elif path[0] == "embed":
                view.mul_(0.02)
            else:
                view.mul_(1.0 / math.sqrt(t.shape[-2] if t.dim() >= 2
                                          else t.shape[-1]))
            _put(out, path, view)
    return out
