"""Profiler ranges of the served path.

``span(name)`` is a ``torch.profiler`` range while a profiler is on and a
context that does nothing otherwise: one check guards it, so with the
profiler off a span costs that check and no range is entered.

The range is ``torch._C._profiler._RecordFunctionFast``, which records a
CPU operation.  ``torch.profiler.record_function`` records a user
annotation instead, and Kineto gives each user annotation a device-side
copy (``gpu_user_annotation``) spanning the kernels launched inside it;
a reader of the device trace would count that copy as device work.  A
CPU operation gets no such copy, so the spans stay on the host, on the
clock of the CUDA activity.  Names are fixed (``engine.decode``,
``model.moe``, ...), never per request.
"""
from __future__ import annotations

import contextlib

import torch

#: the range class (a test may put a counting stand-in here)
Range = torch._C._profiler._RecordFunctionFast
_profiling = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler is on."""
    return Range(name) if _profiling() else _NULL
