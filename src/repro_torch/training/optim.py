"""Optimizer and LR schedules — port of ``repro.training.optim``.

AdamW with decoupled weight decay and global-norm clipping, the
reference's semantics: the update math in float32, the clip scale
``min(1, clip / max(gnorm, 1e-9))``, decay only on leaves with
``ndim >= 2`` (no decay on norms, scales and biases), moments stored in
``moment_dtype`` (Arctic-480B uses bf16), the new parameter cast back to
its own dtype.  Schedules: cosine, WSD (warmup-stable-decay, MiniCPM's)
and constant.

Parameters, gradients and moments are nested dicts and lists of tensors
(the port's parameter layout).  ``adamw_update`` writes the parameters
and moments in place, under ``torch.no_grad()``, and returns the same
objects: at Qwen3-4B's size the state is ~48 GB, so a second copy of it
would not fit on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, NamedTuple, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"          # cosine | wsd | constant
    wsd_decay_frac: float = 0.1       # last 10% of steps decay (WSD)
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"


def lr_at(cfg: OptimizerConfig, step) -> float:
    """The learning rate at ``step``, computed in float32 as the
    reference computes it."""
    f = np.float32
    step = f(step)
    warm = min(step / f(max(cfg.warmup_steps, 1)), f(1.0))
    if cfg.schedule == "constant":
        frac = f(1.0)
    elif cfg.schedule == "wsd":
        decay_start = cfg.total_steps * (1.0 - cfg.wsd_decay_frac)
        in_decay = np.clip((step - f(decay_start))
                           / f(max(cfg.total_steps - decay_start, 1)),
                           f(0.0), f(1.0))
        frac = f(1.0) - f(1.0 - cfg.min_lr_frac) * in_decay
    else:  # cosine
        prog = np.clip(step / f(max(cfg.total_steps, 1)), f(0.0), f(1.0))
        frac = f(cfg.min_lr_frac) + f((1 - cfg.min_lr_frac) * 0.5) * (
            f(1.0) + np.cos(f(math.pi) * prog))
    return float(f(cfg.lr) * warm * frac)


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


def leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict / list / tuple, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def tree_map(fn, tree):
    """``fn`` over the tensors of a nested dict / list, same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def adamw_init(params, cfg: OptimizerConfig) -> AdamWState:
    dt = getattr(torch, cfg.moment_dtype)
    zeros = (lambda p: torch.zeros(p.shape, dtype=dt, device=p.device))
    return AdamWState(step=0, m=tree_map(zeros, params),
                      v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a 0-d
    tensor on the leaves' device)."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


def adamw_update(grads, state: AdamWState, params, cfg: OptimizerConfig):
    """One AdamW step.  Writes ``params`` and the moments in place and
    returns (params, new state, {"lr", "grad_norm"})."""
    step = state.step + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                        max=1.0) if cfg.grad_clip else 1.0
    b1, b2 = cfg.betas
    f = np.float32
    bc1 = float(f(1) - f(b1) ** f(step))
    bc2 = float(f(1) - f(b2) ** f(step))
    with torch.no_grad():
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.m), leaves(state.v)):
            g = g.float() * scale
            m32 = m.float() * b1 + g * (1 - b1)
            v32 = v.float() * b2 + g.square() * (1 - b2)
            update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            if p.dim() >= 2:
                update = update + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * update)
            m.copy_(m32)
            v.copy_(v32)
    return params, AdamWState(step, state.m, state.v), {
        "lr": lr, "grad_norm": gnorm}
