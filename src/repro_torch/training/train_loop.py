"""Training step and loop — port of ``repro.training.train_loop``.

``make_train_step`` differentiates ``Model.forward_train`` with autograd
(which runs no kernel: the kernels have no backward) and applies
``adamw_update`` in place.  With ``accum_steps > 1`` the batch is split
into ``accum_steps`` micro-batches along its first axis; their gradients
are summed in float32, divided by ``accum_steps`` and cast back to each
parameter's dtype, as in the reference, so the optimizer sees the
full-batch gradient while activations scale with the micro-batch.

The entry points take ``device`` (default ``"cuda"``, which needs a
card); it must be the model's device, and only an explicit ``"cpu"``
trains on the CPU.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from ..core.indicators import resolve_device
from ..models.model import Model
from .optim import AdamWState, OptimizerConfig, adamw_init, adamw_update, \
    leaves


def _on(model: Model, device) -> torch.device:
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model on {model.device}, training on {dev}")
    return dev


def _batch(batch: Dict[str, Any], dev) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def make_train_step(model: Model, opt_cfg: OptimizerConfig,
                    remat: bool = True, accum_steps: int = 1,
                    device="cuda") -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), the parameters and moments updated in place; metrics are
    0-d tensors (``lr`` a float)."""
    dev = _on(model, device)

    def grads_of(params, flat, batch):
        loss, metrics = model.forward_train(params, batch, remat=remat)
        return loss, metrics, torch.autograd.grad(loss, flat)

    def train_step(params, opt_state: AdamWState, batch):
        batch = _batch(batch, dev)
        flat = list(leaves(params))
        for p in flat:
            p.requires_grad_(True)
        try:
            if accum_steps == 1:
                loss, metrics, grads = grads_of(params, flat, batch)
            else:
                n = next(iter(batch.values())).shape[0] // accum_steps
                gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device) for p in flat]
                losses, ms = [], []
                for i in range(accum_steps):
                    micro = {k: v[i * n:(i + 1) * n]
                             for k, v in batch.items()}
                    loss_i, m_i, g_i = grads_of(params, flat, micro)
                    for a, g in zip(gsum, g_i):
                        a += g.float()
                    losses.append(loss_i.detach())
                    ms.append({k: v.detach() for k, v in m_i.items()})
                    del g_i
                grads = [(a / accum_steps).to(p.dtype)
                         for a, p in zip(gsum, flat)]
                del gsum
                loss = torch.stack(losses).mean()
                metrics = {k: torch.stack([m[k] for m in ms]).mean()
                           for k in ms[0]}
        finally:
            for p in flat:
                p.requires_grad_(False)
        metrics = {k: v.detach() for k, v in metrics.items()}
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, opt_cfg)
        metrics.update(opt_metrics)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def make_eval_step(model: Model, device="cuda") -> Callable:
    dev = _on(model, device)

    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = model.forward_train(params, _batch(batch, dev),
                                                remat=False)
        return {**metrics, "loss": loss}
    return eval_step


def train_loop(model: Model, opt_cfg: OptimizerConfig, data_iter,
               n_steps: int, params=None, log_every: int = 10,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 0, remat: bool = True,
               log_fn=print, accum_steps: int = 1,
               device="cuda") -> Dict[str, Any]:
    """Single-device training loop; parameters from a generator seeded 0
    unless given."""
    from .checkpoint import save_checkpoint

    dev = _on(model, device)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt_state = adamw_init(params, opt_cfg)
    step_fn = make_train_step(model, opt_cfg, remat=remat,
                              accum_steps=accum_steps, device=dev)
    history = []
    t0 = time.time()
    for step in range(1, n_steps + 1):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             next(data_iter))
        if step % log_every == 0 or step == n_steps:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall"] = time.time() - t0
            history.append(m)
            log_fn(f"step {step:5d} loss={m['loss']:.4f} "
                   f"ce={m['ce']:.4f} gnorm={m['grad_norm']:.3f} "
                   f"lr={m['lr']:.2e} ({m['wall']:.1f}s)")
        if checkpoint_dir and checkpoint_every and \
                step % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, step, params, opt_state)
    return {"params": params, "opt_state": opt_state, "history": history}
