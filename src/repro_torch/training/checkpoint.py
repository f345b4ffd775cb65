"""Checkpoints in the reference's on-disk format — port of
``repro.training.checkpoint``.

A checkpoint of step N in directory ``path`` is ``step_N.npz`` (N as 8
digits) holding one array per leaf, ``step_N.json``, the manifest
``{"step", "extra", "arrays": {key: {"dtype", "shape"}}}``, and a file
``latest`` naming the newest step.  Keys are ``params/<path>`` for the
parameters (the port's paths: ``embed/w``, ``layers/3/attn/wq/w``,
``encoder/layers/0/wq/w``) and, for an ``AdamWState``, ``opt/.step``,
``opt/.m/<path>`` and ``opt/.v/<path>`` as the reference names its
optimizer's fields; the npz names replace ``/`` by ``__``.  bfloat16
leaves are stored as float32 (npz has no bfloat16) and the manifest
keeps their dtype.

The npz is written one leaf at a time (the same zip of ``.npy`` members
``numpy.savez`` writes), so host memory holds one leaf, not the state:
Qwen3-4B's parameters and moments are ~48 GB.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .optim import AdamWState


def _flatten(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _flatten(v, f"{prefix}/{k}" if prefix else str(k))


def _entries(params, opt_state) -> Iterator[Tuple[str, Any]]:
    for key, leaf in _flatten(params):
        yield f"params/{key}", leaf
    if opt_state is not None:
        yield "opt/.step", np.asarray(opt_state.step, np.int32)
        for name in ("m", "v"):
            for key, leaf in _flatten(getattr(opt_state, name)):
                yield f"opt/.{name}/{key}", leaf


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, original dtype name)."""
    if isinstance(leaf, torch.Tensor):
        dtype = str(leaf.dtype).replace("torch.", "")
        t = leaf.detach()
        if t.dtype == torch.bfloat16:         # npz has no bf16: store f32
            t = t.float()
        return t.cpu().numpy(), dtype
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(path: str, step: int, params: Any,
                    opt_state: Optional[AdamWState] = None,
                    extra: Optional[Dict] = None):
    os.makedirs(path, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "arrays": {}}
    name = os.path.join(path, f"step_{step:08d}")
    with zipfile.ZipFile(name + ".npz", mode="w",
                         compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in _entries(params, opt_state):
            arr, dtype = _host(leaf)
            with zf.open(key.replace("/", "__") + ".npy", "w",
                         force_zip64=True) as fh:
                np.lib.format.write_array(fh, np.asarray(arr, order="C"),
                                          allow_pickle=False)
            manifest["arrays"][key] = {"dtype": dtype,
                                       "shape": list(arr.shape)}
    with open(name + ".json", "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(path, "latest"), "w") as f:
        f.write(str(step))


def latest_step(path: str) -> Optional[int]:
    p = os.path.join(path, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _rebuild(data, prefix: str, like, device):
    if isinstance(like, dict):
        return {k: _rebuild(data, f"{prefix}/{k}", v, device)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(data, f"{prefix}/{i}", v, device)
                          for i, v in enumerate(like))
    arr = data[prefix.replace("/", "__")]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {prefix} has shape "
                         f"{arr.shape}, expected {tuple(like.shape)}")
    return torch.from_numpy(arr).to(device or like.device, like.dtype)


def restore_checkpoint(path: str, step: Optional[int], params_like: Any,
                       opt_like: Optional[AdamWState] = None, device=None):
    """Restore into fresh tensors with the structure, shapes and dtypes of
    ``params_like`` / ``opt_like`` (whose leaves may be ``meta`` tensors),
    on ``device`` or each like leaf's device.  ``step=None`` takes the
    latest.  Returns (step, params, opt_state or None)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
    with np.load(os.path.join(path, f"step_{step:08d}.npz")) as data:
        params = _rebuild(data, "params", params_like, device)
        opt = None
        if opt_like is not None:
            opt = AdamWState(
                int(data["opt__.step"]),
                _rebuild(data, "opt/.m", opt_like.m, device),
                _rebuild(data, "opt/.v", opt_like.v, device))
    return step, params, opt
