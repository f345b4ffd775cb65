"""The reference's parameters, as numpy arrays, into the port's layout.

``repro.models.Model.init`` returns a pytree whose layer parameters are
stacked for a scan over the config's repeating unit:
``params["units"][j]`` holds position ``j`` of the unit for all units
along axis 0, and ``params["rest"]`` the remainder layers.  The port keeps
one dict per layer (``layers[u * len(unit) + j]``, then the remainder).
A MoE layer's leaves come along as they are: the experts' ``(E, D, F)``
and ``(E, F, D)`` stacks and the float32 router.  PaliGemma's
``vlm_proj`` is carried too.  Whisper's encoder is stacked by
``jax.vmap`` (every leaf under ``encoder/layers`` has a leading
``enc_layers`` axis): it is split into one dict per encoder layer, and
``encoder/final_norm`` and ``dec_pos`` come along as they are.  A
gradient tree of the reference (``jax.grad`` over the parameters) has
the parameters' structure and converts the same way.  Every leaf is
copied bit for bit.  A bfloat16 leaf arrives as an
``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` refuses; it goes
through its 16-bit pattern instead.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .config import ModelConfig


def _tensor(a) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")      # writable, contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tree(node, leaf):
    if isinstance(node, dict):
        return {k: _tree(v, leaf) for k, v in node.items()}
    return leaf(node)


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any]
                      ) -> Dict[str, Any]:
    """``tree``: the reference's parameters with numpy leaves (nested dicts
    and tuples, e.g. ``jax.tree.map(np.asarray, params)``).  Returns the
    port's parameter dict with CPU tensors."""
    unit, n_units, rest = cfg.repeating_unit()
    if len(tree["units"]) != len(unit) or len(tree["rest"]) != len(rest):
        raise ValueError(f"{cfg.name}: parameter tree does not match the "
                         f"repeating unit {unit} x {n_units} + {rest}")
    if ("lm_head" in tree) == cfg.tie_embeddings:
        raise ValueError(f"{cfg.name}: lm_head must be absent exactly when "
                         "embeddings are tied")
    layers = []
    for u in range(n_units):
        for j in range(len(unit)):
            layers.append(_tree(tree["units"][j],
                                lambda a, u=u: _tensor(np.asarray(a)[u])))
    for j in range(len(rest)):
        layers.append(_tree(tree["rest"][j], _tensor))
    params: Dict[str, Any] = {
        "embed": _tree(tree["embed"], _tensor),
        "final_norm": _tree(tree["final_norm"], _tensor),
        "layers": layers,
    }
    for name in ("lm_head", "vlm_proj", "dec_pos"):
        if name in tree:
            params[name] = _tree(tree[name], _tensor)
    if "encoder" in tree:
        enc = tree["encoder"]
        params["encoder"] = {
            "layers": [_tree(enc["layers"],
                             lambda a, i=i: _tensor(np.asarray(a)[i]))
                       for i in range(cfg.enc_layers)],
            "final_norm": _tree(enc["final_norm"], _tensor)}
    elif cfg.is_encdec:
        raise ValueError(f"{cfg.name}: an encoder-decoder's parameter tree "
                         "needs its encoder")
    return params

