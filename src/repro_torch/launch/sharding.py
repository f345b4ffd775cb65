"""Sharding rules: FSDP over (pod×)data + tensor-parallel over model —
port of ``repro.launch.sharding``.

Parameters get deliberate TP placement (column-sharded up-projections,
row-sharded down-projections → one all-reduce per block in the forward)
with the FSDP axis on the complementary dimension; MoE experts are
expert-parallel over the model axis when the expert count divides it,
else TP within the expert FFN dims.  Every rule degrades to ``None`` on
non-divisible dims, so every assigned architecture has a layout on the
production meshes (e.g. granite's 40 experts / 49155 vocab).

Caches for decode shard batch over data and kv-heads (or head_dim when
kv_heads < model axis) over model; the long_500k batch=1 shape instead
shards the window/sequence dim over data.

A spec is a tuple with one entry per tensor dim: ``None``, an axis name
or a tuple of axis names (the reference's ``PartitionSpec``).  A
``Sharding`` is a mesh and a spec; ``placements()`` gives its
``torch.distributed.tensor`` placements, one per mesh axis.

The rule functions (``param_pspec``, ``cache_pspec``) read the
reference's paths by default: a leaf under ``units/`` (a scan-stacked
layer) or ``/layers/`` (the ``vmap``-stacked encoder) carries one leading
stacked axis, which the rule skips.  The port keeps one dict per layer
(``layers/<i>/...``, ``encoder/layers/<i>/...``), so no port leaf has
that axis: the tree functions, which walk the port's trees, pass
``n_lead=0``.  Where the layouts differ the specs differ too: Whisper's
cross cache has ``cross_rows(1500) = 1504`` rows in the port, which
divide the model axis of 16, so its sequence is sharded over ``model``
where the reference's 1500 rows shard the KV heads instead.
"""
from __future__ import annotations

import re
from typing import Any, Optional, Tuple

from ..training.optim import AdamWState
from .mesh import Mesh

Spec = Tuple[Any, ...]


def _div(dim: int, mesh: Mesh, axes) -> Optional[Any]:
    """Return axes if dim divides their total size, else None."""
    if axes is None:
        return None
    tup = (axes,) if isinstance(axes, str) else tuple(axes)
    size = 1
    for a in tup:
        size *= mesh.shape[a]
    if size > 0 and dim % size == 0:
        return axes
    return None


class Sharding:
    """A mesh and a spec (the reference's ``NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: Spec):
        self.mesh, self.spec = mesh, tuple(spec)

    def placements(self):
        """One ``Shard(dim)`` / ``Replicate()`` per mesh axis, in the
        mesh's order (an axis in a tuple entry shards that dim together
        with the tuple's other axes, major first, as in the mesh)."""
        from torch.distributed.tensor import Replicate, Shard
        dims = {}
        for d, ax in enumerate(self.spec):
            for a in (() if ax is None else (ax,) if isinstance(ax, str)
                      else ax):
                dims[a] = d
        return tuple(Shard(dims[a]) if a in dims else Replicate()
                     for a in self.mesh.axis_names)

    def __eq__(self, other):
        return (isinstance(other, Sharding) and self.spec == other.spec
                and self.mesh.shape == other.mesh.shape)

    def __repr__(self) -> str:
        return f"Sharding({self.mesh.shape}, {self.spec})"


def _canon(spec) -> Spec:
    """A one-axis tuple entry becomes the axis name, as ``PartitionSpec``
    stores it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _stacked(path: str, n_lead: Optional[int], cache: bool) -> int:
    if n_lead is not None:
        return n_lead
    if path.startswith("units/"):
        return 1
    return int(not cache and "/layers/" in path)


def param_pspec(path: str, shape: Tuple[int, ...], mesh: Mesh,
                fsdp, n_lead: Optional[int] = None) -> Spec:
    """Spec for one parameter leaf (path uses '/' separators).
    ``n_lead``: leading stacked axes; ``None`` reads them from the path
    as the reference does."""
    return _canon(_param_rule(path, tuple(shape), mesh, fsdp,
                              _stacked(path, n_lead, cache=False)))


def _param_rule(path, shape, mesh, fsdp, n_lead) -> Spec:
    base = shape[n_lead:]
    lead = (None,) * n_lead

    def col():   # (.., d_in, d_out): fsdp on in, model on out
        if len(base) == 2:
            return (*lead, _div(base[0], mesh, fsdp),
                    _div(base[1], mesh, "model"))
        return (*lead, *(None,) * len(base))

    def row():   # (.., d_in, d_out): model on in, fsdp on out
        if len(base) == 2:
            return (*lead, _div(base[0], mesh, "model"),
                    _div(base[1], mesh, fsdp))
        return (*lead, *(None,) * len(base))

    # MoE expert weights (E, d_in, d_out) MUST be matched before the
    # generic col/row rules (wi/wg/wo names overlap): expert-parallel over
    # the model axis when E divides it, else TP within the expert FFN.
    if len(base) == 3 and re.search(r"/(wi|wg|wo)/w$", path):
        E = base[0]
        ep = _div(E, mesh, "model")
        if ep is not None:
            return (*lead, ep, _div(base[1], mesh, fsdp), None)
        if path.endswith("wo/w"):
            return (*lead, None, _div(base[1], mesh, "model"),
                    _div(base[2], mesh, fsdp))
        return (*lead, None, _div(base[1], mesh, fsdp),
                _div(base[2], mesh, "model"))
    if re.search(r"/(wq|wk|wv|xwq|xwk|xwv|wi|wg|up|wx|wgate)/w$", path):
        return col()
    if re.search(r"/(wo|xwo|down)/w$", path):
        return row()
    if path.endswith("router/w"):
        return (*lead, _div(base[0], mesh, fsdp), None)
    # vocab tables: shard the VOCAB dim over model only (sharding d_model
    # over the fsdp axis makes the lm-head contraction dim conflict with
    # batch-over-data activations)
    if path.endswith("embed/w"):
        return (_div(base[0], mesh, "model"), None)
    if path.endswith("lm_head/w"):
        return (None, _div(base[1], mesh, "model"))
    if path.endswith("dec_pos"):
        return (_div(base[0], mesh, fsdp), None)
    if path.endswith("vlm_proj/w"):
        return col()
    if path.endswith("/r"):          # slstm recurrent (4, H, hd, hd)
        return (*lead, None, _div(base[1], mesh, "model"),
                None, _div(base[3], mesh, fsdp))
    if path.endswith("/wif"):        # mlstm gates (di, 2H)
        return (*lead, _div(base[0], mesh, fsdp), None)
    if path.endswith("/conv"):       # (cw, dr)
        return (*lead, None, _div(base[1], mesh, "model"))
    if len(base) == 1 and base[0] >= 1024:
        # large vectors (rglru lambda/gates): shard over model
        return (*lead, _div(base[0], mesh, "model"))
    return (*lead, *(None,) * len(base))


def _map(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict / list / tuple, same
    structure; ``path`` joins keys and indices with '/'."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def param_shardings(params, mesh: Mesh, fsdp=("data",)):
    """Tree of ``Sharding`` matching the port's parameter tree (tensors
    on any device, ``meta`` included)."""
    return _map(lambda p, leaf: Sharding(
        mesh, param_pspec(p, tuple(leaf.shape), mesh, fsdp, n_lead=0)),
        params)


# ---------------------------------------------------------------------------
# caches and batches
# ---------------------------------------------------------------------------

def cache_pspec(path: str, shape, mesh: Mesh, batch_axes=("data",),
                n_lead: Optional[int] = None) -> Spec:
    """Spec for one cache leaf; ``n_lead`` as in ``param_pspec`` (the
    reference stacks only ``units/`` caches)."""
    return _canon(_cache_rule(tuple(shape), mesh, batch_axes,
                              _stacked(path, n_lead, cache=True)))


def _cache_rule(shape, mesh, batch_axes, n_lead) -> Spec:
    base = shape[n_lead:]
    lead = (None,) * n_lead
    if not base:
        return ()
    B = base[0]
    b_ax = _div(B, mesh, batch_axes)
    rest = [None] * (len(base) - 1)
    if len(base) >= 4:               # (B, S, KV, hd) attention cache
        S, KV, hd = base[1], base[2], base[3]
        # flash-decode layout: shard the SEQUENCE over the model axis --
        # each shard attends its KV slice, the softmax stats combined by
        # small all-reduces -- instead of gathering head-sharded caches
        # every layer
        s_ax = _div(S, mesh, "model")
        if s_ax is not None:
            rest[0] = s_ax
        else:
            kv_ax = _div(KV, mesh, "model")
            if kv_ax is not None:
                rest[1] = kv_ax
            else:
                hd_ax = _div(hd, mesh, "model")
                if hd_ax is not None:
                    rest[2] = hd_ax
        if b_ax is None and rest[0] is None:   # B=1 fallback: S over data
            rest[0] = _div(S, mesh, batch_axes)
    elif len(base) >= 2:
        # recurrent states (B, ...): shard a trailing dim over model
        for i in range(len(base) - 1, 0, -1):
            ax = _div(base[i], mesh, "model")
            if ax is not None:
                rest[i - 1] = ax
                break
        if b_ax is None and rest and rest[0] is None and len(base) > 2:
            rest[0] = _div(base[1], mesh, batch_axes)
    return (*lead, b_ax, *rest)


def cache_shardings(cache, mesh: Mesh, batch_axes=("data",)):
    """Tree of ``Sharding`` matching the port's cache (one dict per
    layer)."""
    def one(path, leaf):
        if not hasattr(leaf, "shape") or tuple(leaf.shape) == ():
            return Sharding(mesh, ())
        return Sharding(mesh, cache_pspec(path, tuple(leaf.shape), mesh,
                                          batch_axes, n_lead=0))
    return _map(one, cache)


def batch_shardings(batch, mesh: Mesh, batch_axes=("data",)):
    def one(_, leaf):
        shape = tuple(leaf.shape)
        B = shape[0] if shape else 1
        return Sharding(mesh, _canon((_div(B, mesh, batch_axes),
                                      *(None,) * (len(shape) - 1))))
    return _map(one, batch)


def opt_shardings(opt_state: AdamWState, pshard, mesh: Mesh) -> AdamWState:
    """AdamW state: moments mirror param shardings, step replicated."""
    def mirror(moments):
        paths = _map(lambda p, _: p, moments)
        if paths != _map(lambda p, _: p, pshard):
            raise ValueError("moments and parameter shardings differ in "
                             "structure")
        return pshard
    return AdamWState(step=Sharding(mesh, ()), m=mirror(opt_state.m),
                      v=mirror(opt_state.v))
