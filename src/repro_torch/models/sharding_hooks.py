"""Optional activation-sharding constraints — port of
``repro.models.sharding_hooks``, with the reference's names and state.

The reference pins the batch dim of activations to the data axes,
logits' vocab dim and MoE dispatch buffers' expert dim to the model
axis (``with_sharding_constraint``), for a distributed launcher to set.
The port runs on one card, where nothing is partitioned: every
``constrain*`` returns its input tensor itself, whether or not a mesh is
set.  ``set_activation_sharding`` / ``clear_activation_sharding`` /
``active`` / ``batch_axes`` / ``model_axis`` and ``SEQUENCE_PARALLEL``
keep the reference's state, so that a multi-card launcher has them to
read.  The port's model does not call these hooks.
"""
from __future__ import annotations

_ACT_SHARD = {"mesh": None, "batch_axes": None, "model_axis": "model"}


def set_activation_sharding(mesh, batch_axes, model_axis="model"):
    _ACT_SHARD.update(mesh=mesh, batch_axes=batch_axes,
                      model_axis=model_axis)


def clear_activation_sharding():
    _ACT_SHARD.update(mesh=None, batch_axes=None)


def active() -> bool:
    return _ACT_SHARD["mesh"] is not None


def constrain(x, *spec):
    """``x`` itself: on one card no layout is imposed."""
    return x


def batch_axes():
    return _ACT_SHARD["batch_axes"]


def model_axis():
    return _ACT_SHARD["model_axis"]


SEQUENCE_PARALLEL = False   # Megatron-SP activation layout


def set_sequence_parallel(v: bool):
    global SEQUENCE_PARALLEL
    SEQUENCE_PARALLEL = bool(v)


def constrain_tokens_dim(x):
    """(B, S, ...) activations at block boundaries: batch over the data
    axes; with SEQUENCE_PARALLEL also sequence over the model axis."""
    if SEQUENCE_PARALLEL and x.ndim >= 3:
        return constrain(x, _ACT_SHARD["batch_axes"],
                         _ACT_SHARD["model_axis"],
                         *(None,) * (x.ndim - 2))
    return constrain(x, _ACT_SHARD["batch_axes"], *(None,) * (x.ndim - 1))


def constrain_logits(x):
    return constrain(x, _ACT_SHARD["batch_axes"], None,
                     _ACT_SHARD["model_axis"])


def constrain_moe_buffer(x):
    """(B, E, cap, D) dispatch buffers: batch over data, experts over
    model (expert-parallel compute)."""
    return constrain(x, _ACT_SHARD["batch_axes"], _ACT_SHARD["model_axis"],
                     None, None)
