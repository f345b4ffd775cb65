"""Production mesh layout — port of ``repro.launch.mesh``.

``Mesh`` is abstract: axis names and sizes, no devices and no process
group, as the sharding rules need (they read ``mesh.shape`` only).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple


class Mesh:
    """Axis names -> sizes, in order (``jax.sharding.Mesh``'s ``shape``
    and ``axis_names``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for axes {axis_names}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, shape)))

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(data=16, model=16) single pod (256 chips); (pod=2, data=16,
    model=16) for the 2-pod 512-chip deployment."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def fsdp_axes(multi_pod: bool = False):
    """Axes over which parameters/optimizer state are fully sharded."""
    return ("pod", "data") if multi_pod else ("data",)


def make_smoke_mesh() -> Mesh:
    """1-device mesh with the production axis names (smoke tests)."""
    return Mesh((1, 1), ("data", "model"))
