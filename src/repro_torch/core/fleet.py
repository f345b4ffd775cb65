"""Heterogeneous fleet description (``FleetSpec``) — port of
``repro.core.fleet``.

A fleet assigns every router slot a *model* (what it can serve) and a
*hardware class* (how fast it serves it).  The routing stack consumes a
fleet three ways:

1. **Normalization** — ``prefill_norm`` is the per-instance marginal
   prefill cost (``EngineSpec.prefill_token_cost``, seconds/token) the
   heterogeneous LMetric score multiplies into the P-token indicator so
   "1000 queued tokens on fast hardware" and "1000 queued tokens on slow
   hardware" stop comparing equal.  When every instance shares one cost
   the vector collapses to ``None`` (``norm_or_none``) and the score is
   *instruction-identical* to the homogeneous path: a common positive
   constant cannot change an argmin, and the collapse makes that a
   bit-identity rather than an epsilon argument.
2. **Capability mask** — ``feasible_mask(requirement)`` marks the
   instances whose model satisfies a request's ``model_requirement``
   (a pre-score filter, like the alive mask).
3. **Per-instance ground truth** — the cluster simulator builds one
   ``LatencyModel`` per instance from ``specs`` so step times and
   admission predictions use each instance's own roofline.

Construction is cheap and pure (numpy); the factory snapshots the code
columns into its arrays at init.  ``make_fleet`` resolves model names
through ``repro_torch.configs`` (which loads the model code, hence
torch) only when it is called.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .latency_model import EngineSpec, spec_from_config


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Immutable per-instance model/hardware assignment for a router.

    ``model_names[i]`` / ``hardware_classes[i]`` / ``specs[i]`` describe
    instance ``i``.  Integer code columns (stable: codes follow first
    appearance order) are what the ``IndicatorFactory`` carries in its
    SoA; the string vocabularies translate back for provenance and
    metrics.
    """
    model_names: Tuple[str, ...]
    hardware_classes: Tuple[str, ...]
    specs: Tuple[EngineSpec, ...]

    def __post_init__(self):
        n = len(self.model_names)
        if not (n and len(self.hardware_classes) == n
                and len(self.specs) == n):
            raise ValueError("fleet columns must be equal-length and "
                             "non-empty")

    # ---- derived columns (cached on first use) ---------------------------
    @property
    def n(self) -> int:
        return len(self.model_names)

    def _codes(self, names: Tuple[str, ...]):
        vocab: Dict[str, int] = {}
        codes = np.empty(len(names), dtype=np.int64)
        for i, m in enumerate(names):
            codes[i] = vocab.setdefault(m, len(vocab))
        return codes, tuple(vocab)

    @property
    def model_codes(self) -> np.ndarray:
        codes, vocab = self._codes(self.model_names)
        object.__setattr__(self, "_model_vocab", vocab)
        return codes

    @property
    def model_vocab(self) -> Tuple[str, ...]:
        if not hasattr(self, "_model_vocab"):
            self.model_codes
        return self._model_vocab

    @property
    def class_codes(self) -> np.ndarray:
        codes, vocab = self._codes(self.hardware_classes)
        object.__setattr__(self, "_class_vocab", vocab)
        return codes

    @property
    def class_vocab(self) -> Tuple[str, ...]:
        if not hasattr(self, "_class_vocab"):
            self.class_codes
        return self._class_vocab

    @property
    def prefill_norm(self) -> np.ndarray:
        """Per-instance marginal prefill cost (s/token), float64."""
        return np.array([s.prefill_token_cost for s in self.specs],
                        dtype=np.float64)

    def norm_or_none(self) -> Optional[np.ndarray]:
        """``prefill_norm``, or ``None`` when it is constant.

        The collapse is what makes the homogeneous configuration
        provably zero-cost: scaling every score by one positive
        constant cannot change the argmin, but it *could* perturb the
        epsilon tie set — returning ``None`` keeps the legacy
        instruction sequence byte-for-byte."""
        norm = self.prefill_norm
        if np.all(norm == norm[0]):
            return None
        return norm

    def feasible_mask(self, requirement: str) -> np.ndarray:
        """Boolean mask of instances whose model serves ``requirement``.

        An empty requirement matches everything (the mask is all-True);
        otherwise the requirement must equal the instance's model name.
        """
        if not requirement:
            return np.ones(self.n, dtype=bool)
        return np.array([m == requirement for m in self.model_names],
                        dtype=bool)

    def class_of(self, iid: int) -> str:
        return self.hardware_classes[iid]

    def model_of(self, iid: int) -> str:
        return self.model_names[iid]


def make_fleet(groups: Sequence[Tuple[str, str, int]],
               chips: int = 1, **spec_kw) -> FleetSpec:
    """Build a ``FleetSpec`` from ``(model_name, hardware_class, count)``
    groups, resolving each model name through ``configs.get_config`` →
    ``spec_from_config`` (``spec_kw`` goes to ``spec_from_config``:
    ``kv_capacity_tokens``, or the reference's ``peak_flops`` and
    ``hbm_bw`` for parity runs).  Instance ids are assigned
    group-by-group in the given order (instances of one hardware class
    are contiguous, which class-scoped kill schedules rely on)."""
    from ..configs import get_config
    names, classes, specs = [], [], []
    spec_cache: Dict[str, EngineSpec] = {}
    for model_name, hw_class, count in groups:
        if model_name not in spec_cache:
            spec_cache[model_name] = spec_from_config(
                get_config(model_name), chips=chips, **spec_kw)
        for _ in range(int(count)):
            names.append(model_name)
            classes.append(hw_class)
            specs.append(spec_cache[model_name])
    return FleetSpec(tuple(names), tuple(classes), tuple(specs))


def homogeneous_fleet(model_name: str, hw_class: str, n: int,
                      chips: int = 1, **spec_kw) -> FleetSpec:
    """Degenerate single-class fleet — useful in tests asserting the
    hetero layer is zero-cost when unused (``norm_or_none()`` is None)."""
    return make_fleet([(model_name, hw_class, n)], chips=chips, **spec_kw)
