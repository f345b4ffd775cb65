"""Overload control: deadline-aware admission and retraction — port of
``repro.core.overload``.

* :class:`OverloadControl` — the per-run switchboard (admission,
  retraction, patience-driven retraction, deadline slack).  Everything
  defaults to *off*, which leaves a run exactly as it was.
* :class:`AdmissionController` — the gate: a request is admitted iff at
  least one live instance is predicted (``LatencyModel`` batch APIs) to
  produce its first token before the prefill deadline (and to keep its
  decode within ``decode_margin`` × the per-token budget).  On a
  heterogeneous fleet it also sheds a request whose
  ``model_requirement`` no live instance serves, with every control off.

Determinism: the gate calls ``predict_ttft_batch(..., noise=1.0)`` and
``predict_tpot_batch(..., noise=1.0)``, so it never draws from the
model's noise stream — policies that draw noise (llm-d, PolyServe) see
the same stream with the gate on or off, and decisions for admitted
requests equal a run where the shed requests never arrived.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .types import Request, stamp_deadline


@dataclasses.dataclass(frozen=True)
class OverloadControl:
    """Overload-control switchboard for a simulator run.

    ``slack`` scales the SLO-derived deadlines (1.0 = the SLO itself);
    admission/retraction both read the same stamped deadline so the two
    mechanisms stay consistent.  ``decode_margin`` relaxes only the
    admission gate's decode-feasibility check: the TPOT predictor reads
    the instance's *instantaneous* decode load, which overestimates the
    interference a request admitted now will actually see once earlier
    batches drain — 1.5 recovers the goodput that a margin-free gate
    sheds away without giving back the wasted-prefill win.  All-off
    (the default) stamps no deadline, sheds and retracts nothing.
    """
    admission: bool = False
    retraction: bool = False
    slack: float = 1.0
    decode_margin: float = 1.5
    #: patience-distribution-driven early retraction (closed loop only):
    #: retract a queued request when its first token is predicted to
    #: miss the prefill deadline AND the session's abandonment hazard
    #: (``repro_torch.workloads.sessions.abandon_hazard``) has crossed
    #: ``patience_threshold`` — the prefill would likely be burnt on a
    #: user about to hang up anyway.  Off by default; open-loop
    #: simulators ignore it (no session state to read a hazard from).
    patience_retraction: bool = False
    patience_threshold: float = 0.75

    @property
    def enabled(self) -> bool:
        return self.admission or self.retraction \
            or self.patience_retraction


#: the all-off configuration
NO_CONTROL = OverloadControl()


class AdmissionController:
    """Deadline-feasibility gate over the factory's indicator arrays.

    ``admit_wave`` partitions an arrival wave into (admitted, shed):
    a request is shed when *no* instance is predicted to reach its
    first token before ``deadline.prefill`` — routing it anywhere
    would burn prefill on a guaranteed SLO breach.
    """

    def __init__(self, model, control: OverloadControl):
        self.model = model
        self.control = control
        self.shed = 0
        self.admitted = 0
        # infeasible-everywhere sheds (no live instance serves the
        # request's model_requirement) — a capability property, counted
        # separately from deadline sheds; see ``admit_wave``
        self.capability_shed = 0

    def metrics_into(self, reg):
        """Mirror the gate's accumulators onto a metrics registry
        (``repro_torch.obs.registry``).  Uses ``counter_set`` — the gate owns
        the counts, the registry mirrors them, so re-ingestion after
        more waves replaces rather than double-counts (the exactly-once
        ingestion contract)."""
        reg.counter_set("admission.shed", self.shed)
        reg.counter_set("admission.admitted", self.admitted)
        reg.counter_set("admission.capability_shed",
                        self.capability_shed)

    def admit_wave(self, factory, reqs: Sequence[Request],
                   now: float, alive: Optional[np.ndarray] = None):
        """Partition ``reqs`` into (admitted, shed) at time ``now``.

        Deadlines are stamped here (idempotently) from each request's
        family SLO scaled by ``control.slack``.  Feasibility is the
        optimistic bound: best predicted TTFT across live instances,
        ignoring the request's own queueing behind wave-mates — an
        intentionally permissive gate (shedding a feasible request is
        worse than admitting a marginal one; retraction catches the
        marginal ones later).
        """
        for r in reqs:
            stamp_deadline(r, slack=self.control.slack)
        shed = []
        if factory.fleet is not None:
            # capability pre-filter: a request whose
            # model_requirement no *live* instance serves is shed here
            # regardless of control.admission — feasibility is a fleet
            # property, not an overload control, and routing it anywhere
            # would raise in the router's masked path.  Fleet-less
            # factories skip this block entirely (legacy sequence).
            feasible_reqs = []
            for r in reqs:
                mask = factory.feasible_mask(r.model_requirement)
                if mask is not None:
                    ok = mask if alive is None \
                        else (mask & alive.astype(bool))
                    if not bool(ok.any()):
                        shed.append(r)
                        self.capability_shed += 1
                        continue
                feasible_reqs.append(r)
            reqs = feasible_reqs
        if not self.control.admission:
            if factory.fleet is not None:
                self.shed += len(shed)
                self.admitted += len(reqs)
            return list(reqs), shed
        q = np.asarray(factory.queued_prefill_tokens, dtype=np.float64)
        d = np.asarray(factory.r_bs, dtype=np.float64)
        c = np.asarray(factory.total_tokens, dtype=np.float64)
        # decode-side feasibility is per instance, not per request:
        # computed once per wave (noise=1.0, see determinism contract)
        tpot = self.model.predict_tpot_batch(d, c, q, noise=1.0)
        admitted = []      # shed already holds any capability sheds
        for r in reqs:
            # per-instance KV$ hits: the gate sees the same new-token
            # cost routing would (a full-prompt bound over-sheds warm
            # sessions whose lineage is already resident somewhere)
            new = np.maximum(r.prompt_len - factory.hits_for(r), 0)
            # noise=1.0: never consume from the policy noise stream
            ttft = self.model.predict_ttft_batch(
                q, new.astype(np.float64), d, c, noise=1.0)
            feasible = ttft <= r.deadline.prefill - now
            if r.output_len > 1:
                # split deadline, decode half: the per-token budget the
                # finish deadline leaves after the prefill deadline
                budget_t = (r.deadline.finish - r.deadline.prefill) \
                    / (r.output_len - 1)
                feasible &= tpot <= budget_t * self.control.decode_margin
            if alive is not None:
                feasible &= alive.astype(bool)
            if factory.fleet is not None:
                # deadline feasibility must be judged on the instances
                # that can actually serve the request
                mask = factory.feasible_mask(r.model_requirement)
                if mask is not None:
                    feasible &= mask
            if bool(feasible.any()):
                admitted.append(r)
            else:
                shed.append(r)
        self.shed += len(shed)
        self.admitted += len(admitted)
        return admitted, shed
