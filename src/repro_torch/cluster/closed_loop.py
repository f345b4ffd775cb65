"""Closed-loop cluster drivers: session completion → next arrival —
port of ``repro.cluster.closed_loop``.

``ClosedLoopSim`` extends ``ClusterSim`` with the feedback edge the
open-loop simulator cannot express: when a request finishes, its session
state machine (``repro_torch.workloads.sessions``) is advanced and the next
turn's request(s) are pushed as *future arrival events* stamped relative
to the observed finish time.  Scheduling quality therefore throttles (or
releases) offered load, per-session KV$ lineage accumulates on whatever
instance the router keeps choosing, and sessions abandon on sustained
SLO breach — the three effects the paper's "real-world workloads" have
that pre-stamped traces do not.

Determinism: the event heap is ordered by ``(t, seq)``; session content
is a pure function of ``(family, seed, sid)`` (per-session RNG); request
ids are assigned in push order.  Two runs of the same scenario produce
bit-identical request logs, and feedback-generated same-timestamp waves
(API fan-out) coalesce through ``Router.route_batch`` exactly like
pre-stamped waves — on a card, one ``route_score`` launch each, and
bit-identical to sequential routing.  Wave pipelining comes unchanged
from ``ClusterSim``: every feedback arrival goes through ``_push``, so
the speculation hint (``_next_arrival_wave``) sees it the moment it
enters the heap, and one that lands *after* a speculation was taken
fails the pipeline's identity check — the speculative walk is
discarded, never misapplied.

``ClosedLoopPDSim`` drives the PD-disaggregated simulator through the
same session feedback: its arrival coalescing already accepts
dynamically pushed waves (events enter the shared heap before it
drains), so the closed loop is just the ``_finish`` hook plus rid
assignment.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional

import numpy as np

from ..core.types import Request
from ..workloads.sessions import Session, abandon_hazard
from .pd_disagg import PDDisaggSim
from .simulator import ClusterSim, _SimInstance


class _SessionFeedback:
    """Shared closed-loop machinery for the simulator backends.

    Owns the session registry and the rid counter; ``_session_feedback``
    is called by the backend's ``_finish`` override and pushes the next
    arrivals into the backend's event heap (``self._push``), where the
    existing same-timestamp coalescing picks them up as waves.
    """

    def _attach_sessions(self, sessions: List[Session]):
        self.sessions = sessions
        self._by_sid: Dict[int, Session] = {s.sid: s for s in sessions}
        self._rid = itertools.count()

    def _push_request(self, req: Request):
        req.rid = next(self._rid)
        self._push(req.arrival, "arrival", req)

    def _seed_arrivals(self):
        for sess in self.sessions:
            for req in sess.start():
                self._push_request(req)

    def _session_feedback(self, req: Request,
                          now: Optional[float] = None):
        """Advance the session; ``now`` overrides the feedback clock for
        requests that never finished (admission/retraction drops use the
        drop time — ``t_finish`` is 0.0 and would rewind the heap)."""
        sess = self._by_sid.get(req.session_id)
        if sess is None:
            return
        t = now if now is not None else req.t_finish
        for nxt in sess.on_complete(req, t):
            self._push_request(nxt)


class ClosedLoopSim(_SessionFeedback, ClusterSim):
    """``ClusterSim`` with the session-completion → next-arrival edge."""

    def run_sessions(self, sessions: List[Session],
                     until: Optional[float] = None) -> List[Request]:
        """Drive ``sessions`` to completion (or ``until``); returns the
        finished-request log in completion order."""
        self._attach_sessions(sessions)
        self._seed_arrivals()
        return self.run([], until=until)

    def _finish(self, inst: _SimInstance, req: Request):
        super()._finish(inst, req)
        self._session_feedback(req)

    def _should_retract(self, req: Request, inst: _SimInstance) -> bool:
        """Patience-driven early retraction (``OverloadControl
        .patience_retraction``): on top of the hard-deadline rule,
        retract a queued request when (a) its first token is
        *predicted* to miss the prefill deadline on the instance it
        sits on, and (b) the session's abandonment hazard — from the
        patience distribution and the observed breach count, never the
        session's private draw — has crossed the threshold.  The
        predictor runs at ``noise=1.0`` (the admission-gate contract)
        so the policy noise stream is untouched."""
        if super()._should_retract(req, inst):
            return True
        ov = self.overload
        if not ov.patience_retraction or req.deadline is None:
            return False
        sess = self._by_sid.get(req.session_id)
        if sess is None:
            return False
        hazard = abandon_hazard(sess._breaches, sess.spec.patience_mean)
        if hazard < ov.patience_threshold:
            return False
        f = self.router.factory
        i = inst.iid
        left = float(inst.prefill_left.get(req.rid, req.new_tokens))
        # its own remaining prefill is the "new" work; queue ahead of it
        # excludes itself (it is already counted in the instance column)
        q = np.array([max(float(f.queued_prefill_tokens[i]) - left, 0.0)])
        # per-instance predictor: inst.model IS self.model on a
        # homogeneous fleet; on a heterogeneous one the prediction uses
        # the instance's own roofline constants
        ttft = inst.model.predict_ttft_batch(
            q, np.array([left]),
            np.array([float(f.r_bs[i])]),
            np.array([float(f.total_tokens[i])]), noise=1.0)
        return bool(self.now + float(ttft[0]) > req.deadline.prefill)

    def _drop(self, req: Request, reason: str):
        """A shed/retracted turn feeds back like a completion: the
        session sees an unserved request (``t_finish`` 0.0 fails the
        SLO predicate), counts the breach against its patience, and —
        if it stays — schedules the next turn from the drop time.
        With a registry attached the closed-loop edge is counted
        separately (``sessions.dropped_turns``) so the shed/retract
        timeline can be attributed to session feedback pressure."""
        super()._drop(req, reason)
        if self._registry is not None:
            self._registry.inc("sessions.dropped_turns")
        self._session_feedback(req, now=self.now)


class ClosedLoopPDSim(_SessionFeedback, PDDisaggSim):
    """PD-disaggregated backend under the same closed loop."""

    def run_sessions(self, sessions: List[Session]) -> List[Request]:
        self._attach_sessions(sessions)
        self._seed_arrivals()
        return self.run([])

    def _finish(self, did: int, req: Request):
        super()._finish(did, req)
        self._session_feedback(req)
