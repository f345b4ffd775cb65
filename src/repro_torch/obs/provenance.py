"""Decision provenance: per-request "why did instance *i* win" records —
port of ``repro.obs.provenance``; imports numpy only.

Opt-in (``make_obs(provenance=True)``): for every routing decision the
recorder captures the top-k candidate instances with the paper's two
indicators — new-prefill tokens (KV$-awareness factor) and batch size
(load factor) — the multiplied score, the tie-break path the epsilon-
round-robin took, the session-pin hint, and the request's eventual
admission/retraction outcome.  This is the decision-level introspection
the paper's "failure conditions can be detected beforehand" claim
demands: the record is enough to replay the argmin by hand.

**Multiplication-failure detector.**  The product ``(P+1) × (BS+1)``
needs no tuned weights precisely because neither factor can dominate
under the paper's workload assumptions; the derived failure condition is
the regime where that breaks — prefill-affinity spreads wider than the
load spread, so the product routes onto an instance whose load is far
above the fleet's, starving load balance ("affinity capture").  The
recorder flags a decision when the chosen instance's batch size exceeds
``alpha ×`` the live-fleet median (default ``alpha=2``) while a
lower-loaded candidate existed — and increments the registry counter
``provenance.failure_condition`` so the condition is observable *before*
its latency cost shows up in TTFT tails.

Under a heterogeneous fleet the failure regime gains a second
shape: the model-normalized score can keep a *fast* hardware class
loaded far above the fleet median because its small normalization
constant discounts queued prefill — cross-class capture.  When the
factory carries a fleet, the detector classifies each capture by
whether the lighter candidate sits in a *different* hardware class
(``failure_kind: "cross_class"``) or the same one (``"affinity
capture"``); the counter ``provenance.failure_condition`` covers both,
``provenance.failure_condition.cross_class`` counts just the hetero
shape: across classes, the normalization ratio that a common constant
would cancel no longer cancels.

Capturing a record costs one aggregated-index walk per decision (plus,
for policies without a hit-vector ``scores`` form, one side-effect-free
``scores_batch`` row) — real but opt-in overhead; the decision sequence
itself is untouched (inspection APIs only).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

# same epsilon as the policies' tie detection (core.policies._EPS)
_EPS = 1e-9


class ProvenanceRecorder:
    def __init__(self, registry=None, top_k: int = 4,
                 alpha: float = 2.0, max_records: int = 1 << 16):
        self.registry = registry
        self.top_k = top_k
        self.alpha = alpha
        self.max_records = max_records
        self.records: List[dict] = []
        self._by_rid = {}
        self.failure_conditions = 0
        self.cross_class_conditions = 0
        self.last_failure_kind = None
        self._all = np.arange(0)  # cached identity candidate set

    # ------------------------------------------------------------------
    def record(self, req, iid: int, factory, now: float, policy=None):
        """Capture one decision (called by the router after the policy
        picked ``iid`` and before any commit hook mutates indicators,
        so the captured landscape is the one the argmin saw)."""
        if len(self.records) >= self.max_records:
            return
        hits = factory.hits_for(req)
        new_prefill = np.maximum(req.prompt_len - hits, 0)
        bs = factory.bs_vector()
        scores = None
        if policy is not None:
            scorer = getattr(policy, "scores", None)
            if scorer is not None:
                # single-walk exact landscape (LMetric-family policies
                # score from a precomputed hit vector)
                scores = np.asarray(scorer(req, factory, hits),
                                    dtype=np.float64)
            else:
                try:
                    scores = np.asarray(
                        policy.scores_batch([req], factory, now)[0],
                        dtype=np.float64)
                except NotImplementedError:
                    scores = None
        if scores is None:
            # the paper's product as the generic landscape
            scores = (new_prefill + 1.0) * (bs + 1.0)
        alive = getattr(policy, "alive", None)
        if alive is not None:
            live = np.flatnonzero(alive)
        else:
            if len(self._all) != len(scores):
                self._all = np.arange(len(scores))
            live = self._all
        s_live = scores[live]
        order = live[np.argsort(s_live, kind="stable")[:self.top_k]]
        best = float(s_live.min()) if len(s_live) else 0.0
        n_ties = int(np.count_nonzero(s_live <= best + _EPS))
        pin = None
        if policy is not None and req.session_id >= 0:
            pin = policy.session_pin(req.session_id)
        hetero = getattr(factory, "fleet", None) is not None
        cls = factory.hardware_class if hetero else None
        failure = self._failure_condition(iid, bs, new_prefill, live,
                                          cls=cls)
        if hetero:
            # normalized indicators: enough to replay the hetero
            # argmin by hand (Contract 7 instrumentation)
            norm = factory.prefill_norm
            top_k = [
                {"iid": int(j),
                 "new_prefill": int(new_prefill[j]),
                 "batch": int(bs[j]),
                 "score": float(scores[j]),
                 "model_id": int(factory.model_id[j]),
                 "hardware_class": int(factory.hardware_class[j]),
                 "norm": 1.0 if norm is None else float(norm[j])}
                for j in order]
        else:
            top_k = [
                {"iid": int(j),
                 "new_prefill": int(new_prefill[j]),
                 "batch": int(bs[j]),
                 "score": float(scores[j])}
                for j in order]
        rec = {
            "rid": req.rid,
            "t": now,
            "family": req.family or "",
            "chosen": int(iid),
            "outcome": "routed",
            "pinned": int(pin) if pin is not None else -1,
            "tie_count": n_ties,
            "tie_break": "round_robin" if n_ties > 1 else "unique",
            "top_k": top_k,
            "failure_condition": failure,
        }
        if hetero:
            rec["model_requirement"] = req.model_requirement
            rec["chosen_model_id"] = int(factory.model_id[iid])
            rec["chosen_hardware_class"] = int(
                factory.hardware_class[iid])
            if failure:
                rec["failure_kind"] = self.last_failure_kind
        self.records.append(rec)
        self._by_rid[req.rid] = rec
        if self.registry is not None:
            self.registry.inc("provenance.records")
            if failure:
                self.registry.inc("provenance.failure_condition")
                if self.last_failure_kind == "cross_class":
                    self.registry.inc(
                        "provenance.failure_condition.cross_class")

    def _failure_condition(self, iid, bs, new_prefill, live,
                           cls=None) -> bool:
        """Affinity capture: the product picked an instance loaded more
        than ``alpha ×`` the live-fleet median while a strictly
        lower-loaded candidate existed — only possible when the prefill
        factor's spread exceeds the load spread (the detectable
        failure regime).

        With ``cls`` (the per-instance hardware-class codes, hetero
        fleets), the capture is additionally classified: when any
        strictly lighter live candidate sits in a *different* class
        than the chosen instance, the kind is ``"cross_class"`` — the
        normalization-ratio regime the hetero cancellation derivation
        flags — else ``"affinity_capture"``.  The classification is
        exposed via ``last_failure_kind`` / the record's
        ``failure_kind`` field; the return value (and the base
        counter) is unchanged from the homogeneous detector.
        """
        self.last_failure_kind = None
        if len(live) < 2:
            return False
        bs_live = bs[live]
        # sort-based median: same value as np.median on the small live
        # vector at a fraction of the dispatch cost (hot per-decision)
        srt = np.sort(bs_live)
        m = srt.size // 2
        med = (float(srt[m]) if srt.size % 2
               else 0.5 * (float(srt[m - 1]) + float(srt[m])))
        med = max(med, 1.0)
        if bs[iid] <= self.alpha * med:
            return False
        lighter = bs_live < bs[iid]
        hit = bool(lighter.any())
        if hit:
            self.failure_conditions += 1
            self.last_failure_kind = "affinity_capture"
            if cls is not None:
                other = cls[live][lighter] != cls[iid]
                if bool(other.any()):
                    self.last_failure_kind = "cross_class"
                    self.cross_class_conditions += 1
        return hit

    # ------------------------------------------------------------------
    def outcome(self, req, what: str, t: float):
        """Stamp a request's fate (``shed`` / ``retracted``); creates a
        minimal record for requests shed before any decision ran."""
        rec = self._by_rid.get(req.rid)
        if rec is not None:
            rec["outcome"] = what
            rec["t_outcome"] = t
            return
        if len(self.records) >= self.max_records:
            return
        rec = {"rid": req.rid, "t": t, "family": req.family or "",
               "chosen": -1, "outcome": what, "pinned": -1,
               "tie_count": 0, "tie_break": "none", "top_k": [],
               "failure_condition": False}
        self.records.append(rec)
        self._by_rid[req.rid] = rec

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        by_outcome = {}
        for r in self.records:
            by_outcome[r["outcome"]] = by_outcome.get(r["outcome"], 0) + 1
        return {
            "n_records": len(self.records),
            "failure_conditions": self.failure_conditions,
            "cross_class_conditions": self.cross_class_conditions,
            "tie_rate": (sum(1 for r in self.records
                             if r["tie_count"] > 1)
                         / max(len(self.records), 1)),
            "outcomes": dict(sorted(by_outcome.items())),
        }
