"""Two-phase KV$-hotspot detector (paper §5.2) — port of
``repro.core.hotspot``.

Phase 1 — the Eq. 2 boundary condition.  Per request class c we track,
over a sliding accumulation window:

    x / x̄        class popularity   (fraction of cluster arrivals)
    |M| / |M̄|    cache coverage     (instances holding c's prefix)

Eq. 2 (x/x̄ ≤ |M|/|M̄|) guarantees that even if every class-c request
lands on M, no hit instance accumulates a larger batch than a non-hit
one.  A violation raises an ALARM — necessary but not sufficient for a
hotspot (derived under the worst-case "all-c-requests-to-M" assumption).

Phase 2 — confirmation.  While alarmed, each subsequent class-c request
is tracked, and mitigation activates only after ``2|M|`` consecutive
requests whose best multiplicative score on a hotspot instance m∈M beats
the best on m'∈M̄ (i.e. LMETRIC would keep feeding the hotspot).
Mitigation filters M from the routing targets; the alarm clears when
Eq. 2 holds again in a later window.

To bound overhead only the ``top_k`` classes by recent KV$-hit tokens are
tracked (paper: "we only track requests with the highest KV$ hit rates").

``observe`` is the reference's vectorized one: per-class counters live
in grow-doubling numpy arrays, one row per class in first-seen order, so
the stable-sort top-k breaks ties as the reference does, and the
hot-set/score logic is mask arithmetic over the hit vector.  The
reference's frozen per-decision Python ``_observe_py`` is its own
differential oracle and is not carried here; the port's tests read it
from the reference directly.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set

import numpy as np

from .indicators import IndicatorFactory
from .types import Request


class HotspotDetector:
    _CAP0 = 64   # initial class-array capacity (doubles on demand)

    def __init__(self, window: float = 60.0, top_k: int = 8,
                 min_requests: int = 20):
        self.window = window
        self.top_k = top_k
        self.min_requests = min_requests
        self._win_start = 0.0
        self._total = 0
        # per-class counters: one row per class in first-seen order
        self._row: Dict[int, int] = {}
        self._counts = np.zeros(self._CAP0, dtype=np.int64)
        self._ht = np.zeros(self._CAP0, dtype=np.int64)
        self._alarmed = np.zeros(self._CAP0, dtype=np.int8)
        self._consec = np.zeros(self._CAP0, dtype=np.int64)
        self._active = np.zeros(self._CAP0, dtype=np.int8)
        # telemetry for Figs. 20 and 21: every Eq. 2 check, and the
        # alarm / activate / clear events
        self.history: List[dict] = []
        self.events: List[dict] = []

    # ------------------------------------------------------------------
    def _roll_window(self, now: float):
        if now - self._win_start < self.window:
            return
        self._win_start = now
        self._total = 0
        self._counts[:] = 0
        self._ht[:] = 0

    def _row_of(self, c: int) -> int:
        r = self._row.get(c)
        if r is None:
            r = len(self._row)
            self._row[c] = r
            if r >= self._counts.shape[0]:
                for name in ("_counts", "_ht", "_alarmed", "_consec",
                             "_active"):
                    old = getattr(self, name)
                    grown = np.zeros(2 * old.shape[0], dtype=old.dtype)
                    grown[: old.shape[0]] = old
                    setattr(self, name, grown)
        return r

    @staticmethod
    def _mset(mask: np.ndarray) -> Set[int]:
        return set(np.flatnonzero(mask).tolist())

    # ------------------------------------------------------------------
    def observe(self, req: Request, factory: IndicatorFactory,
                hits: Sequence[int], scores: Sequence[float],
                now: float) -> Set[int]:
        """Called on every scheduling decision; returns the instances to
        filter out (empty while no mitigation is active for the
        request's class)."""
        self._roll_window(now)
        self._total += 1
        hits = np.asarray(hits)
        scores = np.asarray(scores)
        c = req.class_id
        r = self._row_of(c)
        self._counts[r] += 1
        self._ht[r] += int(hits.max()) if hits.size else 0

        # only track the hottest classes: a stable argsort over rows in
        # first-seen order breaks ties as the reference's sorted() does
        nc = len(self._row)
        if nc > self.top_k:
            hot = np.argsort(-self._ht[:nc], kind="stable")[: self.top_k]
            if not (hot == r).any():
                return set()

        N = len(factory)
        mask = hits > 0
        nM = int(mask.sum())
        if nM == 0 or nM == N or self._total < self.min_requests:
            self._alarmed[r] = 0
            self._consec[r] = 0
            if self._active[r] and nM == 0:
                self._active[r] = 0
            return self._mset(mask) if self._active[r] else set()

        x = int(self._counts[r]) / self._total
        xbar = max(1.0 - x, 1e-9)
        cover = nM / (N - nM)
        eq2_holds = (x / xbar) <= cover
        self.history.append({"t": now, "class": c, "x_ratio": x / xbar,
                             "coverage": cover, "eq2": eq2_holds})

        if eq2_holds:
            self._alarmed[r] = 0
            self._consec[r] = 0
            if self._active[r]:
                self._active[r] = 0
                self.events.append({"t": now, "class": c, "event": "clear"})
            return set()

        # ---- phase 1: alarm raised -----------------------------------
        if not self._alarmed[r]:
            self._alarmed[r] = 1
            self._consec[r] = 0
            self.events.append({"t": now, "class": c, "event": "alarm"})

        if self._active[r]:
            return self._mset(mask)

        # ---- phase 2: confirm via 2|M| consecutive score wins ---------
        best_m = scores[mask].min()
        best_other = scores[~mask].min()
        if best_m <= best_other:
            self._consec[r] += 1
        else:
            self._consec[r] = 0
        if self._consec[r] >= 2 * nM:
            self._active[r] = 1
            self.events.append({"t": now, "class": c, "event": "activate",
                                "M": np.flatnonzero(mask).tolist()})
            return self._mset(mask)
        return set()
