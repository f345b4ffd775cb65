"""Serving-quality metrics — port of ``repro.cluster.metrics``: ``pct``,
``summarize`` (TTFT/TPOT percentiles, SLO attainment, goodput,
per-family breakdowns and, from a registry snapshot, the cross-family
interference block), ``interference_summary``,
``hardware_class_summary`` (mixed fleets), ``overload_summary`` (shed,
retracted and wasted prefill), ``cdf``, ``imbalance_stats`` (Fig. 10's
per-window prefill spread) and ``fmt_row``."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.types import DEFAULT_SLO, Request, SLO, slo_for_family

SLO_TTFT = DEFAULT_SLO.ttft
SLO_TPOT = DEFAULT_SLO.tpot


def pct(xs: Sequence[float], q: float) -> float:
    if len(xs) == 0:
        return float("nan")
    return float(np.percentile(np.asarray(xs), q))


def interference_summary(snapshot: Dict) -> Dict:
    """Cross-family interference view of a metrics-registry snapshot
    (``ClusterSim.metrics_snapshot``), two halves joined by family tag:

    * ``displaced_tokens[victim][displacer]`` — prefill tokens already
      queued ahead of an arriving ``victim``-family request, attributed
      to the ``displacer`` family that owns them (``_enqueue``);
    * ``queue_delay_ms[family]`` — histogram stats (count/sum/max/
      p50/p99) of schedule→first-token delay per family.
    """
    counters = snapshot.get("counters", {})
    hists = snapshot.get("hists", {})
    displaced: Dict[str, Dict[str, int]] = {}
    pre = "interference.displaced_tokens."
    for k, v in sorted(counters.items()):
        if k.startswith(pre):
            victim, displacer = k[len(pre):].split(".", 1)
            displaced.setdefault(victim, {})[displacer] = int(v)
    qpre = "interference.queue_delay_ms."
    qdelay = {k[len(qpre):]: st for k, st in sorted(hists.items())
              if k.startswith(qpre)}
    return {"displaced_tokens": displaced, "queue_delay_ms": qdelay}


def summarize(requests: List[Request], slo_ttft: float = SLO_TTFT,
              slo_tpot: float = SLO_TPOT,
              by_family: bool = True,
              per_family_slo: bool = False,
              registry_snapshot: Optional[Dict] = None
              ) -> Dict[str, float]:
    """Latency + SLO summary of a finished-request log.

    Besides the TTFT/TPOT percentiles, reports

    * ``ttft_slo_attainment`` / ``tpot_slo_attainment`` — fraction of
      completed requests meeting each SLO (single-token requests have no
      TPOT and count as meeting it),
    * ``slo_attainment`` — both at once,
    * ``goodput_rps`` — within-SLO completions per second of makespan
      (the paper-style "useful throughput" a closed-loop client sees),
    * ``families`` — the same summary per workload-family tag, present
      when any request carries one (mixed traces, hotspot bursts,
      closed-loop scenarios).

    ``per_family_slo=True`` judges every request by its family's entry
    in ``repro_torch.core.types.FAMILY_SLOS`` (chat-lenient /
    agent-strict) instead of the single ``slo_ttft``/``slo_tpot`` pair —
    the mixed-scenario spelling the overload runs report.

    ``registry_snapshot`` (a ``ClusterSim.metrics_snapshot`` dict)
    attaches the :func:`interference_summary` block as ``interference``.
    """
    done = [r for r in requests if r.t_finish > 0.0]
    ttft = [r.ttft for r in done]
    tpot = [r.tpot for r in done if r.output_len > 1]
    hits = sum(r.hit_tokens for r in done)
    toks = sum(r.prompt_len for r in done)
    makespan = max((r.t_finish for r in done), default=0.0)
    if per_family_slo:
        slos = [slo_for_family(r.family) for r in done]
    else:
        slos = [SLO(ttft=slo_ttft, tpot=slo_tpot)] * len(done)
    ttft_ok = [s.ttft_met(r) for s, r in zip(slos, done)]
    tpot_ok = [s.tpot_met(r) for s, r in zip(slos, done)]
    both_ok = sum(1 for a, b in zip(ttft_ok, tpot_ok) if a and b)
    out = {
        "n": len(done),
        "ttft_mean": float(np.mean(ttft)) if ttft else math.nan,
        "ttft_p50": pct(ttft, 50), "ttft_p95": pct(ttft, 95),
        "ttft_p99": pct(ttft, 99),
        "tpot_mean": float(np.mean(tpot)) if tpot else math.nan,
        "tpot_p50": pct(tpot, 50), "tpot_p95": pct(tpot, 95),
        "tpot_p99": pct(tpot, 99),
        "kv_hit_ratio": hits / max(toks, 1),
        "makespan": makespan,
        "ttft_slo_attainment": (sum(ttft_ok) / len(done)) if done
        else math.nan,
        "tpot_slo_attainment": (sum(tpot_ok) / len(done)) if done
        else math.nan,
        "slo_attainment": (both_ok / len(done)) if done else math.nan,
        "goodput_rps": both_ok / max(makespan, 1e-9),
    }
    if by_family and any(r.family for r in done):
        fams: Dict[str, List[Request]] = {}
        for r in done:
            fams.setdefault(r.family or "untagged", []).append(r)
        out["families"] = {
            fam: summarize(rs, slo_ttft, slo_tpot, by_family=False,
                           per_family_slo=per_family_slo)
            for fam, rs in sorted(fams.items())}
    if registry_snapshot is not None:
        out["interference"] = interference_summary(registry_snapshot)
    return out


def hardware_class_summary(requests: List[Request], fleet,
                           per_family_slo: bool = True
                           ) -> Dict[str, Dict[str, float]]:
    """:func:`summarize` per hardware class of a mixed fleet: finished
    requests grouped by ``fleet.class_of(r.sched_to)``, judged by their
    family SLO by default.  Requests that never finished or never got
    scheduled have no class and are left out (``overload_summary``
    accounts for them)."""
    by_cls: Dict[str, List[Request]] = {}
    for r in requests:
        if r.t_finish <= 0.0 or r.sched_to < 0:
            continue
        by_cls.setdefault(fleet.class_of(r.sched_to), []).append(r)
    return {c: summarize(rs, by_family=False,
                         per_family_slo=per_family_slo)
            for c, rs in sorted(by_cls.items())}


def overload_summary(finished: List[Request],
                     dropped: Sequence[Request] = (),
                     churn_recovery: Sequence[float] = ()
                     ) -> Dict[str, float]:
    """Overload and failure accounting over a run's request fates.

    ``wasted_fraction`` is the share of prefill work (new tokens
    prefilled) that bought no within-SLO completion: prefill of requests
    that finished late (by their family SLO) plus prefill burnt on
    retracted requests before the cancel.  Shedding burns nothing and
    shows only in ``n_shed``.  ``churn_recovery`` percentiles are the
    failure → first-token-elsewhere latencies of orphaned requests.
    """
    useful = wasted = 0
    late = 0
    for r in finished:
        work = max(r.new_tokens, 0)
        if slo_for_family(r.family).met(r):
            useful += work
        else:
            late += 1
            wasted += work
    retracted = [r for r in dropped if r.drop_reason == "retracted"]
    shed = [r for r in dropped if r.drop_reason == "shed"]
    wasted += sum(r.prefill_done for r in retracted)
    total = useful + wasted
    rec = list(churn_recovery)
    return {
        "n_finished": len(finished),
        "n_late": late,
        "n_shed": len(shed),
        "n_retracted": len(retracted),
        "useful_prefill_tokens": int(useful),
        "wasted_prefill_tokens": int(wasted),
        "wasted_fraction": wasted / total if total else 0.0,
        "n_rerouted": len(rec),
        "churn_recovery_p50": pct(rec, 50) if rec else 0.0,
        "churn_recovery_p95": pct(rec, 95) if rec else 0.0,
    }


def cdf(xs: Sequence[float], n_points: int = 50):
    xs = np.sort(np.asarray(xs))
    if len(xs) == 0:
        return [], []
    qs = np.linspace(0, 100, n_points)
    return list(np.percentile(xs, qs)), list(qs / 100.0)


def imbalance_stats(profile: Dict[int, List[float]]) -> Dict[str, float]:
    """Std-dev of per-instance prefill seconds across windows; also the
    paper's Fig. 10 metric: pick the window-wise top-2 spread."""
    if not profile:
        return {"mean_std": 0.0, "max_spread": 0.0}
    stds, spreads = [], []
    for w, vals in profile.items():
        v = np.asarray(vals)
        stds.append(float(v.std()))
        spreads.append(float(v.max() - v.min()))
    return {"mean_std": float(np.mean(stds)),
            "max_spread": float(np.max(spreads))}


def fmt_row(name: str, s: Dict[str, float]) -> str:
    row = (f"{name:28s} n={s['n']:6d} "
           f"TTFT mean={s['ttft_mean'] * 1e3:9.1f}ms "
           f"p50={s['ttft_p50'] * 1e3:8.1f} p95={s['ttft_p95'] * 1e3:9.1f} "
           f"p99={s['ttft_p99'] * 1e3:9.1f} | "
           f"TPOT mean={s['tpot_mean'] * 1e3:7.2f}ms "
           f"p99={s['tpot_p99'] * 1e3:7.2f} | "
           f"hit={s['kv_hit_ratio'] * 100:5.1f}%")
    if "slo_attainment" in s:
        row += (f" | slo={s['slo_attainment'] * 100:5.1f}% "
                f"good={s['goodput_rps']:6.2f}/s")
    return row
