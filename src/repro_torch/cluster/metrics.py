"""Serving-quality metrics — port of ``repro.cluster.metrics``: ``pct``
and ``summarize`` (TTFT/TPOT percentiles, SLO attainment, goodput and
per-family breakdowns), ``cdf``, ``imbalance_stats`` (Fig. 10's
per-window prefill spread) and ``fmt_row``.  The interference,
hardware-class and overload summaries arrive with observability, fleets
and overload control (ROADMAP Queue A items 5-7)."""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from ..core.types import DEFAULT_SLO, Request, SLO, slo_for_family

SLO_TTFT = DEFAULT_SLO.ttft
SLO_TPOT = DEFAULT_SLO.tpot


def pct(xs: Sequence[float], q: float) -> float:
    if len(xs) == 0:
        return float("nan")
    return float(np.percentile(np.asarray(xs), q))


def summarize(requests: List[Request], slo_ttft: float = SLO_TTFT,
              slo_tpot: float = SLO_TPOT,
              by_family: bool = True,
              per_family_slo: bool = False) -> Dict[str, float]:
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
    in ``repro_torch.core.types.FAMILY_SLOS`` (chat-lenient / agent-strict) instead
    of the single ``slo_ttft``/``slo_tpot`` pair — the mixed-scenario
    spelling the overload bench reports.
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
    return out


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
