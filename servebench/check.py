"""What decides ``correct``: the program's outputs in the window, held to
the plain references once the window has closed.

* Placements: every routing decision of the run (the warm-up's and the
  window's) against ``reference/lmetric_router.py`` replaying the same
  arrivals and the order in which the engines stepped.  The reference
  works out what each engine step did (its kind, the prompt tokens it
  prefilled after restoring a stored prompt, first tokens, finishes)
  from the arrivals and the serving set-up, feeds its router from that,
  and counts the steps the program reported otherwise.  Exact: the
  limit is 0 differences of either kind.
* Served tokens: a sample of the requests the window finished (or the
  drain after it, ``serving.drain``, finished: ``enough``), drawn from
  the seed, with the longest among them, of at least ``sample_tokens``
  served tokens; ``reference/<name>.py``
  runs each prompt with its served tokens once, in float32 with TF32
  off, and at every served position reads how far the served token's
  logit lies below the reference's best.  ``GAPS`` reduces those gaps to
  the numbers a configuration may hold to a limit (its ``check.limits``):
  the widest gap, or the mean gap where a rare near-tie flipped by
  bfloat16 (a MoE router's) makes the widest swing.  Every prompt and
  token is the benchmark's; the served tokens are what is judged.
* A run whose sample holds fewer than ``sample_tokens`` served tokens,
  or that finishes fewer than ``min_finished`` requests, has too little
  to judge and is not correct.

The control computes in float8 e4m3, the precision below the
configurations' bfloat16: ``fp8`` rounds each weight with one scale per
output channel (per row of the embedding), ``fp8_matmul`` each
activation row before it meets a weight, and the products run in
float32.  ``control_gaps`` reads, at each position, the reference's gap
of the token the control puts first, and ``limit_checks`` holds those
gaps to the same limits as the program's.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .reference import lmetric_router


def load_reference(name: str):
    """``servebench/reference/<name>.py``, the configuration's plain
    reference."""
    return importlib.import_module(f"servebench.reference.{name}")


def _round_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def fp8(w: torch.Tensor, kind: str) -> torch.Tensor:
    return _round_fp8(w.float(), -1 if kind == "embed" else -2)


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _round_fp8(x, -1) @ w


def sample(recs: Sequence, seed: int, max_tokens: int,
           max_requests: int) -> List:
    """Finished requests to judge: the longest (prompt and answer), then
    others in an order drawn from the seed, up to ``max_tokens`` served
    tokens or ``max_requests`` requests; one that reused a stored
    fragment is added if the draw has none and the window had one."""
    done = sorted((r for r in recs if r.finished), key=lambda r: r.rid)
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens) + r.output_len,
                                       -r.rid))
    chosen, served = [longest], longest.output_len
    order = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 7]
                                  ).permutation(len(done))
    for i in order:
        r = done[i]
        if served >= max_tokens or len(chosen) >= max_requests:
            break
        if r is not longest:
            chosen.append(r)
            served += r.output_len
    reused = [r for r in done if r.computed < len(r.tokens)]
    if reused and all(r.computed >= len(r.tokens) for r in chosen):
        chosen.append(reused[0])
    return chosen


def reference_logits(ref, cfg: Dict, params: Dict, chosen: Sequence,
                     device, control: bool = False) -> List[torch.Tensor]:
    """Logits at each served position: the prompt's last position, then
    each served token but the last (``control``: computed in float8)."""
    seqs, want = [], []
    for r in chosen:
        toks = np.concatenate([r.tokens, np.asarray(r.out[:-1], np.int64)])
        seqs.append(torch.as_tensor(toks, device=device))
        P = len(r.tokens)
        want.append(torch.arange(P - 1, P - 1 + len(r.out), device=device))
    kw = {"convert": fp8, "mm": fp8_matmul} if control else {}
    return ref.logits_at(cfg, params, seqs, want, **kw)


def token_gaps(logits: Sequence[torch.Tensor], chosen: Sequence) -> np.ndarray:
    """Per served token: the reference's best logit less the served
    token's."""
    out = []
    for lg, r in zip(logits, chosen):
        tok = torch.as_tensor(r.out, device=lg.device)
        out.append((lg.max(-1).values
                    - lg.gather(-1, tok[:, None])[:, 0]).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def control_gaps(logits: Sequence[torch.Tensor],
                 control: Sequence[torch.Tensor]) -> np.ndarray:
    out = []
    for lg, c in zip(logits, control):
        top = c.argmax(-1)
        out.append((lg.max(-1).values
                    - lg.gather(-1, top[:, None])[:, 0]).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


#: the numbers the gaps of a sample reduce to
GAPS = {"widest_logit_gap": np.max, "mean_logit_gap": np.mean,
        "share_not_top": lambda g: float(np.mean(g > 0))}


def limit_checks(lim: Dict, gaps) -> Dict:
    """Each number of ``lim["limits"]`` that ``gaps`` reduce to, beside
    its limit (None: nothing judged)."""
    return {name: {"value": None if gaps is None
                   else float(GAPS[name](gaps)), "limit": limit}
            for name, limit in lim["limits"].items()}


def decide(checks: Dict) -> Tuple[bool, int]:
    """(correct, how many checks failed): a ``*_min`` number has to reach
    its limit, every other stay within it; a missing number fails."""
    failed = sum(c["value"] is None or (
        c["value"] < c["limit"] if name.endswith("_min")
        else c["value"] > c["limit"]) for name, c in checks.items())
    return failed == 0, failed


def _served(chosen: Sequence) -> int:
    return int(sum(len(r.out) for r in chosen))


def enough(cfg: Dict, seed: int):
    """Whether a window's requests give the sample its size: at least
    ``min_finished`` finished and ``sample_tokens`` served tokens in
    what ``sample`` draws (for ``serving.drain``)."""
    lim = cfg["check"]

    def done(recs: Sequence) -> bool:
        if sum(r.finished for r in recs) < lim["min_finished"]:
            return False
        return _served(sample(recs, seed, lim["sample_tokens"],
                              lim["sample_requests"])) >= lim["sample_tokens"]
    return done


def judge(cfg: Dict, params: Dict, window, seed: int, device) -> Dict:
    """``correct``, ``failed`` and each number compared with its limit."""
    lim = cfg["check"]
    rec = window.recorder
    ref_iids, steps_differing = lmetric_router.replay(cfg["serving"],
                                                      rec.events)
    mismatched = int(sum(a != b for a, b in zip(ref_iids, rec.decisions))
                     + abs(len(ref_iids) - len(rec.decisions)))
    chosen = sample(list(window.requests.values()), seed,
                    lim["sample_tokens"], lim["sample_requests"])
    finished = sum(r.finished for r in window.requests.values())
    short = [r.rid for r in chosen if len(r.out) != r.output_len]
    served = _served(chosen)
    gaps = None                   # nothing judged: not correct
    if served and not short:
        ref = load_reference(cfg["reference"])
        gaps = token_gaps(reference_logits(ref, cfg, params, chosen, device),
                          chosen)
    checks = {"placements_differing": {"value": mismatched, "limit": 0},
              "engine_steps_differing": {"value": steps_differing,
                                         "limit": 0},
              "requests_finished_min": {"value": finished,
                                        "limit": lim["min_finished"]},
              "served_tokens_judged_min": {"value": served,
                                           "limit": lim["sample_tokens"]},
              "answers_cut_short": {"value": len(short), "limit": 0}}
    checks.update(limit_checks(lim, gaps))
    correct, failed = decide(checks)
    return {"correct": correct, "failed": failed, "checks": checks,
            "gaps": {n: None if gaps is None else float(f(gaps))
                     for n, f in GAPS.items()},
            "served_tokens_judged": served,
            "requests_judged": len(chosen)}


def control(cfg: Dict, params: Dict, window, seed: int, device,
            verdict: Dict) -> Dict:
    """The control in the program's place: the sample ``judge`` drew,
    read by the reference in float8 (``control_gaps``), held to the same
    limits beside the run's other checks (``verdict``'s) and decided the
    same way.  Its ``correct`` has to come out false."""
    lim = cfg["check"]
    chosen = sample(list(window.requests.values()), seed,
                    lim["sample_tokens"], lim["sample_requests"])
    ref = load_reference(cfg["reference"])
    lg = reference_logits(ref, cfg, params, chosen, device)
    ctl = reference_logits(ref, cfg, params, chosen, device, control=True)
    gaps = control_gaps(lg, ctl)
    checks = {**verdict["checks"], **limit_checks(lim, gaps)}
    correct, failed = decide(checks)
    return {"correct": correct, "failed": failed, "checks": checks,
            "gaps": {n: float(f(gaps)) for n, f in GAPS.items()}}
