"""The one traffic generator: a traffic file's parameters in, requests out.

``family_trace`` is a frozen copy of ``repro_torch.workloads.traces
.make_trace`` for one family of the paper's synthetic traces (the same
``numpy.random.RandomState`` draws in the same order), with the family's
parameters and the block size read from the traffic file instead of the
program's table.  Prompts are sequences of block ids; ``block_tokens``
turns each id into ``block`` token ids drawn from ``--seed``, so a seed
changes what every prompt says and never how long it is or when it comes.

A traffic file (``servebench/traffic/<name>.json``) holds:

* ``family``: the ``TraceFamily`` fields of ``traces.py`` (sizes in
  blocks, popularity, turns, output lengths, arrival burstiness);
* ``block``: tokens per block (64, as the paper's traces);
* ``trace_seed``, ``trace_qps``, ``trace_seconds``: the fixed trace the
  cell replays, so every run seed gets the same sizes and arrivals;
* ``loop``: ``"open"`` (arrivals at ``trace arrival * trace_qps / rate``,
  ``rate`` in requests per second of the engines' virtual time) or
  ``"closed"`` (``clients`` callers, each sending the next request of the
  trace, in trace order, as soon as its previous one finishes);
* ``shared``: false gives every block of every request a fresh id, so no
  prompt token repeats anywhere and no prefix can be reused;
* ``warmup``: ``"system_prompts"`` (each app's bare system prompt, served
  before the window, ``warmup_output`` tokens each) or ``"none"``.
"""
from __future__ import annotations

import itertools
import math
import zlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class TraceRequest:
    arrival: float
    blocks: Tuple[int, ...]
    output_len: int


def family_trace(name: str, fam: Dict, qps: float, duration: float,
                 seed: int) -> List[TraceRequest]:
    """Open-loop requests of one family, sorted by arrival: the draws of
    ``make_trace(name, qps, duration, seed)`` in its order."""
    rng = np.random.RandomState(
        (seed % 2 ** 32) ^ (zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF))
    block_ids = itertools.count(1)
    apps = [tuple(next(block_ids) for _ in range(fam["app_prefix_blocks"]))
            for _ in range(fam["n_apps"])]
    app_p = 1.0 / np.arange(1, fam["n_apps"] + 1) ** fam["zipf_a"]
    app_p /= app_p.sum()
    conv_rate = qps / fam["turns_mean"]
    out: List[TraceRequest] = []
    t = 0.0
    shape = 1.0 / (fam["arrival_cv"] ** 2)
    while t < duration:
        rate = conv_rate * (1.0 + fam["rate_wobble"]
                            * math.sin(2 * math.pi * t / 300.0))
        t += rng.gamma(shape, 1.0 / (shape * max(rate, 1e-6)))
        if t >= duration:
            break
        app = int(rng.choice(fam["n_apps"], p=app_p))
        history = list(apps[app])
        n_turns = max(1, int(rng.poisson(fam["turns_mean"])))
        turn_t = t
        for turn in range(n_turns):
            nb = fam["first_input_blocks"] if turn == 0 \
                else fam["turn_input_blocks"]
            nb = max(1, int(rng.poisson(nb)))
            history.extend(next(block_ids) for _ in range(nb))
            n_out = max(2, int(rng.lognormal(
                math.log(fam["output_tokens_mean"]),
                fam["output_tokens_cv"] * 0.7)))
            out.append(TraceRequest(turn_t, tuple(history), n_out))
            # the answer joins the context of the next turn (64-token
            # blocks in the program's generator)
            history.extend(next(block_ids)
                           for _ in range(max(1, n_out // 64)))
            turn_t += max(0.5, rng.exponential(fam["think_time_mean"])) \
                + n_out * 0.02
            if turn_t >= duration:
                break
    out.sort(key=lambda r: r.arrival)   # stable, as ``list.sort`` there
    return out


# ---------------------------------------------------------------------------
_M64 = (1 << 64) - 1


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(_M64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def block_tokens(block_ids: np.ndarray, block: int, seed: int,
                 vocab: int) -> np.ndarray:
    """(n,) block ids -> (n * block,) token ids in [0, vocab), a function
    of (seed, block id, place in the block) alone."""
    ids = np.asarray(block_ids, np.uint64)
    j = np.arange(block, dtype=np.uint64)
    with np.errstate(over="ignore"):
        s = _splitmix64(np.full(1, seed & _M64, np.uint64))
        x = _splitmix64(ids[:, None] * np.uint64(block) + j[None, :] + s)
    return (x % np.uint64(vocab)).astype(np.int64).reshape(-1)


@dataclass
class Workload:
    """What one run sends: ``warmup`` and ``requests`` as (arrival,
    tokens, output_len) tuples; ``clients`` > 0 for a closed loop."""
    warmup: List[Tuple[float, np.ndarray, int]]
    requests: List[Tuple[float, np.ndarray, int]]
    clients: int


def make_workload(traffic: Dict, seed: int, vocab: int,
                  max_len: int) -> Workload:
    """The cell's requests for ``seed``.  A request whose prompt and
    answer would not fit an engine's ``max_len`` rows (a long
    conversation's late turns) is left out of the trace, so that every
    answer is served whole."""
    block = traffic["block"]
    trace = family_trace(traffic["family_name"], traffic["family"],
                         traffic["trace_qps"], traffic["trace_seconds"],
                         traffic["trace_seed"])
    trace = [r for r in trace
             if len(r.blocks) * block + r.output_len <= max_len - 2]
    fresh = itertools.count(1 << 40)
    if not traffic["shared"]:
        trace = [TraceRequest(r.arrival, tuple(next(fresh) for _ in r.blocks),
                              r.output_len) for r in trace]

    def tokens(blocks):
        return block_tokens(np.asarray(blocks, np.uint64), block, seed, vocab)

    if traffic["loop"] == "open":
        scale = traffic["trace_qps"] / traffic["rate"]
        reqs = [(r.arrival * scale, tokens(r.blocks), r.output_len)
                for r in trace]
        clients = 0
    else:
        reqs = [(0.0, tokens(r.blocks), r.output_len) for r in trace]
        clients = traffic["clients"]
    kind, n_out = traffic["warmup"], traffic.get("warmup_output", 2)
    fam = traffic["family"]
    if kind == "system_prompts":
        warm = [(0.0, tokens(range(1 + a * fam["app_prefix_blocks"],
                                   1 + (a + 1) * fam["app_prefix_blocks"])),
                 n_out) for a in range(fam["n_apps"])]
    elif kind == "none":
        warm = []
    else:
        raise ValueError(f"unknown warm-up {kind!r}")
    return Workload(warm, reqs, clients)
