"""Serving launcher: N in-process engine instances + the LMETRIC router —
port of ``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b \\
      --instances 4 --requests 40 --policy lmetric

As in the reference, ``main`` serves the reduced (``-smoke``) config of
``--arch`` with parameters drawn from seed 0, 40 requests over three
shared 96-token prompts.  It runs on ``--device`` (default ``cuda``,
which needs a card; ``cpu`` runs the kernels' plain versions).  The
body is plain functions: ``make_arrivals`` (the reference's draws, in
its order), ``make_cluster`` (its engine settings) and ``run`` (one
config, policy, parameters and device), which a caller can give a
full-size config.  ``--dry-run`` delegates to ``launch.dryrun`` for
``--arch`` at ``--shape`` (default ``decode_32k``) on the 16 x 16 mesh,
or the 2 x 16 x 16 one with ``--multi-pod``, and returns its record;
without ``--dry-run``, ``--multi-pod`` is ignored, as in the reference.
An encoder-decoder (Whisper) is refused by the engine, as in the
reference.
"""
from __future__ import annotations

import argparse
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np

from ..core import JSQPolicy, LinearKVPolicy, LMetricPolicy

#: the reference launcher's engine settings
ENGINE_KW = dict(block_size=16, max_batch=4, max_len=256, chunk_tokens=64)
POLICIES = {"lmetric": LMetricPolicy, "vllm": JSQPolicy,
            "linear": LinearKVPolicy}


class Served(NamedTuple):
    done: List            # finished requests
    row: str              # ``fmt_row(policy name, summarize(done))``
    cluster: object       # the ``EngineCluster`` that served them


def make_arrivals(n_requests: int, seed: int = 0):
    """(time, prompt tokens, max new tokens) per request: three 96-token
    app prompts, each request one of them plus 8-31 unique tokens and
    4-11 output tokens, exponential gaps of 50 ms mean (the reference's
    ``np.random.RandomState(0)`` draws, in its order)."""
    rng = np.random.RandomState(seed)
    apps = [rng.randint(4, 500, size=96) for _ in range(3)]
    t, arrivals = 0.0, []
    for _ in range(n_requests):
        t += float(rng.exponential(0.05))
        toks = np.concatenate([apps[rng.randint(3)],
                               rng.randint(4, 500,
                                           size=rng.randint(8, 32))])
        arrivals.append((t, toks.astype(np.int32), int(rng.randint(4, 12))))
    return arrivals


def init_params(model):
    """``Model.init`` on a generator seeded 0 on the model's device."""
    import torch
    return model.init(torch.Generator(device=model.device).manual_seed(0))


def make_cluster(model, params, policy: str, instances: int = 4):
    from ..serving.engine import EngineCluster
    return EngineCluster(instances, model, params, POLICIES[policy](),
                         device=model.device, **ENGINE_KW)


def run(cfg, policy: str, params=None, device="cuda", instances: int = 4,
        requests: int = 40,
        prepare: Optional[Callable] = None) -> Served:
    """Serve ``make_arrivals(requests)`` on ``instances`` engines of
    ``cfg`` under ``policy``; ``params`` default to ``init_params``.
    ``prepare(cluster)``, if given, is called just before the run."""
    from ..cluster.metrics import fmt_row, summarize
    from ..models import Model
    model = Model(cfg, device=device)
    if params is None:
        params = init_params(model)
    cluster = make_cluster(model, params, policy, instances)
    if prepare is not None:
        prepare(cluster)
    done = cluster.run(make_arrivals(requests))
    return Served(done, fmt_row(cluster.router.policy.name,
                                summarize(done)), cluster)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--instances", type=int, default=4)
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--policy", default="lmetric", choices=list(POLICIES))
    ap.add_argument("--dry-run", action="store_true",
                    help="the production step's dry run (launch.dryrun)")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.dry_run:
        from .dryrun import launch
        return launch(args.arch, args.shape, args.multi_pod)

    from ..configs import get_config
    out = run(get_config(args.arch + "-smoke"), args.policy,
              device=args.device, instances=args.instances,
              requests=args.requests)
    print(out.row)
    return out


if __name__ == "__main__":
    main()
