"""The readings a cell's correctness limit is set from, on the card.

    python3 servebench/control.py --workload <cell> --seconds <s> \\
        --seeds 11,12,... --control-seeds 11,12,13

One process serves the cell once per seed (fresh weights and cluster),
with the run's own window, sample and reference, and prints one JSON
line per seed:

* ``program``: the numbers ``check.GAPS`` reduces the gaps of the served
  tokens below the reference's best logit to, and every number
  ``check.judge`` compared beside its limit;
* ``control`` (seeds in ``--control-seeds``): the same prompts and served
  tokens read by the reference computed in float8 e4m3 (``check.fp8``,
  ``check.fp8_matmul``), the next precision below the configuration's
  bfloat16: at each position the reference's gap of the token the
  control puts first, reduced the same way and held to the same limits
  (``check.control``); ``correct`` is the run's verdict with the
  control's tokens in the program's place, and has to come out false.

The lower reading of a limit is the largest ``program`` number over the
seeds, the upper the smallest ``control`` number.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from servebench import run  # noqa: E402  (paths and cache directories)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    run._environment()
    import torch
    from servebench import check, harness, serving, traffic_gen
    with open(run.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    srv = cfg["serving"]
    ctl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        built = serving.build(cfg, seed, "cuda")
        cluster = serving.make_cluster(built, srv, "cuda")
        work = traffic_gen.make_workload(traffic, seed, cfg["vocab_size"],
                                         srv["max_len"])
        win = serving.serve(cluster, work, args.seconds)
        serving.drain(cluster, win, check.enough(cfg, seed),
                      harness.DRAIN_SECONDS)
        serving.free(cluster)
        del cluster
        verdict = check.judge(cfg, built.params, win, seed, "cuda")
        line = {"seed": seed, "correct": verdict["correct"],
                "program": verdict["gaps"], "checks": verdict["checks"],
                "requests_judged": verdict["requests_judged"]}
        if seed in ctl_seeds:
            line["control"] = check.control(cfg, built.params, win, seed,
                                            "cuda", verdict)
        del built, win
        gc.collect()          # the recorder and the engines hold a cycle
        torch.cuda.empty_cache()
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
