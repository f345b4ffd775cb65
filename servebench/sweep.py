"""Find an open-loop cell's knee: the highest offered rate whose queue
does not grow over the window.

    python3 servebench/sweep.py --workload <cell> --rates 8,12,16 \\
        --seconds 45 --seed <n>

One process builds the cell's weights once and serves the cell's traffic
at each rate in turn (a fresh cluster each time, the same warm-up), for
``--seconds`` of wall each.  Per rate it prints one JSON line: the
requests due, the virtual window, TTFT p50 / p95 (``ttft_p95_ms``'s
arithmetic), the median TTFT of the requests due in each third of the
virtual window, and the readers named in ``READ``.  A rate is past the
knee when the queue grows, or when decode starves:

* the queue grows when the last third waits longer than the middle one
  by more than half again and by 250 ms or more: the requests of the
  last third then wait behind a backlog that the earlier ones did not
  find;
* decode starves when fewer than half as many requests finish in the
  window as at the rate before (rates ascending).  A step prefills while
  a slot is free and a request waits, so past the engines' pace the
  prefills keep first tokens coming while decode falls behind: TTFT
  stays flat, TPOT grows and answers stop finishing.

The chosen rate (four fifths of the knee) is written into the cell's
traffic file by hand.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from servebench import run  # noqa: E402  (paths and cache directories)


#: the benchmark's own readers, read at each rate: the host's pace
#: (decode step wall) beside the latencies it sets
READ = ("ttft_p50_ms", "tpot_p95_ms", "decode_step_ms",
        "prefill_ms_per_ktok")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    run._environment()
    import numpy as np
    import torch
    from servebench import harness, serving, traffic_gen
    with open(run.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    if traffic["loop"] != "open":
        print("a closed loop has no knee to find", file=sys.stderr)
        return 2
    srv = cfg["serving"]
    built = serving.build(cfg, args.seed, "cuda")
    prev_finished = None
    for rate in (float(r) for r in args.rates.split(",")):
        tr = dict(traffic, rate=rate)
        work = traffic_gen.make_workload(tr, args.seed, cfg["vocab_size"],
                                         srv["max_len"])
        cluster = serving.make_cluster(built, srv, "cuda")
        win = serving.serve(cluster, work, args.seconds)
        serving.free(cluster)
        del cluster
        torch.cuda.empty_cache()
        recs = sorted(win.requests.values(), key=lambda r: r.arrival)
        ttft = np.array([((r.times[0] if r.times else win.t_cut)
                          - r.arrival) * 1e3 for r in recs])
        arr = np.array([r.arrival for r in recs])
        thirds = [float(np.median(ttft[(arr >= win.t_cut * k / 3)
                                       & (arr < win.t_cut * (k + 1) / 3)]))
                  for k in range(3)]
        grows = thirds[2] > 1.5 * thirds[1] and thirds[2] - thirds[1] >= 250
        finished = sum(r.finished for r in recs)
        starved = prev_finished is not None and finished < prev_finished / 2
        prev_finished = finished
        ctx = harness.Context(cfg, win, 0.0, None)
        print(json.dumps({
            "rate": rate, "due": len(recs),
            "finished": finished,
            "virtual_s": win.t_cut, "wall_s": win.seconds,
            "ttft_p50_ms": float(np.percentile(ttft, 50)),
            "ttft_p95_ms": float(np.percentile(ttft, 95)),
            "ttft_median_by_third_ms": thirds, "queue_grows": bool(grows),
            "decode_starves": bool(starved),
            **{name: harness.reader(name)(ctx) for name in READ}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
