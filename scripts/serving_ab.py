"""Compare checkouts of the repo on one serving path, back to back on one
card, and time the ways an engine slot can be copied to the host.

Each argument is the root of a checkout (this repo, or an older commit
unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  In the order given, each runs in a process of its own: it builds
its own kernels (``chip_smoke.KERNELS``, into its own ``build/``), runs
its ``chip_smoke.serving_path`` for ``--arch`` (Qwen2-7B by default) and
prints one JSON line: TTFT and TPOT, the median walls of a full prefill
chunk that does not end its prompt, of a chunk that ends it (which copies
the prompt's fragment to the host) and of a decode step.  Give the trees
as A, B, B, A so that drift of the host shows.

Then, in this process, one Qwen2-7B slot of an engine (28 layers of K and
V rows, 4096 x 4 x 128 bf16 each: 235 MB) is copied to the host five
ways and back two ways (median of 5, host wall, synchronised): each leaf
on its own (56 copies), the slot of a stacked (layers, slots, ...) cache
(2 copies), every leaf gathered into one flat device buffer and copied
once, and that flat buffer into newly allocated or into reused pinned
host memory.  Every copy to the host is kept until the way's last
repetition, as a prefix store keeps its fragments, so that each one
lands in memory that no earlier copy freed.

Run on a machine with a CUDA card, from the repo root:

    python3 scripts/serving_ab.py build/ab/parent . . build/ab/parent

With no checkout given, only the slot copies are timed; ``--no-copies``
skips them.

``--kernels`` times each tree's ``rglru_scan`` and ``mlstm_cell`` instead
(device time per launch, cold and warm, and the wrapper's wall:
``chip_smoke.time_recurrent_kernels``) and its ``route_score`` at the main
path's wave (k = 64 over 16384 instances) and the simulator's waves (k =
9 and 28 over 16): device time per wave cold and warm, and
``route_wave``'s wall per wave (``chip_smoke.time_route_kernels``, which
calls only ``route_wave_device``, ``route_wave`` and ``_pack_aux``, as
every tree has them); ``--profile ARCH,...`` traces
each tree's decode steps and prefill chunks of the named models
(``chip_smoke.profile_steps``); ``--routing`` runs each tree's routing
path (``chip_smoke.main_path``: 2000 hotspot requests over 16384
instances in waves of 64, route_batch and sequential ``route()`` under
lmetric and vllm, building only ``route_score``) and prints its walk /
score / commit µs per wave and µs per decision (and, where the tree has
the routed-window rings, their width after the run, one ring write's µs
and one doubling's ms); all three run THIS
checkout's timing code against each tree's own package and kernels, so
that an older tree is measured the same way:

    python3 scripts/serving_ab.py --kernels build/ab/parent . . build/ab/parent
"""
import argparse
import json
import os
import subprocess
import sys
import time

CHILD = r"""
import json, sys
import numpy as np
import torch
import chip_smoke as c
from repro_torch.kernels import _build
_build.build(c.KERNELS)
sv = c.serving_path(torch, sys.argv[1])
s = sv["summary"]
chunks, decodes = sv["chunks"], sv["decodes"]
med = lambda v: float(np.median(v)) if v else None
print("RESULT " + json.dumps({
    "arch": sys.argv[1], "requests": s["n"], "wall_s": sv["wall_s"],
    "ttft_mean_ms": s["ttft_mean"] * 1e3, "ttft_p50_ms": s["ttft_p50"] * 1e3,
    "ttft_p95_ms": s["ttft_p95"] * 1e3, "tpot_mean_ms": s["tpot_mean"] * 1e3,
    "mid_chunk_ms": med([x[4] * 1e3 for x in chunks
                         if x[2] == c.CHUNK and not x[5]]),
    "end_chunk_ms": med([x[4] * 1e3 for x in chunks if x[5]]),
    "decode_ms": med([x[4] * 1e3 for x in decodes]),
    "n_chunks": len(chunks), "n_decodes": len(decodes)}))
"""


#: ``--kernels`` and ``--profile``: this checkout's timing code
#: (``chip_smoke.time_recurrent_kernels``, ``chip_smoke.profile_steps``)
#: run against the tree's own package and kernels
HERE_CHILD = r"""
import json, os, sys
here, tree, mode = sys.argv[1], os.path.abspath(sys.argv[2]), sys.argv[3]
sys.path.insert(0, here)
import torch
import chip_smoke as c
sys.path.insert(0, os.path.join(tree, "src"))
from repro_torch.kernels import _build
assert os.path.abspath(_build.__file__).startswith(tree), _build.__file__
_build.build(("route_score",) if mode == "routing" else c.KERNELS)
if mode == "routing":
    import time
    import numpy as np
    res, _ = c.main_path(c.N_INST, c.MAIN_REQUESTS, "cuda")
    out = {}
    for name, r in res.items():
        st = r["router"].stage_stats()
        out[name] = {k: st[k] for k in ("walk_us", "score_us", "commit_us",
                                        "waves")}
        out[name].update({k: r[k] for k in ("batch_us_per_decision",
                                            "route_us_per_decision")})
        f = r["router"].factory
        if hasattr(f, "log_routed"):
            # the routed-window rings: their width after the run (256 =
            # never doubled), one ring write, and one doubling
            out[name]["ring_cap"] = int(f._log_t.shape[1])
            ts = []
            for i in range(2000):
                t0 = time.perf_counter_ns()
                f.log_routed(i % 64, 1e6, 1)
                ts.append(time.perf_counter_ns() - t0)
            out[name]["log_routed_us"] = float(np.median(ts)) / 1e3
            t0 = time.perf_counter()
            f._grow_log()
            out[name]["grow_ms"] = (time.perf_counter() - t0) * 1e3
    print("RESULT " + json.dumps(out))
elif mode == "kernels":
    from repro_torch.kernels import route_score as rs
    t = c.time_recurrent_kernels(torch)
    t.update(c.time_route_kernels(torch, rs))
    print("RESULT " + json.dumps(t))
else:
    gpu = c.card()
    for arch in sys.argv[4:]:
        c.profile_steps(torch, gpu, arch)
    print("RESULT {}")
"""
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tree(root, arch, mode="serving", archs=()):
    """Run one tree in a process of its own; returns the child's RESULT
    (and, for ``profile``, its printed lines under "lines")."""
    root = os.path.abspath(root)
    if mode == "serving":
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root, os.path.join(root, "src")]))
        argv = [sys.executable, "-c", CHILD, arch]
    else:
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        argv = [sys.executable, "-c", HERE_CHILD, HERE, root, mode, *archs]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=root, env=env, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"{root}: exit {proc.returncode}")
    lines = proc.stdout.splitlines()
    line = next(x for x in lines if x.startswith("RESULT "))
    out = json.loads(line[len("RESULT "):])
    if mode == "profile":
        out["lines"] = [x for x in lines if not x.startswith("RESULT ")]
    out.update(tree=root, process_s=time.perf_counter() - t0)
    return out


def time_slot_copies(reps=5):
    import numpy as np
    import torch
    L, S, KV, HD, B = 28, 4096, 4, 128, 2
    dev = torch.device("cuda")
    layers = [{n: torch.randn((B, S, KV, HD), device=dev).to(torch.bfloat16)
               for n in ("k", "v")} for _ in range(L)]
    leaves = [t for c in layers for t in c.values()]
    stacked = {n: torch.stack([c[n] for c in layers]) for n in ("k", "v")}
    nbytes = sum(t[0].numel() * t.element_size() for t in leaves)
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def gather():
        flat = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        off = 0
        for t in leaves:
            n = t[0].numel() * t.element_size()
            flat[off:off + n].view(t.dtype).view(t.shape[1:]).copy_(t[1])
            off += n
        return flat

    def fresh_pinned():
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        host.copy_(gather())
        return host

    ways = {
        "each leaf to pageable host memory (56 copies)":
            lambda: [t[1].to("cpu", copy=True) for t in leaves],
        "slot of a stacked cache to pageable host memory (2 copies)":
            lambda: [stacked[n][:, 1].to("cpu", copy=True)
                     for n in ("k", "v")],
        "flat device gather, one copy to pageable host memory":
            lambda: gather().cpu(),
        "flat device gather, one copy to new pinned host memory":
            fresh_pinned,
        "flat device gather, one copy to reused pinned host memory":
            lambda: pinned.copy_(gather()),
    }
    host_leaves = [t[1].cpu() for t in leaves]
    host_flat = gather().cpu()

    def restore_flat():
        flat, off = host_flat.to(dev), 0
        for t in leaves:
            n = t[0].numel() * t.element_size()
            t[0].copy_(flat[off:off + n].view(t.dtype).view(t.shape[1:]))
            off += n

    back = {
        "each leaf from pageable host memory (56 copies)":
            lambda: [t[0].copy_(h) for t, h in zip(leaves, host_leaves)],
        "one copy of the flat buffer, then 56 device copies":
            restore_flat,
    }
    out = {}
    for name, fn in list(ways.items()) + list(back.items()):
        walls, kept = [], []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kept.append(fn())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[name] = float(np.median(walls[1:])) * 1e3
        del kept
    return nbytes, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="checkout roots, in run order")
    ap.add_argument("--arch", default="qwen2_7b")
    ap.add_argument("--no-copies", action="store_true",
                    help="do not time the slot copies")
    ap.add_argument("--kernels", action="store_true",
                    help="time each tree's rglru_scan, mlstm_cell and "
                         "route_score with this checkout's timing code "
                         "instead of serving")
    ap.add_argument("--routing", action="store_true",
                    help="run each tree's routing path (chip_smoke's "
                         "phase 3) with this checkout's code instead of "
                         "serving; prints its stage times")
    ap.add_argument("--profile", metavar="ARCH[,ARCH...]",
                    help="trace each tree's steps of these models with "
                         "this checkout's --profile code instead of "
                         "serving")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    mode = ("kernels" if args.kernels else "routing" if args.routing
            else "profile" if args.profile else "serving")
    for root in args.trees:
        out = run_tree(root, args.arch, mode,
                       args.profile.split(",") if args.profile else ())
        for line in out.pop("lines", []):
            print(f"{root}: {line}")
        print(json.dumps(out), flush=True)
    if args.no_copies or mode != "serving":
        return
    nbytes, copies = time_slot_copies()
    for name, ms in copies.items():
        print(f"[{card}] slot of {nbytes} bytes, {name}: {ms:.2f} ms "
              f"(median of 5)")


if __name__ == "__main__":
    main()
