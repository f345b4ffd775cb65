#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits nonzero):

1. build — print the card's name and power limit, build
   ``csrc/route_score.cu`` with nvcc for sm_90a, print the build time;
2. kernel vs plain — the CUDA ``route_score`` kernel against its plain
   PyTorch version on the card, for every kind and ablation, on seeded
   random and forced-tie states at (k, n) in {(24, 32), (64, 1024),
   (64, 16384)}; ``sel`` and ``hit`` must be exactly equal;
3. main path — a 16384-instance cluster, built with
   ``router_from_numpy_state`` from a seeded backlog, routes the hotspot
   trace in waves of 64 through ``Router.route_batch`` (lmetric, vllm);
   a second router from the same state routes with sequential
   ``route()``; decisions and hit tokens must be identical, and the
   kernel's launch count, zeroed just before, must have risen;
4. timings — kernel time per wave (CUDA events), the plain version's
   time on the same wave, the pipeline's stage times and µs per decision
   of both routers, each beside the card's name and power limit.

Without a CUDA device it exits with 2 and prints no result.  The three
last lines of standard output are the JSON kernel record, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""
import collections
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_INST = 16384
WAVE = 64
BLOCK = 64
KV_CAPACITY = 400_000
MAIN_REQUESTS = 2000
#: the run must end within 1200 s; past this point the main path routes
#: fewer requests (never fewer instances)
CUT_AFTER_S = 600.0
CUT_REQUESTS = 512
#: NVIDIA H100 SXM data sheet: HBM3 rate and float64 rate outside the
#: tensor cores, both at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12

CONFIGS = [("jsq", ()), ("linear", (0.7,)), ("filter", (8,)),
           ("filter", (200,)), ("lmetric", ("ptoken", "bs")),
           ("lmetric", ("ptoken", "tokens")),
           ("lmetric", ("one_minus_hit", "bs")),
           ("lmetric", ("one_minus_hit", "tokens")), ("ptoken", ())]
SHAPES = [(24, 32), (64, 1024), (64, 16384)]


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


def wave_state(rng, k, n, ties):
    """Seeded indicator columns and wave inputs at (k, n).  ``ties``
    makes every instance equal except a strided subset that shares the
    same KV$ depth, so most steps choose among many exact ties."""
    i64 = np.int64
    plen = (rng.randint(1, 80, k) * BLOCK - rng.randint(0, BLOCK, k))
    if ties:
        cols = (np.full(n, 3, i64), np.full(n, 1, i64),
                np.full(n, 4096, i64), np.full(n, 90_000, i64))
        depth = np.zeros((k, n), i64)
        depth[:, ::7] = 2
        lcp = np.zeros((k, k), i64)
    else:
        cols = (rng.randint(0, 65, n).astype(i64),
                rng.randint(0, 17, n).astype(i64),
                rng.randint(0, 32769, n).astype(i64),
                rng.randint(0, 400_001, n).astype(i64))
        depth = (rng.randint(0, 80, (k, n))
                 * (rng.rand(k, n) < 0.05)).astype(i64)
        m = rng.randint(0, 80, (k, k))
        lcp = np.minimum(m, m.T).astype(i64)
    return cols, depth, lcp, plen.astype(i64), int(rng.randint(0, 10 ** 9))


def check_kernels(torch, rs):
    """Phase 2: kernel == plain version on the card, exactly."""
    worst, n_cmp = 0, 0
    for k, n in SHAPES:
        for seed, ties in ((1, False), (2, True)):
            rng = np.random.RandomState(seed * 100_003 + n)
            cols, depth, lcp, plen, tie0 = wave_state(rng, k, n, ties)
            cols_d = tuple(torch.from_numpy(c).cuda() for c in cols)
            for kind, params in CONFIGS:
                got = rs.route_wave(kind, params, BLOCK, *cols_d, depth,
                                    lcp, plen, tie0)
                want = rs.route_wave_ref(kind, params, BLOCK, *cols_d,
                                         depth, lcp, plen, tie0)
                torch.cuda.synchronize()
                err = int(max(np.abs(got[0] - want[0]).max(),
                              np.abs(got[1] - want[1]).max()))
                if err:
                    raise AssertionError(
                        f"kernel != plain for {kind}{params} at k={k} "
                        f"n={n} ties={ties}: max |diff| {err}")
                worst = max(worst, err)
                n_cmp += 1
    return worst, n_cmp


def backlog(trace, n, seed=11):
    """A seeded cluster state: indicator columns over the ranges a busy
    fleet shows, and one or two prefixes of the trace's block chains
    cached on every instance."""
    rng = np.random.RandomState(seed)
    arrays = {
        "r_bs": rng.randint(0, 65, n).astype(np.int64),
        "q_bs": rng.randint(0, 17, n).astype(np.int64),
        "queued_prefill_tokens": rng.randint(0, 32769, n).astype(np.int64),
        "total_tokens": rng.randint(0, 400_001, n).astype(np.int64),
    }
    chains = []
    for _ in range(n):
        mine = []
        for _ in range(1 + rng.randint(2)):
            b = trace[rng.randint(len(trace))].blocks
            mine.append(b[:1 + rng.randint(len(b))])
        chains.append(mine)
    return arrays, chains


def drive(router, reqs, use_batch):
    """Route ``reqs`` in waves of WAVE (route_batch, or sequential route()
    with the same per-wave ``now``) under a deterministic partial-drain
    schedule that keeps every indicator moving.  Returns decisions, hit
    tokens and the host nanoseconds spent in the routing calls."""
    decisions, hits, route_ns = [], [], 0
    outstanding = collections.deque()
    for i in range(0, len(reqs), WAVE):
        wave = reqs[i:i + WAVE]
        now = wave[0].arrival
        t0 = time.perf_counter_ns()
        if use_batch:
            iids = router.route_batch(wave, now)
        else:
            iids = [router.route(r, now) for r in wave]
        route_ns += time.perf_counter_ns() - t0
        decisions.extend(iids)
        hits.extend(r.hit_tokens for r in wave)
        for r, iid in zip(wave, iids):
            outstanding.append((iid, r, r.new_tokens))
            router.on_prefill_progress(iid, 256)
        for _ in range(len(wave)):
            if len(outstanding) > 2:
                did, dreq, dnew = outstanding.popleft()
                router.on_prefill_progress(did, dnew)
                router.on_start_running(did, dreq)
                for _ in range(dreq.output_len % 7):
                    router.on_decode_token(did)
                router.on_finish(did, dreq)
    return decisions, hits, route_ns


def main_path(n, n_req, device, policies=("lmetric", "vllm")):
    """Phase 3: route_batch vs sequential route() from one carried-over
    state.  Returns per-policy results and the batch routers."""
    from repro_torch.core import make_policy, router_from_numpy_state
    from repro_torch.workloads.traces import make_hotspot_trace
    trace = make_hotspot_trace(qps=14.0, duration=160.0, seed=5,
                               burst_start=40.0, burst_len=70.0)
    reqs = trace[:n_req]
    arrays, chains = backlog(trace, n)
    out = {}
    for name in policies:
        runs = {}
        for use_batch in (True, False):
            t0 = time.perf_counter()
            router = router_from_numpy_state(
                make_policy(name), n, arrays, chains, tie=0,
                kv_capacity_tokens=KV_CAPACITY, block_size=BLOCK,
                device=device)
            t_build = time.perf_counter() - t0
            dec, hits, ns = drive(router, copy.deepcopy(reqs), use_batch)
            runs[use_batch] = (router, dec, hits, ns, t_build)
        (rb, dec_b, hit_b, ns_b, tb_b), (rq, dec_s, hit_s, ns_s, _) = \
            runs[True], runs[False]
        if dec_b != dec_s:
            j = next(i for i, (a, b) in enumerate(zip(dec_b, dec_s))
                     if a != b)
            raise AssertionError(f"{name}: route_batch diverges from "
                                 f"sequential route() at request {j}")
        if hit_b != hit_s:
            raise AssertionError(f"{name}: hit tokens differ")
        if not all(0 <= d < n for d in dec_b):
            raise AssertionError(f"{name}: decision out of range")
        if rb.factory.evictions:
            raise AssertionError(f"{name}: evictions fired; the wave "
                                 "plan was not exercised as configured")
        out[name] = {"router": rb, "requests": len(reqs),
                     "batch_us_per_decision": ns_b / len(reqs) / 1e3,
                     "route_us_per_decision": ns_s / len(reqs) / 1e3,
                     "build_s": tb_b,
                     "distinct_instances": len(set(dec_b)),
                     "hit_tokens": int(sum(hit_b))}
    return out, trace


def wave_bound(kind, params, k, n):
    """Least (bytes, float64 operations) of one wave of ``kind``.

    Bytes: each int64 input the kind's result depends on, read once, and
    sel/hit written once.  Columns: jsq, linear and filter read rbs and
    qbs; lmetric reads qpt for the "ptoken" KV$ indicator, rbs and qbs
    for the "bs" load indicator or tt for "tokens"; ptoken reads qpt.
    Kinds that score hits also read depth (k x n), the strict lower
    triangle of lcp (row j credits only the earlier requests of the
    wave) and plen; every kind but ptoken reads the one tie counter.
    Operations per instance and step: the kind's float64 score
    arithmetic plus the min reduction and the tie comparison."""
    if kind == "lmetric":
        kv, load = params
        cols = (kv == "ptoken") + (2 if load == "bs" else 1)
        ops = 5 if kv == "ptoken" else 7
    else:
        cols = 1 if kind == "ptoken" else 2
        ops = {"jsq": 4, "linear": 8, "filter": 2, "ptoken": 2}[kind]
    words = cols * n + 2 * k + (kind != "ptoken")
    if kind != "jsq":
        words += k * n + k * (k - 1) // 2 + k
    return 8 * words, ops * k * n


def time_wave(torch, rs, router, wave_reqs, reps=20):
    """Phase 4: the kernel and its plain version on one real wave of the
    main path (k=64 over the router's n instances)."""
    policy, f = router.policy, router.factory
    depth, lcp, plen = policy.wave_inputs(wave_reqs, f)
    cols = f.device_view()
    kind, params = policy.batch_kind, policy._batch_params()
    tie0 = policy._tie_n
    dev = cols[0].device
    depth_d = torch.from_numpy(depth).to(dev)
    aux_d = torch.from_numpy(rs._pack_aux(lcp, plen, tie0)).to(dev)
    for _ in range(3):
        rs.route_wave_device(kind, params, BLOCK, cols, depth_d, aux_d)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        sel, hit = rs.route_wave_device(kind, params, BLOCK, cols, depth_d,
                                        aux_d)
    stop.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(stop) / reps
    want = rs.route_wave_ref(kind, params, BLOCK, *cols, depth_d, lcp,
                             plen, tie0)
    plain_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        rs.route_wave_ref(kind, params, BLOCK, *cols, depth_d, lcp, plen,
                          tie0)
        torch.cuda.synchronize()
        plain_s.append(time.perf_counter() - t0)
    # the whole score stage as the pipeline runs it (upload through
    # pinned memory, launch, copy back, wait), warm
    stage_s, pin_s, h2d_s = [], [], []
    for _ in range(10):
        t0 = time.perf_counter()
        policy.plan_collect(policy.plan_submit((depth, lcp, plen), f))
        t1 = time.perf_counter()
        pinned = torch.from_numpy(depth).pin_memory()
        t2 = time.perf_counter()
        pinned.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        stage_s.append(t1 - t0)
        pin_s.append(t2 - t1)
        h2d_s.append(t3 - t2)
    err = int(max(np.abs(sel.cpu().numpy() - want[0]).max(),
                  np.abs(hit.cpu().numpy() - want[1]).max()))
    if err:
        raise AssertionError(f"kernel != plain on the main-path wave: {err}")
    k, n = depth.shape
    nbytes, flops = wave_bound(kind, params, k, n)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP64_OPS_PER_S * 1e3
    return {"k": k, "n": n, "kind": kind, "params": params,
            "kernel_ms": kernel_ms,
            "plain_ms": sum(plain_s) / len(plain_s) * 1e3,
            "stage_ms": float(np.median(stage_s)) * 1e3,
            "pin_ms": float(np.median(pin_s)) * 1e3,
            "h2d_ms": float(np.median(h2d_s)) * 1e3,
            "bytes": nbytes, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": err}


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, route_score as rs

    # ---- phase 1: card and build -------------------------------------
    gpu = card()
    print(f"card: {gpu}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load("route_score")
    print(f"build: route_score.cu -> {_build.library_path('route_score')}"
          f" in {time.perf_counter() - t0:.2f} s")

    # ---- phase 2: kernel vs plain version on the card ----------------
    t0 = time.perf_counter()
    worst, n_cmp = check_kernels(torch, rs)
    print(f"kernel vs plain: {n_cmp} waves ({len(CONFIGS)} kind/ablation "
          f"configs x {len(SHAPES)} shapes x random/forced-tie), exact, "
          f"max |diff| {worst}, {time.perf_counter() - t0:.1f} s")

    # ---- phase 3: main path at 16384 instances -----------------------
    n_req = MAIN_REQUESTS
    if time.perf_counter() - t_start > CUT_AFTER_S:
        n_req = CUT_REQUESTS
        print(f"main path: cut from {MAIN_REQUESTS} to {n_req} requests "
              f"to stay within the time limit (instances stay {N_INST})")
    t0 = time.perf_counter()
    rs.LAUNCHES = 0
    results, trace = main_path(N_INST, n_req, "cuda")
    launches = rs.LAUNCHES
    waves = sum(r["router"].pipeline.waves for r in results.values())
    if launches == 0 or launches != waves:
        raise AssertionError(f"route_score launched {launches} times for "
                             f"{waves} device waves on the main path")
    print(f"main path: {N_INST} instances, {n_req} requests in waves of "
          f"{WAVE}, route_batch == sequential route() for "
          f"{'/'.join(results)}; route_score launches {launches} "
          f"({launches / waves:.0f} per wave), "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- phase 4: timings --------------------------------------------
    lm = results["lmetric"]["router"]
    # the main path's last full wave, scored against its final state
    tw = time_wave(torch, rs, lm, copy.deepcopy(trace[n_req - WAVE:n_req]))
    print(f"[{gpu}] route_score kernel: {tw['kernel_ms'] * 1e3:.1f} us per "
          f"wave ({tw['kind']}{tw['params']}, k={tw['k']}, n={tw['n']}, "
          f"1 launch)")
    print(f"[{gpu}] score stage, same wave, warm (median of 10): "
          f"{tw['stage_ms'] * 1e3:.1f} us (upload, launch, copy back); "
          f"of which the depth matrix's copy into pinned memory "
          f"{tw['pin_ms'] * 1e3:.1f} us and its upload "
          f"{tw['h2d_ms'] * 1e3:.1f} us (median of 10, timed apart)")
    print(f"[{gpu}] plain PyTorch version, same wave: "
          f"{tw['plain_ms'] * 1e3:.1f} us")
    print(f"[{gpu}] bound: {tw['bytes']} bytes / {HBM_BYTES_PER_S:.3g} B/s"
          f" vs {tw['flops']} f64 ops / {FP64_OPS_PER_S:.3g} op/s -> "
          f"{tw['bound_ms'] * 1e3:.2f} us ({tw['bound_by']})")
    print(f"[{gpu}] library: no single PyTorch call computes this "
          f"function (library_ms null)")
    for name, r in results.items():
        st = r["router"].stage_stats()
        print(f"[{gpu}] {name}: stages per wave walk {st['walk_us']:.1f} "
              f"us, score {st['score_us']:.1f} us, commit "
              f"{st['commit_us']:.1f} us over {st['waves']} waves; "
              f"route_batch {r['batch_us_per_decision']:.2f} us/decision, "
              f"sequential route() {r['route_us_per_decision']:.2f} "
              f"us/decision; {r['distinct_instances']} instances used, "
              f"{r['hit_tokens']} hit tokens; router built in "
              f"{r['build_s']:.1f} s")
    print(f"total {time.perf_counter() - t_start:.1f} s")

    record = {"kernels": [{
        "name": "route_score", "route": "cuda",
        "source": "src/repro_torch/csrc/route_score.cu",
        "replaces": "src/repro/kernels/route_score.py:218",
        "launches": launches,
        "max_abs_err": max(worst, tw["max_abs_err"]),
        "ms": tw["kernel_ms"], "plain_ms": tw["plain_ms"],
        "bound_ms": tw["bound_ms"], "bound_by": tw["bound_by"],
        "library_ms": None}]}
    print(json.dumps(record))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
