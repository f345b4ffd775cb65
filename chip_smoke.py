#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits nonzero):

1. build — print the card's name and power limit, build
   ``csrc/route_score.cu``, ``prefill_attention.cu`` and
   ``paged_attention.cu`` with nvcc for sm_90a (one nvcc each, all at
   once), print the build time;
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
   of both routers, each beside the card's name and power limit;
5. attention kernels vs plain — ``prefill_attention`` (512-token chunks
   at offsets 0 and 3072, a ragged 300-token chunk, a windowed chunk) and
   ``paged_attention`` (8 sequences, page 16, contexts up to 4096, block
   tables from the ported ``BlockManager`` with shared prefix pages) at
   Qwen2-7B widths, in float32 and bfloat16, within ``ATTN_TOL``;
6. serving path — Qwen2-7B at full width and depth (random bf16 weights
   from a seeded generator on the card), 4 ``InstanceEngine``s under the
   LMetric ``EngineCluster`` serve 32 requests (four 1024-token system
   prompts, unique suffixes, 32 output tokens); every request finishes,
   the attention launch counts, zeroed just before, equal 28 per prefill
   chunk and per decode step, requests placed with their system prompt
   report a hit of it, prefill is really skipped, and one request served
   with a KV$ hit gives the plain full forward's logits for its first
   token and next two decode steps (``LOGIT_ATOL``, ``LOGIT_REL_RMS``);
   prints TTFT/TPOT, prefill tokens/s, decode step times and peak memory;
7. attention timings — each kernel at the serving path's shapes (CUDA
   events), its plain version, its bound and one PyTorch library call
   as a yardstick (``scaled_dot_product_attention``, never used by the
   port).

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
KERNELS = ("route_score", "prefill_attention", "paged_attention")


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


# ---------------------------------------------------------------------------
# the serving path (phases 5-7): Qwen2-7B under EngineCluster
# ---------------------------------------------------------------------------
#: Qwen2-7B's attention widths (src/repro_torch/configs/qwen2_7b.py)
H_Q, H_KV, HEAD_DIM = 28, 4, 128
#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate at 700 W
BF16_OPS_PER_S = 989e12
#: kernel vs plain version (see tests/test_torch_attention_cuda.py)
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: engine vs plain full forward, bf16 logits: max |diff| over the vocab,
#: and the RMS of the difference relative to the RMS of the logits.  Two
#: bf16 paths through 28 random-weight layers part by 2-5% RMS, more on
#: longer contexts (PERF.md); a wrong mask or a stale KV$ fragment gives
#: ~80%
LOGIT_ATOL, LOGIT_REL_RMS = 1.0, 0.15
ENGINES, MAX_BATCH, MAX_LEN, CHUNK = 4, 8, 4096, 512
KV_BLOCK, PREFIX_CAPACITY = 16, 4
N_SERVE, SYS_PREFIX, SUFFIX, OUT_TOKENS, MEAN_GAP_S = 32, 1024, (256, 1536), \
    32, 0.05
SEED = 2026


def prefill_bound(Sq, off, window=None):
    """(bytes, operations) of one causal chunk at Qwen2-7B widths in bf16:
    q, k, v, out read or written once (k/v span off + Sq keys), and 4*hd
    operations per (query row, head, key it sees) for QK and PV."""
    Sk = off + Sq
    seen = sum(min(off + i + 1, window or Sk) for i in range(Sq))
    nbytes = 2 * (2 * Sq * H_Q * HEAD_DIM + 2 * Sk * H_KV * HEAD_DIM) + 4
    return nbytes, 4 * HEAD_DIM * H_Q * seen


def paged_bound(ctx, page):
    """(bytes, operations) of one decode step over contexts ``ctx``: the
    K/V rows in context, q and out, the block-table entries and context
    lengths read once; 4*hd operations per (head, key in context)."""
    B, total = len(ctx), int(sum(ctx))
    pages = int(sum(-(-int(c) // page) for c in ctx))
    nbytes = (2 * 2 * total * H_KV * HEAD_DIM + 2 * 2 * B * H_Q * HEAD_DIM
              + 4 * pages + 4 * B)
    return nbytes, 4 * HEAD_DIM * H_Q * total


def _bound(nbytes, ops):
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / BF16_OPS_PER_S * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def manager_tables(torch, rng, dev):
    """Eight sequences' block tables from the ported BlockManager (page
    16): two 1024-token shared prefixes, ragged private tails up to 4096
    tokens, a few decode tokens each, and one prompt served twice so that
    both copies share every prompt page and decode into private pages."""
    from repro_torch.core.radix import tokens_to_blocks
    from repro_torch.serving.block_manager import BlockManager
    bm = BlockManager(n_pages=8 * MAX_LEN // KV_BLOCK, page_size=KV_BLOCK)
    prefixes = [list(rng.randint(0, 1 << 30, SYS_PREFIX)) for _ in range(2)]
    tails = {0: 1000, 1: 3060, 2: 300, 3: 2500, 4: 17, 5: 1500, 7: 800}
    prompts = {}
    for sid in range(8):
        # sequence 6 repeats sequence 0's prompt
        prompts[sid] = prompts[0] if sid == 6 else \
            prefixes[sid % 2] + list(rng.randint(0, 1 << 30, tails[sid]))
        bm.allocate(sid, [(h,) for h in tokens_to_blocks(prompts[sid],
                                                          KV_BLOCK)])
    for sid in range(8):
        for _ in range(1 + 2 * sid):
            bm.append_token(sid)
    if bm.block_table(0)[:10] != bm.block_table(6)[:10] or \
            bm.block_table(0)[-1] == bm.block_table(6)[-1]:
        raise AssertionError("block tables do not share/fork as built")
    width = MAX_LEN // KV_BLOCK
    bt = torch.tensor([bm.block_table(s, pad_to=width) for s in range(8)],
                      dtype=torch.int32, device=dev)
    ctx = torch.tensor([bm.context_len(s) for s in range(8)],
                       dtype=torch.int32, device=dev)
    return bt, ctx, bm.stats()["shared"]


def check_attention(torch):
    """Phase 5: both attention kernels against their plain versions on the
    card at Qwen2-7B widths, in float32 and bfloat16."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import prefill_attention as fp
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)

    def rand(shape, dtype):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * 0.5).to(dev, dtype)

    worst = {"prefill_attention": 0.0, "paged_attention": 0.0}
    report = []
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        for Sq, off, window in ((512, 0, None), (512, 3072, None),
                                (300, 1000, None), (512, 1024, 256)):
            q = rand((1, Sq, H_Q, HEAD_DIM), dtype)
            k = rand((1, off + Sq, H_KV, HEAD_DIM), dtype)
            v = rand((1, off + Sq, H_KV, HEAD_DIM), dtype)
            offs = torch.full((1,), off, dtype=torch.int32, device=dev)
            got = fp.flash_prefill(q, k, v, offs, window)
            want = fp.flash_prefill_plain(q, k, v, offs, window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            report.append(f"prefill {name} Sq={Sq} off={off} "
                          f"window={window}: {err:.3g}")
            if not err <= ATTN_TOL[name]:
                raise AssertionError(f"prefill_attention != plain: {err} > "
                                     f"{ATTN_TOL[name]} ({report[-1]})")
            worst["prefill_attention"] = max(worst["prefill_attention"], err)
        bt, ctx, shared = manager_tables(torch, rng, dev)
        n_pages = 8 * MAX_LEN // KV_BLOCK
        kp = rand((n_pages, KV_BLOCK, H_KV, HEAD_DIM), dtype)
        vp = rand((n_pages, KV_BLOCK, H_KV, HEAD_DIM), dtype)
        q = rand((8, H_Q, HEAD_DIM), dtype)
        got = pa.paged_attention(q, kp, vp, bt, ctx)
        want = pa.paged_attention_plain(q, kp, vp, bt, ctx)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        report.append(f"paged {name} B=8 page={KV_BLOCK} contexts "
                      f"{ctx.tolist()} ({shared} shared pages): {err:.3g}")
        if not err <= ATTN_TOL[name]:
            raise AssertionError(f"paged_attention != plain: {err} > "
                                 f"{ATTN_TOL[name]} ({report[-1]})")
        worst["paged_attention"] = max(worst["paged_attention"], err)
    return worst, report


def serving_requests(vocab):
    """32 arrivals: four 1024-token system prompts; the first request of
    each is its system prompt with an 8-token opener (under one KV block,
    so the engine stores the bare system prompt as a prefix fragment), the
    others the system prompt of a random group plus a unique 256-1536
    token suffix; 32 output tokens each; exponential gaps, 50 ms mean."""
    rng = np.random.RandomState(SEED)
    prefixes = [rng.randint(0, vocab, SYS_PREFIX) for _ in range(4)]
    arrivals, groups, t = [], [], 0.0
    for i in range(N_SERVE):
        t += float(rng.exponential(MEAN_GAP_S))
        g = i if i < 4 else int(rng.randint(4))
        n = 8 if i < 4 else int(rng.randint(SUFFIX[0], SUFFIX[1] + 1))
        toks = np.concatenate([prefixes[g], rng.randint(0, vocab, n)])
        arrivals.append((t, toks.astype(np.int32), OUT_TOKENS))
        groups.append(g)
    return arrivals, groups, prefixes


def logits_vs_plain(torch, cluster, model, params, arrivals):
    """A follow-up turn of a served prompt (the prompt plus 700 new
    tokens), served step by step by the engine that still holds that
    prompt's fragment: its first-token logits (injected fragment +
    chunked prefill through the kernel) and those of its next two decode
    steps (paged kernel) against ``Model.prefill``, the plain full
    forward, over the same tokens."""
    from repro_torch.core import Request
    from repro_torch.core.radix import tokens_to_blocks
    pick = None
    for _, served, _ in reversed(arrivals):        # most recent first
        key = tuple(tokens_to_blocks(served.tolist(), KV_BLOCK))
        for eng in cluster.engines:
            if eng.prefix_store.lookup(key)[0] == key:
                pick = (eng, served)
                break
        if pick:
            break
    if pick is None:
        raise AssertionError("no engine holds a served prompt's fragment")
    eng, served = pick
    rng = np.random.RandomState(SEED + 1)
    prompt = np.concatenate([served, rng.randint(
        0, model.cfg.vocab_size, 700)]).astype(np.int32)
    got = []                # each engine step's logits
    pre, dec = eng._prefill, eng._decode

    def rec_prefill(*a):
        logits = pre(*a)
        got.append(logits[0])
        return logits

    def rec_decode(*a):
        logits = dec(*a)
        got.append(logits)
        return logits

    eng._prefill, eng._decode = rec_prefill, rec_decode
    req = Request(rid=10 ** 6, arrival=0.0, blocks=(), prompt_len=len(prompt),
                  output_len=3)
    eng.submit(req, prompt)
    first_seen = None
    while eng.has_work():
        ev = eng.step()
        if ev["first"]:
            first_seen = len(got)
    eng._prefill, eng._decode = pre, dec
    if req.hit_tokens < SYS_PREFIX:
        raise AssertionError(f"check request hit {req.hit_tokens} tokens")
    seq = ev["finished"][0]
    engine_logits = [got[first_seen - 1]] + [
        got[first_seen + j][seq.slot] for j in range(2)]
    out = []
    toks = prompt.tolist()
    for j, el in enumerate(engine_logits):
        plain, _ = model.prefill(params, torch.tensor([toks]),
                                 last_only=True)
        plain = plain[0, -1]
        diff = (el - plain).abs()
        rel = float(diff.square().mean().sqrt() / plain.square().mean().sqrt())
        out.append({"step": j, "max_abs": float(diff.max()), "rel_rms": rel,
                    "argmax_equal": int(el.argmax()) == int(plain.argmax())})
        if not (out[-1]["max_abs"] <= LOGIT_ATOL and rel <= LOGIT_REL_RMS):
            raise AssertionError(f"engine logits != plain forward: {out}")
        toks.append(seq.out_tokens[j])
    return req.hit_tokens, out


def serving_path(torch, arch="qwen2_7b", device="cuda"):
    """Phase 6: Qwen2-7B at full width and depth, 4 engines under the
    LMetric router, 32 requests.  Returns the numbers to print.

    ``arch="qwen2_7b-smoke", device="cpu"`` rehearses the same path on
    the CPU with the kernels' plain versions (no launches are counted
    there)."""
    from repro_torch.cluster.metrics import summarize
    from repro_torch.configs import get_config
    from repro_torch.core import LMetricPolicy
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import prefill_attention as fp
    from repro_torch.models import Model
    from repro_torch.serving.engine import EngineCluster
    cfg = get_config(arch)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    model = Model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    sync()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    arrivals, groups, prefixes = serving_requests(cfg.vocab_size)
    cluster = EngineCluster(ENGINES, model, params, LMetricPolicy(),
                            block_size=KV_BLOCK, device=device,
                            max_batch=MAX_BATCH, max_len=MAX_LEN,
                            chunk_tokens=CHUNK,
                            prefix_capacity=PREFIX_CAPACITY)
    steps = []
    for eng in cluster.engines:
        def logged(step=eng.step, iid=eng.iid):
            ev = step()
            steps.append((iid, ev["kind"], ev["prefill_tokens"],
                          ev["decode_bs"], ev["wall"], len(ev["first"])))
            return ev
        eng.step = logged
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    fp.LAUNCHES, pa.LAUNCHES = 0, 0
    t0 = time.perf_counter()
    done = cluster.run(arrivals)
    sync()
    wall = time.perf_counter() - t0
    launches = {"prefill_attention": fp.LAUNCHES,
                "paged_attention": pa.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    chunks = [s for s in steps if s[1] == "prefill"]
    decodes = [s for s in steps if s[1] == "decode"]
    # each engine's warmup runs one prefill chunk and one decode step
    L = cfg.n_layers if on_card else 0
    want = {"prefill_attention": L * (len(chunks) + ENGINES),
            "paged_attention": L * (len(decodes) + ENGINES)}
    if launches != want:
        raise AssertionError(f"attention launches {launches} != {want} "
                             f"({len(chunks)} chunks, {len(decodes)} decode "
                             f"steps, {ENGINES} warmups, {L} layers)")
    if len(done) != N_SERVE:
        raise AssertionError(f"{len(done)} of {N_SERVE} requests finished")
    # LMetric may place a shared-prefix request on an instance that never
    # saw its system prompt (load outweighs the hit); every one placed on
    # an instance that did must report a hit of the whole system prompt
    holders = {g: set() for g in range(len(prefixes))}
    hot, cold, misses = 0, 0, []
    for r in sorted(done, key=lambda r: r.rid):       # routing order
        g = groups[r.rid]
        if r.sched_to in holders[g]:
            hot += 1
            if r.hit_tokens < SYS_PREFIX:
                misses.append((r.rid, g, r.sched_to, r.hit_tokens))
        elif holders[g]:
            cold += 1
        holders[g].add(r.sched_to)
    if misses:
        raise AssertionError(f"requests placed with their system prompt "
                             f"but without a >= {SYS_PREFIX}-token hit "
                             f"(rid, group, instance, hit): {misses}")
    prompt_tokens = sum(r.prompt_len for r in done)
    computed = sum(s[2] for s in chunks)
    if prompt_tokens - computed < SYS_PREFIX:
        raise AssertionError("no prefill was skipped by a KV$ fragment")
    hit, logit_checks = logits_vs_plain(torch, cluster, model, params,
                                        arrivals)
    return {"cfg": cfg, "n_params": n_params, "init_s": t_init,
            "wall_s": wall, "summary": summarize(done),
            "launches": launches, "chunks": chunks, "decodes": decodes,
            "prompt_tokens": prompt_tokens, "computed_tokens": computed,
            "hit_tokens": sum(r.hit_tokens for r in done), "peak": peak,
            "logit_checks": logit_checks, "check_hit": hit,
            "placed_hot": hot, "placed_cold": cold,
            "instances": collections.Counter(r.sched_to for r in done)}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _events_ms(torch, fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_attention(torch):
    """Phase 7: each attention kernel at the serving path's shapes (bf16):
    CUDA events over many launches after a warm-up, the plain version's
    time, the bound, and one PyTorch library call for the same function
    as a yardstick (the port never calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import prefill_attention as fp
    dev = torch.device("cuda")
    bf = torch.bfloat16
    rng = np.random.RandomState(SEED + 2)
    out = {}

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * 0.5).to(dev, bf)

    # prefill: a 512-token chunk right after a 1024-token KV$ hit, and one
    # deeper into a long prompt
    for Sq, off in ((CHUNK, SYS_PREFIX), (CHUNK, 2048)):
        Sk = off + Sq
        q, k, v = rand(1, Sq, H_Q, HEAD_DIM), rand(1, Sk, H_KV, HEAD_DIM), \
            rand(1, Sk, H_KV, HEAD_DIM)
        offs = torch.full((1,), off, dtype=torch.int32, device=dev)
        ms = _events_ms(torch, lambda: fp.flash_prefill(q, k, v, offs), 50)
        plain = _events_ms(torch,
                           lambda: fp.flash_prefill_plain(q, k, v, offs), 5)
        G = H_Q // H_KV
        qt = q.transpose(1, 2)
        kt = k.transpose(1, 2).repeat_interleave(G, dim=1)
        vt = v.transpose(1, 2).repeat_interleave(G, dim=1)
        mask = (torch.arange(Sk, device=dev)[None]
                <= off + torch.arange(Sq, device=dev)[:, None])
        lib = _events_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), 20)
        nbytes, ops = prefill_bound(Sq, off)
        bound, by = _bound(nbytes, ops)
        out[f"prefill Sq={Sq} off={off}"] = dict(
            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
            bound_by=by, bytes=nbytes, ops=ops)
    # decode: all 8 slots of an engine's (8, 4096) cache viewed as pages,
    # ragged contexts as in a busy decode step
    S, B = MAX_LEN, MAX_BATCH
    cache_k, cache_v = rand(B, S, H_KV, HEAD_DIM), rand(B, S, H_KV, HEAD_DIM)
    pages = (B * S // KV_BLOCK, KV_BLOCK, H_KV, HEAD_DIM)
    kp, vp = cache_k.view(pages), cache_v.view(pages)
    bt = torch.arange(B * S // KV_BLOCK, dtype=torch.int32,
                      device=dev).reshape(B, -1)
    ctx_np = rng.randint(SYS_PREFIX + SUFFIX[0],
                         SYS_PREFIX + SUFFIX[1] + OUT_TOKENS, B)
    ctx = torch.from_numpy(ctx_np.astype(np.int32)).to(dev)
    q = rand(B, H_Q, HEAD_DIM)
    ms = _events_ms(torch, lambda: pa.paged_attention(q, kp, vp, bt, ctx),
                    200)
    plain = _events_ms(torch, lambda: pa.paged_attention_plain(
        q, kp, vp, bt, ctx), 5)
    G = H_Q // H_KV
    kt = cache_k.transpose(1, 2).repeat_interleave(G, dim=1)
    vt = cache_v.transpose(1, 2).repeat_interleave(G, dim=1)
    mask = (torch.arange(S, device=dev)[None] < ctx[:, None])[:, None, None]
    lib = _events_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None], kt, vt, attn_mask=mask), 50)
    nbytes, ops = paged_bound(ctx_np, KV_BLOCK)
    bound, by = _bound(nbytes, ops)
    out[f"decode B={B} contexts {ctx_np.tolist()}"] = dict(
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
        bytes=nbytes, ops=ops)
    return out


def profile_steps(torch, gpu):
    """``--profile``: where a serving step's time goes on the card.  Traces
    Qwen2-7B steps at the serving path's shapes with ``torch.profiler``:
    5 decode steps of 8 slots at position ~2000, and 3 prefill chunks of
    512 tokens over a 1024-token prefix.  Prints the wall per step, the
    device time summed over kernels (busy share = device time / wall)
    and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config("qwen2_7b")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    cache = model.init_cache(MAX_BATCH, MAX_LEN)
    rng = np.random.RandomState(SEED)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, CHUNK)))
    pos = torch.from_numpy(rng.randint(1900, 2100, MAX_BATCH))
    slot = {"k": cache["k"][:, :1], "v": cache["v"][:, :1]}

    def decode():
        logits, _ = model.decode_step(params, toks[:, :MAX_BATCH].T, pos,
                                      cache)
        logits.argmax(-1).cpu()

    def prefill():
        logits, _ = model.prefill_cached(
            params, toks, torch.arange(SYS_PREFIX, SYS_PREFIX + CHUNK)[None],
            slot, [SYS_PREFIX], last_only=True)
        logits.argmax(-1).cpu()

    for name, fn, n in (("decode step (8 slots)", decode, 5),
                        (f"prefill chunk ({CHUNK} over {SYS_PREFIX})",
                         prefill, 3)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / n
        # device-side events only (kernels, copies): CPU-op rows carry the
        # same kernels' time again
        us, count = collections.Counter(), collections.Counter()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us[e.name] += e.device_time_total
                count[e.name] += 1
        busy = sum(us.values()) / n / 1e3                   # ms per step
        print(f"[{gpu}] profile {name}: wall {wall * 1e3:.2f} ms, device "
              f"busy {busy:.2f} ms ({busy / (wall * 1e3):.1%}), "
              f"{sum(count.values()) // n} device ops per step")
        for key, t in us.most_common(8):
            print(f"[{gpu}]   {t / n / 1e3:8.3f} ms  x{count[key] // n:<4d} "
                  f"{key[:90]}")


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
    _build.build(KERNELS)         # one nvcc per source, all at once
    print(f"build: {', '.join(k + '.cu' for k in KERNELS)} in parallel -> "
          f"{_build.BUILD_DIR} in {time.perf_counter() - t0:.2f} s")
    if "--profile" in sys.argv[1:]:
        profile_steps(torch, gpu)
        return 0

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

    # ---- phase 5: attention kernels vs plain versions ----------------
    t0 = time.perf_counter()
    attn_err, report = check_attention(torch)
    for line in report:
        print(f"[{gpu}] attention kernel vs plain, max |diff|: {line}")
    print(f"[{gpu}] attention kernels vs plain (tolerance {ATTN_TOL}): ok,"
          f" {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()

    # ---- phase 6: the serving path -----------------------------------
    sv = serving_path(torch)
    s = sv["summary"]
    cfg = sv["cfg"]
    ch_tok = sv["computed_tokens"]
    ch_s = sum(c[4] for c in sv["chunks"])
    dec_ms = [d[4] * 1e3 for d in sv["decodes"]]
    full = [d[4] * 1e3 for d in sv["decodes"] if d[3] == MAX_BATCH]
    print(f"[{gpu}] serving: {cfg.name} {cfg.n_layers} layers d_model "
          f"{cfg.d_model} {sv['n_params'] / 1e9:.2f} B params (bf16, seeded "
          f"on the card in {sv['init_s']:.1f} s); {ENGINES} engines x "
          f"max_batch {MAX_BATCH} x max_len {MAX_LEN}, chunk {CHUNK}, "
          f"LMetric router; {s['n']} of {N_SERVE} requests served in "
          f"{sv['wall_s']:.1f} s wall")
    print(f"[{gpu}] serving: TTFT mean {s['ttft_mean'] * 1e3:.1f} ms p50 "
          f"{s['ttft_p50'] * 1e3:.1f} p95 {s['ttft_p95'] * 1e3:.1f} | TPOT "
          f"mean {s['tpot_mean'] * 1e3:.2f} ms p95 {s['tpot_p95'] * 1e3:.2f}"
          f" | SLO attainment {s['slo_attainment']:.3f} | virtual time "
          f"from measured step walls, makespan {s['makespan']:.2f} s")
    print(f"[{gpu}] serving: {len(sv['chunks'])} prefill chunks, "
          f"{ch_tok} tokens computed at {ch_tok / ch_s:.0f} tokens/s of "
          f"prefill step wall; {sv['prompt_tokens']} prompt tokens, "
          f"{sv['prompt_tokens'] - ch_tok} skipped by KV$ fragments; "
          f"reported hit tokens {sv['hit_tokens']}; requests per instance "
          f"{dict(sorted(sv['instances'].items()))}; of the "
          f"{N_SERVE - 4} shared-prefix requests, {sv['placed_hot']} placed "
          f"where their system prompt was routed before (all hit >= "
          f"{SYS_PREFIX}), {sv['placed_cold']} elsewhere by load")
    mid = [c[4] * 1e3 for c in sv["chunks"] if c[2] == CHUNK and not c[5]]
    last = [c[4] * 1e3 for c in sv["chunks"] if c[5]]
    print(f"[{gpu}] serving: prefill step wall, median: full {CHUNK}-token "
          f"chunk that does not end its prompt {np.median(mid):.2f} ms "
          f"({len(mid)} chunks; a first chunk after a hit includes the "
          f"fragment's upload); chunk that ends its prompt "
          f"{np.median(last):.2f} ms ({len(last)}; includes the fragment's "
          f"copy to the host)")
    print(f"[{gpu}] serving: {len(dec_ms)} decode steps, median "
          f"{float(np.median(dec_ms)):.2f} ms (with all {MAX_BATCH} slots "
          f"running: {len(full)} steps, median "
          f"{float(np.median(full)) if full else float('nan'):.2f} ms); "
          f"peak device memory {sv['peak'] / 2 ** 30:.2f} GiB")
    print(f"[{gpu}] serving: attention launches {sv['launches']} = "
          f"{cfg.n_layers} layers x ({len(sv['chunks'])} chunks | "
          f"{len(sv['decodes'])} decode steps + {ENGINES} warm-ups)")
    for c in sv["logit_checks"]:
        print(f"[{gpu}] serving: engine (hit {sv['check_hit']} tokens) vs "
              f"plain full forward, step {c['step']}: max |dlogit| "
              f"{c['max_abs']:.4f}, RMS ratio {c['rel_rms']:.4f}, argmax "
              f"equal {c['argmax_equal']} (tolerance {LOGIT_ATOL}, "
              f"{LOGIT_REL_RMS})")

    # ---- phase 7: attention timings at the serving shapes -------------
    ta = time_attention(torch)
    for shape, t in ta.items():
        print(f"[{gpu}] {shape}: kernel {t['ms'] * 1e3:.1f} us, plain "
              f"{t['plain_ms'] * 1e3:.1f} us, library (SDPA yardstick) "
              f"{t['library_ms'] * 1e3:.1f} us; bound {t['bound_ms'] * 1e3:.2f}"
              f" us ({t['bound_by']}: {t['bytes']} B, {t['ops']} ops)")
    print(f"total {time.perf_counter() - t_start:.1f} s")

    pre_t = ta[f"prefill Sq={CHUNK} off={SYS_PREFIX}"]
    dec_t = next(v for k, v in ta.items() if k.startswith("decode"))
    record = {"kernels": [{
        "name": "route_score", "route": "cuda",
        "source": "src/repro_torch/csrc/route_score.cu",
        "replaces": "src/repro/kernels/route_score.py:218",
        "launches": launches,
        "max_abs_err": max(worst, tw["max_abs_err"]),
        "ms": tw["kernel_ms"], "plain_ms": tw["plain_ms"],
        "bound_ms": tw["bound_ms"], "bound_by": tw["bound_by"],
        "library_ms": None}]}
    for name, t, line in (("prefill_attention", pre_t, 28),
                          ("paged_attention", dec_t, 29)):
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{name}.py:{line}",
            "launches": sv["launches"][name],
            "max_abs_err": attn_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps(record))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
