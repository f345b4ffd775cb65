#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits nonzero):

1. build — print the card's name and power limit, build every source
   of ``KERNELS`` (``csrc/route_score.cu``, ``prefill_attention.cu``,
   ``paged_attention.cu``, ``rglru_scan.cu``, ``mlstm_cell.cu``) with
   nvcc for sm_90a (one nvcc each, all at once), print the build time
   and ptxas's registers, static shared memory and spills of every
   kernel instantiation, the attention and mLSTM kernels' counts of
   wgmma (HGMMA), mma.sync (HMMA) and TMA load (UTMALDG) instructions
   from ``cuobjdump -sass``, and ``route_score``'s launch plan (warp, or
   cluster size x threads x instances per thread) at every shape below;
2. kernel vs plain — the CUDA ``route_score`` kernel against its plain
   PyTorch version on the card, for every kind and ablation, on seeded
   random and forced-tie states at every (k, n) of ``SHAPES``: the
   simulator's waves (n = 16, and 8 for the PD pool), the regime edges
   (32 / 33 instances, one and two CTAs around 1024, a partial last CTA
   at 16461), 65536 instances, beyond what a cluster holds on chip, and
   waves of 200 requests, beyond the kernels' shared-memory staging;
   the forced ties sit next to every CTA boundary of the plan, so that
   they span CTAs; ``sel`` and ``hit`` must be exactly equal;
3. main path — a 16384-instance cluster, built with
   ``router_from_numpy_state`` from a seeded backlog, routes the hotspot
   trace in waves of 64 through ``Router.route_batch`` (lmetric, vllm);
   a second router from the same state routes with sequential
   ``route()``; decisions and hit tokens must be identical, and the
   kernel's launch count, zeroed just before, must have risen;
4. timings — the kernel's device time per wave and per step
   (``torch.profiler``) with cold inputs (rotating over copies of the
   depth matrix that hold ``COLD_BYTES``) and warm, beside its CUDA-event
   time per wave and the byte bound; the plain version's time on the same
   wave, the pipeline's stage times and µs per decision of both routers,
   each beside the card's name and power limit;
5. attention kernels vs plain — ``prefill_attention`` (512-token chunks
   at offsets 0 and 3072, a ragged 300-token chunk, a windowed chunk) and
   ``paged_attention`` (8 sequences, page 16, contexts up to 4096, block
   tables from the ported ``BlockManager`` with shared prefix pages) at
   Qwen2-7B widths, then one chunk and one decode step each at the MoE
   models' widths (Qwen3-30B-A3B: 32 q over 4 KV heads, hd 128;
   Granite-MoE: 24 over 8, hd 64) and with soft-capped scores
   (``ATTN_WIDTHS``), in float32 and bfloat16, within ``ATTN_TOL``;
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
7. attention timings — each kernel at the serving path's shapes: its
   device time per launch (``torch.profiler``; for decode with cold K/V,
   rotating over copies of the cache that hold ``COLD_BYTES``, and warm)
   beside its wrapper's time per call (CUDA events around back-to-back
   calls), the decode split count and grid, its plain version, its bound
   and share of it, and one PyTorch library call as a yardstick
   (``scaled_dot_product_attention``, never used by the port), timed the
   same ways;
8. recurrent kernels vs plain — ``rglru_scan`` at (1, 512, 4096), ragged
   S and D, B = 2 and the edges of its segments and windows (S = 1,
   P +- 1, P x SEGMAX +- 1) with a non-zero h0; ``mlstm_cell`` at (1,
   256, 4, 512), at L = 37 from m0 = -1e30 and m0 = 0, at the engines'
   warm-up L = 8 (B = 1 and 2), and a chain of 4 chunks against the
   plain chain, with f32 and the model's bf16 q/k/v (``REC_TOL``);
9. attention at head dim 256 vs plain — both kernels at RecurrentGemma's
   widths (16 query heads over 1 KV head, window 2048): prefill with
   kept ring rows below, at and above W, decode over 8 rings with
   contexts below and at W; and one full-width ``swa`` layer's cached
   chunks, wrapping the ring, against its plain full forward;
10. RecurrentGemma-9B serving — 38 layers at full width (random bf16
   weights), phase 6's engine settings, 32 requests (four bare 1024-token
   system prompts first, then each with a block-aligned 256-1536 token
   suffix, 32 output tokens); the same checks as phase 6, with the
   launches of ``rglru_scan`` (26 per chunk) and both attention kernels
   (12 per chunk and per decode step) equal to the expected counts;
11. xLSTM-350M serving — 24 layers at full width, 16 requests (two bare
   1024-token system prompts, suffixes of 128-768 tokens) under the
   ``exact_only`` router, ``mlstm_cell`` launches (21 x ceil(n/256) per
   chunk of n tokens) as expected, logits held to the plain forward;
12. recurrent timings — ``rglru_scan`` and ``mlstm_cell`` at the serving
   shapes as in phase 7: device time per launch with cold inputs
   (rotating over copies that hold ``COLD_BYTES``) and warm, the
   wrapper's time per call in CUDA events, beside their plain versions
   and bounds (``mlstm_bound``: the tensor-core work, beside the first
   version's CUDA-core count); and the head-dim 256 attention timed as in
   phase 7;
13. cluster simulation — ``ClusterSim`` over 16 Qwen2-7B instances on
   the port's H100 latency profile (``spec_from_config``; KV$ per
   instance from the card's memory less the weights, ``sim_kv_capacity``)
   on four traces (chatbot, agent, coder, toolagent: the paper's
   chatbot, API, coding-agent and tool-agent workloads), 2000 requests
   each at 0.8 x the trace's estimated capacity, arrivals rounded to a
   50 ms scheduling tick, under the paper's Fig. 22 policies (lmetric,
   vllm and linear plan their waves on the card; dynamo and llm-d are
   host-only); then ``PDDisaggSim`` with 8 prefill and 8 decode
   instances on the chatbot trace; then LMetric with the §5.2 hotspot
   detector on the four traces (Fig. 20), the hotspot trace (agent
   traffic with a burst sharing one prefix) under lmetric, lmetric with
   the detector and vllm (Fig. 21), chatbot under preble and polyserve
   (Fig. 26), coder under LMetric's "cost" load indicator and agent
   under session affinity.  Each run counts ``route_score`` launches
   from zero and must finish every request; lmetric, vllm and linear
   launch once per arrival wave of two or more, the host-only policies
   never; the lmetric chatbot run, the PD run and the hotspot detector
   run must equal the same runs with the mirror on the CPU, the PD run
   its request-by-request routing, and a detector run that never
   activates the lmetric run of its trace.  Prints TTFT/TPOT (in
   simulated time), KV$ hit ratio, SLO attainment, wave sizes, launches,
   host wall and the score stage's µs per wave, the detector's Eq. 2
   checks, violations and activations, Preble's branch counts, and
   LMetric's TTFT mean against each policy's per trace; one wave's score
   stage timed alone and in parts (``sim_wave_time``: mirror upload, submit,
   collect; the kernel's device time per wave and per step, cold after
   an L2 flush and warm);
   and the profile's predicted step times beside Qwen2-7B's measured
   ones (phase 6's walls, and each step alone: wall and device time);
14. sharded routing — phase 3's backlog and trace over the sharded
   prefix index: route_batch under lmetric and vllm on the serial and
   thread backends at 8 shards and the process backend at 4 and 8
   (``SHARD_RUNS``; the thread and process backends speculate on the
   next wave's walk), and sequential ``route()`` under lmetric; decisions
   and hit tokens must equal phase 3's, with one ``route_score`` launch
   per wave; prints the walk / score (its submit) / commit µs per wave,
   each shard's walk, µs per decision of both, the speculation counters
   and the workers' spawn time.  Then Contract 6 on the card: 8 process
   shards with ``anti_entropy_k=1`` under a seeded plan of crashes and
   stalls (decisions equal phase 3's) and under one corrupt bit (the
   sweep repairs it; every shard verifies after), neither tearing the
   backend down; phase 13's chatbot lmetric run on a router of 4 thread
   shards, equal to the flat run with speculative walks consumed; and
   the mirror's re-upload of dirty ranges in three spellings
   (``time_mirror``).  None of the process's shared-memory segments and
   no shard worker may remain;
15. control plane — on phase 13's profile, KV$ and chatbot trace
   (``control_path``): the lmetric chatbot run with every obs component
   on (``make_obs(metrics, trace, provenance)``) must equal phase 13's
   (tuples, launches) with a provenance record per request and a valid
   trace, two runs of 500 requests must give byte-identical trace JSON,
   and the host wall with obs off and on is printed (best of 3 each,
   beside the reference's 5% budget, not gated); the same run under
   instance churn (instance 3 fails at 10 s and recovers at 25 s,
   instance 11 is drained at 30 s and recovers at 40 s): every request
   finishes, none is scheduled on an instance while it is out, the
   launches equal the waves of two or more routed while every instance
   was live (none while one is out), the tuples equal the CPU run's and
   the index equals a rebuild from the radix trees; the agent trace at 2
   x its estimated capacity with admission and retraction (== its CPU
   run) and without (shed, retracted, wasted prefill,
   ``overload_summary``); ``make_mixed_fleet()`` (8 Qwen3-30B-MoE
   "fast", 8 Qwen2-7B "slow") on the chatbot trace, every fourth
   request needing "qwen2_7b", under the hetero lmetric score and
   route-then-balance (host-only, no infeasible route,
   ``hardware_class_summary``), and a homogeneous fleet of phase 13's
   spec, which must equal phase 13's run with its 572 launches; the
   closed loop (200 mixed chatbot / agent / coder sessions at 1 and 20
   x ``bench_overload``'s start rates, no control and admission +
   retraction, the last with a failure, == its CPU run;
   ``summarize`` with the interference block, ``overload_summary``) and
   a closed-loop PD run of 100 chatbot sessions;
16. MoE serving — Qwen3-30B-A3B, the paper's MoE testbed, at full width
   and depth (48 layers, 128 experts, top-8; 30.53 B parameters, 61.06 GB
   in bf16, random weights from a seeded generator on the card) with
   phase 6's engine settings and workload (32 requests), then
   Granite-MoE-3B-A800M (32 layers, hd 64, 40 experts, 16 requests), at
   the published capacity factor 1.25: every request finishes, the
   attention launches equal 48 (32) per chunk and per decode step,
   requests placed with their system prompt report a hit of it, prefill
   is really skipped; then the logit check on a fresh engine at capacity
   factor E / K, where nothing drops at any chunking
   (``moe_logit_check``: bf16 at full depth if the model's own bf16 noise
   floor is within the tolerances, else float32 on a depth cut); prints
   the memory (weights, caches, peak, and the reckoning from
   ``param_count``), TTFT / TPOT, prefill tokens/s, chunk and decode
   medians and the decode-step floor (all weights read per step);
17. attention at Whisper's shapes vs plain — hd 64 with one query head
   per KV head (G = 1): ``flash_prefill`` unmasked at (B 4, 1500, 16, 64)
   (``kv_offset = Sk = Sq``), cross chunks of 1, 37 and 448 queries over
   the first 1500 rows of a (4, 1504) cross cache, ``paged_attention``
   over the cross cache's paged view (94 pages, context 1500, padding
   rows never read) and self decode over ragged contexts, f32 and bf16
   within ``ATTN_TOL``; then the encoder's attention, a 32-token cross
   chunk and a cross decode step timed as in phase 7 (``time_whisper``);
18. Whisper-medium — 24 + 24 layers at full width (d 1024, vocab 51865;
   random bf16 weights), 8 clips of random (1500, 1024) frames, each:
   ``Model.encode`` (24 ``flash_prefill`` launches), a 64-token prompt in
   two ``prefill_cached`` chunks (the first computes the cross caches from
   the encoder's output, the second reads them; 48 launches each) and 32
   greedy ``decode_step``s (48 ``paged_attention`` launches each), each
   stage's launches counted from zero; clip 0's chunk logits and first 2
   decode steps held to the plain full forward in bf16 (``LOGIT_ATOL``,
   ``LOGIT_REL_RMS``) if the model's own bf16 noise floor is within them,
   else in f32 at full depth (``LOGIT_F32``); prints the encoder, chunk
   and decode medians and the peak memory.  The serving engine refuses an
   encoder-decoder, as the reference's does, so Whisper is driven at
   model level;
19. training — Qwen3-4B (36 layers, d 2560, vocab 151936, tied; the
   reference launcher's documented arch) at full width and depth: bf16
   parameters, f32 moments, ``remat=True``, batch 4 x 512 tokens of the
   synthetic ``DataIterator`` cycling over 8 documents
   (``TRAIN_DOCS_PER_ROW``), 20 steps of ``make_train_step``: every loss
   finite, the mean of the last 5 below that of the first 5; then the
   same 20 steps on a 2-layer depth cut at full width
   (``TRAIN_CKPT_LAYERS``), with a checkpoint saved after step 10
   (``save_checkpoint``, the reference's npz + JSON format, ~6 GB, under
   ``build/``, removed after) and restored into fresh tensors, which
   reproduces step 11's loss and parameters exactly; every kernel's
   launch counter stays 0 throughout; then a 2-layer depth cut
   at full width in f32 (``train_cut_check``): one step on the card
   against the same step on the CPU, and one ``accum_steps=2`` step
   against the unsplit one; prints the memory reckoning, losses, step
   wall, tokens/s, its share of the dense bf16 peak by ``model_flops_at``
   (6 N D) and peak memory;
20. the serving launcher and the layout modules — both attention kernels
   against their plain versions at the launcher's served shapes
   (``check_serve_attention``: Qwen3-4B's 32 q over 8 KV heads, G = 4, hd
   128; chunks of up to 64 queries over a slot of a (4, 256) cache, decode
   over the slots' pages), f32 and bf16 within ``ATTN_TOL``; then
   Qwen3-4B at full width and depth (36 layers, d 2560, tied vocab
   151936, bf16; the reference launcher's default arch) served by
   ``repro_torch.launch.serve.run`` -- what ``main`` calls -- once per
   policy (lmetric, vllm, linear) on one model and one set of parameters
   (``serve.init_params``: seed 0), the reference launcher's 40 arrivals
   each, its engine settings (4 engines x 4 slots x 256 tokens, 64-token
   chunks): every request finishes, the attention launches equal
   ``expected_launches``, and a follow-up turn (of a request whose
   prefill stalled on the last slot while others decoded, where one did)
   is held to the plain full forward (``LOGIT_ATOL``, ``LOGIT_REL_RMS``); prints each ``fmt_row``,
   TTFT / TPOT means, step walls and peak memory; then ``python -m
   repro_torch.launch.serve --arch qwen3_4b --policy lmetric`` (the smoke
   config, as the reference serves) in a subprocess must exit 0 with a
   row of 40 finished requests; then ``model_flops`` and
   ``analytic_flops`` of every assigned arch x input shape at full size on
   ``meta``, and every parameter and decode-cache spec on the 16 x 16 and
   2 x 16 x 16 meshes must divide its dims;
21. the dry run and the card check — ``launch.dryrun``'s analytic sweep
   of the 10 assigned archs x 4 input shapes x the 16 x 16 and 2 x 16 x
   16 meshes: 80 records, all ``ok`` but Whisper x long_500k (the
   reference's documented skip), each printed with its per-card peak
   bytes, its three roofline terms at H100 rates and the dominant one;
   then ``card_check`` of Qwen3-4B at full width and depth on the card:
   a decode step of batch 8 over a 32768-row cache (46.7 GB of
   arguments) and a prefill of 1 x 32768 tokens, each with its arguments
   placed for real (their bytes equal the reckoned ``argument_bytes``,
   the allocator's growth that to its per-tensor rounding), timed (wall,
   CUDA events, the device time of a profiled step) beside its roofline
   terms; 36 ``paged_attention`` launches a decode step (counted from
   zero, and in the trace), none in the plain prefill; then
   ``paged_attention`` against its plain version at that decode shape
   (contexts up to 32768, f32 and bf16 within ``ATTN_TOL``); then
   ``python -m repro_torch.launch.serve --dry-run`` and ``python -m
   repro_torch.launch.train --arch qwen3_4b --dry-run`` in subprocesses
   must exit 0, each with its record under ``results/dryrun_torch``.

Each model is freed before the next is loaded.  If the run nears its
time limit, the Qwen2-7B serving path's depth is cut first (printed),
then phase 14's requests, then the requests of each of phase 13's
comparison runs (never below 500), then phase 15's closed-loop sessions
(halved), then Granite-MoE's requests (to 8), then Whisper's clips (to
4), then the training steps (to 10, the checkpoint after 5), then phase
20's requests (to 10 a policy); the recurrent, MoE, Whisper, training
and launcher paths keep their width and depth,
no run is dropped, and no path keeps fewer instances.  Shard
workers are spawned processes that re-import this file as their main
module, which is why it imports ``torch`` only inside ``main()``.

``python3 chip_smoke.py --profile`` builds the kernels and, instead of
the phases, traces decode steps and prefill chunks of each served model
with ``torch.profiler`` (device busy share, top kernels, and each port
kernel's device time per step however small).

Without a CUDA device it exits with 2 and prints no result.  The three
last lines of standard output are the JSON kernel record, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""
import collections
import copy
import gc
import json
import os
import shutil
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
#: past this point the Qwen2-7B serving path runs this many layers
QWEN_CUT_AFTER_S, QWEN_CUT_LAYERS = 500.0, 8
#: NVIDIA H100 SXM data sheet: HBM3 rate and float64 rate outside the
#: tensor cores, both at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12

CONFIGS = [("jsq", ()), ("linear", (0.7,)), ("filter", (8,)),
           ("filter", (200,)), ("lmetric", ("ptoken", "bs")),
           ("lmetric", ("ptoken", "tokens")),
           ("lmetric", ("one_minus_hit", "bs")),
           ("lmetric", ("one_minus_hit", "tokens")), ("ptoken", ())]
#: route_score's phase-2 shapes (k, n): the simulator's waves (k = 9 and
#: its largest, 28, over 16 instances; the PD pool's 8), the edges of the
#: warp and cluster regimes, the main path's 16384 and 16461 (a partial
#: last CTA), 65536, past REG_IPT instances per thread of a full cluster,
#: so that a CTA keeps some instances in global scratch, and k = 200,
#: whose (k, k+2) aux buffer and, on the warp path, depth matrix exceed
#: the kernels' shared-memory staging, so that they are read in place
SHAPES = [(9, 16), (28, 16), (16, 8), (24, 32), (200, 32), (33, 1025),
          (200, 1025), (64, 1024), (64, 16384), (64, 16461), (64, 65536)]
KERNELS = ("route_score", "prefill_attention", "paged_attention",
           "rglru_scan", "mlstm_cell")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


def cta_edges(n):
    """The instances on both sides of every CTA boundary of
    ``route_score.launch_plan`` at ``n`` (none on the warp path)."""
    from repro_torch.kernels import route_score as rs
    c, _, _ = rs.launch_plan(1, n)
    part = -(-n // c)
    return sorted({i for b in range(1, c) for i in (b * part - 1, b * part)
                   if 0 <= i < n})


def wave_state(rng, k, n, ties):
    """Seeded indicator columns and wave inputs at (k, n).  ``ties``
    makes every instance equal except a strided subset and the instances
    next to each CTA boundary (``cta_edges``), which share the same KV$
    depth, so most steps choose among many exact ties across CTAs."""
    i64 = np.int64
    plen = (rng.randint(1, 80, k) * BLOCK - rng.randint(0, BLOCK, k))
    if ties:
        cols = (np.full(n, 3, i64), np.full(n, 1, i64),
                np.full(n, 4096, i64), np.full(n, 90_000, i64))
        depth = np.zeros((k, n), i64)
        depth[:, ::7] = 2
        depth[:, cta_edges(n)] = 2
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


def drive(router, reqs, use_batch, hint=False):
    """Route ``reqs`` in waves of WAVE (route_batch, or sequential route()
    with the same per-wave ``now``) under a deterministic partial-drain
    schedule that keeps every indicator moving.  With ``hint`` the
    pipeline's ``next_wave_hint`` names the next wave (the speculation of
    an asynchronous shard backend).  Returns decisions, hit tokens and
    the host nanoseconds spent in the routing calls."""
    decisions, hits, route_ns = [], [], 0
    outstanding = collections.deque()
    for i in range(0, len(reqs), WAVE):
        wave = reqs[i:i + WAVE]
        now = wave[0].arrival
        if hint:
            nxt = reqs[i + WAVE:i + 2 * WAVE]
            router.pipeline.next_wave_hint = lambda nxt=nxt: nxt
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
                     "decisions": dec_b, "hits": hit_b,
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
    main path (k=64 over the router's n instances): the kernel's device
    time per launch, cold and warm, and its CUDA-event time per launch."""
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
    # device time per launch (profiler), cold: rotating over copies of the
    # depth matrix and the packed lcp/plen/tie buffer that hold COLD_BYTES
    # (the four mirror columns, 0.5 MB, stay shared); and warm
    sets = [(depth_d.clone(), aux_d.clone()) for _ in range(_copies(
        8 * (depth_d.numel() + aux_d.numel())))]
    runs = [(lambda d=d, x=x: rs.route_wave_device(kind, params, BLOCK, cols,
                                                   d, x)) for d, x in sets]
    device_ms = _device_ms(torch, runs, 5)
    device_warm_ms = _device_ms(torch, runs[:1], 10)
    del sets, runs
    want = rs.route_wave_ref(kind, params, BLOCK, *cols, depth_d, lcp,
                             plen, tie0)
    plain_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        rs.route_wave_ref(kind, params, BLOCK, *cols, depth_d, lcp, plen,
                          tie0)
        torch.cuda.synchronize()
        plain_s.append(time.perf_counter() - t0)
    # the whole score stage as the pipeline runs it (one pinned upload,
    # launch, one copy back, wait), warm, and its submit and collect halves
    stage_s, sub_s, col_s = [], [], []
    for _ in range(10):
        t0 = time.perf_counter()
        h = policy.plan_submit((depth, lcp, plen), f)
        t1 = time.perf_counter()
        policy.plan_collect(h)
        t2 = time.perf_counter()
        stage_s.append(t2 - t0)
        sub_s.append(t1 - t0)
        col_s.append(t2 - t1)
    err = int(max(np.abs(sel.cpu().numpy() - want[0]).max(),
                  np.abs(hit.cpu().numpy() - want[1]).max()))
    if err:
        raise AssertionError(f"kernel != plain on the main-path wave: {err}")
    k, n = depth.shape
    nbytes, flops = wave_bound(kind, params, k, n)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP64_OPS_PER_S * 1e3
    return {"k": k, "n": n, "kind": kind, "params": params,
            "kernel_ms": kernel_ms, "device_ms": device_ms,
            "device_warm_ms": device_warm_ms,
            "plain_ms": sum(plain_s) / len(plain_s) * 1e3,
            "stage_ms": float(np.median(stage_s)) * 1e3,
            "submit_ms": float(np.median(sub_s)) * 1e3,
            "collect_ms": float(np.median(col_s)) * 1e3,
            "bytes": nbytes, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": err}


#: route_score's shapes timed by ``time_route_kernels``: the main path's
#: wave (lmetric, k = 64 over 16384 instances) and the simulator's waves
#: (k = 9, its most common large wave, and 28, its largest, over 16)
ROUTE_TIMED = [(64, N_INST), (9, 16), (28, 16)]


def l2_flush(torch):
    """A closure that overwrites COLD_BYTES of device memory (2x the
    H100's 50 MB L2), so that the next launch finds its inputs cold."""
    buf = torch.empty(int(COLD_BYTES), dtype=torch.uint8, device="cuda")
    return lambda: buf.fill_(1)


def time_route_kernels(torch, rs):
    """``route_score`` of the tree ``rs`` comes from, on seeded lmetric
    waves (``wave_state``) at ROUTE_TIMED: device time per wave
    (``torch.profiler``, the route kernel's events only) cold — after an
    L2 flush — and warm, and the wrapper's wall per wave (``route_wave``
    with host inputs: upload, launch, copy back, wait; median of 50).
    Uses only ``route_wave_device``, ``route_wave`` and ``_pack_aux``,
    which every tree since the first slice has, so that an older tree is
    measured by this code in the same call."""
    kind, params = "lmetric", ("ptoken", "bs")
    flush = l2_flush(torch)
    out = {}
    for k, n in ROUTE_TIMED:
        rng = np.random.RandomState(7 * k + n)
        cols, depth, lcp, plen, tie0 = wave_state(rng, k, n, False)
        cols_d = tuple(torch.from_numpy(c).cuda() for c in cols)
        depth_d = torch.from_numpy(depth).cuda()
        aux_d = torch.from_numpy(rs._pack_aux(lcp, plen, tie0)).cuda()

        def launch():
            rs.route_wave_device(kind, params, BLOCK, cols_d, depth_d, aux_d)

        def cold():
            flush()
            launch()

        walls = []
        for i in range(53):
            t0 = time.perf_counter()
            rs.route_wave(kind, params, BLOCK, *cols_d, depth, lcp, plen,
                          tie0)
            if i >= 3:
                walls.append(time.perf_counter() - t0)
        nbytes, ops = wave_bound(kind, params, k, n)
        out[f"route_score k={k} n={n}"] = {
            "k": k, "n": n,
            "cold_ms": _device_ms(torch, [cold], 10, only="route_"),
            "warm_ms": _device_ms(torch, [launch], 20, only="route_"),
            "wrapper_ms": float(np.median(walls)) * 1e3,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                            ops / FP64_OPS_PER_S) * 1e3}
    del flush
    torch.cuda.empty_cache()
    return out


def report_route_timing(gpu, name, t):
    """Print one ``time_route_kernels`` entry."""
    k = t["k"]
    print(f"[{gpu}] {name} (lmetric ptoken x bs): device "
          f"{t['cold_ms'] * 1e3:.2f} us per wave cold (after an L2 flush), "
          f"{t['warm_ms'] * 1e3:.2f} warm; per step "
          f"{t['cold_ms'] * 1e3 / k:.3f} / {t['warm_ms'] * 1e3 / k:.3f} us;"
          f" route_wave wall {t['wrapper_ms'] * 1e3:.1f} us per wave; "
          f"bound {t['bound_ms'] * 1e3:.4f} us (bytes)")


# ---------------------------------------------------------------------------
# the serving path (phases 5-7): Qwen2-7B under EngineCluster
# ---------------------------------------------------------------------------
#: Qwen2-7B's attention widths (src/repro_torch/configs/qwen2_7b.py)
H_Q, H_KV, HEAD_DIM = 28, 4, 128
#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate at 700 W
BF16_OPS_PER_S = 989e12
#: kernel vs plain version (see tests/test_torch_attention_cuda.py):
#: (atol, rtol), each element within atol + rtol * |plain|.  The bf16
#: checks draw q at scale 2 (k, v at 0.5) so that each softmax peaks over
#: a few keys and outputs reach ~1: a wrong or dropped key then moves an
#: output by more than 1e-2, while the two sides differ by about one bf16
#: ulp of the output (rtol) plus the kernel's bf16 rounding of the
#: softmax weights (atol).  The f32 checks keep q at 0.5
ATTN_TOL = {"float32": (1e-4, 0.0), "bfloat16": (5e-3, 1e-2)}
ATTN_Q_SCALE = {"float32": 0.5, "bfloat16": 2.0}
#: engine vs plain full forward, bf16 logits: max |diff| over the vocab,
#: and the RMS of the difference relative to the RMS of the logits.  Two
#: bf16 paths through 28 random-weight layers part by 2-5% RMS, more on
#: longer contexts (PERF.md); a wrong mask or a stale KV$ fragment gives
#: ~80%
LOGIT_ATOL, LOGIT_REL_RMS = 1.0, 0.15
#: the same check in float32 (xLSTM-350M, whose bf16 logits are chaotic:
#: ``--profile`` prints how far one ulp in 1% of the embeddings moves
#: them): engine and plain forward part by ~0.004 max / 0.0015 RMS at full
#: width
LOGIT_F32 = (0.05, 0.02)
ENGINES, MAX_BATCH, MAX_LEN, CHUNK = 4, 8, 4096, 512
KV_BLOCK, PREFIX_CAPACITY = 16, 4
N_SERVE, SYS_PREFIX, SUFFIX, OUT_TOKENS, MEAN_GAP_S = 32, 1024, (256, 1536), \
    32, 0.05
SEED = 2026


def prefill_bound(Sq, off, window=None, H=H_Q, KV=H_KV, hd=HEAD_DIM):
    """(bytes, operations) of one causal chunk in bf16 (Qwen2-7B's widths
    unless given): q, k, v, out read or written once (k/v span off + Sq
    keys), and 4*hd operations per (query row, head, key it sees) for QK
    and PV."""
    Sk = off + Sq
    seen = sum(min(off + i + 1, window or Sk) for i in range(Sq))
    nbytes = 2 * (2 * Sq * H * hd + 2 * Sk * KV * hd) + 4
    return nbytes, 4 * hd * H * seen


def paged_bound(ctx, page, H=H_Q, KV=H_KV, hd=HEAD_DIM):
    """(bytes, operations) of one decode step over contexts ``ctx`` in bf16
    (Qwen2-7B's widths unless given): the K/V rows in context, q and out,
    the block-table entries and context lengths read once; 4*hd
    operations per (head, key in context)."""
    B, total = len(ctx), int(sum(ctx))
    pages = int(sum(-(-int(c) // page) for c in ctx))
    nbytes = (2 * 2 * total * KV * hd + 2 * 2 * B * H * hd + 4 * pages
              + 4 * B)
    return nbytes, 4 * hd * H * total


def _bound(nbytes, ops, ops_per_s=BF16_OPS_PER_S):
    return _bound_ms(nbytes, ops / ops_per_s * 1e3)


def _bound_ms(nbytes, ops_ms):
    """The larger of the bytes' time at the HBM rate and ``ops_ms``."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(b_ms, ops_ms), ("bytes" if b_ms >= ops_ms else "operations")


def _excess(got, want, rtol):
    """max(|got - want| - rtol * |want|): <= atol means within atol."""
    got, want = got.float(), want.float()
    return ((got - want).abs() - rtol * want.abs()).max().item()


def _attn_err(got, want, name, what, report):
    """Hold an attention kernel's output to its plain version within
    ``ATTN_TOL[name]``; appends the report line, returns max |diff|."""
    atol, rtol = ATTN_TOL[name]
    err = (got.float() - want.float()).abs().max().item()
    exc = _excess(got, want, rtol)
    report.append(f"{what}: max |diff| {err:.3g}, max |diff| - {rtol} "
                  f"|plain| {exc:.3g} (<= {atol}), max |plain| "
                  f"{want.float().abs().max().item():.3g}")
    if not exc <= atol:
        raise AssertionError(f"kernel != plain: {report[-1]}")
    return err


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


#: phase 5's widths beyond Qwen2-7B's (q heads, KV heads, head dim, score
#: soft cap): Qwen3-30B-A3B (G = 8) and Granite-MoE-3B (hd 64, G = 3), as
#: phase 16 serves them, and the soft-capped scores of a config with
#: ``logit_soft_cap`` (no served model sets it), each on one 512-token
#: chunk over 1024 cached keys and one decode step of 8 sequences
ATTN_WIDTHS = [(32, 4, 128, 0.0), (24, 8, 64, 0.0), (32, 4, 128, 2.0)]


def check_attention(torch):
    """Phase 5: both attention kernels against their plain versions on the
    card at Qwen2-7B widths, then at ``ATTN_WIDTHS``, in float32 and
    bfloat16."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import prefill_attention as fp
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)

    def rand(shape, dtype, scale=0.5):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * scale).to(dev, dtype)

    worst = {"prefill_attention": 0.0, "paged_attention": 0.0}
    report = []
    cases = [(H_Q, H_KV, HEAD_DIM, 0.0, chunk) for chunk in (
        (512, 0, None), (512, 3072, None), (300, 1000, None),
        (512, 1024, 256))] + [w + ((512, 1024, None),) for w in ATTN_WIDTHS]
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        for H, KV, hd, cap, (Sq, off, window) in cases:
            q = rand((1, Sq, H, hd), dtype, ATTN_Q_SCALE[name])
            k = rand((1, off + Sq, KV, hd), dtype)
            v = rand((1, off + Sq, KV, hd), dtype)
            offs = torch.full((1,), off, dtype=torch.int32, device=dev)
            got = fp.flash_prefill(q, k, v, offs, window, cap)
            want = fp.flash_prefill_plain(q, k, v, offs, window, cap)
            torch.cuda.synchronize()
            err = _attn_err(got, want, name, f"prefill {name} {H}/{KV} "
                            f"hd {hd} Sq={Sq} off={off} window={window} "
                            f"soft cap {cap}", report)
            worst["prefill_attention"] = max(worst["prefill_attention"], err)
        for H, KV, hd, cap in [(H_Q, H_KV, HEAD_DIM, 0.0)] + ATTN_WIDTHS:
            bt, ctx, shared = manager_tables(torch, rng, dev)
            n_pages = 8 * MAX_LEN // KV_BLOCK
            kp = rand((n_pages, KV_BLOCK, KV, hd), dtype)
            vp = rand((n_pages, KV_BLOCK, KV, hd), dtype)
            q = rand((8, H, hd), dtype, ATTN_Q_SCALE[name])
            got = pa.paged_attention(q, kp, vp, bt, ctx, cap)
            want = pa.paged_attention_plain(q, kp, vp, bt, ctx, cap)
            torch.cuda.synchronize()
            err = _attn_err(got, want, name, f"paged {name} {H}/{KV} hd {hd} "
                            f"soft cap {cap} B=8 page={KV_BLOCK} contexts "
                            f"{ctx.tolist()} ({shared} shared pages)",
                            report)
            worst["paged_attention"] = max(worst["paged_attention"], err)
    return worst, report


#: the serving workloads: requests, system prompts, suffix lengths, output
#: tokens, the opener the first request of each system prompt carries
#: (Qwen2-7B: 8 tokens, under one KV block; the recurrent paths: none, so
#: the bare prompt is stored and every recurrent hit is exact, ROADMAP
#: Queue C.9) and the granule of suffix lengths (block-aligned for the
#: recurrent paths, so that the follow-up turn of the logit check hits an
#: exact state too)
WORKLOADS = {
    "qwen2_7b": dict(n=N_SERVE, groups=4, suffix=SUFFIX, out=OUT_TOKENS,
                     opener=8, align=1),
    "recurrentgemma_9b": dict(n=32, groups=4, suffix=(256, 1536), out=32,
                              opener=0, align=KV_BLOCK),
    "xlstm_350m": dict(n=16, groups=2, suffix=(128, 768), out=16, opener=0,
                       align=KV_BLOCK),
    "qwen3_30b_moe": dict(n=N_SERVE, groups=4, suffix=SUFFIX, out=OUT_TOKENS,
                          opener=8, align=1),
    "granite_moe_3b_a800m": dict(n=16, groups=4, suffix=SUFFIX,
                                 out=OUT_TOKENS, opener=8, align=1),
}
#: phase 16: the MoE models served at full width and depth; past
#: MOE_CUT_AFTER_S Granite-MoE serves MOE_CUT_REQUESTS requests (never
#: fewer layers or a narrower Qwen3-30B-A3B)
MOE_ARCHS = ("qwen3_30b_moe", "granite_moe_3b_a800m")
MOE_CUT_AFTER_S, MOE_CUT_REQUESTS = 1000.0, 8
#: phase 16's float32 logit check, if a MoE model's bf16 noise floor
#: exceeds the tolerances: float32 at full depth where it fits in
#: MOE_F32_BYTES, else the first MOE_F32_LAYERS layers (Qwen3-30B-A3B in
#: float32 is 122 GB; 8 of its 48 layers are ~22 GB)
MOE_F32_BYTES, MOE_F32_LAYERS = 40e9, 8


def serving_requests(vocab, w=WORKLOADS["qwen2_7b"]):
    """``w["n"]`` arrivals: ``w["groups"]`` 1024-token system prompts; the
    first request of each is its system prompt with ``w["opener"]`` more
    tokens (so that the engine stores the bare system prompt as a prefix
    fragment), the others the system prompt of a random group plus a
    unique suffix of ``w["suffix"]`` tokens in steps of ``w["align"]``;
    ``w["out"]`` output tokens each; exponential gaps, 50 ms mean."""
    rng = np.random.RandomState(SEED)
    G = w["groups"]
    prefixes = [rng.randint(0, vocab, SYS_PREFIX) for _ in range(G)]
    lo, hi = (x // w["align"] for x in w["suffix"])
    arrivals, groups, t = [], [], 0.0
    for i in range(w["n"]):
        t += float(rng.exponential(MEAN_GAP_S))
        g = i if i < G else int(rng.randint(G))
        n = w["opener"] if i < G else \
            int(rng.randint(lo, hi + 1)) * w["align"]
        toks = np.concatenate([prefixes[g], rng.randint(0, vocab, n)])
        arrivals.append((t, toks.astype(np.int32), w["out"]))
        groups.append(g)
    return arrivals, groups, prefixes


def check_prompt(served, vocab, extra=700):
    """The logit check's follow-up turn: a served prompt plus ``extra``
    new tokens (seeded)."""
    rng = np.random.RandomState(SEED + 1)
    return np.concatenate([served, rng.randint(0, vocab, extra)]).astype(
        np.int32)


def logits_vs_plain(torch, engines, model, params, arrivals,
                    tol=(LOGIT_ATOL, LOGIT_REL_RMS), extra=700,
                    min_hit=SYS_PREFIX):
    """A follow-up turn of a served prompt (the prompt plus ``extra`` new
    tokens), served step by step by the engine that still holds that
    prompt's fragment (a hit of at least ``min_hit`` tokens): its
    first-token logits (injected fragment + chunked prefill through the
    kernels) and those of its next two decode steps against
    ``Model.prefill``, the plain full forward, over the same tokens,
    within ``tol`` = (max |diff|, RMS ratio).  Returns the comparisons,
    each with the request's hit."""
    atol, rel_rms = tol
    from repro_torch.core import Request
    from repro_torch.core.radix import tokens_to_blocks
    pick = None
    for _, served, _ in reversed(arrivals):        # most recent first
        key = tuple(tokens_to_blocks(served.tolist(), KV_BLOCK))
        for eng in engines:
            if eng.prefix_store.lookup(key)[0] == key:
                pick = (eng, served)
                break
        if pick:
            break
    if pick is None:
        raise AssertionError("no engine holds a served prompt's fragment")
    eng, served = pick
    prompt = check_prompt(served, model.cfg.vocab_size, extra)
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
    if req.hit_tokens < min_hit:
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
                    "argmax_equal": int(el.argmax()) == int(plain.argmax()),
                    "dtype": model.cfg.dtype, "tol": (atol, rel_rms),
                    "hit": req.hit_tokens})
        if not (out[-1]["max_abs"] <= atol and rel <= rel_rms):
            raise AssertionError(f"engine logits != plain forward: {out}")
        toks.append(seq.out_tokens[j])
    return out


def embedding_sensitivity(torch, model, params, prompt, batch=None):
    """How far the plain forward's last logits move when one ulp of the
    parameter dtype is added to 1% of the embedding entries (seeded):
    (max |diff|, RMS ratio), the model's own rounding noise floor
    (``batch``: the forward's inputs beside the tokens, e.g. frames)."""
    w = params["embed"]["w"]
    gen = torch.Generator(device=w.device).manual_seed(SEED + 6)
    hit = torch.rand(w.shape, generator=gen, device=w.device) < 0.01
    ulp = 2.0 ** -7 if w.dtype == torch.bfloat16 else 2.0 ** -23
    w2 = torch.where(hit, (w.float() * (1 + ulp)).to(w.dtype), w)
    toks = torch.as_tensor(np.asarray(prompt, np.int64)).reshape(1, -1)
    base, _ = model.prefill(params, toks, batch, last_only=True)
    moved, _ = model.prefill(dict(params, embed={"w": w2}), toks, batch,
                             last_only=True)
    base, moved = base[0, -1], moved[0, -1]
    d = moved - base
    return (float(d.abs().max()),
            float(d.square().mean().sqrt() / base.square().mean().sqrt()))


def fresh_logit_check(torch, model, params, arrivals, tol):
    """The logit check on one fresh engine of phase 6's settings over
    ``model`` (a replaced config of the served one): it serves the last
    arrival's prompt (block-aligned for the recurrent paths, so that its
    stored state is exact), then its follow-up turn is held to the plain
    forward of ``model`` within ``tol``."""
    from repro_torch.core import Request
    from repro_torch.serving.engine import InstanceEngine
    eng = InstanceEngine(model, params, max_batch=2, max_len=MAX_LEN,
                         chunk_tokens=CHUNK, block_size=KV_BLOCK,
                         prefix_capacity=PREFIX_CAPACITY,
                         device=model.device)
    _, served, _ = arrivals[-1]
    eng.submit(Request(rid=10 ** 6 + 1, arrival=0.0, blocks=(),
                       prompt_len=len(served), output_len=1), served)
    while eng.has_work():
        eng.step()
    return logits_vs_plain(torch, [eng], model, params, [arrivals[-1]], tol)


def f32_logit_check(torch, model, params, arrivals):
    """The logit check in float32: the bf16 model's weights widened, held
    within ``LOGIT_F32``."""
    import dataclasses
    from repro_torch.models import Model
    m32 = Model(dataclasses.replace(model.cfg, dtype="float32"),
                device=model.device)
    return fresh_logit_check(torch, m32, _cast(params, torch.float32),
                             arrivals, LOGIT_F32)


def moe_logit_check(torch, cluster, model, params, arrivals):
    """Phase 16's logit check.  A MoE layer's capacity is computed per
    call, so at the published factor a 512-token chunk drops other
    choices than the full forward (ROADMAP Queue C.12: the reference's
    semantics).  So the cluster's caches are freed and the check runs on
    a fresh engine whose config takes ``capacity_factor = n_experts /
    top_k`` (cap >= S at every call: nothing drops at any chunking), the
    same weights.  First the model's own bf16 noise floor over the
    check's prompt (``embedding_sensitivity``); if it exceeds
    (``LOGIT_ATOL``, ``LOGIT_REL_RMS``) -- rounding flips near-tied
    experts -- the bf16 weights are dropped (``params`` is emptied) and
    the check runs in float32 (``LOGIT_F32``) on weights drawn from the
    same seed, at full depth where that fits in ``MOE_F32_BYTES``, else
    on the first ``MOE_F32_LAYERS`` layers.  Returns (checks, what was
    held and why)."""
    import dataclasses
    from repro_torch.models import Model
    cfg = model.cfg
    for eng in cluster.engines:
        eng.cache = None
    gc.collect()
    torch.cuda.empty_cache()
    nodrop = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    m = Model(nodrop, device=model.device)
    _, served, _ = arrivals[-1]
    floor = embedding_sensitivity(torch, m, params,
                                  check_prompt(served, cfg.vocab_size))
    what = (f"capacity factor {nodrop.capacity_factor:g} (nothing drops); "
            f"bf16 noise floor max {floor[0]:.4f}, RMS ratio {floor[1]:.4f}")
    if floor[0] <= LOGIT_ATOL and floor[1] <= LOGIT_REL_RMS:
        return (fresh_logit_check(torch, m, params, arrivals,
                                  (LOGIT_ATOL, LOGIT_REL_RMS)),
                what + f" within ({LOGIT_ATOL}, {LOGIT_REL_RMS}): bf16 at "
                f"full depth")
    layers = cfg.n_layers if cfg.param_count() * 4 <= MOE_F32_BYTES \
        else min(MOE_F32_LAYERS, cfg.n_layers)
    params.clear()
    del m
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(nodrop, dtype="float32", n_layers=layers,
                                block_pattern=cfg.block_pattern[:layers])
    m32 = Model(cfg32, device=model.device)
    p32 = m32.init(torch.Generator(device=model.device).manual_seed(SEED))
    return (fresh_logit_check(torch, m32, p32, arrivals, LOGIT_F32),
            what + f" above ({LOGIT_ATOL}, {LOGIT_REL_RMS}): float32 on "
            f"{layers} of {cfg.n_layers} layers (float32 at full depth is "
            f"{cfg.param_count() * 4 / 1e9:.1f} GB)")


def _launch_counters():
    from repro_torch.kernels import mlstm_cell, paged_attention
    from repro_torch.kernels import prefill_attention, rglru_scan
    return {"prefill_attention": prefill_attention,
            "paged_attention": paged_attention, "rglru_scan": rglru_scan,
            "mlstm_cell": mlstm_cell}


def expected_launches(cfg, chunks, decodes, on_card, engines=ENGINES,
                      chunk=CHUNK):
    """Launches of each serving kernel for the chunk sizes ``chunks`` and
    ``decodes`` decode steps, each of the ``engines``' warm-up (one chunk
    of min(chunk, 8) tokens and one decode step) included: one attention
    launch per attention layer and chunk or step, one ``rglru_scan`` per
    RG-LRU layer and chunk, ``ceil(n / 256)`` ``mlstm_cell`` per mLSTM
    layer and chunk of n tokens (the reference's chunking), none for
    sLSTM and none on the CPU."""
    from repro_torch.models.recurrent import MLSTM_CHUNK
    if not on_card:
        return dict.fromkeys(_launch_counters(), 0)
    kinds = collections.Counter(cfg.block_pattern)
    n_attn = kinds["attn"] + kinds["swa"]
    sizes = list(chunks) + [min(chunk, 8)] * engines
    return {"prefill_attention": n_attn * len(sizes),
            "paged_attention": n_attn * (decodes + engines),
            "rglru_scan": kinds["rglru"] * len(sizes),
            "mlstm_cell": kinds["mlstm"] * sum(-(-n // MLSTM_CHUNK)
                                              for n in sizes)}


def serving_path(torch, arch="qwen2_7b", device="cuda", n_layers=None,
                 n_req=None):
    """Phases 6, 10, 11 and 16: ``arch`` at full width (``n_layers`` cuts
    the depth of a dense model, never of a recurrent one), 4 engines under
    the LMetric router, the requests of ``WORKLOADS[arch]`` (the first
    ``n_req`` if given).  Returns the numbers to print.

    ``arch="<id>-smoke", device="cpu"`` rehearses the same path on the
    CPU with the kernels' plain versions (no launches are counted
    there)."""
    import dataclasses
    from repro_torch.cluster.metrics import summarize
    from repro_torch.configs import get_config
    from repro_torch.core import LMetricPolicy
    from repro_torch.models import Model
    from repro_torch.serving.engine import EngineCluster
    cfg = get_config(arch)
    if n_layers is not None and n_layers < cfg.n_layers:
        if set(cfg.block_pattern) != {"attn"}:
            raise ValueError("only a dense model's depth may be cut")
        cfg = dataclasses.replace(cfg, n_layers=n_layers,
                                  block_pattern=cfg.block_pattern[:n_layers])
    w = WORKLOADS[arch.replace("-smoke", "")]
    if n_req is not None:
        w = dict(w, n=min(n_req, w["n"]))
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    model = Model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    sync()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    mem = (lambda: torch.cuda.memory_allocated()) if on_card else \
        (lambda: 0)
    mem_weights = mem()
    arrivals, groups, prefixes = serving_requests(cfg.vocab_size, w)
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
    mem_engines = mem()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    counters = _launch_counters()
    for mod in counters.values():
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    done = cluster.run(arrivals)
    sync()
    wall = time.perf_counter() - t0
    launches = {name: mod.LAUNCHES for name, mod in counters.items()}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    chunks = [s for s in steps if s[1] == "prefill"]
    decodes = [s for s in steps if s[1] == "decode"]
    want = expected_launches(cfg, [c[2] for c in chunks], len(decodes),
                             on_card)
    if launches != want:
        raise AssertionError(f"{cfg.name}: launches {launches} != {want} "
                             f"({len(chunks)} chunks, {len(decodes)} decode "
                             f"steps, {ENGINES} warm-ups)")
    if len(done) != w["n"]:
        raise AssertionError(f"{len(done)} of {w['n']} requests finished")
    # LMetric may place a shared-prefix request on an instance that never
    # saw its system prompt (load outweighs the hit); every one placed on
    # an instance that did must report a hit of the whole system prompt.
    # An exact_only router credits only whole routed prompts, so there
    # only the instance that took the bare system prompt holds it
    exact_only = cluster.router.factory.exact_only
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
        if not exact_only or r.rid < len(prefixes):
            holders[g].add(r.sched_to)
    if misses:
        raise AssertionError(f"requests placed with their system prompt "
                             f"but without a >= {SYS_PREFIX}-token hit "
                             f"(rid, group, instance, hit): {misses}")
    prompt_tokens = sum(r.prompt_len for r in done)
    computed = sum(s[2] for s in chunks)
    if prompt_tokens - computed < SYS_PREFIX:
        raise AssertionError("no prefill was skipped by a KV$ fragment")
    check_note = None
    if arch.startswith("xlstm"):
        # xLSTM-350M with random weights is chaotic in bf16 (one ulp in 1%
        # of its embeddings moves its own logits by an RMS ratio of ~0.8,
        # ``--profile``), so its engine is held to the plain forward in f32
        logit_checks = f32_logit_check(torch, model, params, arrivals)
    elif cfg.n_experts:
        logit_checks, check_note = moe_logit_check(torch, cluster, model,
                                                   params, arrivals)
    else:
        logit_checks = logits_vs_plain(torch, cluster.engines, model,
                                       params, arrivals)
    out = {"cfg": cfg, "n_params": n_params, "init_s": t_init,
           "wall_s": wall, "summary": summarize(done), "n_req": w["n"],
           "launches": launches, "chunks": chunks, "decodes": decodes,
           "prompt_tokens": prompt_tokens, "computed_tokens": computed,
           "hit_tokens": sum(r.hit_tokens for r in done), "peak": peak,
           "mem_weights": mem_weights, "mem_engines": mem_engines,
           "logit_checks": logit_checks, "check_note": check_note,
           "placed_hot": hot, "placed_cold": cold,
           "exact_only": exact_only,
           "instances": collections.Counter(r.sched_to for r in done)}
    return out


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


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
    """Wall of ``reps`` back-to-back calls between two CUDA events, per
    call: the wrapper's host work as well as the kernel, whichever sets
    the pace."""
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


def _device_events(prof):
    """(name, us) of every device activity in a trace: from the raw Kineto
    events, which keep activities the profiler could not tie to a
    CPU-side call, else from the profiler's event list."""
    from torch.autograd import DeviceType
    try:
        return [(e.name(), e.duration_ns() / 1e3)
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA]
    except AttributeError:
        return [(e.name, e.device_time_total) for e in prof.events()
                if e.device_type == DeviceType.CUDA]


def _device_ms(torch, fns, rounds, tries=3, only=None):
    """Device time per call: ``rounds`` rounds over ``fns`` (one call each)
    under ``torch.profiler`` after one warm-up round; the time of every
    kernel and copy the calls ran on the card (of those whose names
    contain ``only``, if given), summed, over the calls.
    Rotating over ``fns`` that read distinct copies of their inputs keeps
    those inputs out of the L2 cache.  Every call runs the same kernels,
    so a trace in which some kernel's count is not a multiple of the
    calls has lost events (seen for SDPA and, after the serving phases,
    for the prefill kernel): it is taken again, up to ``tries`` times;
    then each kernel's mean time per event in the last trace that saw any
    is taken once per call, or as many times as its events per call round
    to, and the loss is printed.  If no trace saw a device event at all
    (seen once for SDPA), the calls are timed by CUDA events around
    back-to-back calls instead (``_events_ms``: all of their device work
    and any host gaps), and that is printed."""
    from torch.profiler import ProfilerActivity, profile
    calls = rounds * len(fns)
    kept = None
    for _ in range(tries):
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(rounds):
                for fn in fns:
                    fn()
            torch.cuda.synchronize()
        us, count = collections.Counter(), collections.Counter()
        for name, t in _device_events(prof):
            us[name] += t
            count[name] += 1
        if only is not None:
            us = collections.Counter({k: v for k, v in us.items()
                                      if only in k})
        if count and all(n % calls == 0 for n in count.values()):
            return sum(us.values()) / 1e3 / calls
        if count:
            kept = us, count
    if kept is None:
        print(f"torch.profiler saw no device event in {tries} traces of "
              f"{calls} calls: timed by CUDA events around back-to-back "
              f"calls instead", file=sys.stderr)
        return sum(_events_ms(torch, fn, rounds) for fn in fns) / len(fns)
    us, count = kept
    print(f"torch.profiler lost device events {tries} times ({dict(count)} "
          f"over {calls} calls): each kernel's mean per event taken "
          f"instead", file=sys.stderr)
    return sum(us[k] / count[k] * max(1, round(count[k] / calls))
               for k in us) / 1e3


#: decode timings rotate over copies of the cache that together hold at
#: least this many bytes of context (2x the H100's 50 MB L2), so that
#: each launch finds its K/V cold, as a decode step does after 28-38
#: layers of weights have passed through L2
COLD_BYTES = 100e6


def _copies(nbytes):
    """How many copies of inputs of ``nbytes`` hold ``COLD_BYTES``."""
    return max(2, int(-(-COLD_BYTES // nbytes)))


def _over_group(x, H):
    """(B, S, KV, hd) K or V as SDPA's (B, H, S, hd): a stride-0 view over
    the group when KV == 1, else each head repeated G times."""
    B, S, KV, hd = x.shape
    xt = x.transpose(1, 2)
    if KV == 1:
        return xt.expand(B, H, S, hd)
    return xt.repeat_interleave(H // KV, dim=1)


def time_prefill(torch, rng, Sq, off, H, KV, hd, window=None):
    """One prefill chunk (bf16): the kernel's device time per launch
    (profiler) and its wrapper's time per call (CUDA events), the plain
    version's time, SDPA's device time and wall (boolean mask, K/V
    expanded over the group) and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import prefill_attention as fp
    dev = torch.device("cuda")

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * 0.5).to(dev, torch.bfloat16)

    Sk = off + Sq
    q, k, v = rand(1, Sq, H, hd), rand(1, Sk, KV, hd), rand(1, Sk, KV, hd)
    offs = torch.full((1,), off, dtype=torch.int32, device=dev)
    run = (lambda: fp.flash_prefill(q, k, v, offs, window))
    qt = q.transpose(1, 2)
    kt, vt = _over_group(k, H), _over_group(v, H)
    qpos = off + torch.arange(Sq, device=dev)[:, None]
    kpos = torch.arange(Sk, device=dev)[None]
    mask = (kpos <= qpos) & ((qpos - kpos < window) if window else True)
    lib = (lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask))
    nbytes, ops = prefill_bound(Sq, off, window, H, KV, hd)
    bound, by = _bound(nbytes, ops)
    dev_ms = _device_ms(torch, [run], 20)
    return dict(
        shape=f"Sq={Sq} over {off} cached rows, H={H} KV={KV} hd={hd}"
              + (f" window {window}" if window else ""),
        ms=dev_ms, wrapper_ms=_events_ms(torch, run, 50),
        plain_ms=_events_ms(torch, lambda: fp.flash_prefill_plain(
            q, k, v, offs, window), 5),
        library_ms=_device_ms(torch, [lib], 10),
        library_wall_ms=_events_ms(torch, lib, 20), bound_ms=bound,
        bound_by=by, bytes=nbytes, ops=ops, share=bound / dev_ms)


def time_decode(torch, rng, B, S, H, KV, hd, ctx_np):
    """One decode step over B paged slots of S rows (bf16, page 16,
    contexts ``ctx_np``): the kernel's device time per launch with cold
    K/V (rotating over copies of the cache, ``COLD_BYTES``) and warm (one
    copy), its wrapper's time per call (CUDA events, warm), the split
    count and grid, the plain version's time, SDPA's the same ways (over
    the gathered K/V expanded over the group, masked) and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    dev = torch.device("cuda")

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * 0.5).to(dev, torch.bfloat16)

    nbytes, ops = paged_bound(ctx_np, KV_BLOCK, H, KV, hd)
    copies = _copies(nbytes)
    pages = (B * S // KV_BLOCK, KV_BLOCK, KV, hd)
    caches = [(rand(B, S, KV, hd).view(pages), rand(B, S, KV, hd).view(pages))
              for _ in range(copies)]
    bt = torch.arange(B * S // KV_BLOCK, dtype=torch.int32,
                      device=dev).reshape(B, -1)
    ctx = torch.from_numpy(np.asarray(ctx_np, np.int32)).to(dev)
    q = rand(B, H, hd)
    runs = [(lambda kp=kp, vp=vp: pa.paged_attention(q, kp, vp, bt, ctx))
            for kp, vp in caches]
    splits, grid = pa.launch_config(q, caches[0][0], bt)
    cold = _device_ms(torch, runs, 10)
    warm = _device_ms(torch, runs[:1], 20)
    wrapper = _events_ms(torch, runs[0], 200)
    plain = _events_ms(torch, lambda: pa.paged_attention_plain(
        q, caches[0][0], caches[0][1], bt, ctx), 5)
    del caches
    # SDPA over copies of the slots' K/V put over the group, as many as
    # hold COLD_BYTES (it reads every row, masked or not)
    mask = (torch.arange(S, device=dev)[None] < ctx[:, None])[:, None, None]
    lib_kv = []
    while len(lib_kv) < 2 or sum(t.untyped_storage().nbytes()
                                 for kv in lib_kv for t in kv) < COLD_BYTES:
        lib_kv.append((_over_group(rand(B, S, KV, hd), H),
                       _over_group(rand(B, S, KV, hd), H)))
    libs = [(lambda kt=kt, vt=vt: F.scaled_dot_product_attention(
        q[:, :, None], kt, vt, attn_mask=mask)) for kt, vt in lib_kv]
    lib_cold = _device_ms(torch, libs, 10)
    lib_warm = _device_ms(torch, libs[:1], 20)
    lib_wall = _events_ms(torch, libs[0], 50)
    del lib_kv
    bound, by = _bound(nbytes, ops)
    return dict(
        shape=f"B={B} slots of {S}, H={H} KV={KV} hd={hd}, contexts "
              f"{list(map(int, ctx_np))}",
        ms=cold, warm_ms=warm, wrapper_ms=wrapper, copies=copies,
        splits=splits, grid=grid, plain_ms=plain, library_ms=lib_cold,
        library_warm_ms=lib_warm, library_wall_ms=lib_wall,
        bound_ms=bound, bound_by=by, bytes=nbytes, ops=ops,
        share=bound / cold)


def time_attention(torch):
    """Phase 7: each attention kernel at the Qwen2-7B serving path's
    shapes (bf16): a 512-token chunk after a 1024-token KV$ hit and one
    deeper into a long prompt; a decode step over all 8 slots of an
    engine's (8, 4096) cache with ragged contexts.  Beside each, the
    plain version's time, the bound and one PyTorch library call for the
    same function as a yardstick (the port never calls it)."""
    rng = np.random.RandomState(SEED + 2)
    out = {}
    for Sq, off in ((CHUNK, SYS_PREFIX), (CHUNK, 2048)):
        out[f"prefill Sq={Sq} off={off}"] = time_prefill(
            torch, rng, Sq, off, H_Q, H_KV, HEAD_DIM)
    ctx_np = rng.randint(SYS_PREFIX + SUFFIX[0],
                         SYS_PREFIX + SUFFIX[1] + OUT_TOKENS, MAX_BATCH)
    out["decode"] = time_decode(torch, rng, MAX_BATCH, MAX_LEN, H_Q, H_KV,
                                HEAD_DIM, ctx_np)
    return out


def report_attention_timing(gpu, name, t):
    """Print one attention timing of phases 7 and 12."""
    line = (f"[{gpu}] {name} {t['shape']}: kernel {t['ms'] * 1e3:.2f} us "
            f"device per launch")
    if "warm_ms" in t:
        line += (f" with cold K/V (rotating over {t['copies']} copies of "
                 f"the cache), {t['warm_ms'] * 1e3:.2f} warm; splits "
                 f"{t['splits']}, grid {t['grid']} = "
                 f"{int(np.prod(t['grid']))} blocks")
    line += (f"; wrapper {t['wrapper_ms'] * 1e3:.2f} us per call (CUDA "
             f"events around back-to-back calls); bound "
             f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}: {t['bytes']} "
             f"B, {t['ops']} ops), {t['share']:.1%} of it; plain "
             f"{t['plain_ms'] * 1e3:.1f} us; SDPA yardstick "
             f"{t['library_ms'] * 1e3:.2f} us device per call")
    if "library_warm_ms" in t:
        line += f" cold, {t['library_warm_ms'] * 1e3:.2f} warm"
    line += f", {t['library_wall_ms'] * 1e3:.2f} per call in events"
    print(line)


# ---------------------------------------------------------------------------
# the recurrent paths (phases 8-12): RecurrentGemma-9B and xLSTM-350M
# ---------------------------------------------------------------------------
#: RecurrentGemma-9B's local attention and recurrence widths
#: (src/repro_torch/configs/recurrentgemma_9b.py)
RG_H, RG_KV, RG_HD, RG_W, RG_DR = 16, 1, 256, 2048, 4096
#: xLSTM-350M's mLSTM cell: 4 heads of 2 * 1024 / 4, chunks of 256
XL_H, XL_HD, XL_L = 4, 512, 256
#: NVIDIA H100 SXM data sheet: float32 rate outside the tensor cores
FP32_OPS_PER_S = 67e12
#: kernel vs plain version (see tests/test_torch_recurrent_cuda.py):
#: rglru_scan atol; mlstm_cell (atol, rtol) by q/k/v dtype, h and state
REC_TOL = {"rglru_scan": 2e-5, "float32": (1e-4, 1e-4),
           "bfloat16": (2e-2, 1e-2)}
#: one full-width swa layer's cached chunks vs its plain full forward, f32
SWA_LAYER_ATOL = 2e-3


def check_recurrent(torch):
    """Phase 8: rglru_scan and mlstm_cell against their plain versions on
    the card.  Returns the worst error of each and the report lines."""
    from repro_torch.kernels import mlstm_cell as mc
    from repro_torch.kernels import rglru_scan as rs
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 3)

    def rand(shape, scale=1.0, dtype=torch.float32):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * scale).to(dev, dtype)

    worst = {"rglru_scan": 0.0, "mlstm_cell": 0.0}
    report = []
    # the serving shape, ragged S and D, B = 2, and the segment edges of
    # the serving width's plan: one position, P segments +- 1 position,
    # one window (P x SEGMAX positions) +- 1
    P = rs.launch_plan(torch.empty((1, CHUNK, RG_DR), device=dev))["P"]
    shapes = [(1, CHUNK, RG_DR), (1, 333, 4000), (2, 17, 31)] + [
        (1, S, RG_DR) for S in (1, P - 1, P + 1, P * rs.SEGMAX - 1,
                                P * rs.SEGMAX + 1)]
    for B, S, D in shapes:
        a = torch.from_numpy((rng.rand(B, S, D) * 0.95).astype(
            np.float32)).to(dev)
        x, h0 = rand((B, S, D)), rand((B, D))
        h, hl = rs.rglru_scan(a, x, h0)
        hp, hlp = rs.rglru_scan_plain(a, x, h0)
        torch.cuda.synchronize()
        err = max((h - hp).abs().max().item(), (hl - hlp).abs().max().item())
        report.append(f"rglru_scan (B, S, D) = {(B, S, D)}, h0 != 0: "
                      f"{err:.3g}")
        if not (err <= REC_TOL["rglru_scan"] and torch.equal(hl, h[:, -1])):
            raise AssertionError(f"rglru_scan != plain: {report[-1]}")
        worst["rglru_scan"] = max(worst["rglru_scan"], err)

    def cell_inputs(L, m0, dtype, B=1):
        q, k, v = (rand((B, L, XL_H, XL_HD), 0.3, dtype) for _ in range(3))
        il, fl = rand((B, L, XL_H), 0.5), -rand((B, L, XL_H), 0.3).abs()
        C0 = rand((B, XL_H, XL_HD, XL_HD), 0.1)
        n0 = rand((B, XL_H, XL_HD), 0.1).abs()
        if m0 is None:
            return q, k, v, il, fl, C0, n0, rand((B, XL_H), 0.1)
        if m0 < -1e29:                               # a fresh state
            C0.zero_()
            n0.zero_()
        return q, k, v, il, fl, C0, n0, torch.full((B, XL_H), m0,
                                                    device=dev)

    def compare(got, want, dtype, what):
        atol, rtol = REC_TOL[str(dtype).split(".")[-1]]
        err_h = (got[0].float() - want[0].float()).abs().max().item()
        st_atol, st_rtol = REC_TOL["float32"]
        err_st = max((g - w).abs().max().item()
                     for g, w in zip(got[1], want[1]))
        report.append(f"mlstm_cell {what} {str(dtype)[6:]}: h {err_h:.3g}, "
                      f"state {err_st:.3g}")
        if not (_excess(got[0], want[0], rtol) <= atol and all(
                _excess(g, w, st_rtol) <= st_atol
                for g, w in zip(got[1], want[1]))):
            raise AssertionError(f"mlstm_cell != plain: {report[-1]}")
        worst["mlstm_cell"] = max(worst["mlstm_cell"], err_h, err_st)

    for dtype in (torch.float32, torch.bfloat16):
        # the serving chunk, a ragged one from both starting stabilisers,
        # the engines' warm-up chunk of 8, and B = 2
        for L, m0, B in ((XL_L, None, 1), (37, -1e30, 1), (37, 0.0, 1),
                         (8, 0.0, 1), (8, -1e30, 2)):
            inputs = cell_inputs(L, m0, dtype, B)
            got = mc.mlstm_chunk(*inputs)
            want = mc.mlstm_chunk_plain(*inputs)
            torch.cuda.synchronize()
            compare(got, want, dtype, f"({B}, {L}, {XL_H}, {XL_HD}) m0={m0}")
        q, k, v, il, fl, *_ = cell_inputs(4 * XL_L, 0.0, dtype)
        st = stp = (torch.zeros((1, XL_H, XL_HD, XL_HD), device=dev),
                    torch.zeros((1, XL_H, XL_HD), device=dev),
                    torch.full((1, XL_H), -1e30, device=dev))
        for c in range(4):
            sl = slice(c * XL_L, (c + 1) * XL_L)
            args = [t[:, sl].contiguous() for t in (q, k, v, il, fl)]
            got = mc.mlstm_chunk(*args, *st)
            want = mc.mlstm_chunk_plain(*args, *stp)
            st, stp = got[1], want[1]
            torch.cuda.synchronize()
            compare(got, want, dtype, f"chain chunk {c} of 4")
    return worst, report


def check_attention_hd256(torch):
    """Phase 9: both attention kernels at RecurrentGemma's widths (hd 256,
    KV 1, G 16, window 2048), and one full-width swa layer's cached chunks
    (through the ring and the kernel) against its plain full forward."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import prefill_attention as fp
    from repro_torch.models import attention as attn
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 4)

    def rand(shape, dtype, scale=0.5):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * scale).to(dev, dtype)

    worst = {"prefill_attention": 0.0, "paged_attention": 0.0}
    report = []
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        # kept ring rows below, at and above... W (a ring holds at most W)
        for Sq, kept in ((CHUNK, 0), (CHUNK, 1024), (CHUNK, RG_W),
                         (300, 1800)):
            q = rand((1, Sq, RG_H, RG_HD), dtype, ATTN_Q_SCALE[name])
            k = rand((1, kept + Sq, RG_KV, RG_HD), dtype)
            v = rand((1, kept + Sq, RG_KV, RG_HD), dtype)
            offs = torch.full((1,), kept, dtype=torch.int32, device=dev)
            got = fp.flash_prefill(q, k, v, offs, RG_W)
            want = fp.flash_prefill_plain(q, k, v, offs, RG_W)
            torch.cuda.synchronize()
            err = _attn_err(got, want, name, f"prefill hd 256 {name} "
                            f"Sq={Sq} kept={kept} window={RG_W}", report)
            worst["prefill_attention"] = max(worst["prefill_attention"], err)
        B = MAX_BATCH
        ring_k = rand((B, RG_W, RG_KV, RG_HD), dtype)
        ring_v = rand((B, RG_W, RG_KV, RG_HD), dtype)
        pages = (B * RG_W // KV_BLOCK, KV_BLOCK, RG_KV, RG_HD)
        bt = attn.decode_tables(B, RG_W, dev)
        ctx = torch.tensor([1, 17, 600, RG_W - 1, RG_W, RG_W, 1500, RG_W],
                           dtype=torch.int32, device=dev)
        q = rand((B, RG_H, RG_HD), dtype, ATTN_Q_SCALE[name])
        got = pa.paged_attention(q, ring_k.view(pages), ring_v.view(pages),
                                 bt, ctx)
        want = pa.paged_attention_plain(q, ring_k.view(pages),
                                        ring_v.view(pages), bt, ctx)
        torch.cuda.synchronize()
        err = _attn_err(got, want, name, f"paged hd 256 {name} B={B} ring "
                        f"{RG_W} contexts {ctx.tolist()}", report)
        worst["paged_attention"] = max(worst["paged_attention"], err)
    # one swa layer at full width, f32: cached chunks wrap the ring
    cfg = dataclasses.replace(get_config("recurrentgemma_9b"),
                              dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = attn.init_attention(gen, cfg, "swa")
    S = 2600
    x = rand((1, S, cfg.d_model), torch.float32, 1.0)
    want, _ = attn.attn_prefill(p, x, torch.arange(S, device=dev)[None],
                                cfg, "swa")
    ring_k = torch.zeros((1, RG_W, RG_KV, RG_HD), device=dev)
    ring_v = torch.zeros_like(ring_k)
    bounds = (0, 512, 1024, 1900, 2412, S)     # 1900..2412 wraps the ring
    err = 0.0
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        plan = attn.prefill_plan("swa", [lo], hi - lo, RG_W, dev)
        y = attn.attn_prefill_cached(
            p, x[:, lo:hi], torch.arange(lo, hi, device=dev)[None], cfg,
            "swa", ring_k, ring_v, plan)
        err = max(err, (y - want[:, lo:hi]).abs().max().item())
    torch.cuda.synchronize()
    report.append(f"swa layer (d_model {cfg.d_model}, hd {RG_HD}, window "
                  f"{RG_W}) chunks {bounds} vs plain full forward, f32: "
                  f"{err:.3g}")
    if not err <= SWA_LAYER_ATOL:
        raise AssertionError(f"swa cached chunks != full forward: "
                             f"{report[-1]}")
    return worst, report


def mlstm_bound(L, H, hd):
    """Least (bytes, operations) of one bf16 ``mlstm_cell`` call, and the
    CUDA-core count the first version was held to.

    Bytes: q, k, v read and h written in bf16, C, n, m read and written
    and the two gates read in f32.  Operations, on the tensor cores: q k^T
    over the causal half of the (L, L) square (S is 0 above the diagonal)
    has bf16 operands and takes one pass; S v (causal half), q C0 and
    (k w_src)^T v (the whole state) have an f32 operand, split into bf16
    hi + lo, and take two passes.  The old count took q k^T at the bf16
    rate and the other three once each at the f32 CUDA-core rate."""
    pairs = L * (L + 1) // 2
    nbytes = (2 * 4 * L * H * hd + 4 * 2 * (H * hd * hd + H * hd + H)
              + 4 * 2 * L * H)
    ops = H * (2 * pairs * hd + 2 * (2 * pairs * hd + 2 * 2 * L * hd * hd))
    old_f32 = H * (2 * pairs * hd + 2 * 2 * L * hd * hd)
    old_ms = max(nbytes / HBM_BYTES_PER_S,
                 H * 2 * pairs * hd / BF16_OPS_PER_S
                 + old_f32 / FP32_OPS_PER_S) * 1e3
    return nbytes, ops, old_ms


def time_recurrent_kernels(torch):
    """``rglru_scan`` and ``mlstm_cell`` at the serving shapes: device time
    per launch (``torch.profiler``) with cold inputs, rotating over copies
    that hold ``COLD_BYTES``, and warm (one copy); the wrapper's wall per
    call (CUDA events around back-to-back calls); the plain version; the
    bound.  No single PyTorch call computes either function (library_ms
    null).  Only the public wrappers are called, so ``scripts/
    serving_ab.py --kernels`` times an older checkout's kernels with this
    code."""
    from repro_torch.kernels import mlstm_cell as mc
    from repro_torch.kernels import rglru_scan as rs
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 5)
    out = {}

    def rand(*shape, dtype=torch.float32, scale=1.0):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * scale).to(dev, dtype)

    def timed(name, runs, plain, nbytes, ops, shape, ops_per_s, **extra):
        cold = _device_ms(torch, runs, 10)
        warm = _device_ms(torch, runs[:1], 20)
        bound, by = _bound(nbytes, ops, ops_per_s)
        out[name] = dict(shape=shape, ms=cold, warm_ms=warm,
                         wrapper_ms=_events_ms(torch, runs[0], 100),
                         plain_ms=_events_ms(torch, plain, 3),
                         copies=len(runs), library_ms=None, bound_ms=bound,
                         bound_by=by, bytes=nbytes, ops=ops,
                         share=bound / cold, **extra)

    # rglru_scan: one 512-token chunk of one RG-LRU layer
    B, S, D = 1, CHUNK, RG_DR
    a = torch.from_numpy((rng.rand(B, S, D) * 0.95).astype(
        np.float32)).to(dev)
    x, h0 = rand(B, S, D), rand(B, D)
    nbytes, ops = 4 * (3 * B * S * D + 2 * B * D), 2 * B * S * D
    sets = [(a.clone(), x.clone(), h0.clone()) for _ in range(_copies(
        4 * 2 * B * S * D))]
    # (a checkout older than the segmented scan has no plan)
    plan = rs.launch_plan(a) if hasattr(rs, "launch_plan") else {}
    timed("rglru_scan", [(lambda t=t: rs.rglru_scan(*t)) for t in sets],
          lambda: rs.rglru_scan_plain(a, x, h0), nbytes, ops,
          f"(B, S, D) = {(B, S, D)} f32", FP32_OPS_PER_S,
          plan={k: plan[k] for k in ("vec", "CT", "P", "seg", "grid")
                if k in plan})
    del sets
    # mlstm_cell: one 256-token chunk of one mLSTM layer, bf16 q/k/v
    L, H, hd = XL_L, XL_H, XL_HD
    bf = torch.bfloat16
    q, k, v = (rand(1, L, H, hd, dtype=bf, scale=0.3) for _ in range(3))
    il, fl = rand(1, L, H, scale=0.5), -rand(1, L, H, scale=0.3).abs()
    C0, n0 = rand(1, H, hd, hd, scale=0.1), rand(1, H, hd, scale=0.1).abs()
    m0 = torch.zeros((1, H), device=dev)
    args = (q, k, v, il, fl, C0, n0, m0)
    nbytes, ops, old_ms = mlstm_bound(L, H, hd)
    sets = [tuple(t.clone() for t in args) for _ in range(_copies(
        sum(t.numel() * t.element_size() for t in args)))]
    timed("mlstm_cell", [(lambda t=t: mc.mlstm_chunk(*t)) for t in sets],
          lambda: mc.mlstm_chunk_plain(*args), nbytes, ops,
          f"(B, L, H, hd) = {(1, L, H, hd)} bf16", BF16_OPS_PER_S,
          old_bound_ms=old_ms)
    del sets
    return out


def report_recurrent_timing(gpu, name, t):
    """Print one recurrent kernel's timing of phase 12."""
    line = (f"[{gpu}] {name} {t['shape']}: kernel {t['ms'] * 1e3:.2f} us "
            f"device per launch cold (rotating over {t['copies']} copies "
            f"of the inputs), {t['warm_ms'] * 1e3:.2f} warm; wrapper "
            f"{t['wrapper_ms'] * 1e3:.2f} us per call (CUDA events around "
            f"back-to-back calls); bound {t['bound_ms'] * 1e3:.2f} us "
            f"({t['bound_by']}: {t['bytes']} B, {t['ops']} ops), "
            f"{t['share']:.1%} of it")
    if "old_bound_ms" in t:
        line += (f" (the first version's CUDA-core count: "
                 f"{t['old_bound_ms'] * 1e3:.2f} us)")
    if t.get("plan"):
        line += f"; plan {t['plan']}"
    line += (f"; plain {t['plain_ms'] * 1e3:.1f} us; no single PyTorch call "
             f"computes this function")
    print(line)


def time_recurrent(torch):
    """Phase 12: the recurrent kernels (``time_recurrent_kernels``) and the
    head-dim 256 attention (``time_prefill``, ``time_decode``) at the
    serving shapes; SDPA is the attention's yardstick."""
    out = time_recurrent_kernels(torch)
    rng = np.random.RandomState(SEED + 6)
    # the attention kernels at hd 256: a 512-token chunk after a 1024-token
    # hit, and a decode step over 8 rings of 2048 with contexts up to W
    out["prefill_attention hd 256"] = time_prefill(
        torch, rng, CHUNK, SYS_PREFIX, RG_H, RG_KV, RG_HD, RG_W)
    ctx_np = np.minimum(rng.randint(SYS_PREFIX + 256, SYS_PREFIX + 1536 + 32,
                                    MAX_BATCH), RG_W)
    out["paged_attention hd 256"] = time_decode(
        torch, rng, MAX_BATCH, RG_W, RG_H, RG_KV, RG_HD, ctx_np)
    return out


def report_serving(gpu, sv):
    """Print one serving path's numbers (phases 6, 10, 11, 16)."""
    s = sv["summary"]
    cfg = sv["cfg"]
    tag = f"[{gpu}] serving {cfg.name}:"
    ch_tok = sv["computed_tokens"]
    ch_s = sum(c[4] for c in sv["chunks"])
    dec_ms = [d[4] * 1e3 for d in sv["decodes"]]
    full = [d[4] * 1e3 for d in sv["decodes"] if d[3] == MAX_BATCH]
    kinds = dict(collections.Counter(cfg.block_pattern))
    print(f"{tag} {cfg.n_layers} layers {kinds} d_model {cfg.d_model} "
          f"head_dim {cfg.resolved_head_dim} {sv['n_params'] / 1e9:.2f} B "
          f"params (bf16, seeded on the card in {sv['init_s']:.1f} s); "
          f"{ENGINES} engines x max_batch {MAX_BATCH} x max_len {MAX_LEN}, "
          f"chunk {CHUNK}, LMetric router (exact_only "
          f"{sv['exact_only']}); {s['n']} of {sv['n_req']} requests served "
          f"in {sv['wall_s']:.1f} s wall")
    print(f"{tag} TTFT mean {s['ttft_mean'] * 1e3:.1f} ms p50 "
          f"{s['ttft_p50'] * 1e3:.1f} p95 {s['ttft_p95'] * 1e3:.1f} | TPOT "
          f"mean {s['tpot_mean'] * 1e3:.2f} ms p95 {s['tpot_p95'] * 1e3:.2f}"
          f" | SLO attainment {s['slo_attainment']:.3f} | virtual time "
          f"from measured step walls, makespan {s['makespan']:.2f} s")
    print(f"{tag} {len(sv['chunks'])} prefill chunks, {ch_tok} tokens "
          f"computed at {ch_tok / ch_s:.0f} tokens/s of prefill step wall; "
          f"{sv['prompt_tokens']} prompt tokens, "
          f"{sv['prompt_tokens'] - ch_tok} skipped by KV$ fragments; "
          f"reported hit tokens {sv['hit_tokens']}; requests per instance "
          f"{dict(sorted(sv['instances'].items()))}; {sv['placed_hot']} "
          f"shared-prefix requests placed where their system prompt was "
          f"routed before (all hit >= {SYS_PREFIX}), {sv['placed_cold']} "
          f"elsewhere by load")
    mid = [c[4] * 1e3 for c in sv["chunks"] if c[2] == CHUNK and not c[5]]
    last = [c[4] * 1e3 for c in sv["chunks"] if c[5]]
    med = (lambda v: float(np.median(v)) if v else float("nan"))
    print(f"{tag} prefill step wall, median: full {CHUNK}-token chunk that "
          f"does not end its prompt {med(mid):.2f} ms ({len(mid)} chunks; a "
          f"first chunk after a hit includes the fragment's upload); chunk "
          f"that ends its prompt {med(last):.2f} ms ({len(last)}; includes "
          f"the fragment's copy to the host)")
    print(f"{tag} {len(dec_ms)} decode steps, median {med(dec_ms):.2f} ms "
          f"(with all {MAX_BATCH} slots running: {len(full)} steps, median "
          f"{med(full):.2f} ms); device memory: weights "
          f"{sv['mem_weights'] / 2 ** 30:.2f} GiB, with the engines' caches "
          f"{sv['mem_engines'] / 2 ** 30:.2f} GiB, peak while serving "
          f"{sv['peak'] / 2 ** 30:.2f} GiB")
    weights = cfg.param_count() * 2
    line = (f"{tag} reckoned from param_count: {cfg.param_count() / 1e9:.2f} "
            f"B parameters, {weights / 1e9:.2f} GB ({weights / 2 ** 30:.2f} "
            f"GiB) of bf16 weights")
    if set(cfg.block_pattern) == {"attn"}:
        kv = (ENGINES * MAX_BATCH * MAX_LEN * cfg.n_layers * 2
              * cfg.n_kv_heads * cfg.resolved_head_dim * 2)
        line += (f", KV caches {ENGINES} x {MAX_BATCH} x {MAX_LEN} x "
                 f"{cfg.n_layers} layers x 2 x {cfg.n_kv_heads} x "
                 f"{cfg.resolved_head_dim} x 2 B = {kv / 1e9:.2f} GB "
                 f"({kv / 2 ** 30:.2f} GiB)")
    print(line)
    print(f"{tag} decode-step floor: every step reads all "
          f"{sv['n_params'] * 2 / 1e9:.2f} GB of weights"
          + (f" (the dispatch runs all {cfg.n_experts} experts' products)"
             if cfg.n_experts else "")
          + f": {sv['n_params'] * 2 / HBM_BYTES_PER_S * 1e3:.2f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; measured median "
          f"{med(dec_ms):.2f} ms"
          + (f" ({med(full):.2f} with all {MAX_BATCH} slots running)"
             if full else ""))
    print(f"{tag} kernel launches {sv['launches']} (expected, from "
          f"{len(sv['chunks'])} chunks, {len(sv['decodes'])} decode steps "
          f"and {ENGINES} warm-ups)")
    if sv["check_note"]:
        print(f"{tag} logit check: {sv['check_note']}")
    for c in sv["logit_checks"]:
        print(f"{tag} engine (hit {c['hit']} tokens) vs plain full "
              f"forward, {c['dtype']}, step {c['step']}: max |dlogit| "
              f"{c['max_abs']:.4f}, RMS ratio {c['rel_rms']:.4f}, argmax "
              f"equal {c['argmax_equal']} (tolerance {c['tol'][0]}, "
              f"{c['tol'][1]})")


def port_kernel_times(us, count):
    """{port kernel: (device us, device launches)} summed over the
    profiler's device events ``us`` and ``count`` by name (each name's
    category by ``launch.hlo.category``)."""
    from repro_torch.launch.hlo import PORT_KERNELS, category
    out = {}
    for key, t in us.items():
        name = category(key)
        if name in PORT_KERNELS:
            tot, c = out.get(name, (0.0, 0))
            out[name] = (tot + t, c + count[key])
    return out


def step_fns(torch, arch):
    """``arch`` with random bf16 weights on the card, and two closures at
    the serving path's shapes: a decode step of MAX_BATCH slots at
    position ~2000, and a CHUNK-token prefill chunk over a
    SYS_PREFIX-token prefix, each ending with its argmax on the host.
    Returns (cfg, model, params, rng, decode, prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    cache = model.init_cache(MAX_BATCH, MAX_LEN)
    rng = np.random.RandomState(SEED)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, CHUNK)))
    pos = torch.from_numpy(rng.randint(1900, 2100, MAX_BATCH))
    slot = [{n: t[:1] for n, t in c.items()} for c in cache]

    def decode():
        logits, _ = model.decode_step(params, toks[:, :MAX_BATCH].T, pos,
                                      cache)
        logits.argmax(-1).cpu()

    def prefill():
        logits, _ = model.prefill_cached(
            params, toks, torch.arange(SYS_PREFIX, SYS_PREFIX + CHUNK)[None],
            slot, [SYS_PREFIX], last_only=True)
        logits.argmax(-1).cpu()

    return cfg, model, params, rng, decode, prefill


def profile_steps(torch, gpu, arch):
    """``--profile``: where a serving step's time goes on the card.  Traces
    ``arch``'s steps at the serving path's shapes with ``torch.profiler``:
    5 decode steps of 8 slots at position ~2000, and 3 prefill chunks of
    512 tokens over a 1024-token prefix.  Prints the wall per step with
    and without the profiler, the device time summed over kernels (busy
    share = device time / wall without the profiler), the kernels that
    take the most device time and each port kernel's device time per step
    (``launch.hlo.PORT_KERNELS``), however small.  Then the model's
    rounding noise floor (``embedding_sensitivity``) over a 2748-token
    prompt in bf16, and for xLSTM-350M, whose logit check runs in f32, in
    f32 too."""
    import dataclasses
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import Model
    cfg, model, params, rng, decode, prefill = step_fns(torch, arch)
    for name, fn, n in (("decode step (8 slots)", decode, 5),
                        (f"prefill chunk ({CHUNK} over {SYS_PREFIX})",
                         prefill, 3)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        bare = (time.perf_counter() - t0) / n
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
        print(f"[{gpu}] profile {cfg.name} {name}: wall {bare * 1e3:.2f} ms "
              f"({wall * 1e3:.2f} under the profiler), device busy "
              f"{busy:.2f} ms ({busy / (bare * 1e3):.1%} of the wall), "
              f"{sum(count.values()) // n} device ops per step")
        for key, t in us.most_common(8):
            print(f"[{gpu}]   {t / n / 1e3:8.3f} ms  x{count[key] // n:<4d} "
                  f"{key[:90]}")
        for name, (t, c) in port_kernel_times(us, count).items():
            print(f"[{gpu}]   port kernel {name}: {t / n / 1e3:.3f} ms per "
                  f"step ({t / n / 1e3 / busy:.1%} of the device time), "
                  f"{c // n} device launches per step")
    del decode, prefill
    gc.collect()
    prompt = rng.randint(0, cfg.vocab_size, 2 * SYS_PREFIX + 700)
    floors = [("bf16", model, params)]
    if arch.startswith("xlstm"):
        floors.append(("f32", Model(dataclasses.replace(cfg,
                                                        dtype="float32")),
                       _cast(params, torch.float32)))
    for dt, m, p in floors:
        mx, rel = embedding_sensitivity(torch, m, p, prompt)
        print(f"[{gpu}] noise floor {cfg.name} {dt}: one ulp in 1% of the "
              f"embeddings moves the plain forward's last logits over "
              f"{len(prompt)} tokens by max {mx:.4f}, RMS ratio {rel:.4f}")
    del model, params, floors, m, p
    gc.collect()
    torch.cuda.empty_cache()


def ptxas_summary(reports):
    """One line per kernel of ptxas's ``-v`` reports: registers, static
    shared memory (the attention kernels' tiles are dynamic shared memory,
    sized at launch), stack and spills (names demangled by ``c++filt``
    where it exists)."""
    import re
    out = []
    for src, text in sorted(reports.items()):
        name, regs = None, None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                regs = m.groups()
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                try:
                    name = subprocess.run(
                        ["c++filt", name], capture_output=True, text=True,
                        timeout=10).stdout.strip() or name
                except OSError:
                    pass
                stack, st, ld = regs or ("?", "?", "?")
                name = name.replace("(anonymous namespace)::", "")
                name = name.replace("void ", "").split("(")[0]
                smem = re.search(r"(\d+) bytes smem", line)
                out.append(f"{src}.cu {name}: {m.group(1)} "
                           f"registers, {smem.group(1) if smem else 0} B "
                           f"static smem, {stack} B stack, {st} B spill "
                           f"stores, {ld} B spill loads")
                name, regs = None, None
    return out


def sass_summary(names):
    """One line per kernel of the built libraries ``names``: how many
    tensor-core instructions (HGMMA: wgmma; HMMA: mma.sync) and TMA loads
    (UTMALDG) its machine code holds, from ``cuobjdump -sass``."""
    import re
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = []
    for name in names:
        try:
            text = subprocess.run(
                [tool, "-sass", str(_build.library_path(name))],
                capture_output=True, text=True, timeout=120).stdout
        except OSError as e:
            out.append(f"{name}: cuobjdump not run ({e})")
            continue
        for fn in re.split(r"\n\s*Function : ", text)[1:]:
            head, body = fn.split("\n", 1)
            counts = {op: len(re.findall(rf"\b{op}\b", body))
                      for op in ("HGMMA", "HMMA", "UTMALDG")}
            try:
                head = subprocess.run(
                    ["c++filt", head.strip()], capture_output=True,
                    text=True, timeout=10).stdout.strip() or head
            except OSError:
                pass
            head = head.replace("(anonymous namespace)::", "")
            head = head.replace("void ", "").split("(")[0]
            out.append(f"{name}.so {head}: " + ", ".join(
                f"{n} {op}" for op, n in counts.items()))
    return out


# ---------------------------------------------------------------------------
# the cluster simulation (phase 13): ClusterSim and PDDisaggSim
# ---------------------------------------------------------------------------
#: the paper's testbed (§4.1): 16 Qwen2-7B instances; one trace for each
#: kind of workload it evaluates (chatbots, API calls, coding agents)
SIM_INSTANCES = 16
SIM_TRACES = ("chatbot", "agent", "coder", "toolagent")
#: Fig. 22's policies; the first three plan their waves on the card, the
#: rest are host-only (as in the reference) and launch nothing
SIM_POLICIES = ("lmetric", "vllm", "linear", "dynamo", "llm-d")
DEVICE_POLICIES = ("lmetric", "vllm", "linear")
#: the device-planned runs on the first three traces; every other run of
#: the phase (but PD) is a "comparison run", which a late start may cut
BASE_RUNS = {(f, p) for f in ("chatbot", "agent", "coder")
             for p in DEVICE_POLICIES}
#: the predictors of llm-d and PolyServe err by up to 15%, as in the
#: paper's figures (``benchmarks/common.py``)
PREDICTOR_ERROR = 0.15
#: Fig. 21's adversarial trace: agent traffic with a 4-second burst of
#: requests sharing one 4096-token prefix, at SIM_LOAD x the agent
#: family's estimated capacity
HOTSPOT_DURATION, HOTSPOT_BURST = 10.0, (2.0, 4.0)
#: past this point phase 13's comparison runs route SIM_CUT_REQUESTS
#: requests each (cut after the Qwen2-7B depth and phase 14's requests)
SIM_CUT_AFTER_S, SIM_CUT_REQUESTS = 750.0, 500
#: requests per trace, load as a share of the trace's estimated capacity,
#: the scheduling tick arrivals are rounded to (so that same-time waves
#: form), and the traces' seed
SIM_REQUESTS, SIM_LOAD, SIM_TICK, SIM_SEED = 2000, 0.8, 0.05, 7
#: one instance's KV$: the card's 80 GiB, of which the engine may fill
#: 0.9 (vLLM's default memory share), less Qwen2-7B's bf16 weights as
#: phase 6 measures them on the card (PERF.md §5)
CARD_GIB, MEM_SHARE, QWEN_WEIGHTS_GIB = 80, 0.9, 14.26
PD_PREFILL, PD_DECODE = 8, 8


def sim_kv_capacity(spec):
    """(tokens, how): one instance's KV$ capacity in tokens."""
    free = (CARD_GIB * MEM_SHARE - QWEN_WEIGHTS_GIB) * 2 ** 30
    return int(free // spec.kv_bytes_per_token), (
        f"({CARD_GIB} GiB x {MEM_SHARE} - {QWEN_WEIGHTS_GIB} GiB of bf16 "
        f"weights) / {spec.kv_bytes_per_token} B of KV per token")


def _on_tick(trace):
    """Arrivals rounded to SIM_TICK and re-sorted (stably: a tick keeps
    its requests in rid order)."""
    for r in trace:
        r.arrival = round(r.arrival / SIM_TICK) * SIM_TICK
    trace.sort(key=lambda r: r.arrival)
    return trace


def sim_qps(family, spec):
    """SIM_LOAD x ``family``'s estimated capacity on SIM_INSTANCES
    instances (estimated on a 300-second draw of the family)."""
    from repro_torch.workloads.traces import (estimate_capacity_qps,
                                              make_trace)
    probe = make_trace(family, qps=20.0, duration=300.0, seed=SIM_SEED)
    return SIM_LOAD * estimate_capacity_qps(spec, probe, SIM_INSTANCES)


def sim_trace(family, spec, n_req):
    """The first ``n_req`` requests of ``family`` at ``sim_qps``,
    arrivals on the tick.  Returns (trace, qps)."""
    from repro_torch.workloads.traces import make_trace
    qps = sim_qps(family, spec)
    duration = n_req / qps
    trace = make_trace(family, qps=qps, duration=duration, seed=SIM_SEED)
    while len(trace) < n_req:
        duration *= 1.5
        trace = make_trace(family, qps=qps, duration=duration,
                           seed=SIM_SEED)
    return _on_tick(trace[:n_req]), qps


def hotspot_trace(spec, n_req):
    """Fig. 21's trace: the first ``n_req`` requests of
    ``make_hotspot_trace`` at the agent family's ``sim_qps`` (as the
    reference's figures size "hotspot"), arrivals on the tick.  Returns
    (trace, qps)."""
    from repro_torch.workloads.traces import make_hotspot_trace
    qps = sim_qps("agent", spec)
    start, length = HOTSPOT_BURST
    trace = make_hotspot_trace(qps=qps, duration=HOTSPOT_DURATION,
                               seed=SIM_SEED, burst_start=start,
                               burst_len=length)
    if len(trace) < n_req:
        raise AssertionError(f"the hotspot trace holds {len(trace)} "
                             f"requests, fewer than {n_req}")
    return _on_tick(trace[:n_req]), qps


def sim_policy(name, spec):
    """A policy of phase 13 by name: ``make_policy``'s names, llm-d and
    PolyServe with PREDICTOR_ERROR, ``lmetric+detector`` (§5.2's
    detector) and ``lmetric[cost]`` (the "cost" load indicator)."""
    from repro_torch.core import (HotspotDetector, LatencyModel,
                                  LMetricPolicy, make_policy)
    if name in ("llm-d", "polyserve"):
        return make_policy(name, latency_model=LatencyModel(
            spec, error_std=PREDICTOR_ERROR))
    if name == "lmetric+detector":
        return LMetricPolicy(detector=HotspotDetector())
    if name == "lmetric[cost]":
        return LMetricPolicy(load_indicator="cost",
                             latency_model=LatencyModel(spec))
    return make_policy(name)


def detector_counts(policy):
    """(Eq. 2 checks, violations, activations) of a detector run."""
    det = policy.detector
    return (len(det.history), sum(1 for h in det.history if not h["eq2"]),
            sum(1 for e in det.events if e["event"] == "activate"))


def wave_sizes(trace):
    """{wave size: count} of the same-timestamp arrival groups."""
    return dict(sorted(collections.Counter(collections.Counter(
        r.arrival for r in trace).values()).items()))


def _finished(done):
    return [(r.rid, r.sched_to, r.hit_tokens, r.t_first_token, r.t_finish)
            for r in done]


def multi_waves(trace):
    """The same-tick groups of two requests or more: the waves a device
    policy routes through ``route_score``."""
    return sum(c for k, c in wave_sizes(trace).items() if k > 1)


def sim_path(device="cuda", n_req=SIM_REQUESTS, n_new=None):
    """Phase 13: ``ClusterSim`` on SIM_INSTANCES instances with the
    Qwen2-7B spec on the port's H100 profile.

    * Fig. 22: every (trace, policy) of SIM_TRACES x SIM_POLICIES, then
      ``PDDisaggSim`` with PD_PREFILL prefill and PD_DECODE decode
      instances on the chatbot trace;
    * Fig. 20: ``lmetric+detector`` on every trace of SIM_TRACES;
    * Fig. 21: the hotspot trace (``hotspot_trace``) under lmetric,
      ``lmetric+detector`` and vllm;
    * Fig. 26: the chatbot trace under preble and polyserve; the coder
      trace under ``lmetric[cost]``; the agent trace under
      session-affinity.

    Each run counts ``route_score`` launches from zero and must finish
    every request; a DEVICE_POLICIES run launches once per wave of two
    or more (none on the CPU) and its pipeline counts as many waves, a
    host-only run launches nothing and its pipeline counts no wave.  The
    lmetric chatbot run and the PD run must equal their runs with the
    mirror on the CPU, and the PD run its request-by-request routing; a
    detector run that never activates must equal the lmetric run of its
    trace, and the hotspot detector run its run with the mirror on the
    CPU (finished tuples and detector counts).  The runs of BASE_RUNS
    and PD route ``n_req`` requests, the comparison runs ``n_new``
    (default ``n_req``).  Returns the numbers to print.

    ``device="cpu"`` rehearses the phase with the plain version of
    ``route_score`` (no launches are counted there)."""
    from repro_torch.cluster.metrics import summarize
    from repro_torch.cluster.pd_disagg import PDDisaggSim
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.configs import get_config
    from repro_torch.core import Router, spec_from_config
    from repro_torch.kernels import route_score as rs
    n_new = n_req if n_new is None else n_new
    spec0 = spec_from_config(get_config("qwen2_7b"))
    kv, how = sim_kv_capacity(spec0)
    spec = spec_from_config(get_config("qwen2_7b"), kv_capacity_tokens=kv)

    def run(make_sim, trace, dev, want_waves):
        rs.LAUNCHES = 0
        t0 = time.perf_counter()
        sim = make_sim(dev)
        done = sim.run(copy.deepcopy(trace))
        wall = time.perf_counter() - t0
        launches = rs.LAUNCHES
        if len(done) != len(trace):
            raise AssertionError(f"{len(done)} of {len(trace)} requests "
                                 f"finished")
        if launches != (want_waves if dev != "cpu" else 0):
            raise AssertionError(f"route_score launched {launches} times "
                                 f"for {want_waves} waves of two or more")
        return sim, done, wall, launches

    def sim_run(name, trace, dev=device):
        """One ClusterSim run of policy ``name``; checks launches and the
        pipeline's wave count against the policy's kind."""
        want = multi_waves(trace) if name in DEVICE_POLICIES else 0

        def cluster(d):
            return ClusterSim(Router(sim_policy(name, spec), SIM_INSTANCES,
                                     kv_capacity_tokens=kv, device=d),
                              spec)
        sim, done, wall, launches = run(cluster, trace, dev, want)
        if sim.router.pipeline.waves != want:
            raise AssertionError(f"{name}: {sim.router.pipeline.waves} "
                                 f"device waves, {want} expected")
        return sim, done, wall, launches

    out = {"kv": kv, "how": how, "spec": spec, "runs": [], "new_runs": [],
           "launches": 0}

    def record(family, name, trace, qps, sim, done, wall, launches,
               same_cpu=None, new=True, **extra):
        out["launches"] += launches
        (out["new_runs"] if new else out["runs"]).append({
            "what": f"{family} {name}", "family": family, "policy": name,
            "qps": qps, "span": trace[-1].arrival - trace[0].arrival,
            "summary": summarize(done, per_family_slo=True),
            "sizes": wave_sizes(trace), "waves": multi_waves(trace),
            "launches": launches, "wall": wall,
            "stages": (sim.router.stage_stats()
                       if hasattr(sim, "router") else None),
            "same_cpu": same_cpu, "extra": extra})

    t_phase = time.perf_counter()
    traces, lmetric = {}, {}
    for family in SIM_TRACES:
        full, qps = sim_trace(family, spec, n_req)
        if not multi_waves(full):
            raise AssertionError(f"{family}: no arrival wave of two or "
                                 f"more, so no launch to count")
        traces[family] = (full, qps)
        for policy in SIM_POLICIES:
            new = (family, policy) not in BASE_RUNS
            trace = full[:n_new] if new else full
            sim, done, wall, launches = sim_run(policy, trace)
            same_cpu = None
            if policy == "lmetric":
                lmetric[family] = (len(trace), _finished(done))
            if family == "chatbot" and policy == "lmetric":
                _, plain, _, _ = sim_run(policy, trace, "cpu")
                if _finished(plain) != _finished(done):
                    raise AssertionError("ClusterSim lmetric chatbot: the "
                                         "card's run != the CPU's")
                same_cpu = True
                # phase 14 runs the same trace on a sharded router
                out["flat_chatbot"] = (trace, multi_waves(trace),
                                       _finished(done))
                # the run's router and its largest wave, for the timing
                # of one wave's score stage (``sim_wave_time``)
                at = collections.Counter(r.arrival for r in trace)
                t_max = max(at, key=at.get)
                out["timing"] = (sim.router, [r for r in trace
                                              if r.arrival == t_max])
            record(family, policy, trace, qps, sim, done, wall, launches,
                   same_cpu, new)

    class Sequential(PDDisaggSim):
        def _on_arrivals(self, reqs):
            for r in reqs:
                self._on_arrival(r)

    trace, qps = traces["chatbot"]
    multi = multi_waves(trace)

    def pd(dev, cls=PDDisaggSim):
        return cls(PD_PREFILL, PD_DECODE, spec, kv_capacity_tokens=kv,
                   device=dev)
    sim, done, wall, launches = run(pd, trace, device, multi)
    _, plain, _, _ = run(pd, trace, "cpu", multi)
    _, seq, _, _ = run(lambda dev: pd(dev, Sequential), trace, device, 0)
    if _finished(plain) != _finished(done):
        raise AssertionError("PDDisaggSim: the card's run != the CPU's")
    if _finished(seq) != _finished(done):
        raise AssertionError("PDDisaggSim: waves != request-by-request "
                             "routing")
    record("chatbot", f"PD {PD_PREFILL}+{PD_DECODE}", trace, qps, sim, done,
           wall, launches, True, False)

    # ---- Fig. 20: the detector on the benign traces ----------------------
    for family in SIM_TRACES:
        full, qps = traces[family]
        trace = full[:n_new]
        sim, done, wall, launches = sim_run("lmetric+detector", trace)
        checks, viol, act = detector_counts(sim.router.policy)
        same = None
        if not act:
            # nothing was filtered: the host path decides as the device
            # plan of the lmetric run on the same requests did
            if lmetric[family][0] != len(trace):
                _, lm_done, _, lm_launches = sim_run("lmetric", trace)
                out["launches"] += lm_launches
                lmetric[family] = (len(trace), _finished(lm_done))
            if _finished(done) != lmetric[family][1]:
                raise AssertionError(f"{family}: the detector run never "
                                     f"activated, yet differs from the "
                                     f"lmetric run")
            same = True
        record(family, "lmetric+detector", trace, qps, sim, done, wall,
               launches, checks=checks, violations=viol, activations=act,
               same_lmetric=same)

    # ---- Fig. 21: the hotspot trace --------------------------------------
    hot, qps = hotspot_trace(spec, n_new)
    for name in ("lmetric", "lmetric+detector", "vllm"):
        sim, done, wall, launches = sim_run(name, hot)
        extra, same_cpu = {}, None
        if name == "lmetric+detector":
            cpu, cpu_done, _, _ = sim_run(name, hot, "cpu")
            counts = detector_counts(sim.router.policy)
            if (detector_counts(cpu.router.policy) != counts
                    or _finished(cpu_done) != _finished(done)):
                raise AssertionError("hotspot lmetric+detector: the card's "
                                     "run != the CPU's")
            same_cpu = True
            extra = dict(zip(("checks", "violations", "activations"),
                             counts))
            extra["burst"] = sum(1 for r in hot if r.family == "hotspot")
        record("hotspot", name, hot, qps, sim, done, wall, launches,
               same_cpu, **extra)

    # ---- Fig. 26, the cost indicator, session affinity -------------------
    for family, name in (("chatbot", "preble"), ("chatbot", "polyserve"),
                         ("coder", "lmetric[cost]"),
                         ("agent", "session-affinity")):
        full, qps = traces[family]
        trace = full[:n_new]
        sim, done, wall, launches = sim_run(name, trace)
        pol = sim.router.policy
        extra = {}
        if name == "preble":
            extra["branch_counts"] = dict(pol.branch_counts)
        if name == "session-affinity":
            extra["pins"] = len(pol.pins)
        record(family, name, trace, qps, sim, done, wall, launches, **extra)
    out["wall"] = time.perf_counter() - t_phase
    out["new_wall"] = sum(r["wall"] for r in out["new_runs"])
    return out


def sim_wave_time(torch, rs, router, wave_reqs, reps=50):
    """One simulator wave's score stage: the kernel's device time per
    launch (``torch.profiler``, the route kernel's events), cold after an
    L2 flush and warm (a wave of 16 instances stays in L2), its CUDA-event
    time per launch; the whole stage as the simulator runs it (the mirror
    re-uploaded, as after every wave's hooks, then submit and collect;
    median of ``reps``) and its parts timed apart (medians): the mirror's
    upload (``device_view`` when dirty), ``route_wave_submit`` (pack,
    one pinned upload, launch, one copy back, event) and
    ``route_wave_collect`` (wait, copy out); and the plain version's
    time."""
    policy, f = router.policy, router.factory
    depth, lcp, plen = policy.wave_inputs(copy.deepcopy(wave_reqs), f)
    kind, params = policy.batch_kind, policy._batch_params()
    cols = f.device_view()
    dev = cols[0].device
    depth_d = torch.from_numpy(depth).to(dev)
    aux_d = torch.from_numpy(rs._pack_aux(lcp, plen, 0)).to(dev)

    def launch():
        return rs.route_wave_device(kind, params, f.block_size, cols,
                                    depth_d, aux_d)

    flush = l2_flush(torch)

    def cold():
        flush()
        launch()

    parts = collections.defaultdict(list)
    for _ in range(reps):
        t0 = time.perf_counter()
        f.mark_dirty()                    # dirty, as after a wave's hooks
        c = f.device_view()
        t1 = time.perf_counter()
        h = rs.route_wave_submit(kind, params, f.block_size, *c, depth,
                                 lcp, plen, 0)
        t2 = time.perf_counter()
        rs.route_wave_collect(h)
        t3 = time.perf_counter()
        parts["mirror"].append(t1 - t0)
        parts["submit"].append(t2 - t1)
        parts["collect"].append(t3 - t2)
        parts["stage"].append(t3 - t0)
    plain = []
    for _ in range(5):
        t0 = time.perf_counter()
        rs.route_wave_ref(kind, params, f.block_size, *cols, depth_d, lcp,
                          plen, 0)
        torch.cuda.synchronize()
        plain.append(time.perf_counter() - t0)
    k, n = depth.shape
    nbytes, ops = wave_bound(kind, params, k, n)
    out = {"k": k, "n": n, "kind": kind,
           "device_ms": _device_ms(torch, [launch], reps, only="route_"),
           "cold_ms": _device_ms(torch, [cold], 20, only="route_"),
           "events_ms": _events_ms(torch, launch, reps),
           "plain_ms": float(np.median(plain)) * 1e3,
           "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                           ops / FP64_OPS_PER_S) * 1e3}
    for name, v in parts.items():
        out[f"{name}_ms"] = float(np.median(v)) * 1e3
    del flush
    torch.cuda.empty_cache()
    return out


def sim_step_times(torch, spec, served):
    """The H100 profile's predicted step times at phase 6's shapes (a
    CHUNK-token prefill chunk; a decode step of MAX_BATCH slots at
    position ~2000) beside Qwen2-7B's on the card: phase 6's median
    walls, and the two steps of ``step_fns`` timed alone (wall, and
    device time per step from ``torch.profiler``)."""
    from repro_torch.core import LatencyModel
    lm = LatencyModel(spec)
    sv = served["qwen2_7b"]
    med = (lambda v: float(np.median(v)) * 1e3 if v else float("nan"))
    out = {
        "prefill": {"predicted": lm.step_time(CHUNK, 0, 0) * 1e3,
                    "served": med([c[4] for c in sv["chunks"]
                                   if c[2] == CHUNK and not c[5]])},
        "decode": {"predicted": lm.step_time(0, MAX_BATCH,
                                             MAX_BATCH * 2000) * 1e3,
                   "served": med([d[4] for d in sv["decodes"]])},
        "decode_bs": float(np.median([d[3] for d in sv["decodes"]])),
        "layers": sv["cfg"].n_layers}
    cfg, _, _, _, decode, prefill = step_fns(torch, "qwen2_7b")
    out["alone_layers"] = cfg.n_layers
    for name, fn, n in (("decode", decode, 5), ("prefill", prefill, 3)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        out[name]["wall"] = (time.perf_counter() - t0) / n * 1e3
        out[name]["device"] = _device_ms(torch, [fn], n)
    del decode, prefill
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _sim_line(r):
    """One phase-13 run's line."""
    s, st, x = r["summary"], r["stages"], r["extra"]
    if r["policy"] not in DEVICE_POLICIES and st is not None:
        score = "host-only policy: no device wave"
    elif st:
        score = (f"score stage {st['score_us']:.1f} us/wave, walk "
                 f"{st['walk_us']:.1f}, commit {st['commit_us']:.1f}")
    else:
        score = "no stage timings (route_wave called directly)"
    notes = "".join(f" | {k} {v}" for k, v in x.items()
                    if k not in ("same_lmetric",))
    if x.get("same_lmetric"):
        notes += " | == the lmetric run (device-planned)"
    return (f"{r['what']}: {s['n']} finished at {r['qps']:.2f} "
            f"req/s offered over {r['span']:.2f} s | TTFT mean "
            f"{s['ttft_mean'] * 1e3:.2f} ms p50 {s['ttft_p50'] * 1e3:.2f}"
            f" p95 {s['ttft_p95'] * 1e3:.2f} p99 {s['ttft_p99'] * 1e3:.2f}"
            f" | TPOT mean {s['tpot_mean'] * 1e3:.3f} ms p99 "
            f"{s['tpot_p99'] * 1e3:.3f} | KV$ hit {s['kv_hit_ratio']:.4f} "
            f"| SLO {s['slo_attainment']:.4f} | waves of >= 2: "
            f"{r['waves']}, sizes {r['sizes']} | route_score launches "
            f"{r['launches']} | host wall {r['wall']:.2f} s, {score}"
            + notes + (" | == CPU run" if r["same_cpu"] else ""))


def report_sim(gpu, sim, steps=None, wave=None):
    """Print phase 13's numbers."""
    tag = f"[{gpu}] simulation:"
    spec = sim["spec"]
    print(f"{tag} {SIM_INSTANCES} x {spec.name} on the H100 profile "
          f"(peak {spec.peak_flops:.4g} FLOP/s, HBM {spec.hbm_bw:.4g} B/s, "
          f"mfu {spec.mfu}, step overhead {spec.step_overhead} s, chunk "
          f"{spec.chunk_tokens}); KV$ per instance {sim['kv']} tokens = "
          f"{sim['how']}; arrivals rounded to {SIM_TICK * 1e3:.0f} ms; "
          f"times are simulated; SLO per family (core/types.py)")
    for r in sim["runs"]:
        print(f"{tag} {_sim_line(r)}")
    new = sim["new_runs"]
    print(f"{tag} comparison runs ({len(new)}: the paper's comparison "
          f"policies, the hotspot detector, the cost indicator and "
          f"session affinity), {new[0]['summary']['n']} requests each:")
    for r in new:
        print(f"{tag} {_sim_line(r)}")
    every = sim["runs"] + new
    for family in SIM_TRACES:
        rows = {r["policy"]: r for r in every if r["family"] == family
                and r["policy"] in SIM_POLICIES}
        lm = rows["lmetric"]["summary"]
        vs = ", ".join(
            f"{p} {rows[p]['summary']['ttft_mean'] * 1e3:.2f} ms "
            f"({(lm['ttft_mean'] / rows[p]['summary']['ttft_mean'] - 1):+.1%}"
            f", {rows[p]['summary']['n']} requests)"
            for p in SIM_POLICIES if p != "lmetric")
        print(f"{tag} Fig. 22, {family}: lmetric TTFT mean "
              f"{lm['ttft_mean'] * 1e3:.2f} ms ({lm['n']} requests) "
              f"against {vs}")
    for r in new:
        x = r["extra"]
        if "activations" in x:
            print(f"{tag} Fig. {21 if r['family'] == 'hotspot' else 20}, "
                  f"{r['family']}: Eq. 2 checks {x['checks']}, violations "
                  f"{x['violations']}, activations {x['activations']}")
    hot = {r["policy"]: r["summary"] for r in new
           if r["family"] == "hotspot"}
    print(f"{tag} Fig. 21, hotspot: " + "; ".join(
        f"{p} TTFT mean {s['ttft_mean'] * 1e3:.2f} ms p95 "
        f"{s['ttft_p95'] * 1e3:.2f}, TPOT p99 {s['tpot_p99'] * 1e3:.3f} ms"
        for p, s in hot.items()))
    print(f"{tag} host wall of the comparison runs {sim['new_wall']:.2f} s "
          f"(of {sim['wall']:.2f} s for the phase's runs)")
    if wave is not None:
        k = wave["k"]
        print(f"{tag} one wave's score stage (lmetric chatbot router after "
              f"its run, its largest wave: k={k}, n={wave['n']}): "
              f"{wave['stage_ms'] * 1e3:.1f} us (median of 50) = mirror "
              f"upload {wave['mirror_ms'] * 1e3:.1f} + submit (pack, one "
              f"pinned upload, launch, one copy back) "
              f"{wave['submit_ms'] * 1e3:.1f} + collect (wait, copy out) "
              f"{wave['collect_ms'] * 1e3:.1f} us (medians); the kernel "
              f"{wave['cold_ms'] * 1e3:.2f} us device cold (after an L2 "
              f"flush), {wave['device_ms'] * 1e3:.2f} warm (profiler), "
              f"{wave['cold_ms'] * 1e3 / k:.3f} / "
              f"{wave['device_ms'] * 1e3 / k:.3f} us per step, "
              f"{wave['events_ms'] * 1e3:.2f} us per launch in CUDA events; "
              f"plain version {wave['plain_ms'] * 1e3:.1f} us; bound "
              f"{wave['bound_ms'] * 1e3:.4f} us")
    served = {"prefill": f"phase 6 median wall of a {CHUNK}-token chunk "
                         f"not ending its prompt",
              "decode": f"phase 6 median wall of a decode step (median "
                        f"batch {steps['decode_bs'] if steps else 0:.0f})"}
    shapes = {"prefill": f"{CHUNK}-token chunk over {SYS_PREFIX} cached",
              "decode": f"{MAX_BATCH} slots at position ~2000"}
    for name, shape in shapes.items() if steps else ():
        t = steps[name]
        print(f"{tag} step time, {name} ({shape}): H100 profile predicts "
              f"{t['predicted']:.3f} ms; Qwen2-7B on the card: "
              f"{served[name]} {t['served']:.3f} ms ({steps['layers']} "
              f"layers); the step alone {t['wall']:.3f} ms wall, "
              f"{t['device']:.3f} ms device ({steps['alone_layers']} "
              f"layers)")


# ---------------------------------------------------------------------------
# sharded routing (phase 14): the sharded prefix index on its serial,
# thread and process shard backends, the pipeline's cross-wave walk
# speculation, fault injection and anti-entropy
# ---------------------------------------------------------------------------
#: phase 14's (walk backend, shards) runs of the main path
SHARD_RUNS = (("serial", 8), ("thread", 8), ("process", 4), ("process", 8))
#: the fault runs: 8 process shards, one shard digest-verified per wave,
#: a seeded plan of crashes and stalls (stalls well under the deadline)
FAULT_SHARDS, FAULT_SEED = 8, 2027
FAULT_CRASHES, FAULT_STALLS, FAULT_STALL_S = 2, 2, 0.05
#: the simulator's sharded router (thread backend, speculating)
SIM_SHARDS = 4
#: past this point phase 14 routes SHARD_CUT_REQUESTS requests (never
#: fewer instances); a run at the usual pace reaches phase 14 at ~370 s
#: on an H100, so only a run ~15% slower is cut, before the later phases
#: could push it past the time limit
SHARD_CUT_AFTER_S, SHARD_CUT_REQUESTS = 420.0, 512
#: the mirror's dirty-range sets timed by ``time_mirror`` (8 ranges)
MIRROR_SETS = {"1 range": (0,), "4 adjacent": (0, 1, 2, 3),
               "4 apart": (0, 2, 4, 6), "all 8": tuple(range(8))}


def _own_segments():
    """This process's live shared-memory segments: every process backend
    names its segments ``rps<pid>_...``."""
    from repro_torch.core.shard_backends import own_segments
    return own_segments(f"rps{os.getpid():x}_")


def _shard_workers():
    import multiprocessing as mp
    return [p for p in mp.active_children()
            if p.name.startswith("prefix-shard")]


def sharded_router(name, n, state, device, **kw):
    """A router over ``n`` instances carrying phase 3's backlog
    ``state``, built as phase 3 builds its own, with router options."""
    from repro_torch.core import make_policy, router_from_numpy_state
    arrays, chains = state
    return router_from_numpy_state(
        make_policy(name), n, arrays, chains, tie=0,
        kv_capacity_tokens=KV_CAPACITY, block_size=BLOCK, device=device,
        **kw)


def _same(name, what, dec, hits, want):
    if dec != want["decisions"]:
        j = next(i for i, (a, b) in enumerate(zip(dec, want["decisions"]))
                 if a != b)
        raise AssertionError(f"{what} {name}: decisions diverge from phase "
                             f"3's at request {j}")
    if hits != want["hits"]:
        raise AssertionError(f"{what} {name}: hit tokens differ from "
                             f"phase 3's")


def sharded_path(n, n_req, device, trace, want, runs=SHARD_RUNS):
    """Phase 14a: phase 3's backlog and trace over each (backend,
    shards) of ``runs``: route_batch under lmetric and vllm with the next
    wave as the speculation hint (the thread and process backends
    speculate), and sequential ``route()`` under lmetric; decisions and
    hit tokens must equal phase 3's (``want``), and each route_batch run
    launch ``route_score`` once per wave (none on the CPU)."""
    from repro_torch.kernels import route_score as rs
    reqs = trace[:n_req]
    state = backlog(trace, n)
    waves = -(-n_req // WAVE)
    out = []
    for backend, shards in runs:
        for name in ("lmetric", "vllm"):
            rec = {"backend": backend, "shards": shards, "policy": name}
            for use_batch in (True, False) if name == "lmetric" else (True,):
                t0 = time.perf_counter()
                router = sharded_router(name, n, state, device,
                                        n_shards=shards,
                                        walk_backend=backend)
                build = time.perf_counter() - t0
                try:
                    be = router.factory._agg.backend
                    rs.LAUNCHES = 0
                    dec, hits, ns = drive(router, copy.deepcopy(reqs),
                                          use_batch, hint=use_batch)
                    launches = rs.LAUNCHES
                    what = (f"{backend} x {shards} "
                            f"{'route_batch' if use_batch else 'route()'}")
                    _same(name, what, dec, hits, want[name])
                    us = ns / len(reqs) / 1e3
                    if not use_batch:
                        rec["route_us"] = us
                        continue
                    if router.factory.evictions:
                        raise AssertionError(f"{what}: evictions fired")
                    if (router.pipeline.waves != waves or launches
                            != (waves if device != "cpu" else 0)):
                        raise AssertionError(
                            f"{what} {name}: {launches} route_score "
                            f"launches, {router.pipeline.waves} device "
                            f"waves, for {waves} waves")
                    tel = router.walk_telemetry()
                    rec.update(
                        batch_us=us, launches=launches, waves=waves,
                        build_s=build, stages=tel["pipeline"],
                        max_shard_us=tel["max_shard_us"],
                        shard_us=[s["mean_walk_us"] for s in tel["shards"]],
                        uploads=int(router.factory.mirror_uploads.sum()),
                        spawn_s=getattr(be, "spawn_s", None),
                        spawn_deadline=getattr(be, "spawn_deadline", None))
                finally:
                    router.close()
                    # a router over N_INST instances is millions of host
                    # objects in reference cycles: free it before the next
                    del router
                    gc.collect()
            out.append(rec)
    return out


def fault_path(n, n_req, device, trace, want):
    """Phase 14b (Contract 6): lmetric over FAULT_SHARDS process shards
    with ``anti_entropy_k=1``, first under a seeded plan of crashes and
    stalls — decisions and hits must equal phase 3's — then under one
    ``corrupt`` event, which the sweep must repair (``shard_repairs`` >=
    1, every ``verify_shard`` true after the run).  Neither run may tear
    the backend down or rebuild the index, and every event must fire."""
    from repro_torch.core.faults import FaultEvent, FaultInjector, FaultPlan
    from repro_torch.kernels import route_score as rs
    reqs = trace[:n_req]
    state = backlog(trace, n)
    waves = -(-n_req // WAVE)
    plans = {
        "crashes and stalls": FaultPlan.seeded(
            FAULT_SEED, FAULT_SHARDS, max(waves - 2, 1),
            crashes=FAULT_CRASHES, stalls=FAULT_STALLS,
            stall_s=FAULT_STALL_S),
        "one corrupt bit": FaultPlan(events=(FaultEvent(
            "corrupt", shard=3, at=min(2, waves - 1), seed=FAULT_SEED),))}
    out = []
    for what, plan in plans.items():
        router = sharded_router("lmetric", n, state, device,
                                n_shards=FAULT_SHARDS,
                                walk_backend="process", anti_entropy_k=1)
        try:
            f = router.factory
            agg0 = f._agg
            be = agg0.backend
            inj = FaultInjector(plan)
            f.attach_faults(inj)
            rs.LAUNCHES = 0
            t0 = time.perf_counter()
            dec, hits, ns = drive(router, copy.deepcopy(reqs), True,
                                  hint=True)
            wall = time.perf_counter() - t0
            launches = rs.LAUNCHES
            if (f._agg is not agg0 or be._closed or f.degraded_rebuilds
                    or inj.pending):
                raise AssertionError(
                    f"fault run ({what}): index replaced or backend torn "
                    f"down ({f.degraded_rebuilds} rebuilds), or "
                    f"{inj.pending} events never fired")
            if launches != (waves if device != "cpu" else 0):
                raise AssertionError(f"fault run ({what}): {launches} "
                                     f"launches for {waves} waves")
            same = dec == want["lmetric"]["decisions"] and \
                hits == want["lmetric"]["hits"]
            if plan is plans["crashes and stalls"]:
                _same("lmetric", f"fault run ({what})", dec, hits,
                      want["lmetric"])
                if be.heals < FAULT_CRASHES:
                    raise AssertionError(f"{be.heals} heals for "
                                         f"{FAULT_CRASHES} crashes")
            else:
                ok = [f.verify_shard(s) for s in range(FAULT_SHARDS)]
                if f.shard_repairs < 1 or not all(ok):
                    raise AssertionError(
                        f"fault run ({what}): {f.shard_repairs} repairs, "
                        f"verify_shard {ok}")
            st = router.stage_stats()
            out.append({
                "what": what, "fired": inj.stats(), "same": same,
                "heals": be.heals, "timeouts": be.timeouts,
                "escalations": be.escalations,
                "heal_ms": [t / 1e6 for t in be.repair_ns],
                "repairs": f.shard_repairs,
                "mismatches": f.verify_mismatches,
                "repair_ms": [t / 1e6 for t in f.repair_ns],
                "batch_us": ns / len(reqs) / 1e3, "wall": wall,
                "stages": st, "launches": launches})
        finally:
            router.close()
            del router
            gc.collect()
    return out


def sim_speculation(device, sim):
    """Phase 14c: phase 13's chatbot trace under lmetric on a
    ``ClusterSim`` whose router walks SIM_SHARDS shards on the thread
    backend (speculating on the simulator's heap peek): the finished
    tuples must equal phase 13's flat run, with speculative walks
    consumed and one launch per wave of two or more."""
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.core import Router, make_policy
    from repro_torch.kernels import route_score as rs
    trace, multi, want = sim["flat_chatbot"]
    rs.LAUNCHES = 0
    t0 = time.perf_counter()
    with Router(make_policy("lmetric"), SIM_INSTANCES,
                kv_capacity_tokens=sim["kv"], n_shards=SIM_SHARDS,
                walk_backend="thread", device=device) as router:
        cs = ClusterSim(router, sim["spec"])
        # how often the reference's hint, the heap-top peek, would have
        # named a wave of two or more at the same moments
        peeks = []

        def hint():
            w = cs._peek_next_wave()
            peeks.append(bool(w and len(w) > 1))
            return cs._next_arrival_wave()
        router.pipeline.next_wave_hint = hint
        done = cs.run(copy.deepcopy(trace))
        st = router.stage_stats()
    wall = time.perf_counter() - t0
    launches = rs.LAUNCHES
    if _finished(done) != want:
        raise AssertionError("ClusterSim on a sharded speculating router "
                             "!= phase 13's flat run")
    if st["waves"] != multi or launches != (multi if device != "cpu"
                                            else 0):
        raise AssertionError(f"sharded ClusterSim: {st['waves']} waves, "
                             f"{launches} launches for {multi} waves")
    if not st["prefetch_hits"]:
        raise AssertionError("sharded ClusterSim: no speculative walk was "
                             "consumed")
    return {"stages": st, "wall": wall, "launches": launches,
            "waves": multi, "requests": len(done), "hints": len(peeks),
            "peek_waves": sum(peeks)}


def time_mirror(torch, state, reps=30):
    """The device mirror's re-upload of dirty ranges at N_INST instances
    in 8 ranges (MIRROR_SETS) on the same columns, each checked against
    the numpy source: the factory's ``device_view`` (dirty flags, run
    coalescing and its event included), and three spellings of the
    copies alone — the factory's (a run packed contiguously in pinned
    memory, one upload, one device-to-device copy into the mirror's
    rows; one upload for the whole mirror), one copy per row of a run
    from a pinned ``(4, n)`` staging buffer, and one strided copy per
    run from it.  Median host µs of the call and µs until the copies are
    done."""
    from repro_torch.core import IndicatorFactory
    f = IndicatorFactory(N_INST, n_shards=8, exact_only=True,
                         device="cuda")
    arrays, _ = state
    for name in ("r_bs", "q_bs", "queued_prefill_tokens", "total_tokens"):
        getattr(f, name)[:] = arrays[name]
    f.mark_dirty()
    f.device_view()
    cols = np.stack((f.r_bs, f.q_bs, f.queued_prefill_tokens,
                     f.total_tokens))
    dev = f.device
    n = f.n
    stage = torch.empty((4, n), dtype=torch.int64, pin_memory=True)
    packed = torch.empty(4 * n, dtype=torch.int64, pin_memory=True)
    tmp = torch.empty(4 * n, dtype=torch.int64, device=dev)
    mirror = torch.zeros((4, n), dtype=torch.int64, device=dev)
    host, phost = stage.numpy(), packed.numpy()
    out = {}
    for label, shards in MIRROR_SETS.items():
        runs = []
        for s in shards:
            lo, hi = f._mirror_bounds[s]
            if runs and runs[-1][1] == lo:
                runs[-1][1] = hi
            else:
                runs.append([lo, hi])

        def factory():
            for s in shards:
                f.mark_dirty(f._mirror_bounds[s][0])
            f.device_view()

        def packed_runs():
            for lo, hi in runs:
                w = hi - lo
                phost[4 * lo:4 * hi].reshape(4, w)[...] = cols[:, lo:hi]
                if w == n:
                    mirror.view(-1).copy_(packed, non_blocking=True)
                    continue
                tmp[4 * lo:4 * hi].copy_(packed[4 * lo:4 * hi],
                                         non_blocking=True)
                mirror[:, lo:hi].copy_(tmp[4 * lo:4 * hi].view(4, w))

        def rows():
            for lo, hi in runs:
                host[:, lo:hi] = cols[:, lo:hi]
                for r in range(4):
                    mirror[r, lo:hi].copy_(stage[r, lo:hi],
                                           non_blocking=True)

        def strided():
            for lo, hi in runs:
                host[:, lo:hi] = cols[:, lo:hi]
                mirror[:, lo:hi].copy_(stage[:, lo:hi], non_blocking=True)

        res = {}
        for way, fn in (("factory", factory), ("packed", packed_runs),
                        ("rows", rows), ("strided", strided)):
            got = f._mirror if way == "factory" else mirror
            got.zero_()
            fn()
            torch.cuda.synchronize()
            for lo, hi in runs:
                if not np.array_equal(got[:, lo:hi].cpu().numpy(),
                                      cols[:, lo:hi]):
                    raise AssertionError(f"mirror upload ({way}, {label})"
                                         f" != the numpy columns")
            host_s, done_s = [], []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                host_s.append(t1 - t0)
                done_s.append(time.perf_counter() - t0)
            res[way] = (float(np.median(host_s)) * 1e6,
                        float(np.median(done_s)) * 1e6)
        out[label] = {"runs": len(runs), **res}
    return out


def shard_phase(device, n, n_req, trace, want, sim=None):
    """Phase 14: (a) ``sharded_path``, (b) ``fault_path``, (c)
    ``sim_speculation`` when phase 13's ``sim`` is given, (d) none of this
    process's shared-memory segments and no shard worker left.  ``want``
    holds phase 3's decisions and hit tokens per policy."""
    out = {"sharded": sharded_path(n, n_req, device, trace, want),
           "faults": fault_path(n, n_req, device, trace, want)}
    if sim is not None:
        out["sim"] = sim_speculation(device, sim)
    segs, workers = _own_segments(), _shard_workers()
    if segs or workers:
        raise AssertionError(f"phase 14 left segments {segs} and shard "
                             f"workers {workers}")
    out["launches"] = (sum(r.get("launches", 0) for r in out["sharded"])
                       + sum(r["launches"] for r in out["faults"])
                       + (out["sim"]["launches"] if sim is not None else 0))
    return out


def report_shards(gpu, ph, mirror=None):
    """Print phase 14's numbers."""
    tag = f"[{gpu}] sharded routing:"
    for r in ph["sharded"]:
        st = r["stages"]
        spawn = ("" if r["spawn_s"] is None else
                 f" | workers spawned in {r['spawn_s']:.2f} s (spawn "
                 f"deadline {r['spawn_deadline']:.1f} s)")
        seq = (f", sequential route() {r['route_us']:.2f} us/decision"
               if "route_us" in r else "")
        print(f"{tag} {r['backend']} x {r['shards']} shards, {r['policy']}:"
              f" route_batch {r['batch_us']:.2f} us/decision{seq} | per "
              f"wave: walk {st['walk_us']:.1f} us, score "
              f"{st['score_us']:.1f} us (submit {st['submit_us']:.1f}), "
              f"commit {st['commit_us']:.1f} us over {st['waves']} waves | "
              f"max_shard_us {r['max_shard_us']:.2f}, per shard "
              f"{[round(x, 2) for x in r['shard_us']]} us per walk | "
              f"prefetches {st['prefetches']}, prefetch_hits "
              f"{st['prefetch_hits']}, overlap_fraction "
              f"{st['overlap_fraction']:.3f} | route_score launches "
              f"{r['launches']} for {r['waves']} waves | mirror range "
              f"uploads {r['uploads']} | router built in "
              f"{r['build_s']:.1f} s{spawn} | == phase 3")
    for r in ph["faults"]:
        st = r["stages"]
        print(f"{tag} faults ({r['what']}), lmetric, process x "
              f"{FAULT_SHARDS}, anti_entropy_k=1: fired {r['fired']} | "
              f"heals {r['heals']} (backend heal and repair times "
              f"{', '.join(f'{t:.0f}' for t in r['heal_ms'])} ms), timeouts {r['timeouts']}, escalations "
              f"{r['escalations']} | sweep: {r['mismatches']} mismatches, "
              f"{r['repairs']} repairs ({', '.join(f'{t:.0f}' for t in r['repair_ms'])}"
              f" ms) | route_batch {r['batch_us']:.2f} us/decision, walk "
              f"{st['walk_us']:.1f} us/wave, prefetch_hits "
              f"{st['prefetch_hits']} of {st['prefetches']} | "
              f"{r['wall']:.1f} s | decisions == phase 3: {r['same']} | "
              f"no teardown, no index rebuild")
    if "sim" in ph:
        s = ph["sim"]
        st = s["stages"]
        print(f"{tag} ClusterSim chatbot lmetric on {SIM_SHARDS} thread "
              f"shards: {s['requests']} finished == phase 13's flat run; "
              f"prefetches {st['prefetches']}, prefetch_hits "
              f"{st['prefetch_hits']}, overlap_fraction "
              f"{st['overlap_fraction']:.3f} (the heap-top peek would have "
              f"named {s['peek_waves']} waves of >= 2 at the "
              f"{s['hints']} hints); route_score launches "
              f"{s['launches']} for {s['waves']} waves; per wave walk "
              f"{st['walk_us']:.1f} us, score {st['score_us']:.1f} us; "
              f"host wall {s['wall']:.2f} s")
    for label, m in (mirror or {}).items():
        print(f"{tag} mirror re-upload at {N_INST} instances, {label} "
              f"dirty ({m['runs']} run(s)), median host us / us until "
              f"done: device_view {m['factory'][0]:.1f} / "
              f"{m['factory'][1]:.1f}; its copies alone (a packed upload "
              f"and a device copy per run, one upload for the whole "
              f"mirror) {m['packed'][0]:.1f} / {m['packed'][1]:.1f}; one "
              f"copy per row of a run {m['rows'][0]:.1f} / "
              f"{m['rows'][1]:.1f}; one strided copy per run "
              f"{m['strided'][0]:.1f} / {m['strided'][1]:.1f}")
    print(f"{tag} no segment of this process left in /dev/shm, no "
          f"prefix-shard worker alive")


def rehearse_shards(n=256, n_req=256):
    """Phase 14 on the CPU at a small size (plain versions, no launches):
    phase 3's flat runs, then (a), (b) and (d)."""
    results, trace = main_path(n, n_req, "cpu")
    want = {k: {"decisions": v["decisions"], "hits": v["hits"]}
            for k, v in results.items()}
    ph = shard_phase("cpu", n, n_req, trace, want)
    report_shards("cpu rehearsal", ph)
    return ph


# ---------------------------------------------------------------------------
# the control plane (phase 15): observability, instance churn, overload
# control, heterogeneous fleets and the closed loop, through ClusterSim on
# phase 13's H100 profile
# ---------------------------------------------------------------------------
#: the churn schedule of phase 15's chatbot run: (event, time s, instance)
CHURN = (("fail", 10.0, 3), ("recover", 25.0, 3), ("drain", 30.0, 11),
         ("recover", 40.0, 11))
#: the overload run: the agent trace at this multiple of its estimated
#: capacity (phase 13 runs it at SIM_LOAD)
OVERLOAD_MULT = 2.0
#: obs off / on walls: best of this many runs each, interleaved; the
#: reference's budget for the enabled bundle (printed, not gated)
OBS_REPS, OBS_BUDGET = 3, 1.05
#: requests of each of the two runs whose trace JSON must be identical
OBS_TRACE_REQUESTS = 500
#: the closed loop (``bench_overload``'s scenario): sessions per family,
#: each family's share of the offered load, the share of capacity at
#: mult 1, the session seed, the start-rate multipliers, and the mult-20
#: controlled run's failure (fail time, recover time, instance)
CL_MIX = {"chatbot": 80, "agent": 60, "coder": 60}
CL_SHARES = {"chatbot": 0.4, "agent": 0.3, "coder": 0.3}
CL_BASE, CL_SEED, CL_MULTS = 0.75, 11, (1.0, 20.0)
CL_FAIL = (20.0, 110.0, 3)
CL_PD_SESSIONS = 100
#: past this point phase 15 runs CL_CUT of the closed loop's sessions
#: (never fewer requests in the open-loop runs, never fewer instances);
#: reached at ~555 s at the usual pace on an H100
CL_CUT_AFTER_S, CL_CUT = 630.0, 0.5


class WaveLedger:
    """Wraps a router's ``route_batch``: per call, the wave's size,
    whether every instance was live, whether the device plan takes it
    (the router's own test: two or more requests, the policy's
    ``batch_supported``, no capability requirement on a fleet) and the
    ``route_score`` launches it made."""

    def __init__(self, router, rs):
        self.calls = []
        inner = router.route_batch

        def route_batch(reqs, now):
            f = router.factory
            planned = (len(reqs) > 1 and router.insert_on_route
                       and router.policy.batch_supported(f)
                       and not (f.fleet is not None
                                and any(r.model_requirement
                                        for r in reqs)))
            live = router.policy.alive is None
            n0 = rs.LAUNCHES
            out = inner(reqs, now)
            self.calls.append((len(reqs), live, planned, rs.LAUNCHES - n0))
            return out
        router.route_batch = route_batch

    def launches(self):
        return sum(c[3] for c in self.calls)

    def planned(self):
        """Waves of two or more the device plan took, all instances
        live (the policy's ``batch_supported`` is False otherwise)."""
        return sum(1 for k, live, p, _ in self.calls if k > 1 and live and p)

    def down(self):
        """(waves of two or more routed while an instance was out, the
        launches they made)."""
        return (sum(1 for k, live, _, _ in self.calls if k > 1 and not live),
                sum(d for _, live, _, d in self.calls if not live))


def _index_equals_rebuild(factory):
    """The live aggregated index against a flat rebuild from the
    per-instance radix trees, on every stored chain (up to 4 per
    instance) and seeded misses."""
    from repro_torch.core.prefix_index import AggregatedPrefixIndex
    fresh = AggregatedPrefixIndex(factory.n)
    probes = []
    for inst in factory.instances:
        chains = list(inst.kv.chains())
        for chain in chains:
            fresh.add(inst.iid, chain)
        probes += [tuple(c) for c in chains[:4]]
    rng = np.random.default_rng(SEED)
    probes += [tuple(int(x) for x in rng.integers(1, 4000, size=6))
               for _ in range(16)]
    return bool(np.array_equal(fresh.match_depths_many(probes),
                               factory._agg.match_depths_many(probes))), \
        len(probes)


def control_path(sim13, device="cuda", cl_cut=1.0):
    """Phase 15, on phase 13's profile, KV$ and chatbot trace (``sim13``
    is ``sim_path``'s result):

    * obs: the lmetric chatbot run with every obs component on equals
      phase 13's run (tuples, launches), has a provenance record per
      request and a valid trace; two runs of OBS_TRACE_REQUESTS give
      byte-identical trace JSON; the host wall off and on, best of
      OBS_REPS each;
    * churn: the same run under CHURN: every request finishes, none is
      scheduled on an instance while it is out, launches equal the waves
      of two or more routed while every instance was live (none while
      one is out), the tuples equal the CPU run's, and the index equals
      a rebuild from the radix trees afterwards;
    * overload: the agent trace at OVERLOAD_MULT x capacity with
      admission and retraction (== its CPU run) and without;
    * fleet: ``make_mixed_fleet()`` under the hetero lmetric score and
      route-then-balance (host-only: no launch; no infeasible route),
      every fourth request requiring "qwen2_7b"; a homogeneous fleet of
      phase 13's spec equals phase 13's lmetric run, launches included;
    * closed loop: ``make_mixed_sessions(CL_MIX)`` at each of CL_MULTS,
      no control and admission + retraction (mult 20 with CL_FAIL too,
      == its CPU run), and ``ClosedLoopPDSim`` with CL_PD_SESSIONS
      chatbot sessions.

    ``device="cpu"`` rehearses the phase (no launch is counted there).
    Returns the numbers to print."""
    from repro_torch.cluster.closed_loop import ClosedLoopPDSim, \
        ClosedLoopSim
    from repro_torch.cluster.metrics import (hardware_class_summary,
                                             overload_summary, summarize)
    from repro_torch.cluster.simulator import ClusterSim, make_mixed_fleet
    from repro_torch.core import (LatencyModel, OverloadControl, Router,
                                  homogeneous_fleet, make_policy)
    from repro_torch.kernels import route_score as rs
    from repro_torch.obs import make_obs, validate_events
    from repro_torch.workloads.sessions import (SESSIONS,
                                                make_mixed_sessions,
                                                session_stats)
    from repro_torch.workloads.traces import (estimate_capacity_qps,
                                              make_trace)
    t_phase = time.perf_counter()
    spec, kv = sim13["spec"], sim13["kv"]
    chat, chat_waves, chat_fin = sim13["flat_chatbot"]
    on_card = device != "cpu"

    def run(dev, policy="lmetric", trace=None, sessions=None, obs=None,
            overload=None, churn=(), fleet=None):
        """One ``ClusterSim`` run of ``trace`` (``ClosedLoopSim`` of
        ``sessions``); checks its launches and returns its record."""
        rs.LAUNCHES = 0
        t0 = time.perf_counter()
        router = Router(make_policy(policy), SIM_INSTANCES,
                        kv_capacity_tokens=kv, fleet=fleet, obs=obs,
                        device=dev)
        ledger = WaveLedger(router, rs)
        cls = ClusterSim if sessions is None else ClosedLoopSim
        sim = cls(router, spec, LatencyModel(spec), overload=overload)
        for kind, t, iid in churn:
            getattr(sim, f"{kind}_at")(t, iid)
        done = (sim.run(copy.deepcopy(trace)) if sessions is None
                else sim.run_sessions(sessions))
        wall = time.perf_counter() - t0
        launches = rs.LAUNCHES
        want = ledger.planned() if dev != "cpu" else 0
        if launches != want or ledger.launches() != launches:
            raise AssertionError(f"{policy}: route_score launched "
                                 f"{launches} times for {want} waves of "
                                 f"two or more the device plan took")
        down_waves, down_launches = ledger.down()
        if down_launches:
            raise AssertionError(f"{down_launches} launches while an "
                                 f"instance was out")
        router.close()
        return {"sim": sim, "done": done, "wall": wall,
                "launches": launches, "planned": ledger.planned(),
                "down_waves": down_waves, "router": router}

    out = {"launches": 0, "checks": []}

    def check(ok, what):
        if not ok:
            raise AssertionError(f"control plane: {what}")
        out["checks"].append(what)

    # ---- obs ---------------------------------------------------------
    full = make_obs(metrics=True, trace=True, provenance=True)
    r = run(device, trace=chat, obs=full)
    out["launches"] += r["launches"]
    check(_finished(r["done"]) == chat_fin,
          "obs on: tuples == phase 13's lmetric chatbot run")
    check(r["launches"] == (chat_waves if on_card else 0),
          f"obs on: {r['launches']} launches == phase 13's")
    recs = full.provenance.records
    check(len(recs) == len(chat) and {x["outcome"] for x in recs}
          == {"finished"}, f"{len(recs)} provenance records, all finished")
    events = full.tracer.to_json()["traceEvents"]
    validate_events(events)
    check(True, f"validate_events passes ({len(events)} events)")
    snap = r["sim"].metrics_snapshot()
    out["obs"] = {
        "hists": {k: v for k, v in snap["hists"].items()
                  if k.startswith("pipeline.")},
        "provenance": full.provenance.summary(), "events": len(events),
        "records": len(recs), "launches": r["launches"]}
    docs = []
    for _ in range(2):
        o = make_obs(metrics=True, trace=True, provenance=True)
        rr = run(device, trace=chat[:OBS_TRACE_REQUESTS], obs=o)
        out["launches"] += rr["launches"]
        docs.append(json.dumps(o.tracer.to_json(), sort_keys=True))
    check(docs[0] == docs[1], f"two runs of {OBS_TRACE_REQUESTS} requests: "
          f"byte-identical trace JSON ({len(docs[0])} bytes)")
    walls = {"off": [], "on": []}
    for _ in range(OBS_REPS):
        for mode in ("off", "on"):
            o = (make_obs(metrics=True, trace=True, provenance=True)
                 if mode == "on" else None)
            rr = run(device, trace=chat, obs=o)
            out["launches"] += rr["launches"]
            walls[mode].append(rr["wall"])
            check(_finished(rr["done"]) == chat_fin,
                  f"obs {mode} timing run == phase 13's")
    out["obs"]["walls"] = walls
    out["obs"]["ratio"] = min(walls["on"]) / min(walls["off"])

    # ---- churn -------------------------------------------------------
    r = run(device, trace=chat, churn=CHURN)
    out["launches"] += r["launches"]
    sim, done = r["sim"], r["done"]
    check(len(done) == len(chat), f"churn: {len(done)} of {len(chat)} "
          f"requests finished")
    out_at = {}
    for kind, t, iid in CHURN:
        if kind != "recover":
            out_at[iid] = t
        else:
            t0 = out_at.pop(iid)
            bad = [q.rid for q in done if t0 <= q.t_sched < t
                   and q.sched_to == iid]
            check(not bad, f"churn: nothing scheduled on instance {iid} "
                  f"in [{t0}, {t})")
    check(r["down_waves"] > 0, f"churn: {r['down_waves']} waves of >= 2 "
          f"routed on the host while an instance was out, 0 launches")
    check(r["launches"] == (r["planned"] if on_card else 0),
          f"churn: {r['launches']} launches == waves of >= 2 routed with "
          f"all {SIM_INSTANCES} live")
    same, n_probes = _index_equals_rebuild(r["router"].factory)
    check(same, f"churn: the aggregated index == a rebuild from the radix "
          f"trees ({n_probes} probes)")
    if on_card:
        cpu = run("cpu", trace=chat, churn=CHURN)
        check(_finished(cpu["done"]) == _finished(done),
              "churn: the card's run == the CPU's")
    out["churn"] = {"summary": summarize(done, per_family_slo=True),
                    "overload": overload_summary(done, sim.dropped,
                                                 sim.churn_recovery),
                    "events": sim.churn_events,
                    "stats": sim.overload_stats(),
                    "launches": r["launches"], "planned": r["planned"],
                    "down_waves": r["down_waves"], "wall": r["wall"]}

    # ---- overload ----------------------------------------------------
    probe = make_trace("agent", qps=20.0, duration=300.0, seed=SIM_SEED)
    cap = estimate_capacity_qps(spec, probe, SIM_INSTANCES)
    qps = OVERLOAD_MULT * cap
    agent = make_trace("agent", qps=qps, duration=SIM_REQUESTS / qps,
                       seed=SIM_SEED)
    dur = SIM_REQUESTS / qps
    while len(agent) < SIM_REQUESTS:
        dur *= 1.5
        agent = make_trace("agent", qps=qps, duration=dur, seed=SIM_SEED)
    agent = _on_tick(agent[:SIM_REQUESTS])
    out["overload"] = {"qps": qps, "cap": cap, "runs": {}}
    for name, ctl in (("none", None),
                      ("admission+retraction",
                       OverloadControl(admission=True, retraction=True))):
        r = run(device, trace=agent, overload=ctl)
        out["launches"] += r["launches"]
        sim, done = r["sim"], r["done"]
        check(len(done) + len(sim.dropped) == len(agent),
              f"overload {name}: every request finished or dropped")
        if ctl is not None and on_card:
            cpu = run("cpu", trace=agent, overload=ctl)
            check(_finished(cpu["done"]) == _finished(done)
                  and [(q.rid, q.drop_reason) for q in cpu["sim"].dropped]
                  == [(q.rid, q.drop_reason) for q in sim.dropped],
                  f"overload {name}: the card's run == the CPU's")
        out["overload"]["runs"][name] = {
            "summary": summarize(done, per_family_slo=True),
            "overload": overload_summary(done, sim.dropped),
            "stats": sim.overload_stats(), "launches": r["launches"],
            "planned": r["planned"], "wall": r["wall"]}

    # ---- fleets ------------------------------------------------------
    mixed = copy.deepcopy(chat)
    for i, q in enumerate(mixed):
        if i % 4 == 0:
            q.model_requirement = "qwen2_7b"
    fleet = make_mixed_fleet(kv_capacity_tokens=kv)
    out["fleet"] = {"runs": {}, "norm": fleet.prefill_norm.tolist()}
    for policy in ("lmetric", "route-then-balance"):
        r = run(device, policy=policy, trace=mixed, fleet=fleet)
        done, sim = r["done"], r["sim"]
        check(r["launches"] == 0, f"fleet {policy}: host-only, 0 launches")
        bad = [q.rid for q in done if q.model_requirement
               and fleet.model_of(q.sched_to) != q.model_requirement]
        check(not bad and len(done) + len(sim.dropped) == len(mixed),
              f"fleet {policy}: no infeasible route, every request "
              f"finished or shed")
        out["fleet"]["runs"][policy] = {
            "classes": hardware_class_summary(done, fleet),
            "summary": summarize(done, per_family_slo=True),
            "shed": len(sim.dropped), "wall": r["wall"]}
    homo = homogeneous_fleet("qwen2_7b", "h100", SIM_INSTANCES,
                             kv_capacity_tokens=kv)
    check(homo.specs[0] == spec and homo.norm_or_none() is None,
          "homogeneous fleet: each spec == phase 13's, the norm collapses")
    r = run(device, trace=chat, fleet=homo)
    out["launches"] += r["launches"]
    check(_finished(r["done"]) == chat_fin and r["launches"]
          == (chat_waves if on_card else 0),
          f"homogeneous fleet == phase 13's lmetric chatbot run, "
          f"{r['launches']} launches")
    out["fleet"]["homogeneous"] = {"launches": r["launches"],
                                   "wall": r["wall"]}

    # ---- the closed loop ---------------------------------------------
    caps = {f: sim_qps(f, spec) / SIM_LOAD for f in CL_MIX}
    mix = {f: max(1, int(n * cl_cut)) for f, n in CL_MIX.items()}
    out["closed"] = {"runs": [], "caps": caps, "mix": mix}

    def sessions(mult):
        rates = {f: mult * CL_BASE * CL_SHARES[f] * caps[f]
                 / SESSIONS[f].expected_requests() for f in mix}
        return make_mixed_sessions(mix, seed=CL_SEED, start_rates=rates)

    for mult in CL_MULTS:
        for name, ctl in (("none", None),
                          ("admission+retraction",
                           OverloadControl(admission=True,
                                           retraction=True))):
            churn = ()
            if mult == CL_MULTS[-1] and ctl is not None:
                t_fail, t_back, iid = CL_FAIL
                churn = (("fail", t_fail, iid), ("recover", t_back, iid))
            ss = sessions(mult)
            obs = make_obs(metrics=True)
            r = run(device, sessions=ss, obs=obs, overload=ctl,
                    churn=churn)
            out["launches"] += r["launches"]
            sim, done = r["sim"], r["done"]
            st = session_stats(ss)
            check(st["completed"] + st["abandoned"] == len(ss),
                  f"closed loop x{mult:g} {name}: every session ended")
            if churn and on_card:
                cpu = run("cpu", sessions=sessions(mult),
                          obs=make_obs(metrics=True), overload=ctl,
                          churn=churn)
                check(_finished(cpu["done"]) == _finished(done),
                      f"closed loop x{mult:g} {name} + churn: the card's "
                      f"run == the CPU's")
            snap = sim.metrics_snapshot()
            s = summarize(done, per_family_slo=True, registry_snapshot=snap)
            out["closed"]["runs"].append({
                "mult": mult, "control": name, "churn": bool(churn),
                "summary": s, "sessions": st,
                "overload": overload_summary(done, sim.dropped,
                                             sim.churn_recovery),
                "launches": r["launches"], "planned": r["planned"],
                "down_waves": r["down_waves"],
                "dropped_turns": snap["counters"].get(
                    "sessions.dropped_turns", 0), "wall": r["wall"]})
    # PD: its waves call route_score directly (one launch each of >= 2)
    pd_sessions = make_mixed_sessions(
        {"chatbot": max(1, int(CL_PD_SESSIONS * cl_cut))}, seed=CL_SEED,
        start_rates={"chatbot": CL_BASE * caps["chatbot"]
                     / SESSIONS["chatbot"].expected_requests()})
    rs.LAUNCHES = 0
    t0 = time.perf_counter()
    pd = ClosedLoopPDSim(PD_PREFILL, PD_DECODE, spec, kv_capacity_tokens=kv,
                         device=device)
    waves = []
    inner = pd._on_arrivals

    def on_arrivals(reqs):
        waves.append(len(reqs))
        return inner(reqs)
    pd._on_arrivals = on_arrivals
    done = pd.run_sessions(pd_sessions)
    wall = time.perf_counter() - t0
    multi = sum(1 for k in waves if k > 1)
    check(rs.LAUNCHES == (multi if on_card else 0),
          f"closed-loop PD: {rs.LAUNCHES} launches == waves of >= 2")
    out["launches"] += rs.LAUNCHES
    st = session_stats(pd_sessions)
    check(st["completed"] + st["abandoned"] == len(pd_sessions),
          "closed-loop PD: every session ended")
    out["closed"]["pd"] = {"summary": summarize(done, per_family_slo=True),
                           "sessions": st, "launches": rs.LAUNCHES,
                           "waves": multi, "wall": wall}
    out["wall"] = time.perf_counter() - t_phase
    return out


def _brief(s):
    """TTFT / TPOT / SLO of a summary, in one clause."""
    return (f"{s['n']} finished, TTFT mean {s['ttft_mean'] * 1e3:.2f} ms "
            f"p99 {s['ttft_p99'] * 1e3:.2f}, TPOT mean "
            f"{s['tpot_mean'] * 1e3:.3f} ms, KV$ hit "
            f"{s['kv_hit_ratio']:.4f}, SLO {s['slo_attainment']:.4f}, "
            f"goodput {s['goodput_rps']:.2f}/s")


def _wasted(o):
    return (f"shed {o['n_shed']}, retracted {o['n_retracted']}, late "
            f"{o['n_late']}, wasted prefill {o['wasted_prefill_tokens']} "
            f"tokens ({o['wasted_fraction']:.4f} of "
            f"{o['useful_prefill_tokens'] + o['wasted_prefill_tokens']}), "
            f"rerouted {o['n_rerouted']}")


def report_control(gpu, ph):
    """Print phase 15's numbers."""
    tag = f"[{gpu}] control plane:"
    for c in ph["checks"]:
        print(f"{tag} ok: {c}")
    o = ph["obs"]
    print(f"{tag} obs (metrics, trace every 8th wave, provenance) on the "
          f"lmetric chatbot run: {o['records']} provenance records, "
          f"{o['events']} trace events, {o['launches']} launches")
    for k, h in o["hists"].items():
        print(f"{tag} {k}: count {h['count']}, p50 {h['p50']:.2f}, p99 "
              f"{h['p99']:.2f}, max {h['max']:.2f}")
    print(f"{tag} provenance summary {json.dumps(o['provenance'])}")
    w = o["walls"]
    print(f"{tag} host wall of the run, best of {OBS_REPS}: obs off "
          f"{min(w['off']):.3f} s, on {min(w['on']):.3f} s (all: off "
          f"{[round(x, 3) for x in w['off']]}, on "
          f"{[round(x, 3) for x in w['on']]}); ratio {o['ratio']:.3f} "
          f"against the reference's budget {OBS_BUDGET:.2f} (printed, not "
          f"gated)")
    c = ph["churn"]
    events = ", ".join(f"{e['kind']} {e['iid']} at {e['t']} s "
                       f"({e['orphans']} orphans)" for e in c["events"])
    print(f"{tag} churn ({events}): "
          f"{_brief(c['summary'])} | {_wasted(c['overload'])}, recovery "
          f"p50 {c['overload']['churn_recovery_p50'] * 1e3:.2f} ms p95 "
          f"{c['overload']['churn_recovery_p95'] * 1e3:.2f} | launches "
          f"{c['launches']} == {c['planned']} live waves of >= 2; "
          f"{c['down_waves']} waves of >= 2 on the host while one was "
          f"out | host wall {c['wall']:.2f} s")
    ov = ph["overload"]
    for name, r in ov["runs"].items():
        print(f"{tag} overload, agent at {OVERLOAD_MULT:g} x "
              f"{ov['cap']:.2f} = {ov['qps']:.2f} req/s, {name}: "
              f"{_brief(r['summary'])} | {_wasted(r['overload'])} | "
              f"overload_summary {json.dumps(r['overload'])} | launches "
              f"{r['launches']} | host wall {r['wall']:.2f} s")
    fl = ph["fleet"]
    for policy, r in fl["runs"].items():
        print(f"{tag} mixed fleet (8 qwen3_30b_moe 'fast' + 8 qwen2_7b "
              f"'slow', prefill norm {fl['norm'][0]:.4g} / "
              f"{fl['norm'][-1]:.4g} s per token), chatbot, every 4th "
              f"request needs qwen2_7b, {policy}: {_brief(r['summary'])}, "
              f"shed {r['shed']}, 0 launches | host wall {r['wall']:.2f} s")
        for cls, s in r["classes"].items():
            print(f"{tag}   class {cls}: {_brief(s)}")
    print(f"{tag} homogeneous fleet (16 x qwen2_7b 'h100'): == phase 13, "
          f"{fl['homogeneous']['launches']} launches, host wall "
          f"{fl['homogeneous']['wall']:.2f} s")
    cl = ph["closed"]
    print(f"{tag} closed loop: make_mixed_sessions({cl['mix']}, seed="
          f"{CL_SEED}), start rates mult x {CL_BASE} x share x capacity / "
          f"expected requests (capacity "
          f"{ {f: round(v, 2) for f, v in cl['caps'].items()} } req/s)")
    for r in cl["runs"]:
        s = r["summary"]
        print(f"{tag} closed loop x{r['mult']:g} {r['control']}"
              f"{' + fail/recover' if r['churn'] else ''}: {_brief(s)} | "
              f"sessions {json.dumps(r['sessions'])} | "
              f"{_wasted(r['overload'])}, dropped turns fed back "
              f"{r['dropped_turns']} | launches {r['launches']} == "
              f"{r['planned']} live waves of >= 2 ({r['down_waves']} on "
              f"the host while one was out) | host wall {r['wall']:.2f} s")
        for fam, f in sorted(s.get("families", {}).items()):
            print(f"{tag}   {fam}: {_brief(f)}")
        print(f"{tag}   interference {json.dumps(s['interference'])}")
        print(f"{tag}   overload_summary {json.dumps(r['overload'])}")
    p = cl["pd"]
    print(f"{tag} closed-loop PD {PD_PREFILL}+{PD_DECODE}, chatbot: "
          f"{_brief(p['summary'])} | sessions {json.dumps(p['sessions'])} "
          f"| launches {p['launches']} == {p['waves']} waves of >= 2 | "
          f"host wall {p['wall']:.2f} s")
    print(f"{tag} route_score launches in the phase {ph['launches']}; "
          f"host wall {ph['wall']:.2f} s")


def chat_baseline(device):
    """What phase 15 takes from phase 13 (its spec, KV$ and lmetric
    chatbot run), computed alone: for a rehearsal."""
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.configs import get_config
    from repro_torch.core import Router, make_policy, spec_from_config
    kv, how = sim_kv_capacity(spec_from_config(get_config("qwen2_7b")))
    spec = spec_from_config(get_config("qwen2_7b"), kv_capacity_tokens=kv)
    trace, _ = sim_trace("chatbot", spec, SIM_REQUESTS)
    sim = ClusterSim(Router(make_policy("lmetric"), SIM_INSTANCES,
                            kv_capacity_tokens=kv, device=device), spec)
    done = sim.run(copy.deepcopy(trace))
    return {"spec": spec, "kv": kv, "how": how,
            "flat_chatbot": (trace, multi_waves(trace), _finished(done))}


def rehearse_control(cl_cut=1.0):
    """Phase 15 on the CPU (plain versions, no launches)."""
    ph = control_path(chat_baseline("cpu"), "cpu", cl_cut=cl_cut)
    report_control("cpu rehearsal", ph)
    return ph


# ---------------------------------------------------------------------------
# Whisper-medium (phases 17-18): the encoder and cross-attention on both
# attention kernels
# ---------------------------------------------------------------------------
#: Whisper-medium's attention widths (src/repro_torch/configs/
#: whisper_medium.py): 16 query heads over 16 KV heads (G = 1), hd 64,
#: 1500 encoder frames; the cross cache holds them in 1504 rows (whole
#: decode pages, ``attention.cross_rows``)
W_H, W_HD, W_FRAMES, W_ROWS = 16, 64, 1500, 1504
#: phase 18: clips, the decoder prompt (two chunks: the first computes the
#: cross caches from the encoder's output, the second reads them) and the
#: greedy decode steps per clip; past WHISPER_CUT_AFTER_S it runs
#: WHISPER_CUT_CLIPS clips (never fewer layers or a narrower model)
W_CLIPS, W_PROMPT, W_CHUNKS, W_DECODE = 8, 64, (32, 32), 32
WHISPER_CUT_AFTER_S, WHISPER_CUT_CLIPS = 900.0, 4
#: phase 18's logit check: the cached path's chunk logits and its first
#: W_CHECK_STEPS decode steps against the plain full forward
W_CHECK_STEPS = 2


def whisper_bound(Sq, Sk, B=1, H=W_H, KV=W_H, hd=W_HD, decode=False):
    """(bytes, operations) of unmasked attention of ``Sq`` query rows over
    ``Sk`` keys per sequence in bf16: q, k, v, out read or written once,
    4*hd operations per (query row, head, key); a decode step also reads
    its block table (4 B per 16-key page) and context length."""
    nbytes = 2 * B * (2 * Sq * H * hd + 2 * Sk * KV * hd)
    if decode:
        nbytes += 4 * B * (-(-Sk // KV_BLOCK) + 1)
    return nbytes, 4 * hd * H * Sq * Sk * B


def check_whisper_attention(torch):
    """Phase 17: both attention kernels at Whisper's shapes against their
    plain versions, in float32 and bfloat16 within ``ATTN_TOL``: the
    encoder's unmasked attention at (B 4, 1500, 16, 64) (``kv_offset =
    Sk = Sq``: queries past the keys), cross chunks of 1, 37 and 448
    queries over the first 1500 rows of a (4, 1504) cross cache (a
    batch-strided slice), ``paged_attention`` over the cross cache's paged
    view (94 pages a sequence, ``context_lens`` 1500; the 4 padding rows
    hold 1e3, which must not be read) and self-attention decode over
    ragged contexts."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import prefill_attention as fp
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 17)

    def rand(shape, dtype, scale=0.5):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * scale).to(dev, dtype)

    B, S, H, hd, X = 4, W_FRAMES, W_H, W_HD, W_ROWS
    worst = {"prefill_attention": 0.0, "paged_attention": 0.0}
    report = []
    offs = torch.full((B,), S, dtype=torch.int32, device=dev)
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        qs = ATTN_Q_SCALE[name]
        q, k, v = rand((B, S, H, hd), dtype, qs), rand((B, S, H, hd), dtype), \
            rand((B, S, H, hd), dtype)
        got = fp.flash_prefill(q, k, v, offs)
        want = fp.flash_prefill_plain(q, k, v, offs)
        torch.cuda.synchronize()
        worst["prefill_attention"] = max(worst["prefill_attention"], _attn_err(
            got, want, name, f"whisper encoder {name} B={B} Sq=Sk={S} "
            f"{H}/{H} hd {hd} kv_offset {S} (unmasked)", report))
        del q, k, v, got, want
        xk, xv = rand((B, X, H, hd), dtype), rand((B, X, H, hd), dtype)
        xk[:, S:], xv[:, S:] = 1e3, 1e3
        for Sq in (1, 37, 448):
            qc = rand((B, Sq, H, hd), dtype, qs)
            got = fp.flash_prefill(qc, xk[:, :S], xv[:, :S], offs)
            want = fp.flash_prefill_plain(qc, xk[:, :S], xv[:, :S], offs)
            torch.cuda.synchronize()
            worst["prefill_attention"] = max(
                worst["prefill_attention"], _attn_err(
                    got, want, name, f"whisper cross chunk {name} B={B} "
                    f"Sq={Sq} over {S} of {X} cache rows", report))
        pages = (B * X // KV_BLOCK, KV_BLOCK, H, hd)
        bt = torch.arange(B * X // KV_BLOCK, dtype=torch.int32,
                          device=dev).reshape(B, -1)
        qd = rand((B, H, hd), dtype, qs)
        got = pa.paged_attention(qd, xk.view(pages), xv.view(pages), bt,
                                 offs)
        want = pa.paged_attention_plain(qd, xk.view(pages), xv.view(pages),
                                        bt, offs)
        torch.cuda.synchronize()
        splits, grid = pa.launch_config(qd, xk.view(pages), bt)
        worst["paged_attention"] = max(worst["paged_attention"], _attn_err(
            got, want, name, f"whisper cross decode {name} B={B} {H}/{H} "
            f"hd {hd}, {X // KV_BLOCK} pages of {KV_BLOCK}, contexts {S} "
            f"(splits {splits}, grid {grid})", report))
        del xk, xv
        # self-attention decode over a (B, 128) slot cache, ragged contexts
        ctx = torch.tensor([1, 17, 64, 97], dtype=torch.int32, device=dev)
        kp = rand((B * 128 // KV_BLOCK, KV_BLOCK, H, hd), dtype)
        vp = rand((B * 128 // KV_BLOCK, KV_BLOCK, H, hd), dtype)
        bt = torch.arange(B * 128 // KV_BLOCK, dtype=torch.int32,
                          device=dev).reshape(B, -1)
        got = pa.paged_attention(qd, kp, vp, bt, ctx)
        want = pa.paged_attention_plain(qd, kp, vp, bt, ctx)
        torch.cuda.synchronize()
        worst["paged_attention"] = max(worst["paged_attention"], _attn_err(
            got, want, name, f"whisper self decode {name} B={B} contexts "
            f"{ctx.tolist()}", report))
    return worst, report


def time_whisper(torch):
    """Phase 17's timings at phase 18's shapes (one clip, bf16): the
    encoder's attention (1500 x 1500 unmasked), a 32-token cross chunk
    over 1500 keys, and a cross decode step over the 1504-row cache (cold
    over copies that hold ``COLD_BYTES``, and warm); each kernel's device
    time per launch (profiler) beside its wrapper's CUDA-event time, the
    plain version's time, SDPA's (unmasked, the same ways) and the
    bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import prefill_attention as fp
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 18)

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * 0.5).to(dev, torch.bfloat16)

    out = {}
    S, H, hd, X = W_FRAMES, W_H, W_HD, W_ROWS
    offs = torch.full((1,), S, dtype=torch.int32, device=dev)
    for what, Sq in (("encoder", S), ("cross chunk", W_CHUNKS[1])):
        q = rand(1, Sq, H, hd)
        k, v = rand(1, X, H, hd), rand(1, X, H, hd)
        run = (lambda: fp.flash_prefill(q, k[:, :S], v[:, :S], offs))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k[:, :S], v[:, :S]))
        lib = (lambda: F.scaled_dot_product_attention(qt, kt, vt))
        nbytes, ops = whisper_bound(Sq, S)
        bound, by = _bound(nbytes, ops)
        dev_ms = _device_ms(torch, [run], 20)
        out[f"whisper {what}"] = dict(
            shape=f"Sq={Sq} over {S} keys (unmasked), H={H} KV={H} hd={hd}",
            ms=dev_ms, wrapper_ms=_events_ms(torch, run, 50),
            plain_ms=_events_ms(torch, lambda: fp.flash_prefill_plain(
                q, k[:, :S], v[:, :S], offs), 5),
            library_ms=_device_ms(torch, [lib], 10),
            library_wall_ms=_events_ms(torch, lib, 20), bound_ms=bound,
            bound_by=by, bytes=nbytes, ops=ops, share=bound / dev_ms)
    nbytes, ops = whisper_bound(1, S, decode=True)
    copies = _copies(nbytes)
    pages = (X // KV_BLOCK, KV_BLOCK, H, hd)
    caches = [(rand(1, X, H, hd), rand(1, X, H, hd)) for _ in range(copies)]
    bt = torch.arange(X // KV_BLOCK, dtype=torch.int32, device=dev)[None]
    q = rand(1, H, hd)
    runs = [(lambda k=k, v=v: pa.paged_attention(q, k.view(pages),
                                                 v.view(pages), bt, offs))
            for k, v in caches]
    splits, grid = pa.launch_config(q, caches[0][0].view(pages), bt)
    libs = [(lambda k=k, v=v: F.scaled_dot_product_attention(
        q[:, :, None], k[:, :S].transpose(1, 2), v[:, :S].transpose(1, 2)))
        for k, v in caches]
    bound, by = _bound(nbytes, ops)
    cold = _device_ms(torch, runs, 10)
    out["whisper cross decode"] = dict(
        shape=f"B=1, {X // KV_BLOCK} pages of {KV_BLOCK}, context {S}, "
              f"H={H} KV={H} hd={hd}",
        ms=cold, warm_ms=_device_ms(torch, runs[:1], 20),
        wrapper_ms=_events_ms(torch, runs[0], 200), copies=copies,
        splits=splits, grid=grid,
        plain_ms=_events_ms(torch, lambda: pa.paged_attention_plain(
            q, caches[0][0].view(pages), caches[0][1].view(pages), bt,
            offs), 5),
        library_ms=_device_ms(torch, libs, 10),
        library_warm_ms=_device_ms(torch, libs[:1], 20),
        library_wall_ms=_events_ms(torch, libs[0], 50), bound_ms=bound,
        bound_by=by, bytes=nbytes, ops=ops, share=bound / cold)
    return out


def whisper_clip(torch, model, params, frames, toks, timed=None):
    """One clip through the served path: ``encode`` (the encoder on
    ``flash_prefill``), ``prefill_cached`` of the prompt in the chunks of
    ``W_CHUNKS`` (the first with ``enc_out``), then ``W_DECODE`` greedy
    ``decode_step``s.  Each stage's launches are counted from zero and
    held to 24 / 48 per chunk / 48 per step; ``timed`` collects the
    stages' walls (synchronised).  Returns (chunk logits, decode logits,
    decoded tokens)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import prefill_attention as fp
    cfg = model.cfg
    n_x = sum(k == "xattn" for k in cfg.block_pattern)
    dev = model.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    on_card = dev.type == "cuda"

    def stage(name, fn, want):
        fp.LAUNCHES = pa.LAUNCHES = 0
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        if timed is not None:
            timed.setdefault(name, []).append(time.perf_counter() - t0)
        got = (fp.LAUNCHES, pa.LAUNCHES)
        if got != (want if on_card else (0, 0)):
            raise AssertionError(f"whisper {name}: launches (flash_prefill, "
                                 f"paged_attention) {got} != {want}")
        return out

    enc_out = stage("encoder", lambda: model.encode(params, frames),
                    (cfg.enc_layers, 0))
    cache = model.init_cache(1, -(-(W_PROMPT + W_DECODE) // KV_BLOCK)
                             * KV_BLOCK)
    chunk_logits, lo = [], 0
    for i, n in enumerate(W_CHUNKS):
        pos = torch.arange(lo, lo + n, device=dev)[None]
        logits, cache = stage(
            "chunk", lambda: model.prefill_cached(
                params, toks[:, lo:lo + n], pos, cache, [lo],
                enc_out=enc_out if i == 0 else None), (2 * n_x, 0))
        chunk_logits.append(logits)
        lo += n
    tok = chunk_logits[-1][:, -1].argmax(-1)[:, None]
    dec_logits, out_toks = [], []
    for j in range(W_DECODE):
        pos = torch.full((1,), W_PROMPT + j, device=dev)
        logits, cache = stage("decode", lambda: model.decode_step(
            params, tok, pos, cache), (0, 2 * n_x))
        out_toks.append(int(tok))
        dec_logits.append(logits[:, 0])
        tok = logits[:, 0].argmax(-1)[:, None]
    return torch.cat(chunk_logits, dim=1), dec_logits, out_toks


def _logit_diff(got, want):
    d = (got - want).abs()
    return (float(d.max()), float((got - want).square().mean().sqrt()
                                  / want.square().mean().sqrt()))


def whisper_logit_check(torch, model, params, frames, toks, chunk_logits,
                        dec_logits, out_toks, tol):
    """The served clip's chunk logits and its first ``W_CHECK_STEPS``
    decode steps against ``Model.prefill`` (the plain full forward: the
    encoder's and decoder's plain attention) over the same frames and
    tokens, each within ``tol`` = (max |diff|, RMS ratio)."""
    atol, rel = tol
    checks = []
    plain, _ = model.prefill(params, toks, {"frames": frames})
    checks.append(("prompt chunks",) + _logit_diff(chunk_logits[0],
                                                   plain[0]))
    seq = toks[0].tolist()
    for j in range(W_CHECK_STEPS):
        seq.append(out_toks[j])
        p, _ = model.prefill(params, torch.tensor([seq], device=model.device),
                             {"frames": frames}, last_only=True)
        checks.append((f"decode step {j}",) + _logit_diff(dec_logits[j][0],
                                                          p[0, -1]))
    for what, mx, r in checks:
        if not (mx <= atol and r <= rel):
            raise AssertionError(f"whisper served logits != plain forward "
                                 f"({what}): max |diff| {mx:.4f}, RMS ratio "
                                 f"{r:.4f} (tolerance {tol})")
    return checks


def whisper_path(torch, device="cuda", n_clips=W_CLIPS, arch="whisper_medium"):
    """Phase 18: Whisper-medium at full width and depth (24 + 24 layers, d
    1024, vocab 51865; random bf16 weights from a seeded generator on the
    card), ``n_clips`` clips of random frames (1500 x 1024), each through
    ``whisper_clip`` (encoder, two prompt chunks, 32 decode steps) with
    its launches held; clip 0's logits held to the plain full forward
    (``whisper_logit_check``): in bf16 when the model's own bf16 noise
    floor is within (``LOGIT_ATOL``, ``LOGIT_REL_RMS``), else in float32
    at full depth (~3.2 GB, within ``MOE_F32_BYTES``: phase 16's rule),
    which is printed.  ``arch="whisper_medium-smoke", device="cpu"``
    rehearses it on the CPU (plain versions, no launches)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(arch)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    model = Model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    sync()
    t_init = time.perf_counter() - t0
    rng = np.random.RandomState(SEED + 19)
    frames = torch.from_numpy(rng.randn(n_clips, cfg.enc_seq,
                                        cfg.enc_d_model).astype(np.float32)
                              ).to(device, model.dtype)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                        (n_clips, W_PROMPT))).to(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    mem_weights = torch.cuda.memory_allocated() if on_card else 0
    timed = {}
    t0 = time.perf_counter()
    served = [whisper_clip(torch, model, params, frames[i:i + 1],
                           toks[i:i + 1], timed) for i in range(n_clips)]
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    for chunk, dec, _ in served:
        if not (bool(torch.isfinite(chunk).all())
                and all(bool(torch.isfinite(d).all()) for d in dec)):
            raise AssertionError("whisper served logits are not finite")
    f0, t1 = frames[:1], toks[:1]
    floor = embedding_sensitivity(torch, model, params, t1[0].tolist(),
                                  {"frames": f0})
    what = f"bf16 noise floor max {floor[0]:.4f}, RMS ratio {floor[1]:.4f}"
    if floor[0] <= LOGIT_ATOL and floor[1] <= LOGIT_REL_RMS:
        checks = whisper_logit_check(torch, model, params, f0, t1,
                                     *served[0], (LOGIT_ATOL, LOGIT_REL_RMS))
        what += (f" within ({LOGIT_ATOL}, {LOGIT_REL_RMS}): bf16 at full "
                 f"depth")
    else:
        m32 = Model(dataclasses.replace(cfg, dtype="float32"), device=device)
        p32 = _cast(params, torch.float32)
        served32 = whisper_clip(torch, m32, p32, f0.float(), t1)
        checks = whisper_logit_check(torch, m32, p32, f0.float(), t1,
                                     *served32, LOGIT_F32)
        what += (f" above ({LOGIT_ATOL}, {LOGIT_REL_RMS}): float32 at full "
                 f"depth ({cfg.param_count() * 4 / 1e9:.1f} GB)")
    launches = {"prefill_attention": n_clips * cfg.enc_layers
                + n_clips * len(W_CHUNKS) * 2 * cfg.n_layers,
                "paged_attention": n_clips * W_DECODE * 2 * cfg.n_layers}
    return {"cfg": cfg, "n_params": sum(t.numel() for t in _leaves(params)),
            "init_s": t_init, "wall_s": wall, "clips": n_clips,
            "timed": timed, "peak": peak, "mem_weights": mem_weights,
            "checks": checks, "check_note": what,
            "launches": launches if on_card else dict.fromkeys(launches, 0),
            "tokens": [s[2] for s in served]}


def report_whisper(gpu, wp, timing):
    """Print phases 17 and 18's numbers."""
    cfg = wp["cfg"]
    tag = f"[{gpu}] whisper {cfg.name}:"
    med = (lambda v: float(np.median(v)) * 1e3)
    t = wp["timed"]
    print(f"{tag} {cfg.enc_layers} encoder + {cfg.n_layers} decoder layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, "
          f"{wp['n_params'] / 1e9:.3f} B params (bf16, seeded on the card "
          f"in {wp['init_s']:.1f} s); {wp['clips']} clips of "
          f"{cfg.enc_seq} x {cfg.enc_d_model} frames, each: encoder, a "
          f"{W_PROMPT}-token prompt in chunks {W_CHUNKS}, {W_DECODE} greedy "
          f"decode steps; {wp['wall_s']:.1f} s wall")
    print(f"{tag} medians: encoder {med(t['encoder']):.2f} ms, chunk "
          f"{med(t['chunk']):.2f} ms, decode step {med(t['decode']):.2f} ms "
          f"(B = 1); device memory: weights "
          f"{wp['mem_weights'] / 2 ** 30:.2f} GiB, peak "
          f"{wp['peak'] / 2 ** 30:.2f} GiB")
    print(f"{tag} launches (flash_prefill, paged_attention): "
          f"{cfg.enc_layers} per encoder, {2 * cfg.n_layers} per chunk, "
          f"{2 * cfg.n_layers} per decode step, as expected; in all "
          f"{wp['launches']}")
    print(f"{tag} logit check: {wp['check_note']}")
    for what, mx, rel in wp["checks"]:
        print(f"{tag} served vs plain full forward, {what}: max |dlogit| "
              f"{mx:.4f}, RMS ratio {rel:.4f}")
    for name, tm in timing.items():
        report_attention_timing(gpu, name, tm)


# ---------------------------------------------------------------------------
# training (phase 19): Qwen3-4B at full width and depth
# ---------------------------------------------------------------------------
#: phase 19: the reference launcher's documented arch, batch x sequence
#: (the synthetic ``DataIterator``), steps, the checkpoint step, the
#: optimizer; past TRAIN_CUT_AFTER_S it takes TRAIN_CUT_STEPS steps (the
#: checkpoint at half of them), never a narrower or shallower model
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "qwen3_4b", 4, 512, 20
TRAIN_CUT_AFTER_S, TRAIN_CUT_STEPS = 900.0, 10
TRAIN_LR, TRAIN_WARMUP = 5e-4, 2
#: the stream cycles over this many documents per batch row
#: (``DataConfig.n_docs``: 8 at batch 4), so
#: that each is seen every other step and 20 steps can show the loss
#: fall: on fresh documents every step (the default, 2^20 of them; each
#: spans its own 512-token id range) a random-init model has nothing to
#: learn in 20 steps (a 2-layer width-1024 proxy on the CPU: first-5 mean
#: 12.156, last-5 mean 12.160; with 8 documents 9.665 -> 0.444)
TRAIN_DOCS_PER_ROW = 2
#: the depth cut held between card and CPU (full width, float32) and its
#: batch; tolerances: loss and gradient norm relative 1e-4 (cuBLAS and
#: the CPU's BLAS sum in other orders, no TF32), parameters after the step
#: within 1e-3 x lr + 1e-6 |p| where the clipped gradient is at least
#: 1e3 x eps, within 2.01 x lr elsewhere (where rounding decides the Adam
#: update's sign; tests/test_torch_training.py's ``_hold_step``)
TRAIN_CUT_LAYERS, TRAIN_CUT_BATCH, TRAIN_CUT_SEQ = 2, 2, 64
TRAIN_REL = 1e-4
#: the checkpoint round trip runs on this depth cut at full width (the
#: full-depth ~48 GB state took 64.3 s to save and 113.5 s to restore,
#: PERF.md; the cut's is ~6 GB, most of it the embedding's)
TRAIN_CKPT_LAYERS = 2


def _kernel_launches():
    from repro_torch.kernels import route_score
    return {**{k: m.LAUNCHES for k, m in _launch_counters().items()},
            "route_score": route_score.LAUNCHES}


def _zero_launches():
    from repro_torch.kernels import route_score
    for m in list(_launch_counters().values()) + [route_score]:
        m.LAUNCHES = 0


def hold_step(torch, want, got, m_want, lr, b1=0.9):
    """Parameters after one step on the scale of ``lr`` (the rule above):
    returns (worst |diff| / lr where the clipped gradient is >= 1e3 x eps,
    worst |diff| / lr elsewhere, elements elsewhere)."""
    from repro_torch.training.optim import leaves
    tight = wide = 0.0
    n_wide = 0
    for a, b, m in zip(leaves(want), leaves(got), leaves(m_want)):
        a, b, m = a.float().cpu(), b.float().cpu(), m.float().cpu()
        d = (a - b).abs()
        ok = m.abs() / (1 - b1) >= 1e3 * 1e-8
        excess = (d - 1e-6 * a.abs())[ok]
        if excess.numel():
            tight = max(tight, float(excess.max()) / lr)
        if (~ok).any():
            wide = max(wide, float(d[~ok].max()) / lr)
            n_wide += int((~ok).sum())
    if not (tight <= 1e-3 and wide <= 2.01):
        raise AssertionError(f"parameters after the step differ: {tight:.3g} "
                             f"lr (limit 1e-3), {wide:.3g} lr where the "
                             f"gradient is ill-conditioned (limit 2.01)")
    return tight, wide, n_wide


def train_reckoning(cfg, B, S):
    """Device bytes the step needs: bf16 parameters and gradients, f32
    moments, and the largest activations (the f32 logits of B x S tokens,
    three copies: logits, their softmax's gradient, the bf16 product)."""
    n = cfg.param_count()
    logits = B * S * cfg.padded_vocab_size * 4 * 3
    return {"params": 2 * n, "grads": 2 * n, "moments": 8 * n,
            "logits": logits, "total": 12 * n + logits, "n": n}


def train_path(torch, ckpt_dir, n_steps=TRAIN_STEPS, device="cuda",
               arch=TRAIN_ARCH, B=TRAIN_BATCH, S=TRAIN_SEQ, lr=TRAIN_LR,
               n_layers=None):
    """Phase 19: ``arch`` at full width in bf16 (f32 moments,
    ``remat=True``; its first ``n_layers`` layers if given, else its full
    depth) trained ``n_steps`` steps of ``make_train_step`` on the
    synthetic ``DataIterator``; every loss finite and the mean of the last
    5 below that of the first 5.  With a ``ckpt_dir``, a checkpoint saved
    after step ``n_steps // 2`` (``save_checkpoint``, the reference's
    format) and restored into fresh tensors (everything else freed first)
    reproduces the next step's loss and parameters exactly.  Every
    kernel's launch counter stays 0 throughout (training runs no kernel).
    ``arch="qwen3_4b-smoke", device="cpu"`` rehearses it (at a smoke
    model's width the loss needs a larger ``lr`` to fall in 20 steps)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.models import Model
    from repro_torch.training import checkpoint as ck
    from repro_torch.training.optim import (AdamWState, OptimizerConfig,
                                            adamw_init, leaves, tree_map)
    from repro_torch.training.train_loop import make_train_step
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers,
                                  block_pattern=cfg.block_pattern[:n_layers])
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    model = Model(cfg, device=device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    opt_cfg = OptimizerConfig(lr=lr, warmup_steps=TRAIN_WARMUP,
                              total_steps=n_steps, schedule=cfg.lr_schedule)
    opt = adamw_init(params, opt_cfg)
    sync()
    t_init = time.perf_counter() - t0
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                          global_batch=B, n_docs=TRAIN_DOCS_PER_ROW * B)
    data = DataIterator(data_cfg)
    step_fn = make_train_step(model, opt_cfg, remat=True, device=device)
    mem_state = torch.cuda.memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    save_at = n_steps // 2
    losses, walls, gnorms = [], [], []
    resume = None
    for step in range(1, n_steps + 1):
        batch = next(data)
        sync()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        loss = float(m["loss"])             # waits for the step
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorms.append(float(m["grad_norm"]))
        if not np.isfinite(loss):
            raise AssertionError(f"step {step}: loss {loss}")
        if ckpt_dir is not None and step == save_at:
            t0 = time.perf_counter()
            ck.save_checkpoint(ckpt_dir, step, params, opt,
                               extra={"data": data.state()})
            t_save = time.perf_counter() - t0
        if ckpt_dir is not None and step == save_at + 1:
            resume = {"batch": batch, "loss": loss, "params": tree_map(
                lambda t: t.to("cpu", copy=True), params)}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    launches = _kernel_launches()
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first:
        raise AssertionError(f"the loss did not fall: first 5 mean {first}, "
                             f"last 5 mean {last}")
    out = {"cfg": cfg, "B": B, "S": S, "lr": lr, "steps": n_steps,
           "losses": losses, "gnorms": gnorms, "walls": walls,
           "init_s": t_init, "mem_state": mem_state, "peak": peak,
           "launches": launches, "reckoning": train_reckoning(cfg, B, S)}
    if ckpt_dir is None:
        if any(launches.values()):
            raise AssertionError(f"training launched kernels: {launches}")
        del params, opt, m
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        return out
    # resume: free everything, restore into fresh tensors, take the step
    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")
    like, mlike = tree_map(meta, params), tree_map(meta, opt.m)
    del params, opt, m
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    step0, p2, o2 = ck.restore_checkpoint(
        ckpt_dir, None, like, AdamWState(0, mlike, mlike), device=device)
    t_restore = time.perf_counter() - t0
    data2 = DataIterator(data_cfg)
    with open(os.path.join(ckpt_dir, f"step_{step0:08d}.json")) as f:
        data2.restore(json.load(f)["extra"]["data"])
    batch = next(data2)
    same_batch = all(np.array_equal(batch[k], resume["batch"][k])
                     for k in batch)
    p2, o2, m2 = step_fn(p2, o2, batch)
    loss2 = float(m2["loss"])
    exact = all(torch.equal(a.cpu(), b) for a, b in
                zip(leaves(p2), leaves(resume["params"])))
    if not (step0 == save_at and o2.step == save_at + 1 and same_batch
            and loss2 == resume["loss"] and exact):
        raise AssertionError(f"resume from step {step0}: batch equal "
                             f"{same_batch}, loss {loss2} vs "
                             f"{resume['loss']}, parameters equal {exact}")
    launches2 = _kernel_launches()
    if any(launches.values()) or any(launches2.values()):
        raise AssertionError(f"training launched kernels: {launches}, "
                             f"{launches2}")
    ck_bytes = sum(os.path.getsize(os.path.join(ckpt_dir, f))
                   for f in os.listdir(ckpt_dir))
    del p2, o2, m2, resume
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return {**out, "save_at": save_at, "save_s": t_save,
            "restore_s": t_restore, "ckpt_bytes": ck_bytes,
            "resumed_loss": loss2}


def train_cut_check(torch, device="cuda", arch=TRAIN_ARCH):
    """Phase 19's depth cut: ``arch`` at full width on its first
    ``TRAIN_CUT_LAYERS`` layers in float32; one ``make_train_step`` step
    on the card against the same step on the CPU (the same parameters and
    batch), and one ``accum_steps=2`` step against the unsplit one on the
    card: loss and gradient norm within ``TRAIN_REL``, parameters by
    ``hold_step``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.models import Model
    from repro_torch.training.optim import (OptimizerConfig, adamw_init,
                                            tree_map)
    from repro_torch.training.train_loop import make_train_step
    base = get_config(arch)
    cfg = dataclasses.replace(base, dtype="float32",
                              n_layers=TRAIN_CUT_LAYERS,
                              block_pattern=base.block_pattern[
                                  :TRAIN_CUT_LAYERS])
    opt_cfg = OptimizerConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)
    batch = next(DataIterator(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=TRAIN_CUT_SEQ,
                                         global_batch=TRAIN_CUT_BATCH)))
    model = Model(cfg, device=device)
    p0 = model.init(torch.Generator(device=device).manual_seed(SEED + 1))
    host = tree_map(lambda t: t.cpu(), p0)
    out = {}
    runs = {}
    for name, dev, accum in (("card", device, 1), ("card accum 2", device, 2),
                             ("cpu", "cpu", 1)):
        m = model if dev == device else Model(cfg, device="cpu")
        p = tree_map(lambda t: t.to(dev).clone(), host)
        o = adamw_init(p, opt_cfg)
        t0 = time.perf_counter()
        p, o, met = make_train_step(m, opt_cfg, accum_steps=accum,
                                    device=dev)(p, o, batch)
        runs[name] = (tree_map(lambda t: t.cpu(), p),
                      tree_map(lambda t: t.cpu(), o.m),
                      float(met["loss"]), float(met["grad_norm"]),
                      met["lr"], time.perf_counter() - t0)
        del p, o
    for a, b in (("cpu", "card"), ("card", "card accum 2")):
        pa_, ma, la, ga, lr, _ = runs[a]
        pb, _, lb, gb, _, _ = runs[b]
        if not (abs(la - lb) <= TRAIN_REL * abs(la)
                and abs(ga - gb) <= TRAIN_REL * ga):
            raise AssertionError(f"{b} vs {a}: loss {lb} vs {la}, gradient "
                                 f"norm {gb} vs {ga}")
        out[f"{b} vs {a}"] = (la, lb, ga, gb) + hold_step(torch, pa_, pb,
                                                          ma, lr)
    out["walls"] = {k: v[5] for k, v in runs.items()}
    out["cfg"] = cfg
    return out


def report_train(gpu, tp, cut, ck=None):
    """Print phase 19's numbers: the run ``tp``, the depth cut's card vs
    CPU check ``cut`` and the checkpoint round trip of ``ck`` (or of
    ``tp``, if it made one)."""
    cfg, r = tp["cfg"], tp["reckoning"]
    tag = f"[{gpu}] training {cfg.name}:"
    tokens = tp["B"] * tp["S"]
    med = float(np.median(tp["walls"][1:]))
    print(f"{tag} {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size} (tied), bf16 parameters, f32 moments, remat "
          f"per layer; batch {tp['B']} x {tp['S']} tokens of the synthetic "
          f"DataIterator cycling over {TRAIN_DOCS_PER_ROW * tp['B']} "
          f"documents; {tp['steps']} steps of make_train_step, lr "
          f"{tp['lr']} ({cfg.lr_schedule}, warmup {TRAIN_WARMUP})")
    print(f"{tag} memory reckoning: {r['n'] / 1e9:.3f} B parameters -> "
          f"params {r['params'] / 1e9:.2f} GB + grads {r['grads'] / 1e9:.2f}"
          f" + moments {r['moments'] / 1e9:.2f} = "
          f"{(r['params'] + r['grads'] + r['moments']) / 1e9:.2f} GB, plus "
          f"~{r['logits'] / 1e9:.2f} GB of f32 logits: "
          f"{r['total'] / 1e9:.2f} GB of the card's 80; measured: state "
          f"{tp['mem_state'] / 2 ** 30:.2f} GiB, peak "
          f"{tp['peak'] / 2 ** 30:.2f} GiB")
    print(f"{tag} losses {[round(x, 4) for x in tp['losses']]}; first 5 "
          f"mean {np.mean(tp['losses'][:5]):.4f} > last 5 mean "
          f"{np.mean(tp['losses'][-5:]):.4f}; gradient norms "
          f"{[round(x, 3) for x in tp['gnorms']]}")
    from repro_torch.launch.shapes import model_flops_at
    mf = model_flops_at(cfg, "train", tp["S"], tp["B"])
    print(f"{tag} step wall median {med * 1e3:.1f} ms (first step "
          f"{tp['walls'][0] * 1e3:.1f}), {tokens / med:.0f} tokens/s; "
          f"kernel launches {tp['launches']} (training runs no kernel)")
    print(f"{tag} model_flops_at(train, {tp['S']}, {tp['B']}) = 6 N D = "
          f"{mf:.6g} FLOP a step (remat's second forward not counted): "
          f"{mf / med / 1e12:.1f} TFLOP/s, {mf / med / BF16_OPS_PER_S:.2%} "
          f"of the {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s dense bf16 peak")
    ck = ck or tp
    print(f"{tag} checkpoint of a {ck['cfg'].n_layers}-layer run at full "
          f"width ({ck['steps']} steps, losses {ck['losses'][0]:.4f} -> "
          f"{ck['losses'][-1]:.4f}) after step {ck['save_at']}: "
          f"{ck['ckpt_bytes'] / 1e9:.2f} GB on disk, saved in "
          f"{ck['save_s']:.1f} s, restored into fresh tensors in "
          f"{ck['restore_s']:.1f} s; step {ck['save_at'] + 1} from it: loss "
          f"{ck['resumed_loss']} and every parameter equal to the "
          f"uninterrupted run's")
    for what, v in cut.items():
        if what in ("walls", "cfg"):
            continue
        la, lb, ga, gb, tight, wide, n_wide = v
        print(f"{tag} depth cut ({cut['cfg'].n_layers} layers, full width, "
              f"f32, batch {TRAIN_CUT_BATCH} x {TRAIN_CUT_SEQ}) {what}: loss "
              f"{lb:.7f} vs {la:.7f}, gradient norm {gb:.6f} vs {ga:.6f} "
              f"(rel {TRAIN_REL}); parameters within {tight:.3g} lr "
              f"(limit 1e-3) where the clipped gradient >= 1e3 eps, "
              f"{wide:.3g} lr over {n_wide} elements below it (limit 2.01)")
    print(f"{tag} depth-cut step walls {cut['walls']} s")


# ---------------------------------------------------------------------------
# the serving launcher and the layout modules (phase 20)
# ---------------------------------------------------------------------------
#: phase 20: ``launch/serve.py``'s ``run`` on the reference launcher's
#: default arch at full width and depth, its 40 arrivals once per policy;
#: past SERVE_CUT_AFTER_S each run serves SERVE_CUT_REQUESTS (never fewer,
#: never a narrower or shallower model)
SERVE_ARCH, SERVE_REQUESTS = "qwen3_4b", 40
SERVE_POLICIES = ("lmetric", "vllm", "linear")
SERVE_CUT_AFTER_S, SERVE_CUT_REQUESTS = 1000.0, 10
#: the logit check's follow-up turn: the served prompt (104-127 tokens,
#: its 96-token app prompt stored) plus SERVE_EXTRA tokens, within the
#: launcher's 256-token slots
SERVE_EXTRA, SERVE_MIN_HIT = 64, 96
#: Qwen3-4B's attention widths (src/repro_torch/configs/qwen3_4b.py): 32 q
#: over 8 KV heads (G = 4), hd 128; the launcher's slots of 256 rows
Q4_H, Q4_KV, Q4_HD, SERVE_SLOTS, SERVE_ROWS = 32, 8, 128, 4, 256


def check_serve_attention(torch):
    """Phase 20a: both attention kernels against their plain versions at
    the launcher's served shapes (G = 4, hd 128), f32 and bf16 within
    ``ATTN_TOL``: chunks of up to 64 queries of slot 2 of a (4, 256, 8,
    128) cache (a batch-strided view, as ``prefill_cached`` passes it) at
    offsets 0, 64, 96 (a hit on the app prompt) and 192, a ragged 23-token
    tail and a one-token chunk at 255; decode over the slots' paged view
    (16 pages of 16 a slot) at contexts (1, 100, 255, 256) and (17, 64,
    130, 200)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import prefill_attention as fp
    from repro_torch.models.attention import decode_tables
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 20)

    def rand(shape, dtype, scale=0.5):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * scale).to(dev, dtype)

    B, S, H, KV, hd = SERVE_SLOTS, SERVE_ROWS, Q4_H, Q4_KV, Q4_HD
    worst = {"prefill_attention": 0.0, "paged_attention": 0.0}
    report = []
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        qs = ATTN_Q_SCALE[name]
        kc, vc = rand((B, S, KV, hd), dtype), rand((B, S, KV, hd), dtype)
        for Sq, off in ((64, 0), (64, 64), (64, 96), (64, 192), (23, 120),
                        (1, 255)):
            q = rand((1, Sq, H, hd), dtype, qs)
            k, v = kc[2:3, :off + Sq], vc[2:3, :off + Sq]
            offs = torch.full((1,), off, dtype=torch.int32, device=dev)
            got = fp.flash_prefill(q, k, v, offs)
            want = fp.flash_prefill_plain(q, k, v, offs)
            torch.cuda.synchronize()
            worst["prefill_attention"] = max(
                worst["prefill_attention"], _attn_err(
                    got, want, name, f"served chunk {name} {H}/{KV} hd {hd}"
                    f" Sq={Sq} off={off} (slot 2 of {B} x {S})", report))
        pages = (B * S // KV_BLOCK, KV_BLOCK, KV, hd)
        bt = decode_tables(B, S, dev)
        for ctx in ((1, 100, 255, 256), (17, 64, 130, 200)):
            q = rand((B, H, hd), dtype, qs)
            cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
            got = pa.paged_attention(q, kc.view(pages), vc.view(pages), bt,
                                     cl)
            want = pa.paged_attention_plain(q, kc.view(pages),
                                            vc.view(pages), bt, cl)
            torch.cuda.synchronize()
            splits, grid = pa.launch_config(q, kc.view(pages), bt)
            worst["paged_attention"] = max(
                worst["paged_attention"], _attn_err(
                    got, want, name, f"served decode {name} {H}/{KV} hd "
                    f"{hd} B={B}, {S // KV_BLOCK} pages of {KV_BLOCK} a "
                    f"slot, contexts {list(ctx)} (splits {splits}, grid "
                    f"{grid})", report))
    return worst, report


def serve_path(torch, device="cuda", n_req=SERVE_REQUESTS, arch=SERVE_ARCH):
    """Phase 20b: ``arch`` at full width and depth (bf16, parameters of
    ``serve.init_params``: seed 0 on the card), served by
    ``repro_torch.launch.serve.run`` -- the function ``main`` calls, with
    the full config where ``main`` passes the smoke one -- once per policy
    of ``SERVE_POLICIES`` on one model and one set of parameters, the
    reference launcher's first ``n_req`` arrivals each.  Each run: every
    request finishes, the launches (counted from zero just before the run,
    the engines' warm-ups included) equal ``expected_launches`` from its
    chunks and decode steps, and the follow-up turn of a served prompt
    (``check_arrival``: one whose prefill stalled, where one did) is held
    to the plain full forward (``logits_vs_plain``) within
    (``LOGIT_ATOL``, ``LOGIT_REL_RMS``).  Each run's cluster is freed
    before the next.  ``device="cpu", arch="qwen3_4b-smoke"`` rehearses
    it (no launches there)."""
    from repro_torch.cluster.metrics import summarize
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Model
    cfg = get_config(arch)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    model = Model(cfg, device=device)
    params = serve.init_params(model)
    sync()
    t_init = time.perf_counter() - t0
    mem = (lambda: torch.cuda.memory_allocated()) if on_card else \
        (lambda: 0)
    out = {"cfg": cfg, "n_req": n_req, "init_s": t_init,
           "n_params": sum(t.numel() for t in _leaves(params)),
           "mem_weights": mem(), "runs": {}}
    arrivals = serve.make_arrivals(n_req)
    counters = _launch_counters()
    for policy in SERVE_POLICIES:
        steps, stalls = [], []

        def prepare(cluster):
            for eng in cluster.engines:
                def logged(step=eng.step):
                    ev = step()
                    steps.append((ev["kind"], ev["prefill_tokens"],
                                  ev["wall"]))
                    return ev

                def hold(h=eng._hold_stalled, eng=eng):
                    held = h()
                    if held is not None:
                        stalls.append(eng.waiting[0].req.rid)
                    return held
                eng.step = logged
                eng._hold_stalled = hold
            out["mem_engines"] = mem()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            for m in counters.values():
                m.LAUNCHES = 0

        t0 = time.perf_counter()
        served = serve.run(cfg, policy, params=params, device=device,
                           requests=n_req, prepare=prepare)
        sync()
        wall = time.perf_counter() - t0
        launches = {k: m.LAUNCHES for k, m in counters.items()}
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        chunks = [s[1] for s in steps if s[0] == "prefill"]
        decodes = [s[2] for s in steps if s[0] == "decode"]
        want = expected_launches(cfg, chunks, len(decodes), on_card,
                                 engines=len(served.cluster.engines),
                                 chunk=serve.ENGINE_KW["chunk_tokens"])
        if launches != want:
            raise AssertionError(f"{cfg.name} {policy}: launches {launches} "
                                 f"!= {want} ({len(chunks)} chunks, "
                                 f"{len(decodes)} decode steps)")
        if len(served.done) != n_req:
            raise AssertionError(f"{cfg.name} {policy}: {len(served.done)} "
                                 f"of {n_req} requests finished")
        pick = check_arrival(served.cluster.engines, arrivals, stalls)
        checks = logits_vs_plain(torch, served.cluster.engines, model,
                                 params, [arrivals[pick]], extra=SERVE_EXTRA,
                                 min_hit=SERVE_MIN_HIT)
        out["runs"][policy] = {
            "row": served.row, "wall_s": wall, "launches": launches,
            "peak": peak, "chunks": chunks, "decodes": decodes,
            "chunk_walls": [s[2] for s in steps if s[0] == "prefill"],
            "summary": summarize(served.done), "logit_checks": checks,
            "stalls": collections.Counter(stalls), "checked": pick,
            "instances": collections.Counter(r.sched_to
                                             for r in served.done),
            "hit_tokens": sum(r.hit_tokens for r in served.done)}
        del served
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    return out


def check_arrival(engines, arrivals, stalled):
    """The arrival whose follow-up turn phase 20b's logit check serves:
    the last of those whose prefill stalled (``stalled``: request ids,
    which are arrival indices) that an engine still holds whole, else the
    last held.  A stalled request's fragment is the one the decode steps
    of its stall would have overwritten (ROADMAP Queue C.17)."""
    from repro_torch.core.radix import tokens_to_blocks

    def held(i):
        key = tuple(tokens_to_blocks(arrivals[i][1].tolist(), KV_BLOCK))
        return any(e.prefix_store.lookup(key)[0] == key for e in engines)
    order = sorted(set(stalled), reverse=True) + \
        list(range(len(arrivals) - 1, -1, -1))
    for i in order:
        if held(i):
            return i
    raise AssertionError("no engine holds a served prompt's fragment")


def report_serve(gpu, sp):
    """Print phase 20b's numbers."""
    cfg = sp["cfg"]
    tag = f"[{gpu}] launcher {cfg.name}:"
    kv = (4 * SERVE_SLOTS * SERVE_ROWS * cfg.n_layers * 2
          * cfg.n_kv_heads * cfg.resolved_head_dim * 2)
    print(f"{tag} {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} q / {cfg.n_kv_heads} KV heads, hd "
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size} (tied), "
          f"{sp['n_params'] / 1e9:.3f} B parameters (bf16, seeded on the "
          f"card in {sp['init_s']:.1f} s); launch.serve.run with 4 engines "
          f"x 4 slots x 256 tokens, chunk 64; {sp['n_req']} arrivals of "
          f"the reference launcher per policy")
    print(f"{tag} memory: weights {sp['mem_weights'] / 2 ** 30:.2f} GiB, "
          f"with one cluster's caches {sp['mem_engines'] / 2 ** 30:.2f} GiB"
          f" (reckoned: {cfg.param_count() * 2 / 1e9:.2f} GB of weights + "
          f"4 engines x 4 x 256 x {cfg.n_layers} x 2 x {cfg.n_kv_heads} x "
          f"{cfg.resolved_head_dim} x 2 B = {kv / 1e9:.2f} GB of caches)")
    med = (lambda v: float(np.median(v)) if v else float("nan"))
    for policy, r in sp["runs"].items():
        s = r["summary"]
        print(f"{tag} {r['row']}")
        print(f"{tag} {policy}: {s['n']} of {sp['n_req']} served in "
              f"{r['wall_s']:.1f} s wall (warm-ups included); TTFT mean "
              f"{s['ttft_mean'] * 1e3:.1f} ms, TPOT mean "
              f"{s['tpot_mean'] * 1e3:.2f} ms (virtual time from measured "
              f"step walls); {len(r['chunks'])} prefill chunks (median "
              f"wall {med(r['chunk_walls']) * 1e3:.2f} ms), "
              f"{len(r['decodes'])} decode steps (median "
              f"{med(r['decodes']) * 1e3:.2f} ms); peak memory "
              f"{r['peak'] / 2 ** 30:.2f} GiB; requests per instance "
              f"{dict(sorted(r['instances'].items()))}; hit tokens "
              f"{r['hit_tokens']}")
        print(f"{tag} {policy}: kernel launches {r['launches']} == "
              f"expected from {len(r['chunks'])} chunks, "
              f"{len(r['decodes'])} decode steps and 4 warm-ups")
        st = r["stalls"]
        print(f"{tag} {policy}: {sum(st.values())} decode steps ran while "
              f"a request stalled part-way through its prefill (its slot "
              f"put back after each), requests {dict(sorted(st.items()))};"
              f" the logit check serves the follow-up turn of arrival "
              f"{r['checked']} "
              f"({'stalled' if r['checked'] in st else 'not stalled'})")
        for c in r["logit_checks"]:
            print(f"{tag} {policy}: engine (hit {c['hit']} tokens) vs plain "
                  f"full forward, {c['dtype']}, step {c['step']}: max "
                  f"|dlogit| {c['max_abs']:.4f}, RMS ratio "
                  f"{c['rel_rms']:.4f}, argmax equal {c['argmax_equal']} "
                  f"(tolerance {c['tol'][0]}, {c['tol'][1]})")


def serve_cli(timeout=600):
    """Phase 20c: ``python -m repro_torch.launch.serve --arch qwen3_4b
    --policy lmetric`` (the smoke config, as the reference launcher
    serves) in a subprocess on the card: exit 0 and a row of 40 finished
    requests (its ``--dry-run`` is phase 21d's).  Returns (row, wall s)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           SERVE_ARCH, "--policy", "lmetric"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    if r.returncode != 0 or not lines or \
            not lines[-1].startswith("lmetric") or \
            f"n={SERVE_REQUESTS:>6}" not in lines[-1]:
        raise AssertionError(f"{' '.join(cmd[1:])}: exit {r.returncode}, "
                             f"stdout {r.stdout[-2000:]!r}, stderr "
                             f"{r.stderr[-2000:]!r}")
    return lines[-1], wall


def layout_check():
    """Phase 20d: for every assigned arch x input shape at full size
    (``resolve_arch_for_shape``; ``input_specs`` and
    ``Model.abstract_params`` on ``meta``, nothing allocated),
    ``model_flops`` and ``analytic_flops``; every parameter spec of
    ``param_shardings`` and every decode-cache spec of
    ``cache_shardings`` on the 16 x 16 and 2 x 16 x 16 production meshes
    divides its dims.  Returns the rows and the count of specs held."""
    from repro_torch.configs import ASSIGNED_ARCHS, get_config
    from repro_torch.launch import mesh as lm, sharding as ls
    from repro_torch.launch.shapes import (INPUT_SHAPES, analytic_flops,
                                           input_specs, model_flops,
                                           resolve_arch_for_shape)
    from repro_torch.models import Model
    rows, held = [], 0

    def divides(tree, shard, mesh):
        n = 0
        for leaf, s in zip(_leaves(tree), _leaves(shard)):
            for dim, ax in zip(leaf.shape, s.spec):
                axes = () if ax is None else (ax,) if isinstance(ax, str) \
                    else ax
                size = int(np.prod([mesh.shape[a] for a in axes]))
                if dim % size:
                    raise AssertionError(f"spec {s.spec} does not divide "
                                         f"{tuple(leaf.shape)}")
            n += 1
        return n

    for arch in ASSIGNED_ARCHS:
        base = get_config(arch)
        for shape in INPUT_SHAPES:
            cfg, skip = resolve_arch_for_shape(base, shape)
            if skip:
                rows.append((arch, shape, None, None, skip))
                continue
            rows.append((arch, shape, model_flops(cfg, shape),
                         analytic_flops(cfg, shape), cfg.name))
            specs = input_specs(cfg, shape)
            if any(t.device.type != "meta" for t in _leaves(
                    {k: v for k, v in specs.items() if k != "kind"})):
                raise AssertionError(f"{arch} {shape}: a spec was allocated")
            for multi in (False, True):
                mesh = lm.make_production_mesh(multi_pod=multi)
                axes = lm.fsdp_axes(multi)
                if specs["kind"] == "decode":
                    held += divides(specs["cache"], ls.cache_shardings(
                        specs["cache"], mesh, axes), mesh)
        params = Model(base, device="meta").abstract_params()
        for multi in (False, True):
            mesh = lm.make_production_mesh(multi_pod=multi)
            held += divides(params, ls.param_shardings(
                params, mesh, lm.fsdp_axes(multi)), mesh)
    return rows, held


def report_layout(gpu, rows, held):
    """Print phase 20d's FLOP table."""
    for arch, shape, mf, af, note in rows:
        if mf is None:
            print(f"[{gpu}] layout {arch} {shape}: skipped ({note})")
            continue
        print(f"[{gpu}] layout {arch} {shape} ({note}): model_flops "
              f"{mf:.6g}, analytic_flops {af:.6g} (FLOP per step)")
    print(f"[{gpu}] layout: {held} parameter and cache specs on the 16 x 16 "
          f"and 2 x 16 x 16 meshes divide their dims (10 assigned archs at "
          f"full size on meta)")


def launcher_phase(torch, gpu, t_start):
    """Phase 20, printed as it runs; returns the kernels' worst errors and
    ``serve_path``'s numbers.  Its request count is cut past
    ``SERVE_CUT_AFTER_S`` after ``t_start``."""
    t0 = time.perf_counter()
    s_err, report = check_serve_attention(torch)
    for line in report:
        print(f"[{gpu}] kernel vs plain: {line}")
    print(f"[{gpu}] attention kernels at the launcher's shapes vs plain "
          f"(tolerance {ATTN_TOL}): ok, {time.perf_counter() - t0:.1f} s")
    n_serve = SERVE_REQUESTS
    if time.perf_counter() - t_start > SERVE_CUT_AFTER_S:
        n_serve = SERVE_CUT_REQUESTS
        print(f"launcher: cut from {SERVE_REQUESTS} to {n_serve} requests a "
              f"policy to stay within the time limit (width and depth "
              f"unchanged)")
    t0 = time.perf_counter()
    sp = serve_path(torch, n_req=n_serve)
    gc.collect()
    torch.cuda.empty_cache()
    report_serve(gpu, sp)
    print(f"[{gpu}] launcher {SERVE_ARCH}: {time.perf_counter() - t0:.1f} s")
    row, cli_wall = serve_cli()
    print(f"[{gpu}] python -m repro_torch.launch.serve --arch {SERVE_ARCH} "
          f"--policy lmetric (the smoke config, as the reference serves): "
          f"exit 0 in {cli_wall:.1f} s: {row}")
    t0 = time.perf_counter()
    rows, held = layout_check()
    report_layout(gpu, rows, held)
    print(f"[{gpu}] layout: {time.perf_counter() - t0:.1f} s")
    return s_err, sp


# ---------------------------------------------------------------------------
# the dry run, the roofline and the card check (phase 21)
# ---------------------------------------------------------------------------
#: phase 21b: the launchers' arch at full width and depth on one card, a
#: decode step of DRYRUN_DECODE (batch, cache rows: decode_32k's sequence,
#: its batch of 128 cut to fit 80 GB) and a prefill of DRYRUN_PREFILL
#: (prefill_32k's sequence, batch 1); (warm-up, timed) runs of each, the
#: prefill (~37 s a step) timed in its profiled step
DRYRUN_ARCH = "qwen3_4b"
DRYRUN_DECODE, DRYRUN_PREFILL = (8, 32768), (1, 32768)
DRYRUN_DECODE_RUNS, DRYRUN_PREFILL_RUNS = (2, 5), (1, 0)


def dryrun_sweep():
    """Phase 21a: ``launch.dryrun.run_one`` (not saved) for the 10
    assigned archs x 4 input shapes x the 16 x 16 and 2 x 16 x 16 meshes:
    80 records, every one ``ok``, Whisper x long_500k the reference's
    documented skip and no other.  Returns the records."""
    from repro_torch.configs import ASSIGNED_ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import INPUT_SHAPES
    recs = [dryrun.run_one(a, s, multi_pod=m, save=False)
            for m in (False, True) for a in ASSIGNED_ARCHS
            for s in INPUT_SHAPES]
    bad = [(r["arch"], r["shape"], r["mesh"], r.get("error")) for r in recs
           if not r["ok"]]
    skips = [(r["arch"], r["shape"]) for r in recs if r.get("skipped")]
    if len(recs) != 80 or bad or \
            skips != [("whisper_medium", "long_500k")] * 2:
        raise AssertionError(f"dry-run sweep: {len(recs)} records, failed "
                             f"{bad}, skipped {skips}")
    return recs


def report_sweep(gpu, recs):
    """Print phase 21a's records: per-card peak bytes, the three roofline
    terms and the dominant one."""
    for r in recs:
        key = f"{r['arch']} {r['shape']} {r['mesh']}"
        if r.get("skipped"):
            print(f"[{gpu}] dry run {key}: skipped ({r['skipped']})")
            continue
        t = r["roofline"]
        print(f"[{gpu}] dry run {key}: peak {r['memory']['peak_bytes']} B "
              f"a card, t_compute {t['t_compute'] * 1e3:.4g} ms, t_memory "
              f"{t['t_memory'] * 1e3:.4g} ms, t_collective "
              f"{t['t_collective'] * 1e3:.4g} ms -> {r['dominant']}")


def dryrun_card(torch):
    """Phase 21b: ``launch.dryrun.card_check`` of ``DRYRUN_ARCH`` at full
    width and depth on the card: a decode step over DRYRUN_DECODE (every
    counter zeroed just before, read just after: one ``paged_attention``
    launch per attention layer and run, and as many in the profiled
    step's trace), then, the decode state freed, a prefill of
    DRYRUN_PREFILL (plain attention: no kernel launches).  Returns
    (decode record, prefill record, decode launches)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import card_check
    cfg = get_config(DRYRUN_ARCH)
    n_attn = sum(k in ("attn", "swa", "xattn") for k in cfg.block_pattern)
    B, S = DRYRUN_DECODE
    warm, reps = DRYRUN_DECODE_RUNS
    _zero_launches()
    dec = card_check(cfg, "decode", S, B, warmup=warm, reps=reps)
    launches = _kernel_launches()
    runs = warm + reps + 1
    traced = dec["measured"]["trace"]["launches"]["paged_attention"]
    if launches["paged_attention"] != n_attn * runs or traced != n_attn or \
            sum(launches.values()) != launches["paged_attention"]:
        raise AssertionError(f"decode card check: launches {launches} over "
                             f"{runs} steps, {traced} traced in one; "
                             f"expected {n_attn} paged_attention a step")
    gc.collect()
    torch.cuda.empty_cache()
    B, S = DRYRUN_PREFILL
    warm, reps = DRYRUN_PREFILL_RUNS
    _zero_launches()
    pre = card_check(cfg, "prefill", S, B, warmup=warm, reps=reps)
    if any(_kernel_launches().values()):
        raise AssertionError(f"the plain prefill launched kernels: "
                             f"{_kernel_launches()}")
    gc.collect()
    torch.cuda.empty_cache()
    return dec, pre, launches["paged_attention"]


def report_card(gpu, rec):
    """Print one card check (phase 21b)."""
    tag = f"[{gpu}] card check {rec['arch']} {rec['shape']}"
    b, mem, p = rec["bytes"], rec["memory"], rec["placed"]
    t, m, tr = rec["roofline"], rec["measured"], rec["measured"]["trace"]
    print(f"{tag}: reckoned per card: params {b['params']} B + cache "
          f"{b['cache']} + inputs {b['inputs']} = argument_bytes "
          f"{mem['argument_bytes']} ({mem['argument_bytes'] / 1e9:.2f} GB), "
          f"output_bytes {mem['output_bytes']}, alias_bytes "
          f"{mem['alias_bytes']}")
    print(f"{tag}: placed {p['tensors']} tensors holding {p['bytes']} B == "
          f"argument_bytes; allocator grew {p['allocator_growth']} B against "
          f"{p['rounded']} B rounded up to 512 B each (+ "
          f"{p['allocator_growth'] - p['rounded']} B, under 1 MiB for each "
          f"of the {p['large_tensors']} tensors over 1 MiB)")
    print(f"{tag}: roofline t_compute {t['t_compute'] * 1e3:.4f} ms "
          f"({rec['analytic_flops']:.6g} FLOP / 989e12), t_memory "
          f"{t['t_memory'] * 1e3:.4f} ms ({rec['memory_traffic_bytes']} B / "
          f"3.35e12), t_collective {t['t_collective'] * 1e3:.4f} ms -> "
          f"{rec['dominant']}")
    runs = (f"means of {m['reps']} after {m['warmup']} warm-up"
            if m["reps"] else f"the profiled step, after {m['warmup']} "
            f"warm-up")
    print(f"{tag}: wall {m['wall_ms']:.3f} ms a step, CUDA events "
          f"{m['event_ms']:.3f} ms a step ({runs}), device "
          f"{m['device_ms']:.3f} ms in "
          f"the profiled step ({tr['device_ops']} device ops, busy "
          f"{tr['busy_share']:.1%} of its traced wall); roofline share "
          f"{rec['roofline_share']['device']:.2%} of the device time, "
          f"{rec['roofline_share']['wall']:.2%} of the wall; temp "
          f"{mem['temp_bytes']} B above the arguments, peak "
          f"{mem['peak_bytes'] / 2 ** 30:.2f} GiB")
    for cat, v in tr["categories"].items():
        if v["count"]:
            print(f"{tag}:   {cat}: {v['us'] / 1e3:.3f} ms over {v['count']}"
                  f" device ops")


def check_long_decode(torch):
    """Phase 21c: ``paged_attention`` against its plain version at the
    decode card check's shape: one layer's (8, 32768, 8, 128) cache of
    seeded K/V in 2048 pages of 16 a row, 32 q heads over 8 (G = 4), hd
    128, contexts all 32768 and ragged ones, f32 and bf16 within
    ``ATTN_TOL`` -- 8 x the engines' longest (max_len 4096)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.attention import decode_tables
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 21)
    B, S = DRYRUN_DECODE
    H, KV, hd = Q4_H, Q4_KV, Q4_HD

    def rand(shape, dtype, scale=0.5):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * scale).to(dev, dtype)

    worst, report = 0.0, []
    bt = decode_tables(B, S, dev)
    pages = (B * S // KV_BLOCK, KV_BLOCK, KV, hd)
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        # the caches drawn on the card (numpy would take seconds a cache)
        kc, vc = (torch.randn((B, S, KV, hd), generator=gen, device=dev)
                  .mul_(0.5).to(dtype) for _ in range(2))
        for ctx in ((S,) * B, (S, 1, 20000, S - 1, 4096, 16, 17, 30001)):
            q = rand((B, H, hd), dtype, ATTN_Q_SCALE[name])
            cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
            got = pa.paged_attention(q, kc.view(pages), vc.view(pages), bt,
                                     cl)
            want = pa.paged_attention_plain(q, kc.view(pages),
                                            vc.view(pages), bt, cl)
            torch.cuda.synchronize()
            splits, grid = pa.launch_config(q, kc.view(pages), bt)
            worst = max(worst, _attn_err(
                got, want, name, f"long decode {name} {H}/{KV} hd {hd} B={B}, "
                f"{S // KV_BLOCK} pages of {KV_BLOCK} a row, contexts "
                f"{list(ctx)} (splits {splits}, grid {grid})", report))
        del kc, vc
        torch.cuda.empty_cache()
    return worst, report


def dry_run_cli(timeout=300):
    """Phase 21d: both launchers' ``--dry-run`` as the user runs them, in
    two subprocesses started together: ``python -m
    repro_torch.launch.serve --dry-run`` (its default arch at decode_32k)
    and ``python -m repro_torch.launch.train --arch qwen3_4b --dry-run``
    (train_4k), each exiting 0 with its ``[dryrun] ... OK`` line and its
    record under ``results/dryrun_torch`` ``ok``.  Returns [(command,
    wall s, record path, last line)]."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    jobs = []
    for mod, args, key in (
            ("serve", [], f"{SERVE_ARCH}__decode_32k__16x16"),
            ("train", ["--arch", DRYRUN_ARCH],
             f"{DRYRUN_ARCH}__train_4k__16x16")):
        path = os.path.join(ROOT, "results", "dryrun_torch", key + ".json")
        if os.path.exists(path):
            os.remove(path)
        cmd = [sys.executable, "-m", f"repro_torch.launch.{mod}", *args,
               "--dry-run"]
        jobs.append((cmd, key, path, time.perf_counter(), subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    out = []
    try:
        for cmd, key, path, t0, proc in jobs:
            stdout, stderr = proc.communicate(timeout=timeout)
            wall = time.perf_counter() - t0
            last = (stdout.strip().splitlines() or [""])[-1]
            ok = False
            if os.path.exists(path):
                with open(path) as f:
                    ok = json.load(f).get("ok")
            if proc.returncode != 0 or not ok or \
                    not last.startswith(f"[dryrun] {key}: OK"):
                raise AssertionError(
                    f"{' '.join(cmd[1:])}: exit {proc.returncode}, record ok "
                    f"{ok}, stdout {stdout[-2000:]!r}, stderr "
                    f"{stderr[-2000:]!r}")
            out.append((" ".join(cmd[1:]), wall,
                        os.path.relpath(path, ROOT), last))
    finally:
        for *_, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def dryrun_phase(torch, gpu):
    """Phase 21, printed as it runs; returns the long decode's worst
    error and the decode card check's ``paged_attention`` launches."""
    t0 = time.perf_counter()
    recs = dryrun_sweep()
    report_sweep(gpu, recs)
    print(f"[{gpu}] dry-run sweep: {len(recs)} records ok (the Whisper x "
          f"long_500k skips included), {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dec, pre, launches = dryrun_card(torch)
    for rec in (dec, pre):
        report_card(gpu, rec)
    steps = sum(DRYRUN_DECODE_RUNS) + 1
    print(f"[{gpu}] card check: paged_attention launched {launches} times "
          f"over the decode check's {steps} steps ({launches // steps} a "
          f"step), the prefill nothing; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    err, report = check_long_decode(torch)
    for line in report:
        print(f"[{gpu}] kernel vs plain: {line}")
    print(f"[{gpu}] paged_attention at the card check's decode shape vs "
          f"plain (tolerance {ATTN_TOL}): ok, "
          f"{time.perf_counter() - t0:.1f} s")
    for cmd, wall, path, last in dry_run_cli():
        print(f"[{gpu}] python {cmd}: exit 0 in {wall:.1f} s, {path} ok: "
              f"{last}")
    return err, launches


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
    for line in ptxas_summary(_build.PTXAS):
        print(f"ptxas: {line}")
    for line in sass_summary(("prefill_attention", "paged_attention",
                              "mlstm_cell")):
        print(f"sass: {line}")
    for k, n in SHAPES + [(9, SIM_INSTANCES), (28, PD_PREFILL)]:
        c, threads, ipt = rs.launch_plan(k, n)
        print(f"route_score plan at k={k}, n={n}: " + (
            "one warp (route_warp)" if n <= rs.WARP_MAX else
            f"route_cluster, cluster of {c} CTA(s) x {threads} threads x "
            f"{ipt} instance(s) per thread"
            + (f" ({min(ipt, rs.REG_IPT)} in registers, the rest in "
               f"global scratch)" if ipt > rs.REG_IPT else "")))
    if "--profile" in sys.argv[1:]:
        for arch in ("qwen2_7b", "recurrentgemma_9b", "xlstm_350m") \
                + MOE_ARCHS:
            profile_steps(torch, gpu, arch)
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
    print(f"[{gpu}] route_score kernel: {tw['device_ms'] * 1e3:.1f} us "
          f"device per wave with cold inputs, "
          f"{tw['device_warm_ms'] * 1e3:.1f} warm (profiler); per step "
          f"{tw['device_ms'] * 1e3 / tw['k']:.3f} cold, "
          f"{tw['device_warm_ms'] * 1e3 / tw['k']:.3f} warm; "
          f"{tw['kernel_ms'] * 1e3:.1f} us per wave in CUDA events around "
          f"back-to-back launches ({tw['kind']}{tw['params']}, k={tw['k']}, "
          f"n={tw['n']}, 1 launch, plan {rs.launch_plan(tw['k'], tw['n'])});"
          f" byte bound {tw['bound_ms'] * 1e3:.2f} us per wave")
    print(f"[{gpu}] score stage, same wave, warm (median of 10): "
          f"{tw['stage_ms'] * 1e3:.1f} us = submit (pack aux and depth "
          f"into pinned memory, one upload, launch, one copy back) "
          f"{tw['submit_ms'] * 1e3:.1f} + collect (wait, copy out) "
          f"{tw['collect_ms'] * 1e3:.1f} us (medians)")
    print(f"[{gpu}] plain PyTorch version, same wave: "
          f"{tw['plain_ms'] * 1e3:.1f} us")
    print(f"[{gpu}] bound: {tw['bytes']} bytes / {HBM_BYTES_PER_S:.3g} B/s"
          f" vs {tw['flops']} f64 ops / {FP64_OPS_PER_S:.3g} op/s -> "
          f"{tw['bound_ms'] * 1e3:.2f} us ({tw['bound_by']})")
    print(f"[{gpu}] library: no single PyTorch call computes this "
          f"function (library_ms null)")
    for name, t in time_route_kernels(torch, rs).items():
        report_route_timing(gpu, name, t)
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
        print(f"[{gpu}] attention kernel vs plain: {line}")
    print(f"[{gpu}] attention kernels vs plain (tolerance {ATTN_TOL}): ok,"
          f" {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()

    # ---- phases 8-9: recurrent kernels and hd 256 attention vs plain --
    t0 = time.perf_counter()
    rec_err, report = check_recurrent(torch)
    hd256_err, report2 = check_attention_hd256(torch)
    for line in report + report2:
        print(f"[{gpu}] kernel vs plain: {line}")
    print(f"[{gpu}] recurrent kernels (tolerance {REC_TOL}) and hd-256 "
          f"attention (tolerance {ATTN_TOL}) vs plain: ok, "
          f"{time.perf_counter() - t0:.1f} s")
    for name, err in hd256_err.items():
        attn_err[name] = max(attn_err[name], err)

    # ---- phases 6, 10, 11: the serving paths --------------------------
    # the Qwen2-7B path's depth is cut first if the run nears its limit
    qwen_layers = None
    if time.perf_counter() - t_start > QWEN_CUT_AFTER_S:
        qwen_layers = QWEN_CUT_LAYERS
        print(f"serving: Qwen2-7B cut from 28 to {qwen_layers} layers to "
              f"stay within the time limit (width unchanged)")
    served = {}
    for arch, layers in (("qwen2_7b", qwen_layers),
                         ("recurrentgemma_9b", None), ("xlstm_350m", None)):
        sv = serving_path(torch, arch, n_layers=layers)
        # free the model before the next is loaded: the engines' logged
        # steps are reference cycles, which only a collection frees
        gc.collect()
        torch.cuda.empty_cache()
        report_serving(gpu, sv)
        served[arch] = sv

    # ---- phases 7 and 12: kernel timings at the serving shapes -------
    ta = time_attention(torch)
    for name, t in ta.items():
        report_attention_timing(gpu, name, t)
    tr = time_recurrent(torch)
    for name, t in tr.items():
        if name.endswith("hd 256"):
            report_attention_timing(gpu, name, t)
            continue
        report_recurrent_timing(gpu, name, t)

    # ---- phase 13: the cluster simulation ----------------------------
    # free the main path's 16384-instance routers (millions of host
    # objects) first, so that the simulator's host walls do not pay for
    # collecting them; phase 14 keeps their decisions and hit tokens
    want = {k: {"decisions": v["decisions"], "hits": v["hits"]}
            for k, v in results.items()}
    del results, lm, r
    gc.collect()
    t0 = time.perf_counter()
    n_new = SIM_REQUESTS
    if time.perf_counter() - t_start > SIM_CUT_AFTER_S:
        n_new = SIM_CUT_REQUESTS
        print(f"simulation: the comparison runs cut from {SIM_REQUESTS} to "
              f"{n_new} requests each to stay within the time limit "
              f"(instances stay {SIM_INSTANCES})")
    sim = sim_path(n_new=n_new)
    wave = sim_wave_time(torch, rs, *sim["timing"])
    steps = sim_step_times(torch, sim["spec"], served)
    report_sim(gpu, sim, steps, wave)
    print(f"[{gpu}] simulation: {sim['wall']:.1f} s for the runs, "
          f"{time.perf_counter() - t0:.1f} s with the step timing")

    # ---- phase 14: sharded routing -----------------------------------
    n_req14 = n_req
    if time.perf_counter() - t_start > SHARD_CUT_AFTER_S:
        n_req14 = min(n_req, SHARD_CUT_REQUESTS)
        print(f"sharded routing: cut from {n_req} to {n_req14} requests "
              f"to stay within the time limit (instances stay {N_INST})")
    t0 = time.perf_counter()
    want = {k: {"decisions": v["decisions"][:n_req14],
                "hits": v["hits"][:n_req14]} for k, v in want.items()}
    shards = shard_phase("cuda", N_INST, n_req14, trace, want, sim)
    mirror = time_mirror(torch, backlog(trace, N_INST))
    report_shards(gpu, shards, mirror)
    print(f"[{gpu}] sharded routing: {time.perf_counter() - t0:.1f} s")

    # ---- phase 15: the control plane ---------------------------------
    cl_cut = 1.0
    if time.perf_counter() - t_start > CL_CUT_AFTER_S:
        cl_cut = CL_CUT
        print(f"control plane: the closed loop's sessions cut to "
              f"{cl_cut:g} x to stay within the time limit (instances "
              f"stay {SIM_INSTANCES})")
    t0 = time.perf_counter()
    ctrl = control_path(sim, "cuda", cl_cut=cl_cut)
    report_control(gpu, ctrl)
    print(f"[{gpu}] control plane: {time.perf_counter() - t0:.1f} s")

    # ---- phase 16: MoE serving -----------------------------------------
    for arch in MOE_ARCHS:
        n_moe = None
        if arch != "qwen3_30b_moe" and \
                time.perf_counter() - t_start > MOE_CUT_AFTER_S:
            n_moe = MOE_CUT_REQUESTS
            print(f"MoE serving: {arch} cut to {n_moe} requests to stay "
                  f"within the time limit (width and depth unchanged)")
        t0 = time.perf_counter()
        sv = serving_path(torch, arch, n_req=n_moe)
        gc.collect()
        torch.cuda.empty_cache()
        report_serving(gpu, sv)
        print(f"[{gpu}] MoE serving {arch}: {time.perf_counter() - t0:.1f} s")
        served[arch] = sv

    # ---- phase 17: both attention kernels at Whisper's shapes ---------
    t0 = time.perf_counter()
    w_err, report = check_whisper_attention(torch)
    for line in report:
        print(f"[{gpu}] kernel vs plain: {line}")
    print(f"[{gpu}] attention kernels at Whisper's shapes vs plain "
          f"(tolerance {ATTN_TOL}): ok, {time.perf_counter() - t0:.1f} s")
    for name, err in w_err.items():
        attn_err[name] = max(attn_err[name], err)
    w_time = time_whisper(torch)

    # ---- phase 18: Whisper-medium at full width and depth -------------
    clips = W_CLIPS
    if time.perf_counter() - t_start > WHISPER_CUT_AFTER_S:
        clips = WHISPER_CUT_CLIPS
        print(f"whisper: cut from {W_CLIPS} to {clips} clips to stay within "
              f"the time limit (width and depth unchanged)")
    t0 = time.perf_counter()
    wp = whisper_path(torch, n_clips=clips)
    gc.collect()
    torch.cuda.empty_cache()
    report_whisper(gpu, wp, w_time)
    print(f"[{gpu}] whisper: {time.perf_counter() - t0:.1f} s")

    # ---- phase 19: training Qwen3-4B at full width and depth ----------
    steps = TRAIN_STEPS
    if time.perf_counter() - t_start > TRAIN_CUT_AFTER_S:
        steps = TRAIN_CUT_STEPS
        print(f"training: cut from {TRAIN_STEPS} to {steps} steps to stay "
              f"within the time limit (width and depth unchanged)")
    t0 = time.perf_counter()
    tp = train_path(torch, None, n_steps=steps)
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    try:
        ck = train_path(torch, ckpt_dir, n_steps=steps,
                        n_layers=TRAIN_CKPT_LAYERS)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    cut = train_cut_check(torch)
    report_train(gpu, tp, cut, ck)
    print(f"[{gpu}] training: {time.perf_counter() - t0:.1f} s")

    # ---- phase 20: the serving launcher and the layout modules --------
    s_err, sp = launcher_phase(torch, gpu, t_start)
    for name, err in s_err.items():
        attn_err[name] = max(attn_err[name], err)

    # ---- phase 21: the dry run, the roofline and the card check -------
    t0 = time.perf_counter()
    d_err, d_launches = dryrun_phase(torch, gpu)
    attn_err["paged_attention"] = max(attn_err["paged_attention"], d_err)
    print(f"[{gpu}] dry run and card check: {time.perf_counter() - t0:.1f} s")
    print(f"total {time.perf_counter() - t_start:.1f} s")

    pre_t = ta[f"prefill Sq={CHUNK} off={SYS_PREFIX}"]
    dec_t = ta["decode"]
    record = {"kernels": [{
        "name": "route_score", "route": "cuda",
        "source": "src/repro_torch/csrc/route_score.cu",
        "replaces": "src/repro/kernels/route_score.py:218",
        "launches": (launches + sim["launches"] + shards["launches"]
                     + ctrl["launches"]),
        "max_abs_err": max(worst, tw["max_abs_err"]),
        "ms": tw["device_ms"], "plain_ms": tw["plain_ms"],
        "bound_ms": tw["bound_ms"], "bound_by": tw["bound_by"],
        "library_ms": None}]}
    # the attention kernels' launches are those of every serving path
    # that runs them; their times are device times per launch at
    # Qwen2-7B's shapes (decode with cold K/V; hd 256 above), their SDPA
    # times measured the same way
    for name, t, line in (("prefill_attention", pre_t, 28),
                          ("paged_attention", dec_t, 29),
                          ("rglru_scan", tr["rglru_scan"], 25),
                          ("mlstm_cell", tr["mlstm_cell"], 25)):
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{name}.py:{line}",
            "launches": sum(sv["launches"][name] for sv in served.values())
            + wp["launches"].get(name, 0)
            + sum(r["launches"][name] for r in sp["runs"].values())
            + (d_launches if name == "paged_attention" else 0),
            "max_abs_err": {**attn_err, **rec_err}[name], "ms": t["ms"],
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
