"""Dry run of the production step for every (arch x input shape x mesh):
per-card bytes, collectives and the roofline at H100 rates — port of
``repro.launch.dryrun``.

The reference lowers and compiles each jitted step through XLA on a
fake 512-device host mesh and reads ``memory_analysis()``,
``cost_analysis()`` and the compiled HLO.  The port has no compiler to
ask, so it reckons the same record from the step's own trees:

* ``build_step`` (the counterpart of ``build_lowered``) builds, on
  ``meta`` tensors (nothing allocated), what the step takes and returns:
  ``Model.abstract_params()``, the AdamW state for train,
  ``input_specs``, and the four sharding trees of ``launch.sharding``
  (``param_shardings``, ``opt_shardings``, ``cache_shardings``,
  ``batch_shardings``) on ``make_production_mesh``.  The steps are the
  reference's: ``make_train_step`` (4 micro-batches above 3e10
  parameters), ``Model.prefill(..., last_only=True)`` and
  ``Model.decode_step`` (``step_fn``).
* Per-card bytes (``reckon``): each leaf's bytes divided by the product
  of the mesh axes its spec shards over.  ``memory`` keeps the
  reference's keys: ``argument_bytes`` and ``output_bytes`` of the step,
  ``alias_bytes`` what the step writes in place (the reference's
  donation: parameters and optimizer state for train, the cache for
  decode), ``temp_bytes`` None (nothing ran) and ``peak_bytes`` =
  argument + output - alias (+ temp where measured).  A prefill's output
  cache is ``Model.prefill``'s: (B, S) attention caches, a ``swa``
  ring of ``window`` rows, Whisper's cross K/V of ``enc_seq`` rows.
  Output logits and every activation shard their batch as the batch.
* Collectives, reckoned from the specs (no collective runs), with
  ``hlo._wire_bytes``'s ring factors; ``size`` is an op's result bytes
  on one card, as in the reference's HLO:

  - all-gather over the FSDP group of every FSDP-sharded parameter,
    ``size`` = its shard x the group: once per step for inference, twice
    for train (forward and backward; micro-batches are not counted
    apart);
  - train only: a reduce-scatter of its gradient over the same group,
    ``size`` = the shard;
  - one all-reduce over the ``model`` group of a block's output
    activations, ``size`` = B / (batch shards) x S x D x the dtype's
    bytes, for every block whose output projection's spec names
    ``model``: attention (``attn/wo``), cross-attention (``attn/xwo``),
    FFN and MoE (``ffn/wo``; Arctic's residual ``ffn/dense/wo`` joins
    its block's), the recurrent mixers (``rglru/wo``, ``mlstm/down``)
    and Whisper's encoder layers (S = ``enc_seq``; not run by decode).
    S is 1 for decode; train has twice as many (forward and backward).
    The sLSTM block has no row-parallel output and is not counted, nor
    are the softmax statistics of a sequence-sharded cache.

* ``roofline_terms`` at the H100 SXM data sheet's rates (700 W):
  989e12 FLOP/s dense bf16, 3.35e12 B/s HBM3, NVLink 4 at 450e9 B/s a
  direction inside a node of 8 cards and 50e9 B/s a card between nodes
  (one 400 Gb/s InfiniBand port).  Cards are numbered row-major over
  the mesh, ``model`` innermost, so a ``model`` group of 16 spans two
  nodes and every FSDP group one card in each of 16 or 32: on the
  production meshes every collective crosses the network.  ``t_memory``
  is the floor of reading every argument once and writing every output
  once (``memory_traffic_bytes``): an output the step writes in place
  counts the bytes it changes — all of train's parameters and moments,
  but of a decode cache one row per attention cache, the recurrent
  states whole and the cross caches not at all.  It is not the
  reference's estimate of 2 x the result bytes of every HLO op.
  ``flops_per_device``, ``dominant`` and ``useful_flops_ratio`` are the
  reference's: ``analytic_flops`` over the cards.

``card_check`` is the counterpart of the reference's mini-mesh lower and
compile (``tests/test_sharding_dryrun.py``) on the one real device the
port has (``make_smoke_mesh``, 1 x 1): it places the step's inputs for
real, runs the step and measures it.

Records go to ``results/dryrun_torch/<arch>__<shape>__<mesh><tag>.json``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_4b \\
      --shape decode_32k [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import time
import traceback
from contextlib import nullcontext
from itertools import product
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import ASSIGNED_ARCHS, get_config
from ..models import Model
from ..training.optim import OptimizerConfig, adamw_init, leaves
from . import hlo
from .mesh import Mesh, fsdp_axes, make_production_mesh, make_smoke_mesh
from .shapes import (INPUT_SHAPES, analytic_flops_at, input_specs_at,
                     model_flops_at, resolve_arch_for_shape)
from .sharding import (Sharding, _div, _map, batch_shardings,
                       cache_shardings, opt_shardings, param_shardings)

# NVIDIA H100 SXM data sheet, at the 700 W power limit
PEAK_FLOPS = 989e12          # dense bf16 on the tensor cores
HBM_BW = 3.35e12             # HBM3
NVLINK_BW = 450e9            # NVLink 4, one direction, a card, in a node
NET_BW = 50e9                # one 400 Gb/s InfiniBand port a card
CARDS_PER_NODE = 8

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

#: what the train step returns beside the state, each a float32 scalar
TRAIN_METRICS = ("loss", "ce", "aux", "zloss", "tokens", "grad_norm")
#: a block's output projection: one all-reduce where its spec names model
_OUT_PROJ = re.compile(r"/(wo|xwo|down)/w$")


class Step(NamedTuple):
    """One step as the dry run sees it: ``args`` and ``outputs`` are
    named ``meta`` trees in the step's order, each with its sharding
    tree; ``aliased`` names the arguments the step writes in place."""
    kind: str
    cfg: Any
    seq: int
    batch: int
    mesh: Mesh
    fsdp: Tuple[str, ...]
    accum: int
    remat: bool
    args: Dict[str, Any]
    in_shardings: Dict[str, Any]
    outputs: Dict[str, Any]
    out_shardings: Dict[str, Any]
    aliased: Tuple[str, ...]


def opt_config(cfg) -> OptimizerConfig:
    """The reference dry run's optimizer: defaults, moments in the
    config's ``opt_state_dtype``."""
    return OptimizerConfig(moment_dtype=cfg.opt_state_dtype)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _prefill_cache(cfg, B: int, S: int):
    """``meta`` tree of the cache ``Model.prefill`` returns for (B, S)."""
    cache = Model(cfg, device="meta").init_cache(B, S)
    dtype = getattr(torch, cfg.dtype)
    for entry, kind in zip(cache, cfg.block_pattern):
        rows = {"swa": cfg.window_size, "xattn": S}.get(kind)
        if rows is None:
            continue
        for n in ("k", "v"):
            entry[n] = _meta((B, rows) + tuple(entry[n].shape[2:]), dtype)
        for n in ("xk", "xv") if kind == "xattn" else ():
            entry[n] = _meta((B, cfg.enc_seq) + tuple(entry[n].shape[2:]),
                             dtype)
    return cache


def build(cfg, kind: str, seq: int, batch: int, mesh: Mesh,
          fsdp: Tuple[str, ...], remat: bool = True) -> Step:
    """The ``Step`` of (kind, seq, batch) for ``cfg`` on ``mesh``; ``fsdp``
    shards parameters and batches (the reference's ``batch_axes``)."""
    specs = input_specs_at(cfg, kind, seq, batch)
    params = Model(cfg, device="meta").abstract_params()
    pshard = param_shardings(params, mesh, fsdp)
    args, ins = {"params": params}, {"params": pshard}
    accum = 1
    if kind == "train":
        opt = adamw_init(params, opt_config(cfg))
        args["opt_state"] = opt
        ins["opt_state"] = opt_shardings(opt, pshard, mesh)
        args["batch"] = specs["batch"]
        ins["batch"] = batch_shardings(specs["batch"], mesh, fsdp)
        accum = 4 if cfg.param_count() > 3e10 else 1
        metrics = {k: _meta((), torch.float32) for k in TRAIN_METRICS}
        outs = {"params": params, "opt_state": opt, "metrics": metrics}
        out_sh = {"params": pshard, "opt_state": ins["opt_state"],
                  "metrics": _map(lambda *_: Sharding(mesh, ()), metrics)}
        aliased = ("params", "opt_state")
    elif kind == "prefill":
        args["batch"] = specs["batch"]
        ins["batch"] = batch_shardings(specs["batch"], mesh, fsdp)
        logits = _meta((batch, cfg.vocab_size), torch.float32)
        cache = _prefill_cache(cfg, batch, seq)
        outs = {"logits": logits, "cache": cache}
        out_sh = {"logits": batch_shardings(logits, mesh, fsdp),
                  "cache": cache_shardings(cache, mesh, fsdp)}
        aliased = ()
    else:
        for k in ("token", "pos", "cache"):
            args[k] = specs[k]
        ins.update(batch_shardings({"token": specs["token"],
                                    "pos": specs["pos"]}, mesh, fsdp))
        ins["cache"] = cache_shardings(specs["cache"], mesh, fsdp)
        logits = _meta((batch, 1, cfg.vocab_size), torch.float32)
        outs = {"logits": logits, "cache": specs["cache"]}
        out_sh = {"logits": batch_shardings(logits, mesh, fsdp),
                  "cache": ins["cache"]}
        aliased = ("cache",)
    return Step(kind, cfg, seq, batch, mesh, tuple(fsdp), accum, remat,
                args, ins, outs, out_sh, aliased)


def build_step(arch: str, shape_name: str, multi_pod: bool,
               remat: bool = True):
    """The counterpart of the reference's ``build_lowered``: (``Step``,
    skip reason, config) for one assigned (arch, shape) on the production
    mesh; the step is None where the shape skips the arch."""
    cfg, skip = resolve_arch_for_shape(get_config(arch), shape_name)
    if skip:
        return None, skip, cfg
    mesh = make_production_mesh(multi_pod=multi_pod)
    return build(cfg, **INPUT_SHAPES[shape_name], mesh=mesh,
                 fsdp=fsdp_axes(multi_pod), remat=remat), None, cfg


def step_fn(step: Step, model: Model, device):
    """The callable the step is, on ``model``'s real tensors, taking
    ``step.args``' entries in order."""
    if step.kind == "train":
        from ..training.train_loop import make_train_step
        return make_train_step(model, opt_config(step.cfg), remat=step.remat,
                               accum_steps=step.accum, device=device)
    if step.kind == "prefill":
        def prefill(params, batch):
            logits, cache = model.prefill(params, batch["tokens"], batch,
                                          last_only=True)
            return logits[:, 0], cache
        return prefill
    return model.decode_step


# ---------------------------------------------------------------------------
# reckoning
# ---------------------------------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def spec_axes(spec) -> Tuple[str, ...]:
    """The mesh axes a spec shards over."""
    return tuple(a for e in spec for a in _axes(e))


def group_size(mesh: Mesh, axes) -> int:
    return int(np.prod([mesh.shape[a] for a in axes], dtype=np.int64))


def nbytes(t) -> int:
    """A tensor's bytes (0 for a host value such as AdamW's step)."""
    if not isinstance(t, torch.Tensor):
        return 0
    return t.numel() * hlo.DTYPE_BYTES[t.dtype]


def per_card(tree, shardings) -> int:
    """Bytes of ``tree`` on one card under ``shardings``."""
    total = 0
    for t, sh in zip(leaves(tree), leaves(shardings)):
        n, f = nbytes(t), group_size(sh.mesh, spec_axes(sh.spec))
        if n % f:
            raise ValueError(f"spec {sh.spec} does not divide {t.shape}")
        total += n // f
    return total


def link_rate(mesh: Mesh, axes) -> float:
    """B/s a card sends over the links of a group of ``axes``: NVLink if
    the group lies in one node of ``CARDS_PER_NODE`` cards (numbered
    row-major over the mesh, the last axis innermost), else the network."""
    names = mesh.axis_names
    strides = {a: group_size(mesh, names[i + 1:]) for i, a in
               enumerate(names)}
    members = [sum(i * strides[a] for a, i in zip(axes, idx))
               for idx in product(*(range(mesh.shape[a]) for a in axes))]
    return NVLINK_BW if len({m // CARDS_PER_NODE for m in members}) == 1 \
        else NET_BW


def _paths(tree, shardings):
    """(path, leaf, sharding) over a tree and its shardings."""
    out = []
    _map(lambda p, t: out.append((p, t)), tree)
    return [(p, t, s) for (p, t), s in zip(out, leaves(shardings))]


def collective_ops(step: Step):
    """The step's collectives as (op, result bytes on one card, group
    axes), by the rules of the module docstring."""
    mesh, train = step.mesh, step.kind == "train"
    ops = []
    for path, t, sh in _paths(step.args["params"],
                              step.in_shardings["params"]):
        axes = spec_axes(sh.spec)
        group = tuple(a for a in step.fsdp if a in axes)
        if group:
            shard = nbytes(t) // group_size(mesh, axes)
            gathered = shard * group_size(mesh, group)
            ops += [("all-gather", gathered, group)] * (2 if train else 1)
            if train:
                ops.append(("reduce-scatter", shard, group))
        if not _OUT_PROJ.search(path) or "/dense/" in path or \
                "model" not in axes:
            continue
        encoder = path.startswith("encoder/")
        if encoder and step.kind == "decode":
            continue
        S = 1 if step.kind == "decode" else \
            step.cfg.enc_seq if encoder else step.seq
        b_ax = _div(step.batch, mesh, step.fsdp)
        B = step.batch // group_size(mesh, _axes(b_ax))
        act = B * S * t.shape[-1] * hlo.DTYPE_BYTES[t.dtype]
        ops += [("all-reduce", act, ("model",))] * (2 if train else 1)
    return ops


def _written(step: Step) -> int:
    """Bytes on one card the step writes (see ``t_memory`` above)."""
    if step.kind != "decode":
        return sum(per_card(step.outputs[k], step.out_shardings[k])
                   for k in step.outputs)
    total = per_card(step.outputs["logits"], step.out_shardings["logits"])
    for path, t, sh in _paths(step.outputs["cache"],
                              step.out_shardings["cache"]):
        name = path.rsplit("/", 1)[-1]
        if name in ("xk", "xv"):
            continue
        n = nbytes(t) // group_size(step.mesh, spec_axes(sh.spec))
        total += n // t.shape[1] if name in ("k", "v") else n
    return total


def roofline_terms(flops, bytes_acc, coll_s):
    """Three per-card roofline terms in seconds: ``flops`` and
    ``bytes_acc`` per card at the peak rates, ``coll_s`` already summed
    over the collectives at their links' rates."""
    return {"t_compute": flops / PEAK_FLOPS, "t_memory": bytes_acc / HBM_BW,
            "t_collective": coll_s}


def reckon(step: Step) -> Dict:
    """The dry run's record of ``step`` (no device work)."""
    cfg, mesh = step.cfg, step.mesh
    n_dev = group_size(mesh, mesh.axis_names)
    card = {k: per_card(step.args[k], step.in_shardings[k])
            for k in step.args}
    out = {k: per_card(step.outputs[k], step.out_shardings[k])
           for k in step.outputs}
    arg, res = sum(card.values()), sum(out.values())
    alias = sum(card[k] for k in step.aliased)
    ops = collective_ops(step)
    wire = {k: 0.0 for k in hlo.COLLECTIVES}
    counts = {k: 0 for k in hlo.COLLECTIVES}
    coll_s = 0.0
    for op, size, group in ops:
        w = hlo._wire_bytes(op, size, group_size(mesh, group))
        wire[op] += w
        counts[op] += 1
        coll_s += w / link_rate(mesh, group)
    mf = model_flops_at(cfg, step.kind, step.seq, step.batch)
    af = analytic_flops_at(cfg, step.kind, step.seq, step.batch)
    traffic = arg + _written(step)
    terms = roofline_terms(af / n_dev, traffic, coll_s)
    dom = max(terms, key=terms.get)
    return {
        "config": cfg.name, "kind": step.kind, "seq": step.seq,
        "batch": step.batch, "n_devices": n_dev, "accum_steps": step.accum,
        "bytes": {"params": card["params"],
                  "opt_state": card.get("opt_state", 0),
                  "cache": card.get("cache", 0),
                  "inputs": arg - card["params"] - card.get("opt_state", 0)
                  - card.get("cache", 0)},
        "memory": {"argument_bytes": arg, "output_bytes": res,
                   "alias_bytes": alias, "temp_bytes": None,
                   "peak_bytes": arg + res - alias},
        "collectives": {**wire, "total": sum(wire.values()),
                        "counts": counts},
        "memory_traffic_bytes": traffic,
        "model_flops": mf, "analytic_flops": af,
        "flops_per_device": af / n_dev, "model_flops_per_device": mf / n_dev,
        "roofline": terms, "dominant": dom,
        "useful_flops_ratio": mf / max(af, 1.0),
    }


def _fmt(key: str, rec: Dict) -> str:
    t = rec["roofline"]
    peak = rec["memory"]["peak_bytes"] / 2 ** 30
    return (f"[dryrun] {key}: OK peak={peak:.2f}GiB/card "
            f"compute={t['t_compute'] * 1e3:.2f}ms "
            f"mem={t['t_memory'] * 1e3:.2f}ms "
            f"coll={t['t_collective'] * 1e3:.2f}ms "
            f"dom={rec['dominant'][2:]}")


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            remat: bool = True, tag: str = "", save: bool = True) -> Dict:
    """One (arch, shape, mesh) record, saved under ``RESULTS_DIR``; a
    failure is recorded (``ok`` False, the error and its traceback) and
    returned, so that a sweep goes on."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    key = f"{arch}__{shape_name}__{mesh_name}{tag}"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "tag": tag, "ok": False}
    t0 = time.time()
    try:
        step, skip, _ = build_step(arch, shape_name, multi_pod, remat=remat)
        if skip:
            rec.update(skipped=skip, ok=True)
            print(f"[dryrun] {key}: SKIP ({skip})")
        else:
            rec.update(reckon(step), ok=True)
            print(_fmt(key, rec))
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] {key}: FAIL {rec['error']}")
    rec["total_s"] = time.time() - t0
    if save:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        with open(os.path.join(RESULTS_DIR, key + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


# ---------------------------------------------------------------------------
# the card check
# ---------------------------------------------------------------------------

#: the CUDA caching allocator rounds every block up to a multiple of
#: 512 B, and leaves unsplit a remainder of up to 1 MiB above a block of
#: more than 1 MiB
ALLOC_ROUND, ALLOC_SLACK = 512, 2 ** 20


def _place(step: Step, model: Model) -> Dict[str, Any]:
    """The step's arguments for real on the model's device: parameters by
    ``Model.init`` (seed 0), zero AdamW state, a zero ``init_cache``,
    token ids and float inputs from ``numpy`` (seed 0), each decode row
    at the cache's last position."""
    dev = model.device
    rng = np.random.RandomState(0)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    def draw(t):
        if t.dtype.is_floating_point:
            x = rng.standard_normal(tuple(t.shape)).astype(np.float32)
        else:
            x = rng.randint(0, step.cfg.vocab_size, tuple(t.shape))
        return torch.from_numpy(x).to(dev, t.dtype)

    args = {"params": params}
    for k, spec in step.args.items():
        if k == "opt_state":
            args[k] = adamw_init(params, opt_config(step.cfg))
        elif k == "cache":
            args[k] = model.init_cache(step.batch, step.seq)
        elif k == "pos":
            args[k] = torch.full(tuple(spec.shape), step.seq - 1,
                                 dtype=spec.dtype, device=dev)
        elif k != "params":
            args[k] = _map(lambda _, t: draw(t), spec)
    for k, spec in step.args.items():
        if signature(args[k]) != signature(spec):
            raise AssertionError(f"placed {k} differs from its spec")
    return args


def signature(tree, path: str = "") -> Dict[str, Tuple]:
    """{path: (shape, dtype)} of the tensors of a nested dict / list /
    tuple (host values left out)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: (tuple(tree.shape), tree.dtype)} \
            if isinstance(tree, torch.Tensor) else {}
    out = {}
    for k, v in items:
        out.update(signature(v, f"{path}/{k}"))
    return out


def _storages(tree):
    """{storage address: bytes} of the tensors of ``tree``."""
    return {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in leaves(tree) if isinstance(t, torch.Tensor)}


def card_check(cfg, kind: str, seq: int, batch: int, device="cuda",
               warmup: int = 2, reps: int = 5) -> Dict:
    """The dry run's record of (kind, seq, batch) for ``cfg`` on one card
    (``make_smoke_mesh``, 1 x 1), held to the card:

    1. the step's arguments are placed for real (``_place``): their
       storages must hold exactly ``argument_bytes``, and on a card the
       allocator's growth must be their bytes each rounded up to
       ``ALLOC_ROUND``, plus less than ``ALLOC_SLACK`` for each storage
       of more than ``ALLOC_SLACK`` bytes (``placed``);
    2. the step runs ``warmup`` times, at least once (its first outputs
       must have the reckoned shapes and dtypes), then ``reps`` times
       between two CUDA events and the host clock (synchronised), then
       once under ``torch.profiler``, timed the same way; ``reps=0``
       takes the profiled step's times (for a step of seconds, where the
       profiler's host work is a small part);
    3. ``memory.temp_bytes`` is ``max_memory_allocated`` over the timed
       runs less the memory held before them (the step's outputs and
       temporaries at its peak) and ``memory.peak_bytes`` the allocator's
       peak itself; ``measured`` holds the wall and CUDA-event times per
       step, the device time of the profiled step and ``hlo.analyze``'s
       breakdown;
    4. ``roofline_share``: the dominant roofline term over the measured
       device time, and over the wall.

    ``device="cpu"`` runs the same steps with the plain versions of the
    kernels: no allocator, no device time (None), the wall on the host's
    clock."""
    from ..core.indicators import resolve_device
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    step = build(cfg, kind, seq, batch, make_smoke_mesh(), ("data",))
    rec = {"arch": cfg.name, "shape": f"{kind} {batch}x{seq}", "mesh": "1x1",
           "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
           **reckon(step)}
    model = Model(cfg, device=dev)
    if on_card:
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
    args = _place(step, model)
    st = {}
    for tree in args.values():
        st.update(_storages(tree))
    placed = {"bytes": sum(st.values()), "tensors": len(st)}
    if placed["bytes"] != rec["memory"]["argument_bytes"]:
        raise AssertionError(f"placed {placed['bytes']} B, reckoned "
                             f"{rec['memory']['argument_bytes']}")
    if on_card:
        torch.cuda.synchronize(dev)
        growth = torch.cuda.memory_allocated(dev) - before
        rounded = sum(-(-n // ALLOC_ROUND) * ALLOC_ROUND for n in st.values())
        large = sum(n > ALLOC_SLACK for n in st.values())
        placed.update(allocator_growth=growth, rounded=rounded,
                      large_tensors=large)
        if not rounded <= growth < rounded + large * ALLOC_SLACK + 1:
            raise AssertionError(f"allocator grew {growth} B for {rounded} "
                                 f"B of rounded storages ({large} over "
                                 f"{ALLOC_SLACK} B)")
    rec["placed"] = placed
    fn = step_fn(step, model, dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else \
        (lambda: None)

    def run():
        return fn(*args.values())

    def timed(n):
        """(host wall, CUDA-event time) per step of ``n`` steps."""
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        if on_card:
            stop.record()
        sync()
        return ((time.perf_counter() - t0) / n,
                start.elapsed_time(stop) / 1e3 / n if on_card else None)

    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    with torch.no_grad() if kind != "train" else nullcontext():
        got = signature(dict(zip(step.outputs, run())))
        if got != signature(step.outputs):
            raise AssertionError(f"the step returned {got}, reckoned "
                                 f"{signature(step.outputs)}")
        for _ in range(warmup - 1):
            run()
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
        if reps:
            wall, event = timed(reps)
        with profile(activities=acts) as prof:
            p_wall, p_event = timed(1)
    if not reps:
        wall, event = p_wall, p_event
    ana = hlo.analyze(prof, 1)
    device_s = ana["device_us"] / 1e6 if on_card else None
    rec["measured"] = {
        "wall_ms": wall * 1e3,
        "event_ms": event * 1e3 if on_card else None,
        "device_ms": device_s * 1e3 if on_card else None,
        "profiled_wall_ms": p_wall * 1e3,
        "warmup": warmup, "reps": reps, "trace": ana}
    if on_card:
        peak = torch.cuda.max_memory_allocated(dev)
        rec["memory"].update(temp_bytes=peak - held, peak_bytes=peak)
    t_dom = rec["roofline"][rec["dominant"]]
    rec["roofline_share"] = {
        "device": t_dom / device_s if device_s else None,
        "wall": t_dom / wall if on_card else None}
    rec["ok"] = True
    del args
    return rec


def launch(arch: str, shape_name: str, multi_pod: bool) -> Dict:
    """Both launchers' ``--dry-run``: the reference's ``python -m
    repro.launch.dryrun --arch A --shape S --force [--multi-pod]``, run in
    this process.  Returns the saved record; a failed one exits non-zero
    with its error."""
    rec, = main(["--arch", arch, "--shape", shape_name, "--force"]
                + (["--multi-pod"] if multi_pod else []))
    if not rec["ok"]:
        raise SystemExit(f"dry run {arch} {shape_name}: {rec['error']}")
    return rec


def main(argv: Optional[Sequence[str]] = None):
    """The reference's command line; returns the records of the jobs it
    ran or found cached."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        jobs = [(a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        jobs = [(args.arch, args.shape)]
    recs = []
    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    for a, s in jobs:
        out = os.path.join(RESULTS_DIR,
                           f"{a}__{s}__{mesh_name}{args.tag}.json")
        if not args.force and os.path.exists(out):
            with open(out) as f:
                rec = json.load(f)
            if rec.get("ok"):
                print(f"[dryrun] {a}__{s}__{mesh_name}: cached OK")
                recs.append(rec)
                continue
        recs.append(run_one(a, s, multi_pod=args.multi_pod,
                            remat=not args.no_remat, tag=args.tag))
    return recs


if __name__ == "__main__":
    main()
