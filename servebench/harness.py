"""One run of one cell, driven by ``BENCHMARK.json`` and the files the
cell names:

* ``servebench/configs/<config>.json``: the model's published keys, the
  program's ``ModelConfig`` (``port``), the serving set-up (``serving``),
  the plain reference's name (``reference``) and the limits of the check
  (``check``);
* ``servebench/traffic/<traffic>.json``: the traffic mix, read by
  ``traffic_gen.py``;
* ``servebench/metrics/<metric>.py``: one reader per metric, found by the
  metric's name or, failing that, by the name with its last dotted parts
  taken off (``decode_step_ms.agent`` reads ``decode_step_ms.py``).  A
  reader's ``read(ctx)`` returns a number or None when it finds nothing
  to read, and then the metric is left out of the line.

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1``
profiles the last ``TRACE_SECONDS`` of the window and reports its
per-layer metrics: those read from the card over the profiled part,
those read from the host's clock over the part before it.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from . import check, flops, serving, traffic_gen
from .trace import Tracer

HERE = Path(__file__).resolve().parent
#: the profiled part of a ``--trace 1`` window (at most half of it)
TRACE_SECONDS = 10.0
#: the longest the engines may run on past the close so that the
#: check's sample finishes (``serving.drain``)
DRAIN_SECONDS = 120.0


def load_json(kind: str, name: str) -> Dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def reader(name: str):
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        stem = ".".join(parts[:k])
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                "servebench.metrics." + stem.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{HERE / 'metrics'}")


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics this cell reports: end-to-end ones without a trace,
    per-layer ones with it."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in names)]


class Context:
    """What a metric reader reads."""

    def __init__(self, cfg, window, setup_s, tracer: Optional[Tracer]):
        self.cfg = cfg
        self.shape = flops.model_shape(cfg)
        self.window = window
        self.setup_s = setup_s
        self.trace = tracer.summary() if tracer is not None and \
            tracer.prof is not None else None
        self.launches = tracer.launches if tracer is not None else {}
        rec = window.recorder
        traced = self.trace is not None
        self.host_window_s = (tracer.t0 - rec.t_start) if traced \
            else window.seconds

    def host_steps(self):
        return [s for s in self.window.recorder.steps if not s.traced]

    def traced_steps(self):
        return [s for s in self.window.recorder.steps if s.traced]

    def kernel_seconds(self, names: Sequence[str]) -> float:
        if not self.trace:
            return 0.0
        return sum(v[0] for k, v in self.trace["kernel_s"].items()
                   if any(n in k for n in names))

    def expect_launches(self, kernel: str, n: int):
        """The program's launch counter over the profiled part against
        the launches a reader's shapes account for."""
        got = self.launches.get(kernel)
        if got is not None and got != n:
            raise AssertionError(f"{kernel}: {got} launches in the profiled "
                                 f"part, the steps account for {n}")


@contextlib.contextmanager
def moe_ranges(tracer: Tracer):
    """While tracing, ``moe_apply`` runs inside an ``sb.moe.<step kind>``
    range, so the device time of its kernels can be told apart."""
    from repro_torch.models import model as model_mod
    orig = model_mod.moe_apply

    def ranged(*a, **kw):
        if not tracer.active:
            return orig(*a, **kw)
        with torch.profiler.record_function("sb.moe." + tracer.kind):
            return orig(*a, **kw)
    model_mod.moe_apply = ranged
    try:
        yield
    finally:
        model_mod.moe_apply = orig


def run_cell(bench: Dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t_process: float,
             cfg: Optional[Dict] = None,
             traffic: Optional[Dict] = None) -> Dict:
    """The result line of one run (``cfg`` and ``traffic`` replace the
    cell's files, for tests)."""
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    cfg = cfg or load_json("configs", cell["config"])
    traffic = traffic or load_json("traffic", cell["traffic"])
    srv = cfg["serving"]
    on_card = torch.device(device).type == "cuda"
    built = serving.build(cfg, seed, device)
    cluster = serving.make_cluster(built, srv, device)
    work = traffic_gen.make_workload(traffic, seed, cfg["vocab_size"],
                                     srv["max_len"])
    tracer = Tracer() if trace else None
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ranges = moe_ranges(tracer) if trace and cfg.get("num_experts") \
        else contextlib.nullcontext()
    with ranges:
        window = serving.serve(cluster, work, seconds, tracer,
                               min(TRACE_SECONDS, seconds / 2))
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    ctx = Context(cfg, window, window.recorder.t_start - t_process, tracer)
    metrics = {}
    for m in cell_metrics(bench, cell_name, trace):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    drain_s = serving.drain(cluster, window, check.enough(cfg, seed),
                            DRAIN_SECONDS)
    serving.free(cluster)
    del cluster
    verdict = check.judge(cfg, built.params, window, seed, device)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": verdict["correct"],
           "attempted": len(window.requests),
           "failed": verdict["failed"], "metrics": metrics, "device": dev}
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace["busy_s"]
        dev["window_s"] = ctx.trace["window_s"]
        out["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                            "idle_gaps": ctx.trace["idle_gaps"]}
    walls = {}
    for s in window.recorder.steps:
        walls.setdefault(s.kind, []).append(s.wall)
    # (count, mean wall in ms) of each kind of step, for standard error
    out["steps"] = {k: [len(v), 1e3 * sum(v) / len(v)]
                    for k, v in walls.items()}
    out["steps"]["drain_s"] = drain_s
    out["checks"] = verdict["checks"]
    return out
