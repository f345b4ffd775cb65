"""Roofline table generator — port of ``repro.launch.roofline``.

Reads ``launch.dryrun``'s records (``results/dryrun_torch/*.json``) and
emits a markdown table: the three terms per arch x shape x mesh at the
H100's rates, the dominant bottleneck, the per-card peak, the
MODEL_FLOPS ratio, and a note on what would move the dominant term.

  PYTHONPATH=src python -m repro_torch.launch.roofline [--tag _opt] \\
      [--mesh 16x16] [--notes]
"""
from __future__ import annotations

import argparse
import json
import os

from .dryrun import RESULTS_DIR

ARCH_ORDER = ["xlstm_350m", "paligemma_3b", "yi_6b", "recurrentgemma_9b",
              "whisper_medium", "deepseek_67b", "arctic_480b",
              "granite_moe_3b_a800m", "minicpm_2b", "qwen3_4b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

NOTES = {
    "t_compute": ("compute-bound: fewer FLOPs a card (more cards, less "
                  "recomputation) or more of the tensor cores' peak (larger "
                  "GEMM tiles, fused attention)"),
    "t_memory": ("HBM-bound: shrink the bytes a step reads (KV dtype, "
                 "window, fused attention reads, weights read once a "
                 "batch)"),
    "t_collective": ("link-bound: keep a group inside one NVLink node, "
                     "cross InfiniBand less (stable activation layouts, "
                     "fewer gathers) or overlap collectives with compute"),
}


def load(tag: str = "_opt", mesh: str = "16x16"):
    """{(arch, shape): record} of the records found, in table order."""
    out = {}
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            path = os.path.join(RESULTS_DIR, f"{a}__{s}__{mesh}{tag}.json")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                out[(a, s)] = json.load(f)
    return out


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}µs"


def table(tag: str = "_opt", mesh: str = "16x16") -> str:
    rows = [("arch", "shape", "compute", "memory", "collective",
             "dominant", "peak/dev", "useful"),
            ("---",) * 8]
    recs = load(tag, mesh)
    for (a, s), r in recs.items():
        if r.get("skipped"):
            rows.append((a, s, "SKIP", "-", "-", "-", "-", "-"))
            continue
        if not r.get("ok"):
            rows.append((a, s, "FAIL", "-", "-", "-", "-", "-"))
            continue
        t = r["roofline"]
        rows.append((
            a, s,
            fmt_s(t["t_compute"]), fmt_s(t["t_memory"]),
            fmt_s(t["t_collective"]),
            r["dominant"].replace("t_", ""),
            f"{r['memory']['peak_bytes'] / 2**30:.2f}GiB",
            f"{r.get('useful_flops_ratio', 0):.2f}",
        ))
    return "\n".join("| " + " | ".join(map(str, row)) + " |"
                     for row in rows)


def dominant_summary(tag: str = "_opt", mesh: str = "16x16") -> str:
    recs = load(tag, mesh)
    lines = []
    for (a, s), r in recs.items():
        if not r.get("ok") or r.get("skipped"):
            continue
        d = r["dominant"]
        lines.append(f"* **{a} × {s}** — {d.replace('t_', '')}-bound; "
                     f"{NOTES[d]}.")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="_opt")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--notes", action="store_true")
    args = ap.parse_args(argv)
    print(table(args.tag, args.mesh))
    if args.notes:
        print()
        print(dominant_summary(args.tag, args.mesh))


if __name__ == "__main__":
    main()
