"""Training launcher — the single-device path of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b --full
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b \\
        --steps 5 --device cpu

``--smoke`` (the default) takes the reduced config, ``--full`` the
published one; ``--accum`` micro-batches per step (the reference's
launcher parses it and trains unsplit).  Training runs on ``--device`` (default ``cuda``, which
needs a card; ``cpu`` runs the same code on the CPU).  ``--dry-run``
delegates to ``launch.dryrun`` for ``--arch`` at ``train_4k`` on the 16 x
16 mesh, or the 2 x 16 x 16 one with ``--multi-pod``, and returns its
record; without ``--dry-run``, ``--multi-pod`` is ignored, as in the
reference.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek_67b \\
        --dry-run
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="use the reduced config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--dry-run", action="store_true",
                    help="the production train_4k step's dry run "
                         "(launch.dryrun)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.dry_run:
        from .dryrun import launch
        return launch(args.arch, "train_4k", args.multi_pod)

    from ..configs import get_config
    from ..data.pipeline import DataConfig, DataIterator
    from ..models import Model
    from ..training.optim import OptimizerConfig
    from ..training.train_loop import train_loop

    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    model = Model(cfg, device=args.device)
    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=args.seq,
                                   global_batch=args.batch))
    opt = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps, schedule=cfg.lr_schedule)
    out = train_loop(model, opt, data, n_steps=args.steps,
                     checkpoint_dir=args.ckpt_dir,
                     checkpoint_every=max(args.steps // 2, 1)
                     if args.ckpt_dir else 0, accum_steps=args.accum,
                     device=args.device)
    h = out["history"]
    print(f"final loss {h[-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
