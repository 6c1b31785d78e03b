"""Training launcher (the reference's `launch/train.py`, plus --device).

--smoke runs the reduced config; without it the full-size config runs on
the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --smoke --steps 50 --batch 8 --seq 128 [--cim bp] [--ckpt DIR] \\
      [--device cpu]

Prints one JSON line per logged step, then `done: N steps;
stragglers=[...]`.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import ARCHS, SMOKES
from repro_torch.core.cim_matmul import CIMConfig
from repro_torch.runtime.trainer import Trainer


def build(args) -> Trainer:
    """The launcher's Trainer for parsed arguments."""
    cfg = (SMOKES if args.smoke else ARCHS)[args.arch]
    if args.cim == "bp":
        cfg = cfg.replace(cim=CIMConfig(enabled=True))
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    tc = TrainConfig(steps=args.steps, lr=args.lr,
                     microbatch=args.microbatch,
                     grad_compression=args.grad_compression,
                     checkpoint_every=max(args.steps // 4, 1))
    ckpt = args.ckpt or os.path.join(tempfile.gettempdir(),
                                     "repro_torch_ckpt")
    return Trainer(cfg, shape, tc, ckpt, device=args.device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--cim", choices=("off", "bp"), default="off")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt "
                         "in the temporary directory)")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None):
    trainer = build(parser().parse_args(argv))
    out = trainer.run()
    for m in out["metrics"]:
        print(json.dumps(m))
    print(f"done: {out['final_step']} steps; "
          f"stragglers={trainer.straggler_steps}")


if __name__ == "__main__":
    main()
