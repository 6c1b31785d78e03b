"""CIM-aware QAT of a language model (paper §II-B / §V-C), the reference's
`examples/train_cim_qat.py`.

Trains a reduced llama3-family model (d_model 256, d_ff 512, vocab 1024)
twice — in float, and with every matmul on the simulated PICO-RAM macro
(BP, STE: `cim_matmul_ste`, kernel B2 forward on the card) — and prints the
final-loss gap (the BP scheme's training-simplicity claim: QAT tracks the
standard flow).

    PYTHONPATH=src python -m repro_torch.examples.train_cim_qat \\
        [--steps 200] [--device cpu]

Each run checkpoints into a temporary directory removed at the end, so a
run never resumes an earlier one.
"""
from __future__ import annotations

import argparse
import tempfile
import time

from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import SMOKES
from repro_torch.core.cim_matmul import CIMConfig
from repro_torch.runtime.trainer import Trainer


def run(args, log=print) -> dict:
    """{"float": losses, "cim_bp": losses} of the two runs (the logged
    steps' losses, every `log_every` = 20 steps and the last)."""
    base = SMOKES[args.arch].replace(d_model=256, d_ff=512, vocab=1024)
    shape = ShapeConfig("qat", args.seq, args.batch, "train")
    tc = TrainConfig(steps=args.steps, lr=1e-3, warmup_steps=10,
                     checkpoint_every=args.steps, log_every=20)
    results = {}
    for mode, cfg in (("float", base),
                      ("cim_bp", base.replace(cim=CIMConfig(enabled=True)))):
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory() as ckpt:
            tr = Trainer(cfg, shape, tc, ckpt, device=args.device)
            out = tr.run()
        losses = [m["loss"] for m in out["metrics"]]
        results[mode] = losses
        log(f"[{mode}] first={losses[0]:.3f} last={losses[-1]:.3f} "
            f"({time.monotonic() - t0:.0f}s, "
            f"{len(tr.straggler_steps)} straggler steps)")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    results = run(ap.parse_args(argv))
    gap = results["cim_bp"][-1] - results["float"][-1]
    print(f"\nfinal-loss gap (CIM-QAT − float): {gap:+.4f} nats "
          f"(paper: BP QAT tracks the standard flow; BS needs GSTE and "
          f"often diverges)")


if __name__ == "__main__":
    main()
