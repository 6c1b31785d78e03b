"""The paper's §V-C keyword-spotting deployment: the dim-144 GRU trained in
float, then evaluated on the simulated PICO-RAM macro at gain 3 and the
paper's PVT corners.

    PYTHONPATH=src python -m repro_torch.examples.kws_gru [--steps 300] \
        [--device cpu] [--prequant]

The keyword data is synthetic, from a numpy seed: each class is a distinct
temporal trajectory in the 144-dim (stub MFCC) feature space, plus noise.
Training is full-batch SGD in float. The evaluation on the macro runs at
IDEAL, then at FULL fidelity (thermal noise + INL, PVT-scaled) with a
noise_seed, so the gate matmuls run the seeded stochastic kernel: B5 from
the float weights, or B6 from stored codes with --prequant (B2 / B1 at
IDEAL). On the CPU the kernels' plain versions run.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core.cim_matmul import CIMConfig
from repro_torch.core.macro import PROTOTYPE, OperatingPoint, SimLevel
from repro_torch.core.mapping import MacroBudget, gru_144_shapes, map_model
from repro_torch.device import resolve_device
from repro_torch.models import gru
from repro_torch.models.quantize import quantize_params

N_CLASSES, FRAMES = 12, 12
# (V, °C): nominal, the supply corners, the temperature corners
CORNERS = ((0.9, 25.0), (0.65, 25.0), (1.2, 25.0), (0.9, -40.0),
           (0.9, 105.0))


def make_kws_data(rng: np.random.RandomState, proto: np.ndarray,
                  n: int = 1024):
    """(frames [n, T, 144] f32, labels [n] int64): class trajectories
    `proto[label]` plus 0.4·N(0, 1), rectified."""
    y = rng.randint(0, proto.shape[0], n)
    x = proto[y] + 0.4 * rng.standard_normal((n, *proto.shape[1:]))
    return np.maximum(x, 0.0).astype(np.float32), y.astype(np.int64)


def train(p: dict, frames: torch.Tensor, labels: torch.Tensor, cfg, *,
          steps: int, lr: float = 0.1, log=print) -> tuple[dict, list]:
    """Full-batch SGD in float (plain autograd) → (params, losses)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    losses = []
    batch = {"frames": frames, "labels": labels}
    for i in range(steps):
        loss = gru.train_loss(p, batch, cfg)
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            p = {k: (v - lr * g).requires_grad_(True)
                 for (k, v), g in zip(p.items(), grads)}
        losses.append(float(loss.detach()))
        if i % 50 == 0:
            log(f"  step {i}: loss {losses[-1]:.3f}")
    return {k: v.detach() for k, v in p.items()}, losses


def macro_cfg(cfg, *, vdd: float = 0.9, temp_c: float = 25.0,
              level: SimLevel = SimLevel.FULL,
              noise_seed: int | None = 0):
    """`cfg` on the macro at gain 3 and one operating point."""
    macro = dataclasses.replace(PROTOTYPE, gain=3.0, sim_level=level,
                                op=OperatingPoint(vdd=vdd, temp_c=temp_c))
    return cfg.replace(cim=CIMConfig(enabled=True, macro=macro,
                                     noise_seed=noise_seed))


@torch.no_grad()
def accuracy(p: dict, frames: torch.Tensor, labels: torch.Tensor,
             cfg) -> float:
    logits = gru.forward(p, frames, cfg)
    return float((logits.argmax(-1) == labels).float().mean())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--prequant", action="store_true",
                    help="evaluate on the macro from stored 4-bit codes "
                         "(models.quantize) instead of the float weights")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    mapping = map_model(gru_144_shapes(), MacroBudget(n_macros=64))
    print(f"GRU-144 weights: {mapping.total_weights / 1e3:.1f} K (paper: "
          f"0.16 M params incl. embeddings) — fits on chip: "
          f"{mapping.fits}, bank utilization "
          f"{mapping.bank_utilization() * 100:.1f}%")

    cfg = gru.gru_config(n_classes=N_CLASSES)
    rng = np.random.RandomState(0)
    proto = rng.standard_normal((N_CLASSES, FRAMES, 144)) * 1.2
    xtr, ytr = (torch.from_numpy(a).to(dev)
                for a in make_kws_data(rng, proto))
    xte, yte = (torch.from_numpy(a).to(dev)
                for a in make_kws_data(rng, proto, n=512))
    p, _ = train(gru.init(cfg, seed=3, device=dev), xtr, ytr, cfg,
                 steps=args.steps)
    print(f"float accuracy:            {accuracy(p, xte, yte, cfg):.4f}")

    def on_macro(ccfg):
        return quantize_params(p, ccfg) if args.prequant else p

    weights = "stored codes" if args.prequant else "float weights"
    icfg = macro_cfg(cfg, level=SimLevel.IDEAL, noise_seed=None)
    print(f"CIM 4b×4b IDEAL, gain 3 ({weights}): accuracy "
          f"{accuracy(on_macro(icfg), xte, yte, icfg):.4f}")
    for vdd, temp in CORNERS:
        ccfg = macro_cfg(cfg, vdd=vdd, temp_c=temp)
        print(f"CIM 4b×4b FULL @ {vdd:.2f} V, {temp:+.0f} °C, gain 3 "
              f"({weights}, noise_seed 0): accuracy "
              f"{accuracy(on_macro(ccfg), xte, yte, ccfg):.4f}")


if __name__ == "__main__":
    main()
