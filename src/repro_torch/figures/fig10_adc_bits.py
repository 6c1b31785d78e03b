"""Fig. 10: task accuracy vs ADC resolution, saturating around 8 bits.
Every row runs kernel B2 on the card at its ADC ladder (BP, IDEAL)."""
import dataclasses
import time

from repro_torch.core import PROTOTYPE

from .common import eval_accuracy, make_task, row, train_mlp

LADDER = ((5, 32), (6, 64), (7, 128), (8, 256), (8.5, 362), (9, 512),
          (10, 1024))


def run(device=None):
    task = make_task(device=device)
    params = train_mlp(task)
    acc_float = eval_accuracy(params, task, None)
    out = []
    t0 = time.perf_counter()
    for bits, levels in LADDER:
        macro = dataclasses.replace(PROTOTYPE, adc_levels=levels)
        acc = eval_accuracy(params, task, macro)
        out.append(row(f"fig10_adc{bits}b",
                       (time.perf_counter() - t0) * 1e6,
                       f"acc={acc:.4f}|float={acc_float:.4f}"))
    return out


if __name__ == "__main__":
    run()
