"""Fig. 19: end-to-end task accuracy across voltages / temperatures / gains.

Paper: ≤1.3 % degradation at corners vs nominal. Same protocol with the
synthetic classifier + FULL-fidelity macro sim (noise + INL, PVT-scaled),
the noise drawn from generators seeded from key 0 (common.eval_accuracy):
the einsum backend, as in the reference.
"""
import dataclasses
import time

from repro_torch.core import PROTOTYPE
from repro_torch.core.macro import OperatingPoint, SimLevel

from .common import eval_accuracy, make_task, row, train_mlp


def run(device=None):
    task = make_task(device=device)
    params = train_mlp(task)
    acc_float = eval_accuracy(params, task, None)
    out = []
    t0 = time.perf_counter()

    def acc_at(**kw):
        # deployed operating point: gain 3 (paper Fig. 19 reports CIFAR
        # accuracy at gain 3 across the PVT corners)
        kw.setdefault("gain", 3.0)
        op = OperatingPoint(vdd=kw.pop("vdd", 0.9),
                            temp_c=kw.pop("temp_c", 25.0))
        m = dataclasses.replace(PROTOTYPE, op=op, sim_level=SimLevel.FULL,
                                **kw)
        return eval_accuracy(params, task, m, key=0)

    nominal = acc_at()
    out.append(row("fig19_nominal", (time.perf_counter() - t0) * 1e6,
                   f"acc={nominal:.4f}|float={acc_float:.4f}"))
    for vdd in (0.65, 0.8, 1.0, 1.2):
        out.append(row(f"fig19_vdd{vdd:g}", (time.perf_counter() - t0) * 1e6,
                       f"acc={acc_at(vdd=vdd):.4f}"))
    for temp in (-40.0, 105.0):
        out.append(row(f"fig19_temp{temp:g}",
                       (time.perf_counter() - t0) * 1e6,
                       f"acc={acc_at(temp_c=temp):.4f}"))
    for gain in (1.0, 2.0):
        out.append(row(f"fig19_gain{gain:g}",
                       (time.perf_counter() - t0) * 1e6,
                       f"acc={acc_at(gain=gain):.4f}"))
    return out


if __name__ == "__main__":
    run()
