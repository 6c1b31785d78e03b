"""Fig. 1(b): energy efficiency × task accuracy of BP / WBS / BS.

Paper claim: BP ≈ 1.6× (WBS) and 6.4× (BS) better energy at iso-accuracy.
We report Eq. 4 energy-per-MVM and classifier accuracy per scheme at the
prototype operating point. The BP row runs kernel B2 on the card; WBS and
BS run the einsum backend, as in the reference.
"""
import dataclasses
import time

from repro_torch.core import PROTOTYPE, Scheme
from repro_torch.core.energy import mvm_energy

from .common import eval_accuracy, make_task, row, train_mlp


def run(device=None):
    task = make_task(device=device)
    params = train_mlp(task)
    t0 = time.perf_counter()
    out = []
    acc_float = eval_accuracy(params, task, None)
    for scheme in (Scheme.BP, Scheme.WBS, Scheme.BS):
        macro = dataclasses.replace(PROTOTYPE, scheme=scheme)
        acc = eval_accuracy(params, task, macro)
        e = mvm_energy(macro, 144, dual_threshold=False)
        us = (time.perf_counter() - t0) * 1e6
        out.append(row(f"fig1b_{scheme.value}", us,
                       f"acc={acc:.4f}|float={acc_float:.4f}|"
                       f"E_mvm={e.e_mvm_j:.3e}J|TOPSW={e.tops_per_w:.1f}"))
    return out


if __name__ == "__main__":
    run()
