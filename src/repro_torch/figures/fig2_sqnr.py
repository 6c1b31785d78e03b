"""Fig. 2: simulated SQNR + Eq. 4 energy across hardware configurations.

(a) quantization levels fixed at 64, sweep N;
(b) N = 144 fixed, sweep quantization levels.
Paper anchors: (a) BP(9) +1.8 dB vs WBS(36), +3.5 dB vs BS(144);
(b) BP(1024) +7.8 dB vs WBS(256), +21.6 dB vs BS(32) at iso-energy.
The Monte-Carlo codes come from a torch.Generator (core.sqnr), so the dB
agree with the reference's within the Monte-Carlo spread.
"""
import dataclasses
import time

from repro_torch.core import PROTOTYPE, Scheme
from repro_torch.core.sqnr import simulate_sqnr

from .common import row

N_MC = 1 << 13


def run(device=None):
    out = []
    t0 = time.perf_counter()

    def emit(name, cfg):
        r = simulate_sqnr(cfg, k=144, n_samples=N_MC, device=device)
        us = (time.perf_counter() - t0) * 1e6
        out.append(row(name, us, f"sqnr_db={r.sqnr_db:.2f}|"
                                 f"E={r.energy_per_mvm_j:.3e}J"))

    # (a) levels=64, sweep N per scheme
    for scheme, ns in ((Scheme.BP, (9, 18, 36, 72, 144)),
                       (Scheme.WBS, (36, 144)), (Scheme.BS, (144,))):
        for n in ns:
            emit(f"fig2a_{scheme.value}_N{n}",
                 dataclasses.replace(PROTOTYPE, scheme=scheme, n_rows=n,
                                     adc_levels=64))
    # (b) N=144, sweep levels per scheme
    for scheme, lvls in ((Scheme.BP, (256, 362, 1024)),
                         (Scheme.WBS, (64, 256)), (Scheme.BS, (32, 64))):
        for lv in lvls:
            emit(f"fig2b_{scheme.value}_L{lv}",
                 dataclasses.replace(PROTOTYPE, scheme=scheme,
                                     adc_levels=lv))
    return out


if __name__ == "__main__":
    run()
