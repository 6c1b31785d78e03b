"""Table I: the "This Work" column reproduced from the behavioural models."""
import dataclasses
import time

from repro_torch.core import GEOMETRY, PROTOTYPE
from repro_torch.core.energy import (compute_density_tops_mm2,
                                     macro_throughput_gops, mvm_energy)
from repro_torch.core.macro import OperatingPoint

from .common import row

PAPER = {  # published values for the comparison column
    "memory_density_kb_mm2": 559, "adc_bits": 8.5, "sigma_e_lsb": 0.59,
    "parallelism": 144, "gops_0v65": 3.8, "gops_1v2": 50.3,
    "topsw_0v65": 40.2, "topsw_1v2": 18.6, "tops_mm2_1v2": 0.68,
}


def summary() -> dict:
    """The "This Work" column, by Table I metric."""
    m065 = dataclasses.replace(PROTOTYPE, op=OperatingPoint(vdd=0.65))
    m120 = dataclasses.replace(PROTOTYPE, op=OperatingPoint(vdd=1.2))
    return {
        "memory_density_kb_mm2": GEOMETRY.density_kb_mm2,
        "adc_bits": PROTOTYPE.adc_bits,
        "sigma_e_lsb": PROTOTYPE.sigma_e_lsb(),
        "parallelism": PROTOTYPE.n_rows,
        "gops_0v65": macro_throughput_gops(m065),
        "gops_1v2": macro_throughput_gops(m120),
        "topsw_0v65": mvm_energy(m065, 144).tops_per_w,
        "topsw_1v2": mvm_energy(m120, 144).tops_per_w,
        "tops_mm2_1v2": compute_density_tops_mm2(m120),
        "bitwise_topsw_0v65": mvm_energy(m065, 144).bitwise_tops_per_w,
    }


def run(device=None):
    t0 = time.perf_counter()
    out = []
    for k, v in summary().items():
        ref = PAPER.get(k)
        derived = f"ours={v:.2f}" + (f"|paper={ref}" if ref is not None
                                     else "")
        out.append(row(f"table1_{k}", (time.perf_counter() - t0) * 1e6,
                       derived))
    return out


if __name__ == "__main__":
    run()
