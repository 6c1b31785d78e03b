"""The port's quickstart, sqnr_study and serve_decode examples
(`repro_torch.examples`, the reference's `examples/` scripts) run on the
CPU (--device cpu: the kernels' plain versions) at their defaults; their
output lines are checked.

Their inputs are numpy-seeded (the reference's are jax.random draws), so
the numbers they print are not the reference's. What holds: quickstart's
relative error shrinks with the VTC gain and B2's output is finite; the
SQNR study's configurations at levels 1024 / 256 / 32 are iso-energy (the
reference's Eq. 4 energies, closed form) and BP > WBS > BS in both
sweeps; every served request gets its 8 tokens on both engines, float and
CIM.
"""
import dataclasses
import re

import pytest
import torch

from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

from repro_torch.configs.registry import SMOKES
from repro_torch.core import PROTOTYPE
from repro_torch.core.energy import mvm_energy
from repro_torch.examples import quickstart, serve_decode, sqnr_study


def _lines(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]


def test_quickstart(capsys):
    quickstart.main(["--device", "cpu"])
    lines = _lines(capsys)
    errs = [float(re.search(r"rel err ([\d.]+)%", ln).group(1))
            for ln in lines if ln.startswith("BP 4b×4b")]
    assert len(errs) == 2 and 0 < errs[1] < errs[0] < 100
    schemes = [ln.split(":")[0].strip() for ln in lines
               if re.match(r"\s+(bp|wbs|bs)\s*:", ln)]
    assert schemes == ["bp", "wbs", "bs"]
    assert lines[-2] == "B2 kernel output: (8, 16), finite=True"
    assert lines[-1] == "done."


def test_sqnr_study(capsys):
    sqnr_study.main(["--device", "cpu"])
    lines = _lines(capsys)
    b = [re.search(r"levels=\s*(\d+):\s+([\d.]+) dB\s+E=\s*([\d.]+) pJ", ln)
         for ln in lines[1:4]]
    assert [int(m.group(1)) for m in b] == [1024, 256, 32]
    energies = {m.group(3) for m in b}
    want = mvm_energy(dataclasses.replace(PROTOTYPE, adc_levels=1024), 144,
                      dual_threshold=False).e_mvm_j * 1e12
    assert energies == {f"{want:6.2f}".strip()}
    db = [float(m.group(2)) for m in b]
    assert db[0] > db[1] > db[2]
    assert lines[4].startswith("  BP−WBS = ") and "(paper: 21.6)" in lines[4]
    a = [float(re.search(r"N=\s*\d+:\s+([\d.]+) dB", ln).group(1))
         for ln in lines[6:9]]
    assert len(a) == 3 and a[0] > a[1] > a[2]


@pytest.mark.parametrize("args", [[], ["--cim"], ["--cim", "--paged"],
                                  ["--paged", "--requests", "3",
                                   "--slots", "2"]])
def test_serve_decode(args, capsys):
    reqs = serve_decode.main(args + ["--device", "cpu"])
    lines = _lines(capsys)
    n = int(args[args.index("--requests") + 1]) if "--requests" in args else 6
    assert len(reqs) == n
    vocab = SMOKES["internlm2-1.8b"].vocab
    for r, ln in zip(reqs, lines):
        assert len(r.output) == 8 and all(0 <= t < vocab for t in r.output)
        assert ln == f"req{r.rid} ({len(r.prompt)} prompt tokens) -> " \
                     f"{r.output}"
    mode = "CIM-BP" if "--cim" in args else "float"
    assert re.fullmatch(rf"mode={mode}: {8 * n} tokens in \d+ batched decode "
                        r"steps, [\d.]+ tok/s", lines[-1]), lines[-1]
