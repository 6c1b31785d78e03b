"""Three-term roofline of a dry-run cell on the NVIDIA H100, and the card's
peak rates (one source for the port: `chip_smoke.py` reads its bounds
from here).

    compute    = FLOPs / 989.4 TFLOP/s  (dense bf16 tensor core)
    memory     = bytes / 3.35 TB/s      (HBM3)
    collective = wire bytes / 450 GB/s  (NVLink 4, per direction)

plus MODEL_FLOPS = 6·N·D (train, dense) / 6·N_active·D (MoE) / 2·N·D
(inference) and the useful-compute ratio MODEL_FLOPS / FLOPs that
catches remat / dispatch / quantization waste.

The rates are the H100 SXM5's data-sheet peaks (NVIDIA H100 Tensor Core
GPU datasheet), not measurements; the card this port runs on is an
"NVIDIA H100 80GB HBM3" at a 700 W power limit. FLOPs, bytes and
collective bytes come from `analysis.hlo`'s trace of rank 0's step on the
meta device; model_flops is global. The useful ratio and the roofline
fraction divide it by `work_chips`, the chips the traced program divides
its work over. The reference's compiled program is partitioned whole:
the mesh's chips. The port's step issues a collective only where it
partitions (the sharded kernel MVMs, the expert slices) and keeps the
rest whole on every rank; a step that issues none is the whole model's
on one chip and is set against the whole model_flops (`work_chips` 1).
`launch.dryrun` sets it and names the program in the cell's "program".
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989.4e12    # dense BF16 tensor-core FLOP/s (data sheet)
HBM_BW = 3.35e12         # HBM3 bytes/s (data sheet)
LINK_BW = 450e9          # NVLink 4, 18 links, bytes/s per direction
ICI_BW = LINK_BW         # the reference's name for the link rate
F32_FLOPS = 67e12        # FP32 FLOP/s outside the tensor cores (data sheet)
INT8_OPS = 1979e12       # dense INT8 tensor-core op/s (data sheet)
HBM_BYTES = 80 * 2**30   # the card's device memory (80 GB HBM3)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    peak_bytes_per_chip: float
    collective_detail: dict
    work_chips: int | None = None    # None: chips (module docstring)

    # hlo_flops / hlo_bytes / collective_bytes are rank 0's; model_flops is
    # global.
    @property
    def _share(self) -> int:
        return self.chips if self.work_chips is None else self.work_chips

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def wire_bytes(self) -> float:
        """Physical per-chip link traffic: ring all-reduce moves ≈2× its
        operand bytes ((n−1)/n reduce-scatter + (n−1)/n all-gather); AG / RS /
        A2A / permute move ≈1× the operand."""
        detail = (self.collective_detail or {}).get("bytes", {})
        if not detail:
            return self.collective_bytes
        total = 0.0
        for kind, b in detail.items():
            total += (2.0 if kind == "all-reduce" else 1.0) * b
        return total

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        if not self.hlo_flops:
            return 0.0
        return self.model_flops / self._share / self.hlo_flops

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step ran at the
        bound implied by the dominant term: useful_FLOPs/chip/step_time over
        peak (per work chip: module docstring)."""
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        if t_bound <= 0:
            return 0.0
        return (self.model_flops / self._share / t_bound) / PEAK_FLOPS

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "work_chips": self._share,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "wire_bytes": self.wire_bytes,
            "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_bytes_per_chip": self.peak_bytes_per_chip,
            "collective_detail": self.collective_detail,
        }


def _leaves(tree, path=()):
    """(path of keys, leaf) over a params tree of dicts and per-layer
    lists (list indices are not keys)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, path)
    else:
        yield path, tree


def count_params(abstract_params) -> int:
    return sum(int(x.numel()) for _, x in _leaves(abstract_params))


def count_active_params(abstract_params, cfg) -> float:
    """MoE-aware active parameter count for MODEL_FLOPS."""
    total = routed = 0
    for path, leaf in _leaves(abstract_params):
        total += int(leaf.numel())
        if path[-1] in ("e_gate", "e_up", "e_down"):
            routed += int(leaf.numel())
    if cfg.moe is None or routed == 0:
        return float(total)
    frac = cfg.moe.top_k / cfg.moe.n_experts
    return float(total - routed + routed * frac)


def model_flops(cfg, shape, abstract_params) -> float:
    n_active = count_active_params(abstract_params, cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence per step
    return 2.0 * n_active * shape.global_batch
