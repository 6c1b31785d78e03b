"""Mapping DNN layers onto PICO-RAM macro arrays (paper §V).

The prototype stores 9 weight bits per cluster position (9 × 6T cells share
one MAC unit): one slice holds the ACTIVE bit, the other 8 cells bank
weights of other layers/channels — that's how the macro reaches 559 Kb/mm²
*usable* density and why "the weight storage density may approach a
commercial SRAM" (§III-A). When a model exceeds on-chip capacity the host
reloads banks between layers (§V-C: "reloading the memory is necessary").

This module does the arithmetic a deployment needs:
  * how many macro tiles a weight matrix occupies (144-row × 8-col ADC
    groups per macro, 4-bit weights);
  * bank utilization of the 9-cell clusters;
  * reload traffic/energy when the model doesn't fit the macro budget.

A copy of the JAX package's `core/mapping.py` (pure Python arithmetic).
"""
from __future__ import annotations

import dataclasses
import math

from .macro import GEOMETRY, MacroConfig


@dataclasses.dataclass(frozen=True)
class MacroBudget:
    n_macros: int = 64              # macros available on chip
    banks_per_cluster: int = 9      # 9 × 6T cells per cluster

    @property
    def rows(self) -> int:
        return 144

    @property
    def cols(self) -> int:
        return GEOMETRY.mvm_groups   # 8 ADC columns per macro

    def capacity_weights(self) -> int:
        """4-bit weights storable on chip (all banks)."""
        return (self.n_macros * self.rows * self.cols
                * self.banks_per_cluster)


@dataclasses.dataclass(frozen=True)
class LayerMapping:
    name: str
    k: int                          # reduction depth
    m: int                          # output columns
    tiles: int                      # (144-row × 8-col) tile count
    weights: int                    # k × m


def map_layer(name: str, k: int, m: int) -> LayerMapping:
    tiles = math.ceil(k / 144) * math.ceil(m / GEOMETRY.mvm_groups)
    return LayerMapping(name=name, k=k, m=m, tiles=tiles, weights=k * m)


@dataclasses.dataclass(frozen=True)
class ModelMapping:
    layers: tuple
    budget: MacroBudget

    @property
    def total_weights(self) -> int:
        return sum(l.weights for l in self.layers)

    @property
    def resident_fraction(self) -> float:
        """Fraction of the model resident on chip (banked)."""
        return min(1.0, self.budget.capacity_weights()
                   / max(self.total_weights, 1))

    @property
    def fits(self) -> bool:
        return self.total_weights <= self.budget.capacity_weights()

    def reload_bits_per_pass(self) -> int:
        """Weight bits (re)loaded per full forward pass when over budget."""
        overflow = max(0, self.total_weights
                       - self.budget.capacity_weights())
        return overflow * 4

    def bank_utilization(self) -> float:
        """Fraction of 9-cell banks actually holding weights."""
        active_positions = self.budget.n_macros * self.budget.rows \
            * self.budget.cols * self.budget.banks_per_cluster
        return min(1.0, self.total_weights / active_positions)


def map_model(shapes: list[tuple[str, int, int]],
              budget: MacroBudget | None = None) -> ModelMapping:
    """shapes: [(layer_name, K, M)] for every macro-mapped matmul."""
    budget = budget or MacroBudget()
    return ModelMapping(tuple(map_layer(n, k, m) for n, k, m in shapes),
                        budget)


def gru_144_shapes(d: int = 144) -> list[tuple[str, int, int]]:
    """The paper's custom 0.16M-param KWS GRU: input and hidden dims of 144
    'to perfectly fit into the SRAM' (§V-C). Gates: z, r, candidate — each
    [d + d → d]."""
    return [(f"gru_{g}", 2 * d, d) for g in ("z", "r", "h")] + \
        [("head", d, 16)]
