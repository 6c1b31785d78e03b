"""PICO-RAM core: the paper's contribution as composable PyTorch modules.

Layers:
  quant      — DAC/weight quantizers + STE (Eq. 5, Eq. 7 encoding)
  macro      — macro + operating-point (PVT) configuration
  adc / dac  — behavioural converter models (transfer, INL, noise, energy)
  schemes    — BP / WBS / BS analog MVM flows (Eq. 1, 2)
  engine     — unified execution engine: backend registry + execute_mvm
  cim_matmul — float-in/float-out layer entry point (+ STE for QAT)
  energy     — Eq. 4 energy / throughput / density model
  sqnr       — Monte-Carlo SQNR harness (Eq. 3, Fig. 2)
"""
from .cim_matmul import (BP_IDEAL, OFF, CIMConfig, cim_matmul,
                         cim_matmul_prequant, cim_matmul_ste)
from .engine import (PackedCodes, available_backends, choose_backend,
                     execute_mvm, get_backend, register_backend)
from .macro import (GEOMETRY, PROTOTYPE, MacroConfig, MacroGeometry,
                    OperatingPoint, Scheme, SimLevel)
from .quant import ActQuantConfig, WeightQuantConfig
from .schemes import bp_mvm, bs_mvm, cim_mvm_codes, exact_mvm_codes, wbs_mvm

__all__ = [
    "BP_IDEAL", "OFF", "CIMConfig", "cim_matmul", "cim_matmul_prequant",
    "cim_matmul_ste",
    "PackedCodes", "available_backends", "choose_backend", "execute_mvm",
    "get_backend", "register_backend",
    "GEOMETRY", "PROTOTYPE", "MacroConfig", "MacroGeometry", "OperatingPoint",
    "Scheme", "SimLevel", "ActQuantConfig", "WeightQuantConfig",
    "bp_mvm", "bs_mvm", "cim_mvm_codes", "exact_mvm_codes", "wbs_mvm",
]
