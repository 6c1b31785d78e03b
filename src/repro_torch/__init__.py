"""PyTorch / CUDA port of the PICO-RAM CIM simulator and serving stack.

Mirrors `repro`'s subpackage and file names, one module per reference
module. Imports torch only; the Hopper kernels under `kernels/csrc/` are
compiled with nvcc at first use (see `kernels/build.py`).
"""
