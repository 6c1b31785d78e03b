"""Build and load the port's hand-written Hopper kernels.

Each CUDA source in `csrc/` has a plain C interface and compiles with nvcc
into its own shared library (`-gencode arch=compute_90a,code=sm_90a`),
loaded with ctypes. Libraries are built at first use into
`build/repro_torch_kernels/` at the repository root, named by a hash of the
source and flags so an edited source rebuilds. `build_all()` starts one
nvcc per source at once and waits for all of them. Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" \
    / "repro_torch_kernels"
SOURCES = {"cim_mvm": "cim_mvm.cu", "paged_attention": "paged_attention.cu"}
# --split-compile=0 optimises the device code on every core: the paged
# attention source's many template instances make it the longest build
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--split-compile=0", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_SIGNATURES: dict[str, dict[str, list]] = {}
_LOADED: dict[str, ctypes.CDLL] = {}


def declare(name: str, signatures: dict[str, list]) -> None:
    """Record the ctypes argtypes of a library's C entry points (each
    returns the int from cudaGetLastError)."""
    _SIGNATURES[name] = signatures


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def lib_path(name: str) -> pathlib.Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:12]}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile every missing library, one nvcc per source, all started
    together. Returns seconds per library built; raises with nvcc's output
    when one fails. The -Xptxas -v report lands beside each library."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        log = open(out.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    took = {}
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        took[name] = time.monotonic() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exited {rc}\n"
                          + out.with_suffix(".log").read_text()[-4000:])
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if it is missing."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    path = lib_path(name)
    if not path.exists():
        build_all([name])
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _LOADED[name] = lib
    return lib


def launch_counts() -> dict[str, int]:
    """Launch counts of every kernel wrapper, by wrapper name."""
    from . import cim_mvm, paged_attention
    return {f.__name__: f.launches for f in _wrappers(cim_mvm,
                                                       paged_attention)}


def reset_launch_counts() -> None:
    from . import cim_mvm, paged_attention
    for f in _wrappers(cim_mvm, paged_attention):
        f.launches = 0


def _wrappers(cim_mvm, paged_attention):
    return (cim_mvm.cim_mvm_grouped_packed, cim_mvm.cim_mvm_grouped,
            cim_mvm.cim_mvm_grouped_noisy,
            cim_mvm.cim_mvm_grouped_noisy_packed,
            cim_mvm.cim_mvm_grouped_packed_experts,
            cim_mvm.cim_mvm_grouped_noisy_packed_experts,
            cim_mvm.cim_mvm_grouped_experts,
            cim_mvm.cim_mvm_grouped_noisy_experts,
            paged_attention.paged_attn_call,
            paged_attention.decode_write_attend_call)
