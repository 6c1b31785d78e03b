"""Kernel tuning cache: launch knobs of the Hopper kernels as tuned,
persisted data.

The kernels' host launchers choose their geometry in code: B3 (paged
attention) splits a slot's block-table columns over S = min(8, MB) ranks of
a thread-block cluster (`kernels.paged_attention.attn_splits`), and the
MVM kernels B1/B2/B5/B6 pick their cluster size and column warps toward a
target number of CTAs or warps (`csrc/cim_mvm.cu`, `launch_packed` and
`launch_dense`). This module lets a small JSON cache override those
choices, keyed by a bucketed shape family, as the reference's cache
overrides its Pallas tiles.

Cache schema (`pico-ram/tune_cache/v1`, the reference's)::

    {
      "schema":   "pico-ram/tune_cache/v1",
      "platform": "sm_90",                     # provenance only
      "torch":    "2.11.0+cu128",              # provenance only
      "entries": {
        "paged_attn|decode_w256|kernel|sm_90": {
            "splits": 4, "block_size": null, "us": 9.1, "default_us": 9.3},
        "cim_mvm|m4_g15_n2048|cuda_packed|sm_90": {
            "cluster": 4, "wcols": 1, "us": 80.0, "default_us": 81.0}
      }
    }

Every entry is keyed `kernel|shape-family|backend|platform`:

* **kernel** — "paged_attn" (consulted by `paged_attention`'s dispatcher
  and the decode route of `models.common.paged_attention_apply`, above
  both the kernel and the plain backend) or "cim_mvm" (consulted by the
  MVM entry points of `kernels.ops`);
* **shape-family** — `attn_family` / `mvm_family`, the reference's
  bucketing;
* **backend** — the port's backend name: "kernel" for attention, and
  "cuda" / "cuda_packed" / "cuda_noisy" / "cuda_noisy_packed" for the MVMs
  (`core.engine`'s backends of B2 / B1 / B5 / B6); the expert-batched
  entries add "_experts". A cache written by the reference (backend
  "pallas", platform "cpu" / "tpu") therefore misses, never hits;
* **platform** — "cpu" for a CPU tensor, `sm_{major}{minor}` of the
  tensor's card otherwise ("sm_90" on the H100), taken from the tensor's
  device.

The knobs, each bit-exact against the kernel's plain version at every
value it may take:

* "cim_mvm": `cluster` (the cluster size the launcher asks for, 1-8) and
  `wcols` (warps side by side along the columns, 1, 2, 4 or 8). The
  digital sum is one ascending `__fmaf_rn` chain over the groups however
  they are split over ranks and warps, so every value gives the default's
  bits. A value the geometry cannot take (a cluster larger than the group
  count, codes that do not fit in shared memory) is clamped by the host
  launcher, which alone decides what it takes, and the launch is counted
  once (`KERNEL_COUNTERS.tune_cache["cim_mvm:clamp"]`), never an error;
* "paged_attn": `splits`, B3's S (1 to min(8, MB)). A different S
  combines the ranks' softmax states in another order and may move the
  last bits, so the dispatcher hands the same S to the kernel and to its
  plain version;
* "paged_attn": `block_size`, a pool-layout recommendation that only
  `launch.serve` acts on, when `--block-size` is not given.

`REPRO_TUNE_CACHE` points at the cache file (`serve.py --tune-cache` sets
it). Explicit keyword arguments win over the cache. No env, a missing
file, malformed JSON, a wrong schema or non-dict entries all give an
empty cache: the kernels keep their built-in choices. A file that cannot
be read warns once and counts `KERNEL_COUNTERS.count_fallback()`. The
file is re-read when its mtime changes, checked at most once a second
(`RECHECK_S`) and at once after `save_cache`. Each lookup under a set env
counts `KERNEL_COUNTERS.tune_lookup(kernel, hit=)`.
"""
from __future__ import annotations

import functools
import json
import os
import time
import warnings

import torch

from repro_torch.runtime.telemetry import KERNEL_COUNTERS

CACHE_SCHEMA = "pico-ram/tune_cache/v1"
CACHE_ENV = "REPRO_TUNE_CACHE"

# single-slot memo: the path as given, its mtime when last read, its
# entries, and until when (time.monotonic) they stand without a new stat
_STATE: dict = {"key": None, "entries": {}, "path": None, "until": 0.0}
# how long a read cache stands before its mtime is checked again: the
# dispatchers look up once per MVM, and one stat each cost ~0.3 ms of
# host time on an H100 machine's host (PERF.md §6)
RECHECK_S = 1.0


def _bucket(n: int) -> int:
    """Round up to the next power of two (shape-family coarsening)."""
    return 1 << max(0, int(n - 1).bit_length())


def attn_family(window: int, c: int) -> str:
    """Shape family for the paged-attention kernel: decode (C = 1) vs
    prefill, window bucketed to the next power of two."""
    mode = "decode" if c == 1 else "prefill"
    return f"{mode}_w{_bucket(window)}"


def mvm_family(m: int, groups: int, n: int) -> str:
    """Shape family for the CIM MVM kernels: rows bucketed, contraction
    keyed by its macro-group count, output width exact."""
    return f"m{_bucket(m)}_g{groups}_n{n}"


def platform_of(device) -> str:
    """"cpu" for the CPU, "sm_{major}{minor}" for a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return _cuda_platform(device.index)


@functools.lru_cache(maxsize=16)
def _cuda_platform(index) -> str:
    major, minor = torch.cuda.get_device_capability(index)
    return f"sm_{major}{minor}"


def cache_key(kernel: str, family: str, backend: str,
              platform: str = "cpu") -> str:
    return "|".join((kernel, family, backend, platform))


def cache_path() -> str | None:
    p = os.environ.get(CACHE_ENV, "").strip()
    return p or None


def load_cache(path: str | None = None) -> dict:
    """Entries dict from `path` (default: $REPRO_TUNE_CACHE), {} on any
    problem: a tuning cache is an accelerant, never a dependency. Re-read
    when the file's mtime changes, checked at most once every RECHECK_S
    seconds, and at once after `save_cache` writes a cache."""
    if path is None:
        path = cache_path()
    if not path:
        return {}
    now = time.monotonic()
    if path == _STATE["path"] and now < _STATE["until"]:
        return _STATE["entries"]
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = None
    _STATE["path"], _STATE["until"] = path, now + RECHECK_S
    key = (path, mtime)
    if _STATE["key"] == key:
        return _STATE["entries"]
    entries: dict = {}
    if mtime is not None:
        try:
            with open(path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict) or doc.get("schema") != CACHE_SCHEMA:
                schema = doc.get("schema") if isinstance(doc, dict) else None
                raise ValueError(f"unknown tune-cache schema {schema!r} "
                                 f"(want {CACHE_SCHEMA})")
            raw = doc.get("entries", {})
            if not isinstance(raw, dict):
                raise ValueError("tune-cache entries must be an object")
            entries = {str(k): v for k, v in raw.items()
                       if isinstance(v, dict)}
        except (OSError, ValueError) as e:
            KERNEL_COUNTERS.count_fallback()
            warnings.warn(f"ignoring tune cache {path!r}: {e}", stacklevel=2)
    _STATE["key"] = key
    _STATE["entries"] = entries
    return entries


def lookup(kernel: str, family: str, backend: str, platform: str = "cpu",
           path: str | None = None) -> dict | None:
    """The tuned config dict for (kernel, family, backend, platform), or
    None on a miss: callers keep their built-in defaults then."""
    entries = load_cache(path)
    if not entries:
        return None
    return entries.get(cache_key(kernel, family, backend, platform))


def tuned(kernel: str, family: str, backend: str, device) -> dict:
    """The dispatchers' lookup: {} without a cache; under a set env one
    counted lookup, the entry on a hit, {} on a miss."""
    if not cache_path():
        return {}
    entry = lookup(kernel, family, backend, platform_of(device))
    KERNEL_COUNTERS.tune_lookup(kernel, hit=entry is not None)
    return entry or {}


def save_cache(path: str, entries: dict, platform: str | None = None) -> dict:
    """Write `entries` as a schema-v1 cache file (atomically: a temporary
    file, then os.replace); returns the document."""
    if platform is None:
        platform = platform_of("cuda" if torch.cuda.is_available()
                               else "cpu")
    doc = {
        "schema": CACHE_SCHEMA,
        "platform": platform,
        "torch": torch.__version__,
        "entries": entries,
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    _STATE["until"] = 0.0            # the next lookup reads what was written
    return doc


# ---------------------------------------------------------------------------
# candidate enumeration (timed on the card by chip_smoke.py's phase "tune")
# ---------------------------------------------------------------------------
def attn_candidates(mb: int, block_size: int | None = None) -> list[dict]:
    """B3 split candidates for a block table of MB columns: every S from
    1 to min(8, MB), the default min(8, MB) first; with the pool's
    pagination stated, coarser pool blocks (4x, 8x, where MB divides) as
    layout candidates for serve.py. The default first, so tuning can only
    tie or win."""
    top = max(1, min(8, mb))
    out = [{"splits": top, "block_size": block_size}]
    out += [{"splits": s, "block_size": block_size}
            for s in range(1, top)]
    if block_size is not None:
        for mult in (4, 8):
            if mb % mult == 0:
                out.append({"splits": max(1, min(8, mb // mult)),
                            "block_size": block_size * mult})
    return out


def mvm_candidates(groups: int) -> list[dict]:
    """Cluster-size x column-warp candidates for the MVM kernels over
    `groups` macro groups: the built-in heuristic first ({} = cluster 0,
    wcols 0), then every cluster 1, 2, 4, 8 up to the group count at one
    column warp, then the widest column tiles at the smallest and the
    largest cluster."""
    out = [{"cluster": 0, "wcols": 0}]
    clusters = [c for c in (1, 2, 4, 8) if c <= max(1, groups)]
    out += [{"cluster": c, "wcols": 1} for c in clusters]
    for wc in (2, 4, 8):
        out += [{"cluster": c, "wcols": wc}
                for c in sorted({clusters[0], clusters[-1]})]
    return out
