"""Per-layer mixed analog precision autotuner.

The paper's energy headline is converter-bound: at the native 362 levels the
TD-ADC is ~48 % of a BP group MVM's energy (Eq. 4 with the §IV gating), and
TD-ADC energy scales ~linearly with LEVELS — so per-call-site ADC resolution
is the dominant serving energy knob, and different call sites can afford
very different resolutions (a K=2048 FFN reduction hides more ADC noise per
output than the logit head the argmax reads). This module searches that
space:

    profile  = calibrate_act_tree(...)          # per-site grids + shapes
    manifest = search(params, cal_tokens, cfg)  # greedy per-site descent
    save_manifest(path, manifest)
    # serving:  Server(..., ServingConfig(precision_manifest=path))
    # launch:   python -m repro_torch.launch.serve ... \
    #               --precision-manifest path

Per site the search enumerates (ADC bits → levels via
core.precision.adc_levels_for_bits, scheme bp vs wbs/bs via
core.schemes/macro.Scheme, per-channel vs per-matrix weight scales) and
scores each candidate against:

* `core.energy.mvm_energy` — Eq. 4 energy/token from the profile's
  (k, m, rows) traffic counts (every ADC constant derives from core.adc's
  single source of truth, so this sweep cannot diverge from the Fig. 21
  golden);
* an SQNR screen (`core.sqnr.simulate_sqnr` at the site's K) that discards
  candidates below a quantization-noise floor before touching the model;
* a held-out logit-KL probe: the candidate config runs through the LIVE
  per-site dispatch path (CIMConfig.site_overrides resolved by
  cim_matmul.resolve_site_cfg) and the mean KL(base ‖ candidate) of the
  next-token distributions on held-out tokens must stay inside the
  iso-accuracy budget.

The result is a versioned JSON deployment manifest (schema
"pico-ram/precision_manifest/v1": unknown schema / malformed file / wrong
arch degrade to uniform defaults with a warning, never an error) that
`ServingConfig(precision_manifest=...)` consumes. The probes run the
port's eager forward on the params' device; the SQNR screen draws its
codes from a torch.Generator (core.sqnr), so a candidate whose SQNR lies
within the Monte-Carlo spread of the floor may be screened differently
from the reference's search.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings

import torch

from repro_torch.analysis.calibrate import (_calibration_cfg,
                                            calibrate_act_tree,
                                            params_device, token_tensor)
from repro_torch.core import energy as energy_mod
from repro_torch.core.cim_matmul import SitePrecision
from repro_torch.core.macro import Scheme
from repro_torch.core.precision import (ADC_BIT_CANDIDATES,
                                        adc_levels_for_bits)

MANIFEST_SCHEMA = "pico-ram/precision_manifest/v1"


# ---------------------------------------------------------------------------
# energy accounting (Eq. 4 over the calibration traffic profile)
# ---------------------------------------------------------------------------
def site_energy_per_token_j(entry: dict, cfg, *, adc_levels: int | None = None,
                            scheme: str | None = None,
                            n_tokens: int = 1) -> float:
    """Energy/token of one call site under a candidate (levels, scheme).

    entry is a calibrate_act_tree site record: `rows` is the summed MVM row
    count over the calibration batch (layers × batch × tokens [× expert
    capacity]), `m` the output columns, `k` the reduction depth — so the
    site runs rows·m K-deep single-column MVMs per n_tokens tokens.
    """
    macro = cfg.cim.macro
    if adc_levels is not None:
        macro = dataclasses.replace(macro, adc_levels=adc_levels)
    if scheme is not None:
        macro = dataclasses.replace(macro, scheme=Scheme(scheme))
    rep = energy_mod.mvm_energy(macro, entry["k"])
    m = entry["m"] or 1
    return rep.e_mvm_j * m * entry["rows"] / max(n_tokens, 1)


def energy_per_token_j(tree: dict, cfg, overrides: dict,
                       n_tokens: int) -> float:
    """Total model energy/token under per-site overrides ({} = uniform)."""
    total = 0.0
    for name, entry in tree["sites"].items():
        ov = overrides.get(name)
        total += site_energy_per_token_j(
            entry, cfg,
            adc_levels=ov.adc_levels if ov else None,
            scheme=ov.scheme if ov else None,
            n_tokens=n_tokens)
    return total


# ---------------------------------------------------------------------------
# accuracy proxies
# ---------------------------------------------------------------------------
def _sqnr_db(cfg, k: int, *, adc_levels: int, scheme: str, seed: int,
             device=None) -> float:
    """Quantization-only SQNR screen at the site's reduction depth (small
    seeded Monte-Carlo — a coarse filter before the model-level KL probe)."""
    from repro_torch.core.sqnr import simulate_sqnr
    macro = dataclasses.replace(cfg.cim.macro, adc_levels=adc_levels,
                                scheme=Scheme(scheme))
    res = simulate_sqnr(macro, k=max(k, 1), n_samples=1 << 10,
                        batch=1 << 10, seed=seed, device=device)
    return res.sqnr_db


def _logits(params, tokens, cfg, mod):
    """Eager forward log-probs under a candidate CIM config (live per-site
    dispatch: site_overrides resolve inside the model's matmuls). The LM
    stack's forward returns hidden states; the head projection (itself a
    CIM site, resolving any "head" override) is applied here."""
    with torch.no_grad():
        out = mod.forward(params, {"tokens": token_tensor(tokens, params)},
                          cfg, train=False)
        h = out[0] if isinstance(out, tuple) else out
        if isinstance(params, dict) and "tok" in params:
            from repro_torch.models.common import unembed
            h = unembed(params["tok"], h, cfg)
        return torch.log_softmax(h.float(), dim=-1)


def logit_kl(base_logp: torch.Tensor, cand_logp: torch.Tensor) -> float:
    """Mean next-token KL(base ‖ candidate) over all probe positions."""
    p = torch.exp(base_logp)
    return float(torch.mean(torch.sum(p * (base_logp - cand_logp), dim=-1)))


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------
def _probe_cfg(cfg, overrides: dict, tree: dict):
    """The eager probe config: unrolled/einsum like calibration, with the
    per-site static grids + candidate overrides installed."""
    site_overrides = tuple(sorted(
        (name, _site_precision(name, overrides.get(name), tree))
        for name in tree["sites"]))
    cal = _calibration_cfg(cfg)
    cim = dataclasses.replace(
        cal.cim, site_overrides=site_overrides,
        act=dataclasses.replace(
            cal.cim.act, static_scale=tree["default"]["scale"],
            static_zero_point=tree["default"]["zero_point"]))
    return cal.replace(cim=cim)


def _site_precision(name: str, ov: SitePrecision | None,
                    tree: dict) -> SitePrecision:
    """Fold the site's calibrated static grid into its (possibly None)
    search override — every site always carries its own grid."""
    entry = tree["sites"][name]
    base = ov or SitePrecision()
    return dataclasses.replace(base, act_scale=entry["scale"],
                               act_zero_point=entry["zero_point"])


def search(params, cal_tokens, cfg, *, holdout_tokens=None, seed: int = 0,
           kl_budget: float = 0.08, max_sqnr_drop_db: float = 9.5,
           bit_candidates=ADC_BIT_CANDIDATES, schemes=("bp",),
           try_per_channel: bool = True, percentile: float = 1.0,
           mod=None) -> dict:
    """Greedy per-site precision descent → deployment manifest (dict).

    Deterministic under a fixed `seed` (it keys the SQNR Monte-Carlo and the
    synthetic holdout batch): same inputs → identical manifest.

    Both accuracy gates anchor on references, not on the candidate alone —
    changing ADC levels redraws the whole quantization grid, so a candidate
    differs from the native-levels run by the quantization error itself and
    a candidate-vs-native distance would reject everything:

    * SQNR screen: the site's candidate SQNR (at its reduction depth K) must
      stay within `max_sqnr_drop_db` of the NATIVE-resolution SQNR at the
      same K — a per-site coarseness floor from quantization theory alone.
    * KL probe: the model's held-out next-token KL against the FLOAT
      reference may exceed the uniform-native config's KL by at most
      `kl_budget` ("iso-accuracy-proxy": the mixed config tracks the float
      model as well as uniform native does, within the budget).

    Sites are visited in descending uniform-energy share; per site,
    candidates run coarsest-first ((levels ascending) × schemes ×
    per-channel) and the first that passes both gates wins, so every
    accepted override monotonically lowers energy at bounded proxy drift.
    """
    if mod is None:
        from repro_torch.models import registry
        mod = registry.get_module(cfg)
    device = params_device(params)
    if holdout_tokens is None:
        import numpy as np
        rng = np.random.RandomState(seed + 101)
        holdout_tokens = rng.randint(0, cfg.vocab, size=(2, 12))

    tree = calibrate_act_tree(params, cal_tokens, cfg, percentile=percentile,
                              mod=mod)
    n_tokens = int(torch.as_tensor(cal_tokens).numel())
    base_levels = cfg.cim.macro.adc_levels
    base_scheme = cfg.cim.macro.scheme.value

    # float reference + the iso-accuracy BASELINE: uniform native precision
    # on the per-site static grids (the grids are the calibration fix, not
    # the search's savings — the energy win is measured grid-for-grid)
    float_cfg = _calibration_cfg(cfg)
    float_cfg = float_cfg.replace(
        cim=dataclasses.replace(float_cfg.cim, enabled=False))
    ref_logp = _logits(params, holdout_tokens, float_cfg, mod)
    kl_uniform = logit_kl(ref_logp,
                          _logits(params, holdout_tokens,
                                  _probe_cfg(cfg, {}, tree), mod))
    uniform_pj = energy_per_token_j(tree, cfg, {}, n_tokens)

    # candidate ladder: coarsest first, native resolution excluded (it is
    # the baseline); schemes beyond bp multiply ADC conversions (Eq. 4), so
    # they are enumerated but can only win if bp's candidates all fail
    levels_ladder = sorted({adc_levels_for_bits(b) for b in bit_candidates
                            if adc_levels_for_bits(b) < base_levels})
    share = {n: site_energy_per_token_j(e, cfg, n_tokens=n_tokens)
             for n, e in tree["sites"].items()}
    native_sqnr = {k: _sqnr_db(cfg, k, adc_levels=base_levels,
                               scheme=base_scheme, seed=seed, device=device)
                   for k in {e["k"] for e in tree["sites"].values()}}
    overrides: dict[str, SitePrecision] = {}
    trace = []
    kl_now = kl_uniform
    for name in sorted(tree["sites"], key=lambda n: -share[n]):
        entry = tree["sites"][name]
        floor_db = native_sqnr[entry["k"]] - max_sqnr_drop_db
        picked = None
        for levels in levels_ladder:
            cands = [(levels, sch, pc)
                     for sch in schemes
                     for pc in ((False, True) if try_per_channel
                                else (False,))]
            # within one resolution, cheapest first (scheme energy order)
            cands.sort(key=lambda c: site_energy_per_token_j(
                entry, cfg, adc_levels=c[0], scheme=c[1],
                n_tokens=n_tokens))
            for levels_c, scheme_c, pc in cands:
                if _sqnr_db(cfg, entry["k"], adc_levels=levels_c,
                            scheme=scheme_c, seed=seed,
                            device=device) < floor_db:
                    continue
                cand = SitePrecision(adc_levels=levels_c, scheme=scheme_c,
                                     per_channel=pc or None)
                trial = dict(overrides)
                trial[name] = cand
                kl = logit_kl(ref_logp,
                              _logits(params, holdout_tokens,
                                      _probe_cfg(cfg, trial, tree), mod))
                if kl <= kl_uniform + kl_budget:
                    picked, kl_now = cand, kl
                    break
            if picked is not None:
                break
        if picked is not None:
            overrides[name] = picked
            trace.append({"site": name, "adc_levels": picked.adc_levels,
                          "scheme": picked.scheme,
                          "per_channel": bool(picked.per_channel),
                          "kl": kl_now})

    mixed_pj = energy_per_token_j(tree, cfg, overrides, n_tokens)
    sites = {}
    for name, entry in tree["sites"].items():
        ov = overrides.get(name)
        sites[name] = {
            "act_scale": entry["scale"],
            "act_zero_point": entry["zero_point"],
            "adc_levels": ov.adc_levels if ov else base_levels,
            "scheme": (ov.scheme if ov and ov.scheme else base_scheme),
            "per_channel": bool(ov.per_channel) if ov else False,
            "k": entry["k"], "m": entry["m"], "calls": entry["calls"],
        }
    return {
        "schema": MANIFEST_SCHEMA,
        "arch": cfg.arch,
        "seed": seed,
        "act_qmax": tree["qmax"],
        "base_adc_levels": base_levels,
        "default": {"act_scale": tree["default"]["scale"],
                    "act_zero_point": tree["default"]["zero_point"]},
        "sites": sites,
        "metrics": {
            "uniform_pj_per_token": uniform_pj * 1e12,
            "mixed_pj_per_token": mixed_pj * 1e12,
            "energy_win": uniform_pj / max(mixed_pj, 1e-30),
            "kl_uniform": kl_uniform,   # KL(float ‖ uniform native grid)
            "kl_proxy": kl_now,         # KL(float ‖ final mixed config)
            "kl_budget": kl_budget,
            "trace": trace,
        },
    }


# ---------------------------------------------------------------------------
# manifest I/O — a bad file degrades to uniform defaults with a warning
# ---------------------------------------------------------------------------
def save_manifest(path: str, manifest: dict) -> None:
    """Atomic write (tmp + rename)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def load_manifest(path: str, *, arch: str | None = None) -> dict | None:
    """Load a deployment manifest; ANY problem (missing file, malformed
    JSON, unknown schema version, wrong arch) degrades to None — uniform
    defaults — with a warning: a stale or corrupt precision file must
    never take serving down."""
    try:
        with open(path) as f:
            doc = json.load(f)
        if doc.get("schema") != MANIFEST_SCHEMA:
            raise ValueError(f"schema {doc.get('schema')!r} != "
                             f"{MANIFEST_SCHEMA!r}")
        if arch is not None and doc.get("arch") != arch:
            raise ValueError(f"manifest arch {doc.get('arch')!r} != "
                             f"serving arch {arch!r} (stale manifest)")
        if not isinstance(doc.get("sites"), dict):
            raise ValueError("missing per-site table")
        return doc
    except (OSError, ValueError) as e:
        warnings.warn(f"ignoring precision manifest {path!r}: {e} — "
                      "serving with uniform precision defaults")
        return None


def manifest_overrides(manifest: dict) -> tuple:
    """CIMConfig.site_overrides from a manifest (hashable tuple-of-pairs,
    sorted by site name for a deterministic static-arg identity)."""
    out = []
    for name in sorted(manifest.get("sites", {})):
        s = manifest["sites"][name]
        out.append((name, SitePrecision(
            act_scale=float(s["act_scale"]),
            act_zero_point=float(s.get("act_zero_point", 0.0)),
            adc_levels=int(s["adc_levels"]),
            scheme=str(s.get("scheme", "bp")),
            per_channel=bool(s.get("per_channel", False)) or None)))
    return tuple(out)


def apply_manifest(cim_cfg, manifest: dict | None):
    """The serving-side application: per-site overrides + the whole-model
    default static grid. None (failed load) returns cim_cfg unchanged —
    the uniform-defaults degradation path."""
    if manifest is None:
        return cim_cfg
    act = dataclasses.replace(
        cim_cfg.act,
        static_scale=float(manifest["default"]["act_scale"]),
        static_zero_point=float(manifest["default"].get("act_zero_point",
                                                        0.0)))
    return dataclasses.replace(cim_cfg, act=act,
                               site_overrides=manifest_overrides(manifest))


def pareto_points(manifest: dict) -> list[dict]:
    """(energy/token, kl) points of a Pareto table: the uniform baseline
    and the searched mixed config."""
    m = manifest["metrics"]
    levels = manifest.get("base_adc_levels", 362)
    return [
        {"config": f"uniform 4b×4b BP ({levels}-level ADC)",
         "pj_per_token": m["uniform_pj_per_token"],
         "kl": m.get("kl_uniform", 0.0)},
        {"config": "mixed (per-site ADC levels, searched)",
         "pj_per_token": m["mixed_pj_per_token"], "kl": m["kl_proxy"]},
    ]
