"""Static activation-scale calibration for CIM serving.

The dynamic per-tensor act_scale (core.quant) takes a global max over the
batched activation tensor, so every lane's 4-bit DAC grid depends on what
else shares the batch: CIM-mode serving outputs change with batch
COMPOSITION. The hardware has no such coupling: the paper's input
interface is a fixed charge-domain C-DAC reference, i.e. a CALIBRATED
STATIC grid.

    cal = calibrate_act_scale(params, tokens, cfg)
    server = Server(params, cfg, ServingConfig(
        ..., act_scale=cal["scale"], act_zero_point=cal["zero_point"]))

`collect_act_spans` runs one forward (`models.transformer.forward`, eager,
on the `einsum` CIM backend with the DYNAMIC scale, which is what is being
measured) with a recorder hooked into core.quant.act_scale and returns the
per-matmul activation spans in call order — `quant.SpanRecord` entries
(floats carrying the call-site name, the signed range [lo, hi] and the
(k, m, rows) shape) — one per CIM-routed matmul. Recording reads each span
back to the host; only calibration does that.

Two reductions of that profile:

* `calibrate_act_scale` — ONE static (scale, zero_point) grid for the whole
  model (max span / qmax, optionally a percentile over call sites; the zero
  point covers the profile's most negative tail).
* `calibrate_act_tree` — the PER-CALL-SITE tree: one (scale, zero_point) +
  range/shape entry per site name ("wq", "w_up", "head", ...). Site names
  exclude the layer index, so each site resolves one constant grid; this is
  the profile the mixed-precision search (analysis.precision_search)
  searches over.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import quant


def _calibration_cfg(cfg):
    """The config the calibration forward runs under: CIM enabled with the
    DYNAMIC scale, the deterministic einsum backend, no noise seed, layer
    scan off (the port's forward is eager either way)."""
    cim = cfg.cim
    if not cim.enabled:
        raise ValueError("activation calibration needs cfg.cim.enabled")
    cim = dataclasses.replace(
        cim, backend="einsum", noise_seed=None,
        act=dataclasses.replace(cim.act, static_scale=None))
    return cfg.replace(cim=cim, scan_layers=False)


def params_device(params) -> torch.device:
    """The device of the first tensor in a parameter tree."""
    stack = [params]
    while stack:
        node = stack.pop()
        if torch.is_tensor(node):
            return node.device
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    raise ValueError("parameter tree holds no tensor")


def token_tensor(tokens, params) -> torch.Tensor:
    """Token ids [B, T] as an int32 tensor on the params' device."""
    return torch.as_tensor(tokens, dtype=torch.int32).to(
        params_device(params))


def collect_act_spans(params, tokens, cfg, *, mod=None) -> list:
    """Per-matmul activation spans (max − min(·, 0)), in call order, over
    one eager forward of `tokens` [B, T]. Entries are `quant.SpanRecord`
    (float subclass) carrying (site, lo, hi, k, m, rows)."""
    if mod is None:
        from repro_torch.models import registry
        mod = registry.get_module(cfg)
    cal_cfg = _calibration_cfg(cfg)
    with torch.no_grad(), quant.record_act_spans() as spans:
        mod.forward(params, {"tokens": token_tensor(tokens, params)},
                    cal_cfg, train=False)
    if not spans:
        raise RuntimeError("calibration forward recorded no activation "
                           "spans — did every matmul bypass the CIM path?")
    return spans


def _grid(lo: float, span: float, qmax: int) -> tuple[float, float]:
    """(scale, zero_point) covering [min(lo, 0), min(lo, 0) + span]."""
    scale = span / qmax
    zp = float(round(min(max(-min(lo, 0.0) / scale, 0.0), float(qmax))))
    return scale, zp


def _percentile_span(spans, percentile: float) -> float:
    ordered = sorted(float(s) for s in spans)
    return ordered[max(0, math.ceil(percentile * len(ordered)) - 1)]


def _check_percentile(percentile: float) -> None:
    if not 0.0 < percentile <= 1.0:
        raise ValueError(f"percentile must be in (0, 1], got {percentile}")


def calibrate_act_scale(params, tokens, cfg, *, percentile: float = 1.0,
                        mod=None) -> dict:
    """One static DAC grid from a calibration batch.

    percentile < 1.0 drops the hottest call sites from the max (the VTC
    gain trade of Fig. 15). Returns {"scale", "zero_point", "spans",
    "span", "qmax"}; feed (scale, zero_point) to ServingConfig(act_scale=,
    act_zero_point=) / ActQuantConfig(static_scale=, static_zero_point=).
    """
    _check_percentile(percentile)
    spans = collect_act_spans(params, tokens, cfg, mod=mod)
    span = _percentile_span(spans, percentile)
    qmax = cfg.cim.act.qmax
    lo = min((r.lo for r in spans), default=0.0)
    scale, zp = _grid(lo, span, qmax)
    return {"scale": scale, "zero_point": zp, "span": span, "spans": spans,
            "qmax": qmax}


def calibrate_act_tree(params, tokens, cfg, *, percentile: float = 1.0,
                       mod=None) -> dict:
    """Per-call-site calibration tree from one eager calibration forward.

    Per site (layer-index-free name), the range is the min/percentile-max
    envelope over every call that hit it, reduced to a static
    (scale, zero_point) grid plus the shape/traffic metadata (k, m, rows,
    calls) the precision search's energy accounting consumes.

    Returns {"sites": {name: {"scale", "zero_point", "lo", "hi", "span",
    "k", "m", "rows", "calls"}}, "default": the whole-model grid,
    "qmax": ...} with sites in order of first appearance.
    """
    _check_percentile(percentile)
    spans = collect_act_spans(params, tokens, cfg, mod=mod)
    qmax = cfg.cim.act.qmax
    by_site: dict[str, list] = {}
    for r in spans:
        by_site.setdefault(r.site or "<unnamed>", []).append(r)
    sites = {}
    for name, recs in by_site.items():
        span = _percentile_span(recs, percentile)
        lo = min(r.lo for r in recs)
        scale, zp = _grid(lo, span, qmax)
        sites[name] = {
            "scale": scale, "zero_point": zp, "lo": lo,
            "hi": max(r.hi for r in recs), "span": span,
            "k": max(r.k for r in recs),
            "m": max((r.m for r in recs if r.m is not None), default=None),
            "rows": sum(r.rows for r in recs), "calls": len(recs)}
    lo_all = min(r.lo for r in spans)
    span_all = _percentile_span(spans, percentile)
    scale, zp = _grid(lo_all, span_all, qmax)
    return {"sites": sites,
            "default": {"scale": scale, "zero_point": zp, "span": span_all,
                        "lo": lo_all},
            "qmax": qmax}
