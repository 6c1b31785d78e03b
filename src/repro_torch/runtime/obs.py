"""Telemetry exporters: Chrome trace-event JSON, Prometheus text, JSONL.

Consumes a :class:`repro_torch.runtime.telemetry.Telemetry` instance and
renders it for external tooling (a copy of the JAX package's
`runtime/obs.py`; the dispatch and energy counters it exports count
calls here, see `telemetry.KernelCounters`):

* :func:`chrome_trace` — Chrome trace-event JSON (the Perfetto / legacy
  ``chrome://tracing`` format): one track per serving slot carrying
  ``req<rid>`` spans from admit/resume to retire/preempt, plus a scheduler
  track with per-``step()`` slices and KV-pool counter series.  Load the
  file at https://ui.perfetto.dev.
* :func:`validate_chrome_trace` — structural schema check used by CI on the
  emitted artifact; also runnable directly::

      python -m repro_torch.runtime.obs trace.json

* :func:`prometheus_text` — Prometheus text-exposition snapshot (histograms
  with ``_bucket``/``_sum``/``_count``, counters, pool gauges, per-site CIM
  energy).
* :func:`write_events_jsonl` — raw event + snapshot log, one JSON object
  per line.

This module is stdlib-only, like ``telemetry`` itself.
"""
from __future__ import annotations

import json
import sys

_PID = 1
_SCHED_TID = 0
# ph values the exporter emits; the validator rejects anything else.
_KNOWN_PH = frozenset({"M", "B", "E", "X", "i", "C"})

# event kinds rendered as instants on the request's slot track
_INSTANT_KINDS = ("prefill_chunk", "first_token", "decode", "spec_verify",
                  "cow_fork")


def _us(t: float, t0: float) -> float:
    return round((t - t0) * 1e6, 3)


def chrome_trace(tel, *, process_name: str = "pico-ram serve") -> dict:
    """Render the telemetry ring buffers as a Chrome trace-event document.

    Track layout: tid 0 is the scheduler (step slices, submit instants,
    KV-pool counters); tid ``slot + 1`` carries that slot's request spans.
    Ring-buffer truncation is handled by construction: an ``E`` whose ``B``
    was evicted is dropped, and spans still open at export time are closed
    with a synthetic ``E`` flagged ``{"truncated": true}``.
    """
    events = list(tel.events)
    snaps = list(tel.snapshots)
    times = [e.t for e in events] + [s.t - s.wall_s for s in snaps]
    t0 = min(times) if times else 0.0
    t_end = max([e.t for e in events] + [s.t for s in snaps], default=0.0)

    out = [
        {"ph": "M", "pid": _PID, "tid": _SCHED_TID, "ts": 0,
         "name": "process_name", "args": {"name": process_name}},
        {"ph": "M", "pid": _PID, "tid": _SCHED_TID, "ts": 0,
         "name": "thread_name", "args": {"name": "scheduler"}},
    ]
    named_tids = {_SCHED_TID}

    def slot_tid(slot: int) -> int:
        tid = slot + 1
        if tid not in named_tids:
            named_tids.add(tid)
            out.append({"ph": "M", "pid": _PID, "tid": tid, "ts": 0,
                        "name": "thread_name",
                        "args": {"name": f"slot {slot}"}})
        return tid

    open_spans: dict[int, list[str]] = {}   # tid -> stack of span names

    for e in events:
        args = {"rid": e.rid}
        if e.data:
            args.update(e.data)
        if e.kind == "submit":
            out.append({"ph": "i", "pid": _PID, "tid": _SCHED_TID,
                        "ts": _us(e.t, t0), "s": "t",
                        "name": f"submit req{e.rid}", "args": args})
        elif e.kind in ("admit", "resume"):
            tid = slot_tid(e.slot)
            name = f"req{e.rid}"
            open_spans.setdefault(tid, []).append(name)
            out.append({"ph": "B", "pid": _PID, "tid": tid,
                        "ts": _us(e.t, t0), "name": name, "cat": e.kind,
                        "args": args})
        elif e.kind in ("retire", "preempt"):
            tid = slot_tid(e.slot)
            name = f"req{e.rid}"
            stack = open_spans.get(tid, [])
            if stack and stack[-1] == name:
                stack.pop()
                out.append({"ph": "E", "pid": _PID, "tid": tid,
                            "ts": _us(e.t, t0), "name": name,
                            "cat": e.kind, "args": args})
            # else: the matching B fell out of the ring buffer — drop the E
        elif e.kind == "decode" and e.data and "lanes" in e.data:
            # batched per-step decode event (Telemetry.decode_step):
            # expand back into one instant per emitting lane
            for rid, slot in e.data["lanes"]:
                out.append({"ph": "i", "pid": _PID, "tid": slot_tid(slot),
                            "ts": _us(e.t, t0), "s": "t", "name": "decode",
                            "args": {"rid": rid}})
        elif e.kind in _INSTANT_KINDS:
            out.append({"ph": "i", "pid": _PID, "tid": slot_tid(e.slot),
                        "ts": _us(e.t, t0), "s": "t", "name": e.kind,
                        "args": args})

    # close spans still open at export time (mid-run export)
    for tid, stack in open_spans.items():
        while stack:
            out.append({"ph": "E", "pid": _PID, "tid": tid,
                        "ts": _us(t_end, t0), "name": stack.pop(),
                        "args": {"truncated": True}})

    for s in snaps:
        ts = _us(s.t - s.wall_s, t0)
        out.append({"ph": "X", "pid": _PID, "tid": _SCHED_TID, "ts": ts,
                    "dur": round(s.wall_s * 1e6, 3),
                    "name": f"step c={s.c}" + (" spec" if s.all_logits else ""),
                    "args": s.to_dict()})
        out.append({"ph": "C", "pid": _PID, "tid": _SCHED_TID,
                    "ts": _us(s.t, t0), "name": "kv_pool",
                    "args": {"free": s.blocks_free,
                             "private": s.blocks_private,
                             "shared": s.blocks_shared,
                             "cached_cold": s.blocks_cached_cold}})
        out.append({"ph": "C", "pid": _PID, "tid": _SCHED_TID,
                    "ts": _us(s.t, t0), "name": "lanes",
                    "args": {"decode": s.decode_lanes,
                             "prefill": s.prefill_lanes,
                             "spec": s.spec_lanes}})

    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"telemetry": tel.summary()}}


def validate_chrome_trace(doc) -> list[str]:
    """Structural schema check on a Chrome trace-event document.

    Returns a list of problems (empty == valid).  Checks: top-level shape,
    required per-event fields, known ``ph`` values, numeric non-negative
    timestamps, ``X`` durations >= 0, and balanced ``B``/``E`` nesting per
    thread track.
    """
    problems: list[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["top level must be an object with a traceEvents list"]
    stacks: dict[tuple, list[str]] = {}
    for i, ev in enumerate(doc["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _KNOWN_PH:
            problems.append(f"{where}: unknown ph {ph!r}")
            continue
        for key in ("pid", "tid", "ts", "name"):
            if key not in ev:
                problems.append(f"{where}: missing {key!r}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: X event with bad dur {dur!r}")
        elif ph == "B":
            stacks.setdefault((ev.get("pid"), ev.get("tid")),
                              []).append(ev.get("name"))
        elif ph == "E":
            stack = stacks.get((ev.get("pid"), ev.get("tid")), [])
            if not stack:
                problems.append(f"{where}: E without open B on its track")
            else:
                opened = stack.pop()
                if opened != ev.get("name"):
                    problems.append(
                        f"{where}: E {ev.get('name')!r} closes B "
                        f"{opened!r}")
        elif ph == "i" and ev.get("s") not in (None, "t", "p", "g"):
            problems.append(f"{where}: bad instant scope {ev.get('s')!r}")
    for (pid, tid), stack in stacks.items():
        if stack:
            problems.append(
                f"track pid={pid} tid={tid}: {len(stack)} unclosed B "
                f"event(s): {stack}")
    return problems


# ---------------------------------------------------------------------------
# Prometheus text exposition


def _prom_hist(lines: list[str], name: str, hist, help_text: str) -> None:
    lines.append(f"# HELP {name} {help_text}")
    lines.append(f"# TYPE {name} histogram")
    cum = 0
    for bound, count in zip(hist.bounds, hist.counts):
        cum += count
        lines.append(f'{name}_bucket{{le="{bound:g}"}} {cum}')
    lines.append(f'{name}_bucket{{le="+Inf"}} {hist.n}')
    lines.append(f"{name}_sum {hist.total:g}")
    lines.append(f"{name}_count {hist.n}")


def prometheus_text(tel, server=None) -> str:
    """Render telemetry (and optionally ``server.metrics``) as a Prometheus
    text-exposition snapshot."""
    lines: list[str] = []
    _prom_hist(lines, "picoram_ttft_seconds", tel.ttft,
               "time to first token")
    _prom_hist(lines, "picoram_itl_seconds", tel.itl,
               "inter-token latency per decode step")
    _prom_hist(lines, "picoram_accept_length", tel.accept_len,
               "accepted draft tokens per spec-decode verify step")
    _prom_hist(lines, "picoram_step_wall_seconds", tel.step_wall,
               "scheduler step wall time")

    lines.append("# HELP picoram_events_total lifecycle trace events by kind")
    lines.append("# TYPE picoram_events_total counter")
    for kind in sorted(tel.counters):
        lines.append(f'picoram_events_total{{kind="{kind}"}} '
                     f"{tel.counters[kind]}")

    k = tel.kernel
    lines.append("# HELP picoram_mvm_dispatch_total execute_mvm backend "
                 "picks (one per call, every step)")
    lines.append("# TYPE picoram_mvm_dispatch_total counter")
    for name in sorted(k.backend_dispatch):
        lines.append(f'picoram_mvm_dispatch_total{{backend="{name}"}} '
                     f"{k.backend_dispatch[name]}")
    lines.append("# HELP picoram_attn_dispatch_total paged-attention "
                 "backend picks (one per layer call, every step)")
    lines.append("# TYPE picoram_attn_dispatch_total counter")
    for name in sorted(k.attn_dispatch):
        lines.append(f'picoram_attn_dispatch_total{{backend="{name}"}} '
                     f"{k.attn_dispatch[name]}")
    lines.append("# HELP picoram_tune_cache_total tuning-cache lookups")
    lines.append("# TYPE picoram_tune_cache_total counter")
    for key in sorted(k.tune_cache):
        kernel, outcome = key.rsplit(":", 1)
        lines.append(f'picoram_tune_cache_total{{kernel="{kernel}",'
                     f'outcome="{outcome}"}} {k.tune_cache[key]}')
    lines.append("# HELP picoram_tune_cache_fallback_warnings_total "
                 "malformed tune caches ignored at load")
    lines.append("# TYPE picoram_tune_cache_fallback_warnings_total counter")
    lines.append(f"picoram_tune_cache_fallback_warnings_total "
                 f"{k.fallback_warnings}")
    lines.append("# HELP picoram_drafter_total drafter proposal outcomes")
    lines.append("# TYPE picoram_drafter_total counter")
    for name in sorted(k.drafter):
        lines.append(f'picoram_drafter_total{{event="{name}"}} '
                     f"{k.drafter[name]}")
    lines.append("# HELP picoram_mvm_energy_joules_total paper-model CIM "
                 "MVM energy per weight site across execute_mvm calls")
    lines.append("# TYPE picoram_mvm_energy_joules_total counter")
    for site in sorted(k.site_energy):
        lines.append(f'picoram_mvm_energy_joules_total{{site="{site}"}} '
                     f"{k.site_energy[site]['energy_j']:.6e}")
    lines.append("# HELP picoram_mvm_traced_dots_total K-deep dot products "
                 "per weight site across execute_mvm calls")
    lines.append("# TYPE picoram_mvm_traced_dots_total counter")
    for site in sorted(k.site_energy):
        lines.append(f'picoram_mvm_traced_dots_total{{site="{site}"}} '
                     f"{k.site_energy[site]['dots']}")

    if server is not None:
        m = server.metrics.to_dict()
        pool_keys = {"blocks_total", "blocks_free", "blocks_private",
                     "blocks_shared", "blocks_cached_cold", "trie_entries"}
        lines.append("# HELP picoram_server_metric aggregate ServerMetrics "
                     "counters")
        lines.append("# TYPE picoram_server_metric gauge")
        for key in sorted(m):
            if key in pool_keys or key == "accept_hist":
                continue
            val = m[key]
            if isinstance(val, (int, float)):
                lines.append(f'picoram_server_metric{{name="{key}"}} '
                             f"{val:g}")
        lines.append("# HELP picoram_kv_blocks KV pool composition")
        lines.append("# TYPE picoram_kv_blocks gauge")
        for state in ("free", "private", "shared", "cached_cold"):
            if f"blocks_{state}" in m:
                lines.append(f'picoram_kv_blocks{{state="{state}"}} '
                             f"{m[f'blocks_{state}']}")
        if "trie_entries" in m:
            lines.append("# HELP picoram_trie_entries prefix-trie cached "
                         "block entries")
            lines.append("# TYPE picoram_trie_entries gauge")
            lines.append(f"picoram_trie_entries {m['trie_entries']}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# JSONL


def write_events_jsonl(tel, path: str) -> int:
    """Write events + step snapshots as JSONL; returns the line count."""
    n = 0
    with open(path, "w") as f:
        for e in tel.events:
            f.write(json.dumps(e.to_dict()) + "\n")
            n += 1
        for s in tel.snapshots:
            f.write(json.dumps(s.to_dict()) + "\n")
            n += 1
    return n


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m repro_torch.runtime.obs <trace.json>",
              file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        doc = json.load(f)
    problems = validate_chrome_trace(doc)
    if problems:
        for p in problems:
            print(f"INVALID: {p}", file=sys.stderr)
        return 1
    print(f"ok: {argv[0]} valid ({len(doc['traceEvents'])} trace events)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
