"""Serving-stack telemetry: lifecycle event trace, step snapshots, histograms.

This module is the in-process observability core for the paged serving
engine, a copy of the JAX package's `runtime/telemetry.py`. It is
deliberately stdlib-only (no torch / numpy imports) so every layer of the
stack — ``core.engine``'s dispatch hook included — can import it without
creating a cycle.

Three kinds of state live here:

* **Event trace** — a ring-buffered sequence of structured per-request
  lifecycle events (submit, admit, prefill_chunk, first_token, decode,
  spec_verify, cow_fork, preempt, resume, retire).  Timestamps come from an
  injectable monotonic clock so tests can drive a deterministic fake.
* **Step snapshots** — one :class:`StepSnapshot` per scheduler ``step()``
  sampling pool composition (free / private / shared / cached-cold blocks),
  prefix-trie size, token-budget utilization, lane counts and which step
  shape (chunk width ``c``, all-logits or not) ran.
* **Histograms** — fixed-bucket :class:`Histogram` instances for TTFT, ITL,
  spec-decode accept length and step wall time, with p50/p90/p99 estimation
  by linear interpolation inside the winning bucket.

Kernel/engine-layer counters (`KERNEL_COUNTERS`) are a process-wide
singleton because ``execute_mvm`` dispatch happens deep inside the model
step, far away from any `Server` instance.  The port runs eagerly, so
those counters count CALLS — one per ``execute_mvm`` and one per layer's
attention call, on every step — as documented on the class.

Exporters (Chrome trace-event JSON for Perfetto, Prometheus text
exposition, JSONL) live in :mod:`repro_torch.runtime.obs`.
"""
from __future__ import annotations

import math
import time
from bisect import bisect_left
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import NamedTuple

# ---------------------------------------------------------------------------
# histograms

# Bucket upper bounds (seconds unless noted).  Chosen to straddle both real
# wall clocks (ms..s per eager step) and the fake unit-step clocks tests
# inject.
TTFT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
ITL_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
               0.5, 1.0, 2.5, 10.0)
STEP_BUCKETS = ITL_BUCKETS
# accepted draft tokens per verify step (counts, not seconds)
ACCEPT_BUCKETS = tuple(float(i) for i in range(9))


class Histogram:
    """Fixed-bucket histogram with percentile estimation.

    ``bounds`` are ascending bucket upper edges; an implicit +Inf bucket
    catches overflow.  Percentiles interpolate linearly inside the winning
    bucket, clamped to the observed min/max so single-sample histograms
    report the sample itself rather than a bucket edge.
    """

    def __init__(self, bounds):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly ascending")
        self.counts = [0] * (len(self.bounds) + 1)
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, value: float) -> None:
        v = float(value)
        self.counts[bisect_left(self.bounds, v)] += 1
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def record_many(self, values) -> None:
        """Bulk :meth:`record` — one bound-method call for a whole batch.

        The per-call dispatch is what shows up on the serving hot path
        (``decode_step`` records one ITL sample per lane per step), so the
        loop body binds the attributes once.
        """
        counts, bounds = self.counts, self.bounds
        vmin, vmax, total = self.vmin, self.vmax, self.total
        n = 0
        for value in values:
            v = float(value)
            counts[bisect_left(bounds, v)] += 1
            n += 1
            total += v
            if v < vmin:
                vmin = v
            if v > vmax:
                vmax = v
        self.n += n
        self.total = total
        self.vmin = vmin
        self.vmax = vmax

    def percentile(self, p: float) -> float:
        if self.n == 0:
            return 0.0
        target = max(1, math.ceil((p / 100.0) * self.n))
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            cum += c
            if cum >= target:
                lo = self.bounds[i - 1] if i > 0 else self.vmin
                hi = self.bounds[i] if i < len(self.bounds) else self.vmax
                lo = max(lo, self.vmin)
                hi = min(hi, self.vmax)
                if hi <= lo:
                    return lo
                frac = (target - (cum - c)) / c
                return lo + frac * (hi - lo)
        return self.vmax  # pragma: no cover — unreachable

    def summary(self) -> dict:
        if self.n == 0:
            return {"count": 0}
        return {
            "count": self.n,
            "sum": self.total,
            "mean": self.total / self.n,
            "min": self.vmin,
            "max": self.vmax,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


# ---------------------------------------------------------------------------
# events + snapshots


# Per-request lifecycle event kinds, in canonical per-rid order:
#   submit -> admit -> prefill_chunk* -> first_token
#          -> (decode | spec_verify | cow_fork)*
#          -> (preempt -> resume -> prefill_chunk* ...)*  -> retire
EVENT_KINDS = frozenset({
    "submit", "admit", "resume", "prefill_chunk", "first_token", "decode",
    "spec_verify", "cow_fork", "preempt", "retire",
})


# Event and StepSnapshot are NamedTuples, not dataclasses: construction is
# on the decode hot path (one Event per emitted token, one StepSnapshot per
# step) and tuple construction is several times cheaper — the difference
# shows directly in the telemetry-overhead check.
class Event(NamedTuple):
    """One structured trace event.  ``data`` holds kind-specific fields."""

    kind: str
    t: float
    rid: int = -1
    slot: int = -1
    data: dict | None = None

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "t": self.t, "rid": self.rid,
             "slot": self.slot}
        if self.data:
            d.update(self.data)
        return d


class StepSnapshot(NamedTuple):
    """Scheduler/pool state sampled once per paged ``step()``."""

    step: int
    t: float
    wall_s: float
    active: int
    decode_lanes: int
    prefill_lanes: int
    spec_lanes: int
    c: int                 # compiled chunk width this step ran with
    all_logits: bool       # True when the spec-verify compilation ran
    budget_used: int
    token_budget: int
    blocks_free: int
    blocks_private: int
    blocks_shared: int
    blocks_cached_cold: int
    trie_entries: int

    def to_dict(self) -> dict:
        return {
            "kind": "step_snapshot", "step": self.step, "t": self.t,
            "wall_s": self.wall_s, "active": self.active,
            "decode_lanes": self.decode_lanes,
            "prefill_lanes": self.prefill_lanes,
            "spec_lanes": self.spec_lanes, "c": self.c,
            "all_logits": self.all_logits,
            "budget_used": self.budget_used,
            "token_budget": self.token_budget,
            "blocks_free": self.blocks_free,
            "blocks_private": self.blocks_private,
            "blocks_shared": self.blocks_shared,
            "blocks_cached_cold": self.blocks_cached_cold,
            "trie_entries": self.trie_entries,
        }


# ---------------------------------------------------------------------------
# kernel / engine counters


@dataclass
class KernelCounters:
    """Process-wide engine/kernel dispatch + energy counters.

    PER CALL: the ``execute_mvm`` hook (`core.engine`) and the attention
    hook (`models.common.paged_attention_apply` at the one-launch decode,
    `kernels.paged_attention.paged_attention` otherwise) run on every
    eager call, so one serving step adds one ``backend_dispatch`` count
    and one ``site_energy`` record per MVM (169 for internlm2-1.8b: 24
    layers x 7 weights + the head) and one ``attn_dispatch`` count per
    layer.  With the kernel backends these equal the kernels' launch
    counts (`kernels.build.launch_counts()`).  (The JAX package counts at
    trace time instead: once per compiled shape.)

    Under CUDA-graph capture a hook fires once, while the step is
    captured; a replay of the graph runs no Python and counts nothing.

    The hooks read shapes only, never a tensor's values, so they add no
    host-device synchronisation.  Host-side counters (drafter, tune-cache,
    fallback warnings) count real calls as well.
    """

    backend_dispatch: Counter = field(default_factory=Counter)
    attn_dispatch: Counter = field(default_factory=Counter)
    tune_cache: Counter = field(default_factory=Counter)
    fallback_warnings: int = 0
    drafter: Counter = field(default_factory=Counter)
    # site -> {"calls": execute_mvm calls, "dots": K-deep dot products
    # summed over those calls (rows x out-cols each), "energy_j":
    # paper-model Eq.4 energy for those dots}
    site_energy: dict = field(default_factory=dict)

    def count_backend(self, name: str) -> None:
        self.backend_dispatch[name] += 1

    def count_attn(self, name: str) -> None:
        self.attn_dispatch[name] += 1

    def tune_lookup(self, kernel: str, hit: bool) -> None:
        self.tune_cache[f"{kernel}:{'hit' if hit else 'miss'}"] += 1

    def tune_clamp(self, kernel: str) -> None:
        """A tuned launch knob the geometry could not take, clamped."""
        self.tune_cache[f"{kernel}:clamp"] += 1

    def count_fallback(self) -> None:
        self.fallback_warnings += 1

    def count_drafter(self, event: str) -> None:
        self.drafter[event] += 1

    def add_site_energy(self, site: str, energy_j: float, dots: int) -> None:
        rec = self.site_energy.setdefault(
            site, {"calls": 0, "dots": 0, "energy_j": 0.0})
        rec["calls"] += 1
        rec["dots"] += int(dots)
        rec["energy_j"] += float(energy_j)

    def snapshot(self) -> dict:
        return {
            "backend_dispatch": dict(self.backend_dispatch),
            "attn_dispatch": dict(self.attn_dispatch),
            "tune_cache": dict(self.tune_cache),
            "fallback_warnings": self.fallback_warnings,
            "drafter": dict(self.drafter),
            "site_energy": {k: dict(v) for k, v in self.site_energy.items()},
        }

    def reset(self) -> None:
        self.backend_dispatch.clear()
        self.attn_dispatch.clear()
        self.tune_cache.clear()
        self.fallback_warnings = 0
        self.drafter.clear()
        self.site_energy.clear()


#: Singleton the engine/kernel hooks write into.  Reset via
#: ``KERNEL_COUNTERS.reset()`` (tests) — serving code only reads it.
KERNEL_COUNTERS = KernelCounters()


# ---------------------------------------------------------------------------
# per-server telemetry


# Pending-buffer auto-flush threshold: bounds memory between reads while
# keeping the replay pass far off the per-step hot path (~3 ops/step, so a
# mid-serve flush fires once per ~1400 steps — a GC-pause-scale hiccup).
_FLUSH_AT = 4096


class Telemetry:
    """Per-:class:`~repro_torch.runtime.server.Server` telemetry sink.

    ``clock`` is any zero-arg callable returning monotonic seconds; tests
    inject a deterministic fake.  With ``enabled=False`` every recording
    method early-returns after serving the clock, so the telemetry-off
    overhead is one attribute check per call site.

    Recording is TWO-PHASE.  The hooks the Server calls from inside
    ``step()`` do nothing but append one small raw tuple to a pending
    list — on a serving step measured in milliseconds every Python
    operation spent aggregating would land directly on TTFT/ITL, and
    in-situ (cold-cache, right after the model step) each op costs
    several times its microbenchmark price.  The aggregation — Event
    construction, ring append, histogram bucketing, per-rid ITL marks —
    happens in :meth:`_flush`, which replays the raw tuples in order.
    Every read surface (``events``, ``snapshots``, ``counters``, the
    histograms, :meth:`summary`) is a property/method that flushes
    first, so readers never observe the buffering; a size threshold
    (``_FLUSH_AT``) bounds pending memory on export-free runs.  The
    hot-phase cost is held under 3 % of step wall (`chip_smoke.py`
    phase 3t); the deferred replay runs at export time (or amortised
    ~once per 1400 steps mid-serve).
    """

    def __init__(self, *, enabled: bool = True, clock=time.monotonic,
                 capacity: int = 65536, snapshot_capacity: int = 16384):
        self.enabled = bool(enabled)
        self.clock = clock
        self._events: deque[Event] = deque(maxlen=capacity)
        self._snapshots: deque[StepSnapshot] = deque(
            maxlen=snapshot_capacity)
        self._counters: Counter = Counter()  # total events by kind (no cap)
        self._ttft = Histogram(TTFT_BUCKETS)
        self._itl = Histogram(ITL_BUCKETS)
        self._accept_len = Histogram(ACCEPT_BUCKETS)
        self._step_wall = Histogram(STEP_BUCKETS)
        self.kernel = KERNEL_COUNTERS
        self._last_emit: dict[int, float] = {}   # rid -> t (replay state)
        self._pending: list[tuple] = []
        self._replay = {
            "event": self._rp_event, "submit": self._rp_submit,
            "admit": self._rp_admit, "prefill_chunk": self._rp_prefill,
            "first_token": self._rp_first_token,
            "emission": self._rp_emission, "decode": self._rp_decode_step,
            "spec_verify": self._rp_spec_verify, "retire": self._rp_retire,
            "snap": self._rp_snap,
        }

    # -- clock ------------------------------------------------------------
    def now(self) -> float:
        return self.clock()

    # -- hot-phase hooks (called by Server; append raw tuples only) -------
    def event(self, kind: str, rid: int = -1, slot: int = -1,
              t: float | None = None, **data) -> None:
        """Generic event.  ``t=None`` stamps the clock NOW (not at flush)."""
        if not self.enabled:
            return
        p = self._pending
        p.append(("event", kind, rid, slot,
                  self.clock() if t is None else t, data or None))
        if len(p) >= _FLUSH_AT:
            self._flush()

    def submit(self, rid: int, t: float, prompt_len: int,
               n_samples: int) -> None:
        if not self.enabled:
            return
        p = self._pending
        p.append(("submit", rid, t, prompt_len, n_samples))
        if len(p) >= _FLUSH_AT:
            self._flush()

    def admit(self, rid: int, slot: int, t: float, *, prefix_hit_blocks: int,
              prefill_tokens: int, resume: bool = False,
              fork: bool = False) -> None:
        if not self.enabled:
            return
        p = self._pending
        p.append(("admit", rid, slot, t, prefix_hit_blocks, prefill_tokens,
                  resume, fork))
        if len(p) >= _FLUSH_AT:
            self._flush()

    def prefill_chunk(self, rid: int, slot: int, t: float, tokens: int,
                      done: int, total: int) -> None:
        if not self.enabled:
            return
        p = self._pending
        p.append(("prefill_chunk", rid, slot, t, tokens, done, total))
        if len(p) >= _FLUSH_AT:
            self._flush()

    def first_token(self, rid: int, slot: int, t: float,
                    t_submit: float) -> None:
        if not self.enabled:
            return
        p = self._pending
        p.append(("first_token", rid, slot, t, t_submit))
        if len(p) >= _FLUSH_AT:
            self._flush()

    def emission(self, rid: int, slot: int, t: float,
                 tokens: int = 1) -> None:
        """One token emission outside the batched plain-decode path.

        Used by spec-verify (multi-token: the ITL sample is the per-token
        effective latency ``(t - last) / tokens``, the quantity
        speculative decoding improves), resume completions, and the
        legacy slot engine.  Plain decode uses :meth:`decode_step`.
        """
        if not self.enabled:
            return
        p = self._pending
        p.append(("emission", rid, slot, t, tokens))
        if len(p) >= _FLUSH_AT:
            self._flush()

    def decode_step(self, lanes: list, t: float) -> None:
        """Batched decode emissions: ``lanes`` is ``[(rid, slot), ...]``.

        The hottest hook — one call per paged ``step()`` covering every
        plain-decode lane.  Per-lane ITL samples and ``decode`` counter
        semantics are preserved at replay, but the ring gets a SINGLE
        event carrying the lane list (``data={"lanes": [...]}``; rid/slot
        stamp the first lane).  ``obs.chrome_trace`` expands it back into
        one instant per lane, so the exported trace is unchanged.
        """
        if not self.enabled or not lanes:
            return
        p = self._pending
        p.append(("decode", lanes, t))
        if len(p) >= _FLUSH_AT:
            self._flush()

    def spec_verify(self, rid: int, slot: int, t: float, *, drafted: int,
                    accepted: int, emitted: int) -> None:
        if not self.enabled:
            return
        p = self._pending
        p.append(("spec_verify", rid, slot, t, drafted, accepted, emitted))
        if len(p) >= _FLUSH_AT:
            self._flush()

    def cow_fork(self, rid: int, slot: int, t: float, src_block: int,
                 dst_block: int) -> None:
        self.event("cow_fork", rid, slot, t, src_block=src_block,
                   dst_block=dst_block)

    def preempt(self, rid: int, slot: int, t: float,
                tokens_done: int) -> None:
        self.event("preempt", rid, slot, t, tokens_done=tokens_done)

    def retire(self, rid: int, slot: int, t: float, *, tokens: int,
               latency_s: float | None) -> None:
        if not self.enabled:
            return
        p = self._pending
        p.append(("retire", rid, slot, t, tokens, latency_s))
        if len(p) >= _FLUSH_AT:
            self._flush()

    def step_snapshot(self, step, t, wall_s, active, decode_lanes,
                      prefill_lanes, spec_lanes, c, all_logits, budget_used,
                      token_budget, blocks_free, blocks_private,
                      blocks_shared, blocks_cached_cold,
                      trie_entries) -> None:
        # explicit parameter list (not **kw): the kwargs repack showed up
        # in the overhead check, and both legs pay the binding
        if not self.enabled:
            return
        p = self._pending
        p.append(("snap", step, t, wall_s, active, decode_lanes,
                  prefill_lanes, spec_lanes, c, all_logits, budget_used,
                  token_budget, blocks_free, blocks_private, blocks_shared,
                  blocks_cached_cold, trie_entries))
        if len(p) >= _FLUSH_AT:
            self._flush()

    # -- replay (aggregation) phase ---------------------------------------
    def _flush(self) -> None:
        """Replay pending raw tuples, in order, into the read structures."""
        pending = self._pending
        if not pending:
            return
        self._pending = []
        replay = self._replay
        for op in pending:
            replay[op[0]](*op[1:])

    def _rp_event(self, kind, rid, slot, t, data) -> None:
        self._counters[kind] += 1
        self._events.append(Event(kind, t, rid, slot, data))

    def _rp_submit(self, rid, t, prompt_len, n_samples) -> None:
        self._rp_event("submit", rid, -1, t,
                       {"prompt_len": prompt_len, "n_samples": n_samples})

    def _rp_admit(self, rid, slot, t, prefix_hit_blocks, prefill_tokens,
                  resume, fork) -> None:
        data = {"prefix_hit_blocks": prefix_hit_blocks,
                "prefill_tokens": prefill_tokens}
        if fork:
            data["fork"] = True
        self._rp_event("resume" if resume else "admit", rid, slot, t, data)

    def _rp_prefill(self, rid, slot, t, tokens, done, total) -> None:
        self._rp_event("prefill_chunk", rid, slot, t,
                       {"tokens": tokens, "done": done, "total": total})

    def _rp_first_token(self, rid, slot, t, t_submit) -> None:
        ttft = t - t_submit
        self._ttft.record(ttft)
        self._last_emit[rid] = t
        self._rp_event("first_token", rid, slot, t, {"ttft_s": ttft})

    def _rp_emission(self, rid, slot, t, tokens) -> None:
        last = self._last_emit.get(rid)
        if last is not None and t >= last:
            self._itl.record((t - last) / tokens if tokens > 1
                             else t - last)
        self._last_emit[rid] = t
        self._rp_event("decode", rid, slot, t, {"tokens": tokens})

    def _rp_decode_step(self, lanes, t) -> None:
        last = self._last_emit
        samples = []
        for rid, _slot in lanes:
            lt = last.get(rid)
            if lt is not None and t >= lt:
                samples.append(t - lt)
            last[rid] = t
        if samples:
            self._itl.record_many(samples)
        self._counters["decode"] += len(lanes)
        rid0, slot0 = lanes[0]
        self._events.append(Event("decode", t, rid0, slot0,
                                  {"lanes": lanes}))

    def _rp_spec_verify(self, rid, slot, t, drafted, accepted,
                        emitted) -> None:
        self._accept_len.record(accepted)
        self._rp_event("spec_verify", rid, slot, t,
                       {"drafted": drafted, "accepted": accepted,
                        "emitted": emitted})

    def _rp_retire(self, rid, slot, t, tokens, latency_s) -> None:
        self._last_emit.pop(rid, None)
        self._rp_event("retire", rid, slot, t,
                       {"tokens": tokens, "latency_s": latency_s})

    def _rp_snap(self, *fields) -> None:
        self._step_wall.record(fields[2])        # wall_s
        self._snapshots.append(StepSnapshot(*fields))

    # -- read surfaces (flush first, so buffering is never observable) ----
    @property
    def events(self) -> deque:
        self._flush()
        return self._events

    @property
    def snapshots(self) -> deque:
        self._flush()
        return self._snapshots

    @property
    def counters(self) -> Counter:
        self._flush()
        return self._counters

    @property
    def ttft(self) -> Histogram:
        self._flush()
        return self._ttft

    @property
    def itl(self) -> Histogram:
        self._flush()
        return self._itl

    @property
    def accept_len(self) -> Histogram:
        self._flush()
        return self._accept_len

    @property
    def step_wall(self) -> Histogram:
        self._flush()
        return self._step_wall

    # -- management -------------------------------------------------------
    def reset(self) -> None:
        """Clear per-run state (events, snapshots, histograms, ITL marks).

        Does NOT touch :data:`KERNEL_COUNTERS` — that singleton is shared
        across servers and owned by whoever resets it explicitly.
        """
        self._pending.clear()
        self._events.clear()
        self._snapshots.clear()
        self._counters.clear()
        self._last_emit.clear()
        self._ttft = Histogram(TTFT_BUCKETS)
        self._itl = Histogram(ITL_BUCKETS)
        self._accept_len = Histogram(ACCEPT_BUCKETS)
        self._step_wall = Histogram(STEP_BUCKETS)

    def summary(self) -> dict:
        self._flush()
        return {
            "events": dict(self._counters),
            "ttft": self._ttft.summary(),
            "itl": self._itl.summary(),
            "accept_len": self._accept_len.summary(),
            "step_wall": self._step_wall.summary(),
            "kernel": self.kernel.snapshot(),
        }
