"""Continuous-batching serving loop over the paged KV cache: chunked
prefill, watermark admission with preemption, prefix sharing with
copy-on-write, seeded per-request sampling and speculative decoding.

    from repro_torch.runtime.server import Request, Server, ServingConfig
    server = Server(params, cfg, ServingConfig(paged=True, n_slots=4,
                                               max_len=256))

A physical pool of fixed-size KV blocks is shared by all slots through a
refcounted `BlockAllocator` + `PrefixTrie` (runtime.paging) and per-slot
block tables threaded through `models.transformer.paged_step`. Prefill is
chunked through the same step as decode (decode is C = 1), and a token
budget caps new tokens per step (decode lanes first, then prompt chunks).
At admission a prompt is matched against the trie of cached full-block
prefixes (the shared span maps the same physical blocks); a lane about to
write into a block another holder maps first forks it (`_write_plan` →
`cow_copy_block`); when decode growth outruns the pool the newest-admitted
lane is preempted and re-queued with prompt + generated-so-far.

`Request(n_samples=N)` decodes N continuations off ONE prefill: the N − 1
clone requests are made at submit (`req.samples`, clone i sampling with
seed + i + 1) and installed, prefill-free, at the front of the queue when
the parent's prefill completes (`_stash_forks` / `_install_fork`); they
map the parent's whole block chain and copy-on-write its partial tail on
their first write. With `ServingConfig.trie_watermark` set, every `step()`
(idle ones included) sweeps the prefix trie back down to half the
watermark once it caches more than the watermark's share of the pool.

Tokens are drawn by `runtime.speculative.sample_token` (greedy argmax at
temperature 0, else a top-k softmax draw keyed by (request seed, emission
index)). With a drafter (`ServingConfig.drafter`), each decode lane's K
drafted tokens are verified in one C = K + 1 `paged_step(all_logits=True)`
under exact rejection sampling, and rollback is `tables.lens[s] =
committed`.

Every step runs all `n_slots` lanes at one chunk width (1, the prefill
chunk, or spec_k + 1 when a lane drafts), idle lanes included, exactly as
the reference engine does: the dynamic activation scale of the CIM path
spans the whole [B, C, D] tensor, so dropping idle lanes or changing C
would change the quantization grid.

Every Server carries a `runtime.telemetry.Telemetry` (on by default;
`Server(telemetry=...)` injects one, with a fake clock in the tests): the
hooks below append to it at the reference's places, and every timestamp
and `ServerMetrics.wall_s` comes from its clock, so two servers driven by
one fake clock record the same trace.

Not ported yet, and raising NotImplementedError with their ROADMAP item:
static activation grids and precision manifests (A7), the slot engine and
the model drafter (A4e).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.runtime.paging import BlockAllocator, PrefixTrie, SlotTables
from repro_torch.runtime.speculative import (SamplingParams, make_drafter,
                                             parse_drafter, sample_token,
                                             verify_token)
from repro_torch.runtime.telemetry import Telemetry


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Everything the Server needs beyond (params, model cfg); the fields
    of the reference's ServingConfig. `paged` defaults to True here because
    the slot engine is not ported. Speculative decoding: `drafter` picks a
    proposer from the runtime.speculative registry ("off" / "ngram" /
    "model:<name>") and `spec_k` caps drafted tokens per lane per verify
    step. Trie capacity (needs prefix_sharing): `trie_watermark` is a pool
    fraction; when the prefix cache exceeds it, an LRU sweep drains it to
    half that (None: eviction only under admission pressure).
    Observability: `telemetry` enables the per-request event trace, step
    snapshots and latency histograms (runtime.telemetry); the
    Server(telemetry=...) keyword overrides it."""
    n_slots: int = 4
    max_len: int = 128
    prequant: bool = False
    packed: bool = True
    paged: bool = True
    block_size: int = 16
    num_blocks: Optional[int] = None
    prefill_chunk: int = 16
    token_budget: Optional[int] = None
    attn: str = "auto"
    act_scale: Optional[float] = None
    act_zero_point: Optional[float] = None
    precision_manifest: Optional[str] = None
    prefix_sharing: bool = True
    watermark: float = 1 / 16
    drafter: str = "off"
    spec_k: int = 4
    trie_watermark: Optional[float] = None
    telemetry: bool = True

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if self.max_len < 2:
            raise ValueError("max_len must be >= 2")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.token_budget is not None and self.token_budget < 1:
            raise ValueError("token_budget must be >= 1")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.max_len % self.block_size:
            raise ValueError("max_len must be a multiple of block_size")
        if self.num_blocks is not None and self.num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        if not 0.0 <= self.watermark < 1.0:
            raise ValueError("watermark is a pool fraction in [0, 1)")
        if self.spec_k < 1:
            raise ValueError("spec_k must be >= 1 (tokens drafted per "
                             "verify step)")
        from repro_torch.kernels.paged_attention import choose_attn_backend
        choose_attn_backend(self.attn)   # validate the name up front
        name, _ = parse_drafter(self.drafter)   # validate like attn
        if name != "off" and not self.paged:
            raise ValueError("speculative decoding (drafter != 'off') "
                             "needs the paged engine (paged=True)")
        if not self.paged:
            raise _not_ported("the slot-based engine (paged=False)", "A4e")
        if self.act_scale is not None or self.act_zero_point is not None:
            raise _not_ported("static activation grids (act_scale)", "A7")
        if self.precision_manifest is not None:
            raise _not_ported("precision manifests", "A7")
        if self.trie_watermark is not None:
            if not 0.0 < self.trie_watermark <= 1.0:
                raise ValueError("trie_watermark is a pool fraction in "
                                 "(0, 1]")
            if not (self.paged and self.prefix_sharing):
                raise ValueError("trie_watermark needs the paged engine "
                                 "with prefix_sharing enabled")

    @classmethod
    def from_flags(cls, args, **overrides) -> "ServingConfig":
        """Build from an argparse namespace (launch.serve's flag names)."""
        kw = {}
        pairs = [("n_slots", "slots"), ("max_len", "max_len"),
                 ("paged", "paged"), ("block_size", "block_size"),
                 ("num_blocks", "num_blocks"),
                 ("prefill_chunk", "prefill_chunk"),
                 ("token_budget", "token_budget"), ("attn", "attn"),
                 ("watermark", "watermark"), ("drafter", "drafter"),
                 ("spec_k", "spec_k"),
                 ("trie_watermark", "trie_watermark")]
        for field, flag in pairs:
            v = getattr(args, flag, None)
            if v is not None:
                kw[field] = v
        if getattr(args, "no_prefix_sharing", False):
            kw["prefix_sharing"] = False
        if getattr(args, "cim", None) == "bp-prequant":
            kw["prequant"] = True
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    n_samples: int = 1       # continuations off one prefill
    # per-request sampling policy (runtime.speculative): greedy default;
    # temperature/top-k draws are keyed by (sampling.seed, emission index)
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    # filled by the server:
    rid: int = -1
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    samples: list["Request"] = dataclasses.field(default_factory=list)
    # latency timestamps from the Server's telemetry clock
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0

    @property
    def ttft_s(self) -> float:
        return max(self.t_first - self.t_submit, 0.0)

    @property
    def latency_s(self) -> float:
        return max(self.t_done - self.t_submit, 0.0)


@dataclasses.dataclass
class ServerMetrics:
    steps: int = 0
    decode_tokens: int = 0
    prefill_tokens: int = 0
    stalled_prefills: int = 0
    stalled_decodes: int = 0
    preemptions: int = 0
    prefix_hit_tokens: int = 0
    cow_forks: int = 0
    spec_steps: int = 0        # speculative verify steps run
    draft_tokens: int = 0      # tokens proposed by the drafter
    draft_accepted: int = 0    # proposed tokens accepted by verification
    # accept-length histogram: {accepted drafts per verify step: count}
    accept_hist: dict = dataclasses.field(default_factory=dict)
    trie_sweep_freed: int = 0  # blocks freed by trie watermark sweeps
    peak_active: int = 0
    peak_decode_lanes: int = 0
    wall_s: float = 0.0       # time inside step() + admission at submit
    # pool composition sampled at the end of each step (and at
    # construction); see Server._pool_stats
    pool: dict = dataclasses.field(default_factory=dict)

    def summary(self) -> dict:
        w = max(self.wall_s, 1e-9)
        return {"steps": self.steps,
                "decode_tokens": self.decode_tokens,
                "prefill_tokens": self.prefill_tokens,
                "decode_tok_s": self.decode_tokens / w,
                "prefill_tok_s": self.prefill_tokens / w,
                "stalled_prefills": self.stalled_prefills,
                "stalled_decodes": self.stalled_decodes,
                "preemptions": self.preemptions,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "cow_forks": self.cow_forks,
                "spec_steps": self.spec_steps,
                "draft_tokens": self.draft_tokens,
                "draft_accepted": self.draft_accepted,
                "accept_rate": self.draft_accepted / self.draft_tokens
                if self.draft_tokens else 0.0,
                # mean emissions per verify step (accepted drafts + the
                # correction/bonus token)
                "mean_accept_len": 1.0 + self.draft_accepted
                / self.spec_steps if self.spec_steps else 0.0,
                "accept_hist": dict(sorted(self.accept_hist.items())),
                "trie_sweep_freed": self.trie_sweep_freed,
                "peak_active": self.peak_active,
                "peak_decode_lanes": self.peak_decode_lanes,
                "wall_s": self.wall_s}

    def to_dict(self) -> dict:
        """summary() plus the KV-pool composition (shared / private /
        cached-cold block split and prefix-trie entry count)."""
        return {**self.summary(), **self.pool}


class Server:
    def __init__(self, params, cfg: ModelConfig,
                 serving: ServingConfig | None = None, *,
                 telemetry: Telemetry | None = None, device=None):
        serving = serving or ServingConfig()
        self.serving = serving
        self.device = resolve_device(device)
        # a caller-provided sink (tests pass a fake clock) wins over the
        # ServingConfig.telemetry on/off flag
        self.telemetry = telemetry if telemetry is not None \
            else Telemetry(enabled=serving.telemetry)
        cfg = cfg.replace(attn_backend=serving.attn)
        if serving.prequant:
            if not cfg.cim.enabled:
                raise ValueError("prequant serving needs cim.enabled")
            from repro_torch.models.quantize import quantize_params
            params = quantize_params(params, cfg, packed=serving.packed)
        self.params = params
        self.cfg = cfg
        self.n_slots = serving.n_slots
        self.max_len = serving.max_len
        self.mod = registry.get_module(cfg)
        if not self.mod.supports_paged(cfg):
            raise NotImplementedError(
                f"paged serving not supported for arch {cfg.arch!r}")
        self.slot_req: list[Optional[Request]] = [None] * self.n_slots
        self.queue: list[Request] = []
        self._next_rid = 0
        self.steps_run = 0
        self.metrics = ServerMetrics()

        self.block_size = serving.block_size
        max_blocks = self.max_len // self.block_size
        num_blocks = serving.num_blocks
        if num_blocks is None:
            num_blocks = self.n_slots * max_blocks
        self.alloc = BlockAllocator(num_blocks)
        self.tables = SlotTables(self.n_slots, max_blocks, self.block_size)
        self.trie = PrefixTrie(self.block_size) \
            if serving.prefix_sharing else None
        self.prefill_chunk = serving.prefill_chunk
        self.token_budget = serving.token_budget \
            if serving.token_budget is not None \
            else self.n_slots + self.prefill_chunk
        self._watermark = max(1, round(num_blocks * serving.watermark)) \
            if serving.watermark > 0 else 0
        # pool holds num_blocks usable blocks + the trash block (id 0)
        self.cache = self.mod.init_paged_cache(cfg, num_blocks + 1,
                                               self.block_size,
                                               device=self.device)
        # speculative decoding: the drafter instance (None = off); its
        # verify steps score every drafted token in one C=spec_k+1 step
        self.spec_k = serving.spec_k
        self.drafter = make_drafter(serving.drafter, cfg, self.max_len)
        # trie capacity watermarks (block counts; 0 = sweep disabled)
        self._trie_hi = self._trie_lo = 0
        if self.trie is not None and serving.trie_watermark is not None:
            self._trie_hi = max(1, int(num_blocks * serving.trie_watermark))
            self._trie_lo = self._trie_hi // 2
        self._pf_done = np.zeros(self.n_slots, np.int64)
        self._pf_src: list[Optional[list[int]]] = [None] * self.n_slots
        self._slot_seq = np.zeros(self.n_slots, np.int64)
        self._adm_seq = 0
        self._fork_children: dict[int, list[Request]] = {}
        self._fork_ready: dict[int, dict] = {}
        self._rr = 0   # round-robin offset for budget-capped decode
        self._preempted_rids: set[int] = set()
        self.metrics.pool = self._pool_stats()

    # -- request lifecycle ---------------------------------------------------
    def submit(self, req: Request) -> int:
        if not req.prompt:
            raise ValueError("empty prompt")
        if req.n_samples < 1:
            raise ValueError("n_samples must be >= 1")
        if not isinstance(req.sampling, SamplingParams):
            raise ValueError("Request.sampling must be a SamplingParams "
                             f"(runtime.speculative), got "
                             f"{type(req.sampling).__name__}")
        if len(req.prompt) >= self.max_len - 1:
            raise ValueError(f"prompt of {len(req.prompt)} tokens exceeds "
                             f"max_len={self.max_len}")
        need = self._blocks_worst_case(req)
        if req.n_samples > 1:
            # a sibling's CoW fork keeps the shared original alive in the
            # stash while the private copy grows
            need += 1
        if need > self.alloc.stats.num_blocks:
            raise ValueError(f"request needs {need} KV blocks worst-case but "
                             f"the pool only has "
                             f"{self.alloc.stats.num_blocks}")
        tel = self.telemetry
        req.rid = self._next_rid
        req.t_submit = tel.now()
        self._next_rid += 1
        tel.submit(req.rid, req.t_submit, len(req.prompt), req.n_samples)
        if req.n_samples > 1:
            kids = []
            for i in range(req.n_samples - 1):
                # distinct sampling streams (seed + sibling index); greedy
                # clones stay identical to the parent
                c = Request(prompt=list(req.prompt),
                            max_new_tokens=req.max_new_tokens,
                            eos_id=req.eos_id,
                            sampling=dataclasses.replace(
                                req.sampling, seed=req.sampling.seed + i + 1))
                c.rid = self._next_rid
                self._next_rid += 1
                c.t_submit = req.t_submit
                tel.submit(c.rid, c.t_submit, len(c.prompt), 1)
                kids.append(c)
            req.samples = list(kids)
            self._fork_children[req.rid] = kids
        self.queue.append(req)
        t0 = tel.now()
        self._admit()
        self.metrics.wall_s += tel.now() - t0
        return req.rid

    def step(self):
        """One serving step; retires finished requests and re-admits."""
        t0 = self.telemetry.now()
        self._step_paged()
        # the watermark sweep runs every step, idle ones included (where
        # _step_paged returns early), so a cold prefix cache drains
        if self._trie_hi:
            self.metrics.trie_sweep_freed += self.trie.sweep(
                self.alloc, self._trie_hi, self._trie_lo)
        self.metrics.wall_s += self.telemetry.now() - t0

    def _blocks_worst_case(self, req: Request) -> int:
        need = min(len(req.prompt) + req.max_new_tokens, self.max_len)
        return self.tables.blocks_for(need)

    def _available(self) -> int:
        """Blocks admission can count on: free now + trie-evictable."""
        n = self.alloc.stats.free
        if self.trie is not None:
            n += self.trie.evictable(self.alloc)
        return n

    def _admit(self):
        while self.queue:
            try:
                slot = self.slot_req.index(None)
            except ValueError:
                return
            req = self.queue[0]
            if req.rid in self._fork_ready:
                # fork clones map already-referenced blocks: no new
                # blocks, no prefill, no watermark
                self.queue.pop(0)
                self._install_fork(slot, req)
                continue
            # effective prompt: prompt + anything generated before a
            # preemption (resume is a prefill of the longer prompt; the trie
            # turns most of it into a free match)
            eff = req.prompt + req.output
            matched = self.trie.match(eff[:-1]) if self.trie is not None \
                else []
            need = self.tables.blocks_for(len(eff)) - len(matched)
            headroom = self._watermark if any(
                r is not None for r in self.slot_req) else 0
            if self._available() < need + headroom:
                return  # head-of-line waits; active lanes keep draining
            self.queue.pop(0)
            self.slot_req[slot] = req
            self._slot_seq[slot] = self._adm_seq
            self._adm_seq += 1
            if matched:
                self.alloc.incref(matched)
                self.tables.assign(slot, matched,
                                   len(matched) * self.block_size)
                self.metrics.prefix_hit_tokens += \
                    len(matched) * self.block_size
            self._pf_src[slot] = eff
            self._pf_done[slot] = len(matched) * self.block_size
            # a preempted rid re-admitting is a resume (even if it was
            # preempted mid-prefill, before emitting anything)
            resume = req.rid in self._preempted_rids
            self._preempted_rids.discard(req.rid)
            self.telemetry.admit(
                req.rid, slot, self.telemetry.now(),
                prefix_hit_blocks=len(matched),
                prefill_tokens=len(eff) - len(matched) * self.block_size,
                resume=resume)

    def _install_fork(self, slot: int, req: Request):
        info = self._fork_ready.pop(req.rid)
        self.slot_req[slot] = req
        self._slot_seq[slot] = self._adm_seq
        self._adm_seq += 1
        self.tables.assign(slot, info["blocks"], info["lens"])
        self._pf_src[slot] = []          # nothing to prefill: pure decode
        self._pf_done[slot] = 0
        req.output = list(info["output"])
        now = self.telemetry.now()
        self.telemetry.admit(req.rid, slot, now,
                             prefix_hit_blocks=len(info["blocks"]),
                             prefill_tokens=0, fork=True)
        if not req.t_first:
            req.t_first = now
            self.telemetry.first_token(req.rid, slot, now, req.t_submit)
        self.metrics.prefix_hit_tokens += info["lens"]
        if (len(req.output) >= req.max_new_tokens
                or (req.eos_id is not None
                    and req.output[-1] == req.eos_id)):
            self._retire(slot, now)

    def _schedule(self, active):
        """Pick this step's lanes under the token budget: decode first
        (1 token each), then prompt chunks. Returns
        (decode_lanes, dropped_decodes, takes, starved_prefills)."""
        prefilling = [s for s in active
                      if self._pf_done[s] < len(self._pf_src[s])]
        budget = self.token_budget
        cands = [s for s in active if s not in prefilling]
        if cands:
            rot = self._rr % len(cands)
            cands = cands[rot:] + cands[:rot]
        decode_lanes = cands[:budget]
        dropped = len(cands) - len(decode_lanes)
        budget -= len(decode_lanes)
        takes: dict[int, int] = {}
        starved = 0
        for s in prefilling:
            take = min(len(self._pf_src[s]) - int(self._pf_done[s]),
                       self.prefill_chunk, budget)
            if take <= 0:
                starved += 1
                continue
            takes[s] = take
            budget -= take
        return decode_lanes, dropped, takes, starved

    def _write_plan(self, valid_map: dict[int, int]):
        """Blocks this step must acquire: table growth for new positions,
        plus one private copy per shared block about to be written (CoW).
        Returns (total_new_blocks, [(slot, logical_idx, shared_block)])."""
        bs = self.block_size
        need, copies = 0, []
        for s, v in valid_map.items():
            if not v:
                continue
            lens = int(self.tables.lens[s])
            new_len = lens + v
            need += max(0, self.tables.blocks_for(new_len)
                        - int(self.tables.n_alloc[s]))
            for j in range(lens // bs,
                           min((new_len - 1) // bs + 1,
                               int(self.tables.n_alloc[s]))):
                b = int(self.tables.tables[s, j])
                if self.alloc.refcount(b) > 1:
                    copies.append((s, j, b))
                    need += 1
        return need, copies

    def _step_paged(self):
        if not any(r is not None for r in self.slot_req):
            return
        tel = self.telemetry
        t_begin = tel.now()
        # plan the step; preempt the newest-admitted lane while the pool
        # cannot back every write
        while True:
            active = [s for s in range(self.n_slots) if self.slot_req[s]]
            if not active:
                return
            decode_lanes, dropped, takes, starved = self._schedule(active)
            spec = self._plan_spec(decode_lanes)
            valid_map = {s: 1 + len(spec.get(s, ())) for s in decode_lanes}
            valid_map.update(takes)
            need, copies = self._write_plan(valid_map)
            if need <= self._available() or len(active) == 1:
                break
            victim = max(active, key=lambda s: int(self._slot_seq[s]))
            self._preempt(victim)
        self._rr += 1
        self.metrics.stalled_decodes += dropped
        self.metrics.stalled_prefills += starved
        self.metrics.peak_active = max(self.metrics.peak_active, len(active))
        self.metrics.peak_decode_lanes = max(self.metrics.peak_decode_lanes,
                                             len(decode_lanes))
        shortfall = need - self.alloc.stats.free
        if shortfall > 0 and self.trie is not None:
            self.trie.evict(shortfall, self.alloc)
        if not self.alloc.can_acquire(need):
            raise RuntimeError(
                f"pool cannot back this step: need {need} blocks, free "
                f"{self.alloc.stats.free} — scheduler invariant violated")
        for s, j, b in copies:
            [nb] = self.alloc.acquire(1)
            self.cache = self.mod.cow_copy_block(self.cache, b, nb)
            self.tables.replace(s, j, nb, self.alloc)
            self.metrics.cow_forks += 1
            tel.cow_fork(self.slot_req[s].rid, s, tel.now(), b, nb)
        for s, v in valid_map.items():
            if v:
                self.tables.grow(s, int(self.tables.lens[s]) + v, self.alloc)
        # steps whose prefill lanes are all budget-starved run C = 1; spec
        # verify lanes always stamp C = spec_k + 1 (per-lane clamps shrink
        # `valid`, never the chunk width)
        c = self.prefill_chunk if takes else 1
        if spec:
            c = max(c, self.spec_k + 1)
        toks = np.zeros((self.n_slots, c), np.int32)
        valid = np.zeros(self.n_slots, np.int32)
        for s in decode_lanes:
            toks[s, 0] = self.slot_req[s].output[-1]
            drafts = spec.get(s, ())
            toks[s, 1:1 + len(drafts)] = drafts
            valid[s] = 1 + len(drafts)
        for s, take in takes.items():
            done = int(self._pf_done[s])
            toks[s, :take] = self._pf_src[s][done:done + take]
            valid[s] = take
        dev = self.device
        # verify steps need the logits at every chunk position (one row per
        # drafted token plus the bonus)
        logits, self.cache = self.mod.paged_step(
            self.params, torch.from_numpy(toks).to(dev), self.cache,
            torch.from_numpy(self.tables.tables).to(dev),
            torch.from_numpy(self.tables.lens).to(dev),
            torch.from_numpy(valid).to(dev), self.cfg,
            all_logits=bool(spec))
        rows = logits.float().cpu().numpy()              # [B, V] or [B, C, V]
        now = tel.now()
        dec_lanes = []      # plain-decode emissions, one batched event
        retires = []
        for s in active:
            if not valid[s]:
                continue
            req = self.slot_req[s]
            if s in takes:
                self.tables.lens[s] += int(valid[s])
                self._pf_done[s] += int(valid[s])
                self.metrics.prefill_tokens += int(valid[s])
                tel.prefill_chunk(req.rid, s, now, int(valid[s]),
                                  int(self._pf_done[s]), len(self._pf_src[s]))
                if self._pf_done[s] == len(self._pf_src[s]):
                    row = rows[s, int(valid[s]) - 1] if rows.ndim == 3 \
                        else rows[s]
                    # emission index = len(output): 0 for a fresh prompt,
                    # the resume index after preemption
                    req.output.append(
                        sample_token(row, req.sampling, len(req.output)))
                    if not req.t_first:
                        req.t_first = now
                        tel.first_token(req.rid, s, now, req.t_submit)
                    else:
                        # a resume re-emits: its ITL sample spans the
                        # preemption gap on purpose
                        tel.emission(req.rid, s, now)
                    self._register_prefix(s)
                    self._stash_forks(s)
                    if (len(req.output) >= req.max_new_tokens
                            or (req.eos_id is not None
                                and req.output[-1] == req.eos_id)):
                        self._retire(s, now)
                continue
            if s in spec:
                self._apply_verify(s, rows[s], spec[s], now)
                continue
            self.tables.lens[s] += 1
            row = rows[s, 0] if rows.ndim == 3 else rows[s]
            nxt = sample_token(row, req.sampling, len(req.output))
            req.output.append(nxt)
            self.metrics.decode_tokens += 1
            dec_lanes.append((req.rid, s))
            exhausted = len(req.output) >= req.max_new_tokens
            hit_eos = req.eos_id is not None and nxt == req.eos_id
            full = int(self.tables.lens[s]) + 1 >= self.max_len - 1
            if exhausted or hit_eos or full:
                retires.append(s)
        # the step's plain emissions as one event, THEN the retires, so
        # each rid's events end with its retire
        tel.decode_step(dec_lanes, now)
        for s in retires:
            self._retire(s, now)
        self.steps_run += 1
        self.metrics.steps += 1
        t_end = tel.now()
        pool = self._pool_stats()
        self.metrics.pool = pool
        # positional, in StepSnapshot's field order (the reference's
        # binding; both telemetry legs pay it)
        tel.step_snapshot(
            self.steps_run, t_end, t_end - t_begin,
            len(active), len(decode_lanes), len(takes),
            len(spec), c, bool(spec),
            int(valid.sum()), self.token_budget,
            pool["blocks_free"], pool["blocks_private"],
            pool["blocks_shared"], pool["blocks_cached_cold"],
            pool["trie_entries"])
        self._admit()

    def _plan_spec(self, decode_lanes) -> dict[int, list[int]]:
        """Draft proposals for this step's decode lanes: {slot: tokens}.

        Per-lane k is clamped so the verify step never proposes past the
        request's remaining allowance (the correction/bonus token always
        fits) nor writes past the slot window. Both clamps and the
        proposals are functions of the lane's own state, so a lane drafts
        the same tokens whether it serves alone or in a full batch. Lanes
        clamped to k=0 fall back to plain 1-token decode."""
        if self.drafter is None:
            return {}
        spec = {}
        for s in decode_lanes:
            req = self.slot_req[s]
            lens0 = int(self.tables.lens[s])
            k = min(self.spec_k,
                    req.max_new_tokens - len(req.output) - 1,
                    self.max_len - 2 - lens0)
            if k > 0:
                drafts = self.drafter.propose(req.prompt + req.output, k)
                spec[s] = [int(t) for t in drafts]
        return spec

    def _apply_verify(self, s: int, rows, drafts: list[int], now: float):
        """Commit one lane's verify-step results.

        Walks the per-position target rows in plain-decode order (emission
        index = len(output)): each drafted token is accepted or replaced by
        exact rejection sampling (runtime.speculative.verify_token); the
        first rejection's row yields the replacement, and a fully accepted
        run earns the bonus token from the last row. Retirement checks
        (exhaustion / EOS / window full) run after every emission as the
        plain decode loop would. Rollback is truncation: kv_len becomes the
        committed prefix (prev token + matched drafts); rejected positions
        stay past kv_len, masked, until later writes overwrite them."""
        req = self.slot_req[s]
        lens0 = int(self.tables.lens[s])
        matched = emitted = 0
        retire = False
        self.metrics.spec_steps += 1
        self.metrics.draft_tokens += len(drafts)
        for i in range(len(drafts) + 1):
            idx = len(req.output)
            if i < len(drafts):
                tok, ok = verify_token(rows[i], drafts[i], req.sampling,
                                       idx)
            else:   # every draft matched: the bonus row is a free token
                tok, ok = sample_token(rows[i], req.sampling, idx), False
            req.output.append(int(tok))
            emitted += 1
            if ok:
                matched += 1
            self.metrics.decode_tokens += 1
            exhausted = len(req.output) >= req.max_new_tokens
            hit_eos = req.eos_id is not None and int(tok) == req.eos_id
            # plain-decode parity: before this emission the plain loop
            # would have written lens0 + emitted tokens and checked
            # lens + 1 against max_len - 1
            full = lens0 + emitted + 1 >= self.max_len - 1
            if exhausted or hit_eos or full:
                retire = True
                break
            if not ok:
                break
        self.metrics.draft_accepted += matched
        self.metrics.accept_hist[matched] = \
            self.metrics.accept_hist.get(matched, 0) + 1
        self.telemetry.spec_verify(req.rid, s, now, drafted=len(drafts),
                                   accepted=matched, emitted=emitted)
        self.telemetry.emission(req.rid, s, now, tokens=emitted)
        self.tables.lens[s] = lens0 + 1 + matched
        if retire:
            self._retire(s, now)

    def _register_prefix(self, slot: int):
        """Cache the completed prefill's full prompt blocks in the trie."""
        if self.trie is None:
            return
        src = self._pf_src[slot]
        nfull = len(src) // self.block_size
        if nfull:
            self.trie.insert(src[:nfull * self.block_size],
                             self.tables.held(slot)[:nfull], self.alloc)

    def _stash_forks(self, slot: int):
        """The parent's prefill just completed: reference its whole block
        chain once per clone and queue the clones at the front (they need
        no new blocks, so they never wait on the watermark)."""
        req = self.slot_req[slot]
        kids = self._fork_children.pop(req.rid, None)
        if not kids:
            return
        held = self.tables.held(slot)
        for c_req in reversed(kids):
            self.alloc.incref(held)
            self._fork_ready[c_req.rid] = {
                "blocks": list(held),
                "lens": int(self.tables.lens[slot]),
                "output": list(req.output)}
            self.queue.insert(0, c_req)

    def _preempt(self, slot: int):
        """Evict a running lane under pool pressure: register its full
        blocks in the trie, release its refs, and re-queue it at the head
        with prompt + generated-so-far as the effective prompt."""
        req = self.slot_req[slot]
        lens = int(self.tables.lens[slot])
        if self.trie is not None and lens >= self.block_size:
            nfull = lens // self.block_size
            stream = (req.prompt + req.output)[:nfull * self.block_size]
            self.trie.insert(stream, self.tables.held(slot)[:nfull],
                             self.alloc)
        self.tables.release(slot, self.alloc)
        self.slot_req[slot] = None
        self._pf_src[slot] = None
        self._pf_done[slot] = 0
        self.queue.insert(0, req)
        self.metrics.preemptions += 1
        self._preempted_rids.add(req.rid)
        self.telemetry.preempt(req.rid, slot, self.telemetry.now(),
                               tokens_done=len(req.output))

    def _retire(self, slot: int, now: float):
        req = self.slot_req[slot]
        req.done = True
        req.t_done = now
        self.telemetry.retire(req.rid, slot, now, tokens=len(req.output),
                              latency_s=req.latency_s)
        self.tables.release(slot, self.alloc)
        self.slot_req[slot] = None
        self._pf_src[slot] = None
        self._pf_done[slot] = 0

    def run_until_drained(self, max_steps: int = 10_000):
        while any(self.slot_req) or self.queue:
            before = self.steps_run
            self.step()
            if self.steps_run == before:
                self._admit()
                if not any(self.slot_req):
                    raise RuntimeError("admission stalled with an empty "
                                       "batch — the head request cannot fit")
            if self.steps_run > max_steps:
                raise RuntimeError("serving loop did not drain")

    # -- capacity / reporting -------------------------------------------------
    def _pool_stats(self) -> dict:
        """KV-pool composition: `blocks_shared` counts blocks of refcount
        >= 2, `blocks_cached_cold` blocks whose only reference is the trie,
        `blocks_private` the rest of the blocks in use (one live lane
        each); shared + cached_cold + private + free == blocks_total."""
        st = self.alloc.stats
        cold = self.trie.cached_cold(self.alloc) \
            if self.trie is not None else 0
        return {"blocks_total": st.num_blocks,
                "blocks_free": st.free,
                "blocks_shared": st.shared,
                "blocks_cached_cold": cold,
                "blocks_private": st.private - cold,
                "trie_entries": self.trie.cached_blocks
                if self.trie is not None else 0}

    def flush_prefix_cache(self) -> int:
        """Drop every trie entry; returns blocks freed to the pool."""
        return self.trie.flush(self.alloc) if self.trie is not None else 0

    def kv_cache_bytes(self) -> dict:
        """Resident KV bytes on the device: {"total": the pool tensors'
        bytes, "in_use": the bytes of the blocks referenced now, by live
        requests or by the trie}. Reads sizes only."""
        pools = self.cache["layers"].values()
        total = sum(t.numel() * t.element_size() for t in pools)
        per_block = total // (self.alloc.stats.num_blocks + 1)   # + trash
        return {"total": total,
                "in_use": per_block * self.alloc.stats.in_use}
