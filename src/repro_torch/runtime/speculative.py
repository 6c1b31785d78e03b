"""Per-request sampling + speculative-decoding primitives for the paged
serving engine: a copy of the JAX package's `runtime/speculative.py`
(numpy only), so the port imports nothing of that package.

* **SamplingParams** — the per-request sampling policy carried on
  `Request.sampling`. `temperature=0.0` (the default) is greedy argmax;
  `temperature>0` samples from the (optionally top-k-truncated) softmax
  with a counter-based PRNG keyed by `(seed, emission index)`, so a
  request's token stream is bit-reproducible per (request seed, step) and
  invariant to batch composition. All sampling is host-side numpy float64
  over the step's logits row.

* **the drafter registry** — `off` / `ngram` / `model:<name>` specs: a
  frozen spec dataclass, a module-level dict, a `register_drafter`
  decorator, and `parse_drafter` / `make_drafter` resolvers that validate
  names up front (ServingConfig.__post_init__ calls `parse_drafter`). A
  drafter proposes K tokens per decode lane from the lane's committed
  token stream alone; the target model verifies all K in ONE C=K+1
  `paged_step` and the longest agreeing prefix is accepted (see
  `verify_token`).

Exact rejection sampling: the drafters are deterministic (a point-mass
proposal q), so the accept rule `u < p(d)/q(d)` reduces to `u < p(d)`; on
rejection the replacement is drawn from the residual `p` with the rejected
token zeroed, renormalized. The marginal over (accept, resample) is
exactly `p`, and under greedy verification is an argmax prefix match, so
spec-decode streams are bit-identical to plain decode. Both draws for
emission index j come from the same `(seed, j)` Philox key.

The ngram drafter counts each proposed token as a match or a fallback
(`runtime.telemetry.KERNEL_COUNTERS.drafter`). Not ported yet: the model
drafter (`model:<name>` parses, but building it raises NotImplementedError
naming ROADMAP A4e, the slot engine whose padded `forward` it runs).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.runtime.telemetry import KERNEL_COUNTERS


# ---------------------------------------------------------------------------
# per-request sampling policy
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How one request turns a logits row into a token.

    temperature: 0.0 = greedy argmax (the default, and the setting every
        bit-identity soak pins); > 0 scales the logits before softmax.
    top_k: 0 = full vocabulary; k > 0 restricts sampling to the k highest
        logits (ties at the k-th value are all kept — deterministic).
    seed: per-request PRNG seed. Emission index j draws from Philox key
        (seed, j), so streams are bit-reproducible per (seed, step) and
        independent of batch composition and scheduling.
    """
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if not isinstance(self.temperature, (int, float)) \
                or not math.isfinite(self.temperature) \
                or self.temperature < 0.0:
            raise ValueError("temperature must be a finite float >= 0 "
                             f"(0 = greedy), got {self.temperature!r}")
        if not isinstance(self.top_k, int) or self.top_k < 0:
            raise ValueError("top_k must be an int >= 0 (0 = full vocab), "
                             f"got {self.top_k!r}")
        if not isinstance(self.seed, int) or self.seed < 0:
            raise ValueError(f"seed must be an int >= 0, got {self.seed!r}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def _probs(logits: np.ndarray, sp: SamplingParams) -> np.ndarray:
    """Target distribution p for one logits row: top-k filter, then
    temperature softmax, in float64 (host-side, bit-stable)."""
    z = np.asarray(logits, np.float64)
    if sp.top_k and sp.top_k < z.shape[-1]:
        kth = np.partition(z, -sp.top_k)[-sp.top_k]
        z = np.where(z < kth, -np.inf, z)
    z = z / sp.temperature
    z = z - z.max()
    p = np.exp(z)
    return p / p.sum()


def _rng(sp: SamplingParams, index: int) -> np.random.Generator:
    """Counter-based PRNG for emission `index`: a fresh Philox stream per
    (request seed, emission index) — no draw ever depends on how many
    tokens any OTHER step or lane consumed."""
    return np.random.Generator(np.random.Philox(key=[sp.seed, index]))


def _inverse_cdf(p: np.ndarray, u: float) -> int:
    tok = int(np.searchsorted(np.cumsum(p), u, side="right"))
    return min(tok, p.shape[-1] - 1)   # guard float cumsum < 1.0


def sample_token(logits: np.ndarray, sp: SamplingParams, index: int) -> int:
    """Sample emission `index` from one logits row under `sp`."""
    if sp.greedy:
        return int(np.argmax(logits))
    return _inverse_cdf(_probs(logits, sp), _rng(sp, index).random())


def verify_token(logits: np.ndarray, draft: int, sp: SamplingParams,
                 index: int) -> tuple[int, bool]:
    """Exact-rejection-sample one drafted token against the target row.

    Returns (token, accepted). Greedy: accept iff the draft IS the argmax.
    Sampled: accept with probability p(draft) (the point-mass-q rejection
    rule); on rejection draw the replacement from the residual (p with the
    draft zeroed, renormalized). Marginal distribution == plain
    `sample_token` — spec-decode is distribution-identical to plain decode.
    """
    draft = int(draft)
    if sp.greedy:
        tok = int(np.argmax(logits))
        return tok, tok == draft
    p = _probs(logits, sp)
    g = _rng(sp, index)
    if g.random() < p[draft]:
        return draft, True
    q = p.copy()
    q[draft] = 0.0
    tot = q.sum()
    if tot <= 0.0:                     # p was a point mass on the draft;
        return draft, True             # rejection prob was 0 — unreachable
    return _inverse_cdf(q / tot, g.random()), False


# ---------------------------------------------------------------------------
# drafter registry (mirrors kernels.paged_attention's backend registry)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DrafterSpec:
    """One registered drafter family. `factory(arg, cfg, max_len)` builds
    the per-server drafter instance (arg = the `:`-suffix of the spec
    string, e.g. the arch name of `model:<name>`; None when absent)."""
    name: str
    factory: Callable
    takes_arg: bool = False


_DRAFTER_REGISTRY: dict[str, DrafterSpec] = {}


def register_drafter(name: str, takes_arg: bool = False):
    def deco(factory):
        _DRAFTER_REGISTRY[name] = DrafterSpec(name, factory, takes_arg)
        return factory
    return deco


def get_drafter(name: str) -> DrafterSpec:
    try:
        return _DRAFTER_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown drafter {name!r}; registered: "
            f"{sorted(_DRAFTER_REGISTRY)}") from None


def parse_drafter(spec: str) -> tuple[str, Optional[str]]:
    """Split + validate a drafter spec string: "off", "ngram", or
    "model:<name>" (a configs.registry smoke arch). Raises ValueError on
    unknown families, a missing required arg, or an unknown model name —
    ServingConfig.__post_init__ calls this so bad flags fail at config
    construction, not mid-serve."""
    if not isinstance(spec, str) or not spec:
        raise ValueError(f"drafter spec must be a non-empty string, "
                         f"got {spec!r}")
    name, _, arg = spec.partition(":")
    ds = get_drafter(name)
    if ds.takes_arg and not arg:
        raise ValueError(f"drafter {name!r} needs an argument: "
                         f"'{name}:<name>'")
    if not ds.takes_arg and arg:
        raise ValueError(f"drafter {name!r} takes no argument, got {spec!r}")
    if name == "model":
        from repro_torch.configs.registry import SMOKES
        if arg not in SMOKES:
            raise ValueError(f"model drafter arch {arg!r} not in "
                             f"configs.registry (have {sorted(SMOKES)})")
    return name, (arg or None)


def make_drafter(spec: str, cfg, max_len: int):
    """Resolve a spec string into a drafter instance (None for "off").
    `cfg` is the TARGET model config (vocab compatibility checks)."""
    name, arg = parse_drafter(spec)
    ds = get_drafter(name)
    return ds.factory(arg, cfg, max_len)


@register_drafter("off")
def _off(arg, cfg, max_len):
    return None


@register_drafter("ngram")
def _ngram(arg, cfg, max_len):
    return NGramDrafter()


@register_drafter("model", takes_arg=True)
def _model(arg, cfg, max_len):
    # ModelDrafter runs the slot engine's padded `forward`, which comes
    # with the slot engine
    raise NotImplementedError(f"the model drafter 'model:{arg}' is not "
                              "ported yet (ROADMAP A4e)")


class NGramDrafter:
    """Self-speculation via prompt lookup: no second model at all.

    To propose the next token, find the most recent PREVIOUS occurrence of
    the stream's longest trailing n-gram (n = max_n down to 1) and predict
    the token that followed it; extend one token at a time so cyclic
    streams (greedy decode's usual steady state) are predicted through the
    whole cycle. No match → repeat the last token. Deterministic in the
    lane's own history — required for composition-invariant scheduling.
    Proposal quality only affects SPEED (accept length); `verify_token`
    keeps the output distribution exact regardless.
    """

    def __init__(self, max_n: int = 3):
        if max_n < 1:
            raise ValueError("max_n must be >= 1")
        self.max_n = max_n

    def _next(self, work: Sequence[int]) -> int:
        top = len(work) - 1          # last index a match may PRECEDE
        for n in range(min(self.max_n, top), 0, -1):
            suffix = tuple(work[-n:])
            for i in range(top - n, -1, -1):
                if tuple(work[i:i + n]) == suffix:
                    KERNEL_COUNTERS.count_drafter("ngram_match")
                    return int(work[i + n])
        KERNEL_COUNTERS.count_drafter("ngram_fallback")
        return int(work[-1])

    def propose(self, tokens: Sequence[int], k: int) -> list[int]:
        work = list(tokens)
        for _ in range(k):
            work.append(self._next(work))
        return work[len(tokens):]
