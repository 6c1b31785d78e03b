"""RWKV6 ("Finch"): an attention-free LM with a data-dependent per-channel
decay, served on the slot engine only, and trained (`train_loss`).

The WKV6 recurrence  S_t = diag(w_t)·S_{t−1} + k_tᵀv_t,
                     y_t = r_t·(S_{t−1} + diag(u)·k_tᵀv_t)
runs in chunked-parallel form for prefill (intra-chunk matmuls plus an
inter-chunk state scan, `wkv6_chunked`) and as the exact single-token
recurrence for decode; training runs the chunked form under autograd
(every layer recomputed in the backward under cfg.remat; the R/K/V/G/
output and channel-mix projections through `dense(train=True)`, the
STE under CIM). The recurrence, the token shift, the decay LoRA and
the group norm are digital (plain PyTorch, as the reference computes them
in jnp outside any Pallas kernel); the R/K/V/G/output projections and the
channel-mix FFN go through `common.dense`, so onto the macro under CIM.

Parameters mirror the reference (`models/rwkv6.py`) with its stacked [L,
...] leaves split into one dict per layer: {"tok", "final_norm", "layers":
[{"norm1", "tm", "norm2", "cm"}, ...]}. The slot cache keeps the
reference's stacked layout, {"pos", "layers": {"tm_x", "cm_x": [L, B, 1,
D], "S": [L, B, H, dh, dh] f32}}; `decode_step` writes each layer's slice
in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import generator, resolve_device
from repro_torch.parallel import sharding

from . import common
from .common import (_normal, cumsum_f32, dense, dtype_of, embed_init,
                     embed_lookup, norm, norm_init, silu, unembed)

LOG_DECAY_FLOOR = -5.0  # per-step log-decay clamp for chunk-form stability


def _time_mix_init(gen, cfg: ModelConfig, *, device) -> dict:
    d = cfg.d_model
    r = cfg.ssm.decay_lora_rank
    kw = dict(dtype=dtype_of(cfg), device=device)
    p = {"mu": torch.full((5, d), 0.5, **kw)}   # r,k,v,g,w token-shift mixes
    for name in ("w_r", "w_k", "w_v", "w_g"):
        p.update(common.dense_init(gen, d, d, name_w=name, **kw))
    p["decay_w0"] = torch.linspace(-6.0, -0.5, d, dtype=torch.float32,
                                   device=device)
    p["decay_a"] = (_normal(gen, (d, r), device) * 0.01).to(kw["dtype"])
    p["decay_b"] = (_normal(gen, (r, d), device) * 0.01).to(kw["dtype"])
    p["bonus_u"] = torch.zeros(d, dtype=torch.float32, device=device)
    p.update(common.dense_init(gen, d, d,
                               scale=1.0 / math.sqrt(d * 2 * cfg.n_layers),
                               name_w="w_out", **kw))
    p["norm_g"] = torch.ones(d, **kw)        # per-head group-norm scale
    return p


def _channel_mix_init(gen, cfg: ModelConfig, *, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype_of(cfg), device=device)
    p = {"mu": torch.full((2, d), 0.5, **kw)}
    p.update(common.dense_init(gen, d, f, name_w="w_up", **kw))
    p.update(common.dense_init(gen, f, d,
                               scale=1.0 / math.sqrt(f * 2 * cfg.n_layers),
                               name_w="w_down", **kw))
    p.update(common.dense_init(gen, d, d, name_w="w_r", **kw))
    return p


def init(cfg: ModelConfig, *, seed: int = 0, device=None,
         layer_fn=None, max_seq: int = 0) -> dict:
    """Random weights from a torch.Generator seeded with `seed`, made on
    `device` (default: the card); the reference's constants (μ 0.5, the
    decay base linspace(−6, −0.5), u 0) as in its init. `layer_fn` maps
    each layer's params as soon as they are made (e.g.
    models.quantize.quantize_params). `max_seq` is taken and ignored, as
    the reference's init takes `**_`."""
    dev = resolve_device(device)
    gen = generator(dev, seed)
    layer_fn = layer_fn or (lambda lp: lp)
    kw = dict(dtype=dtype_of(cfg), device=dev, kind=cfg.norm)
    params = {"tok": embed_init(gen, cfg, device=dev),
              "final_norm": norm_init(cfg.d_model, **kw)}
    params["layers"] = [layer_fn({
        "norm1": norm_init(cfg.d_model, **kw),
        "tm": _time_mix_init(gen, cfg, device=dev),
        "norm2": norm_init(cfg.d_model, **kw),
        "cm": _channel_mix_init(gen, cfg, device=dev)})
        for _ in range(cfg.n_layers)]
    return params


# ---------------------------------------------------------------------------
# the digital state math
# ---------------------------------------------------------------------------
def _token_shift(x: torch.Tensor, prev: torch.Tensor | None):
    """xs_t = x_{t−1}; position 0 sees `prev` (zeros at sequence start)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel log-decay (negative), Finch's w_t: the
    decay LoRA as float f32 matmuls, off the macro."""
    lora = torch.tanh(xw.float() @ p["decay_a"].float()) \
        @ p["decay_b"].float()
    logw = -torch.exp(torch.clamp(p["decay_w0"] + lora, -8.0, 1.0))
    return torch.clamp(logw, LOG_DECAY_FLOOR, -1e-4)


def _group_norm(y: torch.Tensor, scale: torch.Tensor,
                n_heads: int) -> torch.Tensor:
    b, t, d = y.shape
    yh = y.reshape(b, t, n_heads, d // n_heads).float()
    yh = yh * torch.rsqrt((yh * yh).mean(-1, keepdim=True) + 1e-5)
    return (yh.reshape(b, t, d) * scale.float()).to(y.dtype)


def wkv6_chunked(r, k, v, logw, u, *, chunk: int, state0=None):
    """Chunked-parallel WKV6. r, k, v, logw [B, T, H, dh] → (y [B, T, H,
    dh] f32, the final state [B, H, dh, dh] f32).

    T is padded to a whole number of chunks (zeros; log-decays −1e-4). All
    within-chunk exponents are differences of cumulative log-decays (at
    most |chunk·LOG_DECAY_FLOOR|), safe in f32 for chunk ≤ 32.
    """
    b, t, h, dh = r.shape
    pad = (-t) % chunk
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        logw = F.pad(logw, (0, 0, 0, 0, 0, pad), value=-1e-4)
    nc = (t + pad) // chunk
    shp = (b, nc, chunk, h, dh)
    rc, kc, vc = (a.reshape(shp).float() for a in (r, k, v))
    lw = logw.reshape(shp).float()
    cum = cumsum_f32(lw, 2)                           # inclusive Σ log w
    state = torch.zeros((b, h, dh, dh), dtype=torch.float32,
                        device=r.device) if state0 is None else state0
    ys = []
    for c in range(nc):
        rcc, kcc, vcc, lwc, cumc = (a[:, c] for a in (rc, kc, vc, lw, cum))
        r_dec = rcc * torch.exp(cumc - lwc)           # r_i ⊙ Π_{l<i} w
        k_dec = kcc * torch.exp(-cumc)                # k_j ⊘ Π_{l≤j} w
        # intra-chunk attention (strictly causal) + the bonus diagonal
        att = torch.tril(torch.einsum("bihd,bjhd->bhij", r_dec, k_dec), -1)
        diag = torch.einsum("bihd,bihd->bhi", rcc * u, kcc)
        y = torch.einsum("bhij,bjhd->bihd", att, vcc) \
            + diag.transpose(1, 2)[..., None] * vcc
        # inter-chunk, from the carried state
        y = y + torch.einsum("bihk,bhkv->bihv", r_dec, state)
        # S' = diag(W_C)·S + Σ_j (k_j·W_C/W_j) ⊗ v_j
        wc = torch.exp(cumc[:, -1])                   # [B, H, dh]
        s_add = torch.einsum("bjhk,bjhv->bhkv", k_dec, vcc)
        state = wc[..., None] * (state + s_add)
        ys.append(y)
    y = torch.stack(ys, 1).reshape(b, nc * chunk, h, dh)[:, :t]
    return y, state


def wkv6_recurrent(r, k, v, logw, u, state):
    """The exact single-token recurrence: r, k, v, logw [B, H, dh], state
    [B, H, dh, dh] f32 → (y [B, H, dh] f32, the next state)."""
    r1, k1, v1 = r.float(), k.float(), v.float()
    w1 = torch.exp(logw.float())
    kv = k1[..., :, None] * v1[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r1, state + u[..., None] * kv)
    return y, w1[..., None] * state + kv


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _time_mix(p: dict, x, cfg: ModelConfig, *, prev_x=None, state=None,
              chunked: bool = True, train: bool = False):
    """Returns (out, (last_x, state))."""
    b, t, d = x.shape
    hd = cfg.ssm.head_dim
    h = d // hd
    xs = _token_shift(x, prev_x) if chunked else prev_x
    mu = p["mu"].to(x.dtype)

    def mix(i):
        return x + mu[i] * (xs - x)

    rr = dense(p, mix(0), cfg, train=train, w="w_r", b=None)
    kk = dense(p, mix(1), cfg, train=train, w="w_k", b=None)
    vv = dense(p, mix(2), cfg, train=train, w="w_v", b=None)
    gg = dense(p, mix(3), cfg, train=train, w="w_g", b=None)
    logw = _decay(p, mix(4))                          # [B, T, D] f32
    sh = (b, t, h, hd)
    r4, k4, v4, lw4 = (a.reshape(sh) for a in (rr, kk, vv, logw))
    u4 = p["bonus_u"].reshape(h, hd)
    if chunked:
        y, state = wkv6_chunked(r4, k4, v4, lw4, u4, chunk=cfg.ssm.chunk,
                                state0=state)
    else:
        y, state = wkv6_recurrent(r4[:, 0], k4[:, 0], v4[:, 0], lw4[:, 0],
                                  u4, state)
        y = y[:, None]
    y = _group_norm(y.reshape(b, t, d).to(x.dtype), p["norm_g"], h)
    y = y * silu(gg)
    return dense(p, y, cfg, train=train, w="w_out", b=None), \
        (x[:, -1:], state)


def _channel_mix(p: dict, x, cfg: ModelConfig, *, prev_x=None,
                 chunked: bool = True, train: bool = False):
    xs = _token_shift(x, prev_x) if chunked else prev_x
    mu = p["mu"].to(x.dtype)
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    kk = torch.relu(dense(p, xk, cfg, train=train, w="w_up", b=None)) ** 2
    vv = dense(p, kk, cfg, train=train, w="w_down", b=None)
    rr = torch.sigmoid(dense(p, xr, cfg, train=train, w="w_r", b=None))
    return rr * vv, x[:, -1:]


def _layer(lp: dict, h, cfg: ModelConfig, *, cache=None,
           chunked: bool = True, train: bool = False):
    """cache: {"tm_x", "cm_x": [B, 1, D], "S": [B, H, dh, dh]} or None
    (zeros). Returns (h, the layer's new cache entries)."""
    c = cache or {}
    a, (tm_x, s) = _time_mix(lp["tm"], norm(lp["norm1"], h, cfg), cfg,
                             prev_x=c.get("tm_x"), state=c.get("S"),
                             chunked=chunked, train=train)
    h = h + a
    f, cm_x = _channel_mix(lp["cm"], norm(lp["norm2"], h, cfg), cfg,
                           prev_x=c.get("cm_x"), chunked=chunked,
                           train=train)
    return h + f, {"tm_x": tm_x, "cm_x": cm_x, "S": s}


def _train_layer(lp: dict, h, cfg: ModelConfig):
    """One layer of the training forward (chunked, zero carries)."""
    return _layer(lp, h, cfg, train=True)[0]


def train_loss(params: dict, batch: dict, cfg: ModelConfig, rng=None):
    """Next-token cross-entropy of batch["tokens"] against batch["labels"]:
    embed → layers (chunked, zero carries; each recomputed in the backward
    under cfg.remat, `common.remat_layer`) → final_norm → head, a scalar
    f32 tensor to differentiate (`rng` is the reference's PRNG key
    argument, unread)."""
    h = embed_lookup(params["tok"], batch["tokens"].long(), cfg)
    for lp in params["layers"]:
        h = common.remat_layer(cfg, _train_layer, lp, h, cfg)
    h = norm(sharding.gathered(params["final_norm"]), h, cfg)
    return common.cross_entropy(unembed(params["tok"], h, cfg, train=True),
                                batch["labels"].long())


# ---------------------------------------------------------------------------
# the slot engine
# ---------------------------------------------------------------------------
def supports_paged(cfg: ModelConfig) -> bool:
    return False


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """The slot cache (zeros): "pos" an int32 scalar on the device, the
    token-shift carries tm_x / cm_x [L, batch, 1, D] in the model dtype
    and the WKV state S [L, batch, H, dh, dh] f32. max_len sizes nothing:
    the state is O(1) in the sequence."""
    dev = resolve_device(device)
    d, hd, n = cfg.d_model, cfg.ssm.head_dim, cfg.n_layers
    dt = dtype_of(cfg)
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "layers": {
                "tm_x": torch.zeros((n, batch, 1, d), dtype=dt, device=dev),
                "cm_x": torch.zeros((n, batch, 1, d), dtype=dt, device=dev),
                "S": torch.zeros((n, batch, d // hd, hd, hd),
                                 dtype=torch.float32, device=dev)}}


def prefill(params: dict, batch: dict, cfg: ModelConfig,
            max_len: int | None = None):
    """A whole prompt through the chunked form → (last-token logits [B, V],
    its cache: every layer's carries and final state, "pos" = T)."""
    h = embed_lookup(params["tok"], batch["tokens"].long(), cfg)
    entries = []
    for lp in params["layers"]:
        h, c = _layer(lp, h, cfg, chunked=True)
        entries.append(c)
    h = norm(params["final_norm"], h, cfg)
    cache = {"pos": torch.full((), h.shape[1], dtype=torch.int32,
                               device=h.device),
             "layers": {leaf: torch.stack([e[leaf] for e in entries])
                        for leaf in entries[0]}}
    return unembed(params["tok"], h[:, -1], cfg), cache


def decode_step(params: dict, tokens: torch.Tensor, cache: dict,
                cfg: ModelConfig):
    """One token per slot through the exact recurrence: tokens [B, 1] →
    (logits [B, V], cache). Every layer's carries and state are written in
    place; the returned dict carries pos + 1 (pos is read by nothing
    here)."""
    h = embed_lookup(params["tok"], tokens.long(), cfg)
    layers = cache["layers"]
    for i, lp in enumerate(params["layers"]):
        h, c = _layer(lp, h, cfg, cache={leaf: t[i]
                                         for leaf, t in layers.items()},
                      chunked=False)
        for leaf, t in c.items():
            layers[leaf][i].copy_(t)
    h = norm(params["final_norm"], h, cfg)
    return unembed(params["tok"], h[:, 0], cfg), \
        {**cache, "pos": cache["pos"] + 1}


def input_specs(cfg: ModelConfig, shape) -> dict:
    """Meta-tensor stand-ins for a dry-run cell's tokens (and labels)."""
    return common.token_specs(shape)
