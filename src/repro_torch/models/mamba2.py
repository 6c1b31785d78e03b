"""Mamba2 (SSD) blocks and the Zamba2 hybrid: a Mamba2 backbone with one
weight-shared attention + MLP block after every `shared_every` layers,
served on the slot engine only, and trained (`train_loss`).

Prefill runs the chunked SSD schedule (`ssd_chunked`: intra-chunk matmuls
with scalar per-head decays plus an inter-chunk state scan); decode is the
exact single-token recurrence; training runs the chunked form under
autograd (each Mamba layer recomputed in the backward under cfg.remat, as
the reference's run_span; the shared block, used at every application,
sums its weights' gradients over them). The SSD state math, the causal
depthwise conv and the gated norm are digital (plain PyTorch, as the reference
computes them in jnp outside any Pallas kernel); the fused in-projection
[z | x | B | C | dt], the out-projection and the shared block's matmuls go
through `common.dense`, so onto the macro under CIM.

Parameters mirror the reference (`models/mamba2.py`) with its stacked
[L, ...] leaves split into one dict per layer: {"tok", "final_norm",
"layers": [{"norm1", "ssm"}, ...], "shared": {"norm1", "attn", "norm2",
"mlp"}} ("shared" is one block, not stacked). The slot cache keeps the
reference's stacked layout: {"pos", "layers": {"conv": [L, B, k−1,
conv_dim], "S": [L, B, H, dh, N] f32}, "shared": {"k", "v": [A, B,
max_len, KH, dh]}} with A the shared block's applications; `decode_step`
writes each slice in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

from . import common
from .common import (_normal, attention_apply, attention_init, cumsum_f32,
                     dense, dtype_of, embed_init, embed_lookup, mlp_apply,
                     mlp_init, norm, norm_init, pad_cache, silu, unembed)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, d_in + 2 * s.d_state


def _mamba_init(gen, cfg: ModelConfig, *, device) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in, n_h, conv_dim = _dims(cfg)
    dt = dtype_of(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    p = {}
    # fused in-projection: [z | x | B | C | dt]
    p.update(common.dense_init(gen, d, 2 * d_in + 2 * s.d_state + n_h,
                               dtype=dt, device=device, name_w="w_in"))
    p["conv_w"] = (_normal(gen, (s.conv_kernel, conv_dim), device)
                   * 0.1).to(dt)
    p["conv_b"] = torch.zeros(conv_dim, dtype=dt, device=device)
    p["a_log"] = torch.log(torch.linspace(1.0, 16.0, n_h, **f32))
    u = torch.rand(n_h, generator=gen, **f32)
    dt0 = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    p["dt_bias"] = torch.log(torch.expm1(dt0))        # softplus⁻¹(dt0)
    p["d_skip"] = torch.ones(n_h, **f32)
    p["norm_g"] = torch.ones(d_in, dtype=dt, device=device)
    p.update(common.dense_init(gen, d_in, d, dtype=dt, device=device,
                               scale=1.0 / math.sqrt(d_in * 2 * cfg.n_layers),
                               name_w="w_out"))
    return p


def _n_shared_apps(cfg: ModelConfig) -> int:
    se = cfg.ssm.shared_every
    return cfg.n_layers // se if se else 0


def init(cfg: ModelConfig, *, seed: int = 0, device=None,
         layer_fn=None, max_seq: int = 0) -> dict:
    """Random weights from a torch.Generator seeded with `seed`, made on
    `device` (default: the card); the reference's constants (A = −(1 …
    16), dt from a log-uniform [1e-3, 1e-1], D = 1). `layer_fn` maps each
    layer's params, and the shared block's, as soon as they are made.
    `max_seq` is taken and ignored, as the reference's init takes `**_`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    layer_fn = layer_fn or (lambda lp: lp)
    kw = dict(dtype=dtype_of(cfg), device=dev, kind=cfg.norm)
    params = {"tok": embed_init(gen, cfg, device=dev),
              "final_norm": norm_init(cfg.d_model, **kw)}
    params["layers"] = [layer_fn({"norm1": norm_init(cfg.d_model, **kw),
                                  "ssm": _mamba_init(gen, cfg, device=dev)})
                        for _ in range(cfg.n_layers)]
    if cfg.ssm.shared_every:
        params["shared"] = layer_fn({
            "norm1": norm_init(cfg.d_model, **kw),
            "attn": attention_init(gen, cfg, device=dev),
            "norm2": norm_init(cfg.d_model, **kw),
            "mlp": mlp_init(gen, cfg, device=dev)})
    return params


# ---------------------------------------------------------------------------
# the SSD core
# ---------------------------------------------------------------------------
def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ) as jax.nn.softplus computes it (logaddexp(x, 0))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            state: torch.Tensor | None):
    """Causal depthwise conv, then SiLU. x [B, T, C]; state [B, k−1, C]
    carries the history (zeros when None). Returns (out, the new state)."""
    k, t = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    out = xp[:, :t] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + t] * w[i]
    return silu(out + b), xp[:, -(k - 1):]


def ssd_chunked(xh, dt, a, B, C, *, chunk: int, state0=None):
    """Chunked SSD. xh [B, T, H, dh], dt [B, T, H], a [H] (< 0), B / C [B,
    T, N] → (y [B, T, H, dh] f32, the final state [B, H, dh, N] f32).

    y_i = Σ_{j≤i} exp(l_i − l_j)·(C_i·B_j)·dt_j·x_j + C_i·(exp(l_i)·S₀)
    with l = cumsum(a·dt): every exponent ≤ 0. The three-operand
    contractions pair their operands as the reference's einsum path does
    (the first with the third, then the second).
    """
    b, t, h, dh = xh.shape
    n = B.shape[-1]
    pad = (-t) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt, B, C = (F.pad(z, (0, 0, 0, pad)) for z in (dt, B, C))
    nc = (t + pad) // chunk
    xc = xh.reshape(b, nc, chunk, h, dh).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    bc = B.reshape(b, nc, chunk, n).float()
    cc = C.reshape(b, nc, chunk, n).float()
    l = cumsum_f32(a * dtc, 2)                        # [B, NC, C, H], ≤ 0
    state = torch.zeros((b, h, dh, n), dtype=torch.float32,
                        device=xh.device) if state0 is None else state0
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))[None, :, :, None]
    ys = []
    for c in range(nc):
        xcc, dcc, bcc, ccc, lcc = (z[:, c] for z in (xc, dtc, bc, cc, l))
        # decay matrix exp(l_i − l_j) for j ≤ i, else 0. The exponent is
        # masked before the exp: above the diagonal l_i − l_j > 0 overflows
        # to inf once a chunk's decays add past ~88, and the masked-out
        # cotangent 0 · inf would be NaN in the backward (the reference
        # masks after the exp and gets NaN gradients there, ROADMAP Queue
        # C); the forward is the same bits
        dec = torch.exp(torch.where(mask, lcc[:, :, None, :]
                                    - lcc[:, None, :, :], -math.inf))
        cb = torch.einsum("bin,bjn->bij", ccc, bcc)   # C_i·B_j
        att = cb[..., None] * dec * dcc[:, None, :, :]    # [B, i, j, H]
        y = torch.einsum("bijh,bjhd->bihd", att, xcc)
        # inter-chunk: y_i += (C_i·exp(l_i)) @ S
        ce = ccc[:, :, :, None] * torch.exp(lcc)[:, :, None, :]  # [B,i,N,H]
        y = y + torch.einsum("binh,bhdn->bihd", ce, state)
        # S' = exp(l_C)·S + Σ_j dt_j·exp(l_C − l_j)·x_j ⊗ B_j
        wc = torch.exp(lcc[:, -1])                    # [B, H]
        kj = dcc * torch.exp(lcc[:, -1, None, :] - lcc)   # [B, C, H]
        kb = kj[:, :, :, None] * bcc[:, :, None, :]       # [B, C, H, N]
        s_add = torch.einsum("bjhn,bjhd->bhdn", kb, xcc)
        state = wc[..., None, None] * state + s_add
        ys.append(y)
    y = torch.stack(ys, 1).reshape(b, nc * chunk, h, dh)[:, :t]
    return y, state


def ssd_recurrent(x1, dt1, a, B1, C1, state):
    """The exact single-token recurrence: x1 [B, H, dh], dt1 [B, H], B1 /
    C1 [B, N], state [B, H, dh, N] f32 → (y [B, H, dh] f32, the next
    state). dt·x⊗B is (dt·B)·x, the reference's einsum path."""
    x1, B1, C1 = x1.float(), B1.float(), C1.float()
    decay = torch.exp(a * dt1)                        # [B, H]
    db = dt1[:, :, None] * B1[:, None, :]             # [B, H, N]
    state = state * decay[..., None, None] + db[:, :, None, :] \
        * x1[..., None]
    return torch.einsum("bhdn,bn->bhd", state, C1), state


def _gated_norm(y, z, g):
    yf = (y * silu(z)).float()
    yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-5)
    return (yf * g.float()).to(y.dtype)


def _mamba_block(p: dict, x, cfg: ModelConfig, *, cache=None,
                 chunked: bool = True, train: bool = False):
    """x [B, T, D] → (y, {"conv": [B, k−1, conv_dim], "S": [B, H, dh, N]})."""
    s = cfg.ssm
    d_in, n_h, conv_dim = _dims(cfg)
    b, t, _ = x.shape
    proj = dense(p, x, cfg, train=train, w="w_in", b=None)
    z, xbc, dt_raw = torch.split(proj, [d_in, conv_dim, n_h], dim=-1)
    c = cache or {}
    xbc, conv_state = _conv1d(xbc, p["conv_w"].to(xbc.dtype),
                              p["conv_b"].to(xbc.dtype), c.get("conv"))
    xh, B, C = torch.split(xbc, [d_in, s.d_state, s.d_state], dim=-1)
    xh = xh.reshape(b, t, n_h, s.head_dim)
    dt = softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    if chunked:
        y, S = ssd_chunked(xh, dt, a, B, C, chunk=s.chunk,
                           state0=c.get("S"))
    else:
        y, S = ssd_recurrent(xh[:, 0], dt[:, 0], a, B[:, 0], C[:, 0],
                             c["S"])
        y = y[:, None]
    y = y + p["d_skip"][..., None] * xh.float()
    y = _gated_norm(y.reshape(b, t, d_in).to(x.dtype), z, p["norm_g"])
    return dense(p, y, cfg, train=train, w="w_out", b=None), \
        {"conv": conv_state, "S": S}


# ---------------------------------------------------------------------------
# the zamba2 plumbing
# ---------------------------------------------------------------------------
def _shared_block(sp: dict, h, cfg: ModelConfig, *, positions, cache=None,
                  pos_idx=0, train: bool = False):
    a, new_kv = attention_apply(sp["attn"], norm(sp["norm1"], h, cfg), cfg,
                                positions=positions, train=train, cache=cache,
                                cache_index=pos_idx)
    h = h + a
    return h + mlp_apply(sp["mlp"], norm(sp["norm2"], h, cfg), cfg,
                         train=train), new_kv



def _forward(params: dict, tokens, cfg: ModelConfig, *, caches=None,
             shared_kv=None, pos0=0, chunked: bool = True,
             train: bool = False):
    """Layer spans of `shared_every` with the shared block after each whole
    span (at most _n_shared_apps times). caches: the stacked SSM caches
    (decode: written in place) or None (prefill); shared_kv: the stacked
    [A, ...] shared K/V (decode: written in place) or None (prefill: each
    application's K/V come back). `train` runs the training forward
    (chunked, no cache entries or K/V kept). Returns (h after the final
    norm, the per-layer cache entries, the per-application K/V)."""
    x = embed_lookup(params["tok"], tokens.long(), cfg)
    b, t = x.shape[:2]
    positions = pos0 + torch.arange(t, device=x.device).expand(b, t)
    se = cfg.ssm.shared_every or cfg.n_layers + 1
    entries, shared = [], []
    h = x
    app = 0
    for lo in range(0, cfg.n_layers, se):
        hi = min(lo + se, cfg.n_layers)
        for i in range(lo, hi):
            lp = params["layers"][i]
            if train:       # recomputed in the backward under cfg.remat
                h = common.remat(cfg, lambda hh, lp=lp: _mamba_block(
                    lp["ssm"], norm(lp["norm1"], hh, cfg), cfg,
                    train=True)[0], h)
                continue
            c = None if caches is None else \
                {leaf: st[i] for leaf, st in caches.items()}
            # no residual around the block, as in the reference
            h, nc = _mamba_block(lp["ssm"], norm(lp["norm1"], h, cfg), cfg,
                                 cache=c, chunked=chunked)
            entries.append(nc)
        if cfg.ssm.shared_every and hi - lo == se \
                and app < _n_shared_apps(cfg):
            kv = None if train else {} if shared_kv is None else \
                {leaf: st[app] for leaf, st in shared_kv.items()}
            h, new_kv = _shared_block(params["shared"], h, cfg,
                                      positions=positions, cache=kv,
                                      pos_idx=pos0, train=train)
            if not train:
                shared.append(new_kv)
            app += 1
    return norm(params["final_norm"], h, cfg), entries, shared


# ---------------------------------------------------------------------------
# the slot engine
# ---------------------------------------------------------------------------
def supports_paged(cfg: ModelConfig) -> bool:
    return False



def train_loss(params: dict, batch: dict, cfg: ModelConfig, rng=None):
    """Next-token cross-entropy of batch["tokens"] against batch["labels"]
    through the training forward and the head, a scalar f32 tensor to
    differentiate (`rng` is the reference's PRNG key argument, unread)."""
    h, _, _ = _forward(params, batch["tokens"], cfg, train=True)
    return common.cross_entropy(unembed(params["tok"], h, cfg, train=True),
                                batch["labels"].long())

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """The slot cache (zeros): "pos" an int32 scalar on the device; per
    layer the conv history [L, batch, k−1, conv_dim] in the model dtype
    and the SSD state [L, batch, H, dh, N] f32; the shared block's K/V
    [A, batch, max_len, KH, dh] per application."""
    dev = resolve_device(device)
    d_in, n_h, conv_dim = _dims(cfg)
    s = cfg.ssm
    n = cfg.n_layers
    dt = dtype_of(cfg)
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=dev),
             "layers": {
                 "conv": torch.zeros((n, batch, s.conv_kernel - 1, conv_dim),
                                     dtype=dt, device=dev),
                 "S": torch.zeros((n, batch, n_h, s.head_dim, s.d_state),
                                  dtype=torch.float32, device=dev)}}
    apps = _n_shared_apps(cfg)
    if apps:
        kv = (apps, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        cache["shared"] = {leaf: torch.zeros(kv, dtype=dt, device=dev)
                           for leaf in ("k", "v")}
    return cache


def prefill(params: dict, batch: dict, cfg: ModelConfig,
            max_len: int | None = None):
    """A whole prompt through the chunked form → (last-token logits [B, V],
    its cache: every layer's conv history and final state, the shared
    block's K/V [A, B, T, KH, dh] zero-padded to max_len, "pos" = T)."""
    tokens = batch["tokens"]
    t = tokens.shape[1]
    h, entries, shared = _forward(params, tokens, cfg, chunked=True)
    cache = {"pos": torch.full((), t, dtype=torch.int32, device=h.device),
             "layers": {leaf: torch.stack([e[leaf] for e in entries])
                        for leaf in entries[0]}}
    if shared:
        cache["shared"] = pad_cache(
            {leaf: torch.stack([e[leaf] for e in shared])
             for leaf in ("k", "v")}, max_len or t)
    return unembed(params["tok"], h[:, -1], cfg), cache


def decode_step(params: dict, tokens: torch.Tensor, cache: dict,
                cfg: ModelConfig):
    """One token per slot at the shared position cache["pos"]: tokens [B,
    1] → (logits [B, V], cache). The SSM carries and the shared K/V row at
    pos (row max_len − 1 once pos reaches max_len) are written in place;
    the returned dict carries pos + 1."""
    pos = cache["pos"]
    layers = cache["layers"]
    h, entries, _ = _forward(params, tokens, cfg, caches=layers,
                             shared_kv=cache.get("shared"), pos0=pos,
                             chunked=False)
    for i, e in enumerate(entries):
        for leaf, t in e.items():
            layers[leaf][i].copy_(t)
    return unembed(params["tok"], h[:, 0], cfg), {**cache, "pos": pos + 1}
