"""Transformer (dense GQA LMs, the MoE family, deepseek-v3's MLA, the VLM
prefix and whisper's encoder-decoder): the padded `forward` and the
training loss `train_loss`, the slot engine's `prefill` / `decode_step`
and the paged `paged_step`. A
layer's FFN is the MLP, or the MoE FFN (`models.moe`) where its params
hold a router; its attention is GQA, or MLA (`models.mla`) where cfg.mla
is set.

internvl2-26b (family "vlm") is the dense decoder behind an image prefix:
`forward` and `prefill` put batch["image_embeds"] (the stub frontend's
patch embeddings) in front of the token embeddings.

whisper-large-v3 (family "audio") adds an encoder over batch["frames"]
(the stub conv frontend's frame embeddings [B, T, D]) with learned
positions, run without the causal mask; every decoder layer attends to
the encoder's output through its cross-attention ("norm_x", "xattn"),
and the decoder adds learned positions (params["dec_pos"], max_seq rows).

Parameters are a dict: {"tok": {"embed", "head"}, "final_norm": {"scale"},
"dense_layers": [...], "layers": [per-layer dict, ...], "enc_layers":
[...], "enc_norm", "enc_pos" / "dec_pos": {"pos_embed"}, "mtp": {...}} —
the reference's stacked [L, ...] leaves become one dict of tensors per
layer, and its layer scans become Python loops.

Training (`forward(train=True)`, `train_loss`) covers every arch: every
float weight runs `dense(train=True)` (cim_matmul_ste under CIM; MLA's
seven projections, whisper's cross-attention and encoder, the MoE FFN's
routed experts through `moe.apply(train=True)`), each layer is
recomputed in the backward under cfg.remat (torch.utils.checkpoint), and
the LM loss is taken in cfg.ce_chunks recomputed sequence chunks, on the
text positions only behind a VLM's image prefix; the MoE layers'
load-balance losses are summed per stack in layer order (0.01 · aux in
the loss), and deepseek adds its MTP loss (`_mtp_loss`, weighted by
cfg.mtp_weight).
"dense_layers" holds MoEConfig.first_dense leading layers with a dense FFN
of width d_ff_dense (deepseek-v3's first three), run before "layers";
"mtp" (the multi-token-prediction block) is read by the training loss
only. The caches keep the reference's stacked
layouts, one entry per layer stack: slot {"pos", "dense_layers", "layers":
{"k", "v": [L, B, max_len, KH, dh]}} ({"latent": [L, B, max_len, lat]}
under MLA; whisper's "cross": {"k", "v": [L, B, frames, KH, dh]}, the
encoder's K/V per decoder layer) and paged {"dense_layers", "layers":
{"k", "v": [L, NB, bs, KH, dh]}}; a layer reads and writes its slice in
place.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

from . import common, mla, moe
from .common import (attention_apply, attention_init, dtype_of, embed_init,
                     embed_lookup, mlp_apply, mlp_init, norm, norm_init,
                     pad_cache, unembed)


def _n_dense(cfg: ModelConfig) -> int:
    """Leading layers with a dense FFN of width d_ff_dense."""
    return cfg.moe.first_dense if cfg.moe is not None else 0


def _layer_init(gen, cfg: ModelConfig, *, device, ffn: str) -> dict:
    """One decoder layer; ffn "dense", "moe" or "dense_wide" (the leading
    dense layers' width d_ff_dense)."""
    kw = dict(dtype=dtype_of(cfg), device=device, kind=cfg.norm)
    attn = mla.init if cfg.mla is not None else attention_init
    p = {"norm1": norm_init(cfg.d_model, **kw),
         "norm2": norm_init(cfg.d_model, **kw),
         "attn": attn(gen, cfg, device=device)}
    if ffn == "moe":
        p["ffn"] = moe.init(gen, cfg, device=device)
    else:
        p["ffn"] = mlp_init(gen, cfg, device=device,
                            d_ff=cfg.moe.d_ff_dense if ffn == "dense_wide"
                            else None)
    if cfg.cross_attention:
        p["norm_x"] = norm_init(cfg.d_model, **kw)
        p["xattn"] = attention_init(gen, cfg, device=device)
    return p


def _pos_table(gen, n: int, cfg: ModelConfig, device) -> dict:
    """Learned positions [n, D], N(0, 0.02²) in the model dtype."""
    return {"pos_embed": (common._normal(gen, (n, cfg.d_model), device)
                          * 0.02).to(dtype_of(cfg))}


def _stacks(tree: dict):
    """(name, entry) of each layer stack present in a params or cache
    tree, in execution order: "dense_layers", then "layers"."""
    return [(name, tree[name]) for name in ("dense_layers", "layers")
            if name in tree]


def init(cfg: ModelConfig, *, seed: int = 0, device=None, layer_fn=None,
         max_seq: int = 0) -> dict:
    """Random weights from a torch.Generator seeded with `seed`, made on
    `device` (default: the card). The draws differ from the reference's
    jax.random ones; `registry.params_from_numpy` carries the reference's
    weights across instead. `layer_fn` maps each layer's params (encoder
    layers too) as soon as they are made (e.g.
    models.quantize.quantize_params), so a model whose float weights would
    not fit is never held whole. Learned decoder positions get `max_seq`
    rows."""
    if cfg.pos_embed == "learned" and max_seq <= 0:
        raise ValueError("learned positions need max_seq at init")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    layer_fn = layer_fn or (lambda lp: lp)
    n_dense = _n_dense(cfg)
    params = {"tok": embed_init(gen, cfg, device=dev),
              "final_norm": norm_init(cfg.d_model, dtype=dtype_of(cfg),
                                      device=dev, kind=cfg.norm)}
    if n_dense:
        params["dense_layers"] = [
            layer_fn(_layer_init(gen, cfg, device=dev, ffn="dense_wide"))
            for _ in range(n_dense)]
    main = "moe" if cfg.moe is not None else "dense"
    params["layers"] = [layer_fn(_layer_init(gen, cfg, device=dev, ffn=main))
                        for _ in range(cfg.n_layers - n_dense)]
    if cfg.encoder_layers:
        enc_cfg = cfg.replace(cross_attention=False)
        params["enc_layers"] = [
            layer_fn(_layer_init(gen, enc_cfg, device=dev, ffn="dense"))
            for _ in range(cfg.encoder_layers)]
        params["enc_norm"] = norm_init(cfg.d_model, dtype=dtype_of(cfg),
                                       device=dev, kind=cfg.norm)
        params["enc_pos"] = _pos_table(gen, cfg.encoder_len, cfg, dev)
    if cfg.pos_embed == "learned":
        params["dec_pos"] = _pos_table(gen, max_seq, cfg, dev)
    if cfg.mtp:     # deepseek's multi-token prediction: one block + proj
        kw = dict(dtype=dtype_of(cfg), device=dev, kind=cfg.norm)
        params["mtp"] = layer_fn({
            "proj": common.dense_init(gen, 2 * cfg.d_model, cfg.d_model,
                                      dtype=dtype_of(cfg), device=dev,
                                      name_w="w_proj"),
            "block": _layer_init(gen, cfg, device=dev,
                                 ffn="dense_wide" if cfg.moe else "dense"),
            "norm_h": norm_init(cfg.d_model, **kw),
            "norm_e": norm_init(cfg.d_model, **kw)})
    return params


# ---------------------------------------------------------------------------
# forward (inference) and the slot engine: prefill + decode over [B, S] caches
# ---------------------------------------------------------------------------
def _embed_inputs(params, batch, cfg: ModelConfig):
    """Token embeddings, behind a VLM's image prefix where the batch holds
    one (batch["image_embeds"] [B, n_image_tokens, D], cast to the
    embedding dtype), plus learned positions [0, T) where the arch has
    them; and their positions [0, T) over the whole span."""
    x = embed_lookup(params["tok"], batch["tokens"].long(), cfg)
    if cfg.n_image_tokens and "image_embeds" in batch:
        x = torch.cat([batch["image_embeds"].to(x.dtype), x], dim=1)
    b, t = x.shape[:2]
    if cfg.pos_embed == "learned":
        x = x + params["dec_pos"]["pos_embed"][:t]
    return x, torch.arange(t, device=x.device).expand(b, t)


def _encode(params: dict, batch: dict, cfg: ModelConfig, *,
            train: bool = False) -> torch.Tensor:
    """whisper's encoder over batch["frames"] [B, T, D] (cast to the model
    dtype, plus enc_pos[:T]), its layers without the causal mask (each
    recomputed in the backward under `train` and cfg.remat), then
    enc_norm."""
    if "frames" not in batch:
        raise KeyError(
            "frames: the encoder reads batch['frames'] (the stub frontend's "
            "frame embeddings) and this batch holds none; the Servers pass "
            "tokens only, so whisper is served through prefill / "
            "decode_step, as in the reference")
    frames = batch["frames"]
    b, t = frames.shape[:2]
    h = frames.to(dtype_of(cfg)) + params["enc_pos"]["pos_embed"][:t]
    positions = torch.arange(t, device=h.device).expand(b, t)
    for lp in params["enc_layers"]:
        if train:
            h, _ = _train_layer(lp, h, cfg, positions, causal=False)
        else:
            h, _, _ = _layer(lp, h, cfg, positions=positions, causal=False)
    return norm(params["enc_norm"], h, cfg)


def _ffn(p: dict, x, cfg: ModelConfig, train: bool = False):
    """The layer's FFN → (y, its load-balance loss): the MoE FFN where its
    params hold a router, else the MLP (aux 0.0)."""
    if "router" in p:
        return moe.apply(p, x, cfg, train=train)
    return mlp_apply(p, x, cfg, train=train), 0.0


def _layer(lp: dict, h, cfg: ModelConfig, *, positions, cache=None,
           cache_index=0, causal: bool = True, enc_out=None, cross=None,
           train: bool = False):
    """One layer; `cache` is None (the padded forward), {} (prefill: the
    layer's cache entries come back) or the layer's slot cache {"k", "v"}
    / {"latent"} (decode: written in place). A decoder layer with
    cross-attention attends to `enc_out` (forward, prefill: its K/V come
    back as "xk" / "xv") or to its cached encoder K/V `cross` (decode).
    `train` (full-sequence only) routes every projection through
    dense(train=True). Returns (h, the entries or None, the FFN's
    load-balance loss)."""
    hn = norm(lp["norm1"], h, cfg)
    if cfg.mla is not None:
        a, kv = mla.apply(lp["attn"], hn, cfg, positions=positions,
                          train=train, cache=cache or None,
                          cache_index=cache_index,
                          return_cache=cache == {})
    else:
        a, kv = attention_apply(lp["attn"], hn, cfg, positions=positions,
                                train=train, causal=causal, cache=cache,
                                cache_index=cache_index)
    h = h + a
    if enc_out is not None or cross is not None:
        prefill = cache == {}
        xa, xkv = attention_apply(
            lp["xattn"], norm(lp["norm_x"], h, cfg), cfg,
            positions=positions, train=train, causal=False,
            kv_x=h if enc_out is None else enc_out,
            cache=cross if cross is not None else ({} if prefill else None))
        h = h + xa
        if prefill:
            kv = {**kv, "xk": xkv["k"], "xv": xkv["v"]}
    f, aux = _ffn(lp["ffn"], norm(lp["norm2"], h, cfg), cfg, train)
    return h + f, kv, aux


def _train_layer(lp: dict, h, cfg: ModelConfig, positions, *,
                 causal: bool = True, enc_out=None):
    """One layer of the training forward → (h, its load-balance loss),
    recomputed in the backward under cfg.remat (`common.remat`)."""
    def body(hh, pos, enc):
        out, _, aux = _layer(lp, hh, cfg, positions=pos, causal=causal,
                             enc_out=enc, train=True)
        return out, aux

    return common.remat(cfg, body, h, positions, enc_out)


def forward(params: dict, batch: dict, cfg: ModelConfig, *, train: bool):
    """Full-sequence causal forward → (hidden [B,T,D] after the final norm,
    aux_loss, the encoder's output or None), the reference's triple. aux is
    the MoE layers' load-balance losses summed per stack from 0.0 in layer
    order, dense_layers first (0.0 without a MoE layer). `train` runs the
    training forward."""
    x, positions = _embed_inputs(params, batch, cfg)
    enc_out = _encode(params, batch, cfg, train=train) \
        if cfg.encoder_layers else None
    aux_total = 0.0
    for _, stack in _stacks(params):
        aux_stack = 0.0
        for lp in stack:
            if train:
                x, aux = _train_layer(lp, x, cfg, positions, enc_out=enc_out)
            else:
                x, _, aux = _layer(lp, x, cfg, positions=positions,
                                   enc_out=enc_out)
            aux_stack = aux_stack + aux
        aux_total = aux_total + aux_stack
    return norm(params["final_norm"], x, cfg), aux_total, enc_out


def train_loss(params: dict, batch: dict, cfg: ModelConfig,
               rng=None) -> torch.Tensor:
    """Next-token cross-entropy of batch["tokens"] against batch["labels"]
    (both [B, T]; behind a VLM's image prefix the loss is taken on the text
    positions only), plus cfg.mtp_weight × deepseek's MTP loss, plus 0.01 ×
    the aux loss; a scalar f32 tensor to differentiate. `rng` is the
    reference's PRNG key argument; no leg draws from it."""
    h, aux, _ = forward(params, batch, cfg, train=True)
    if cfg.n_image_tokens and "image_embeds" in batch:
        h = h[:, cfg.n_image_tokens:]
    loss = _lm_loss(params, h, batch["labels"].long(), cfg)
    if cfg.mtp:
        loss = loss + cfg.mtp_weight * _mtp_loss(params, h, batch, cfg)
    return loss + 0.01 * aux


def _mtp_loss(params: dict, h, batch: dict, cfg: ModelConfig):
    """deepseek-v3's multi-token prediction: position t predicts token t + 2
    (labels[:, t + 1]) from norm_h(h_t) ∥ norm_e(embed(token_{t+1})),
    through w_proj, one block (not recomputed in the backward, as in the
    reference) and the shared head."""
    mp = params["mtp"]
    tokens, labels = batch["tokens"].long(), batch["labels"].long()
    h_in = norm(mp["norm_h"], h[:, :-1], cfg)
    e_next = norm(mp["norm_e"], embed_lookup(params["tok"], tokens[:, 1:],
                                             cfg), cfg)
    merged = common.dense(mp["proj"], torch.cat([h_in, e_next], -1), cfg,
                          train=True, w="w_proj", b=None)
    b, t = merged.shape[:2]
    positions = torch.arange(t, device=merged.device).expand(b, t)
    h2, _, _ = _layer(mp["block"], merged, cfg, positions=positions,
                      train=True)
    return common.cross_entropy(unembed(params["tok"], h2, cfg, train=True),
                                labels[:, 1:])


def _lm_loss(params: dict, h, labels, cfg: ModelConfig) -> torch.Tensor:
    """Token-mean next-token CE. With cfg.ce_chunks = n > 1 dividing T, the
    [tokens, vocab] logits are made and consumed one sequence chunk at a
    time, each chunk recomputed in the backward, so the whole tensor never
    lives at once: the chunks' NLL sums are added in chunk order from 0,
    then divided by B·T, as the reference's scan does."""
    n = cfg.ce_chunks
    t = h.shape[1]
    if n <= 1 or t % n != 0:
        return common.cross_entropy(unembed(params["tok"], h, cfg,
                                            train=True), labels)

    def chunk_nll(hx, lx):
        return torch.sum(common.nll(unembed(params["tok"], hx, cfg,
                                            train=True), lx))

    c = t // n
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        hx, lx = h[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        total = total + (torch.utils.checkpoint.checkpoint(
            chunk_nll, hx, lx, use_reentrant=False)
            if torch.is_grad_enabled() else chunk_nll(hx, lx))
    return total / torch.full((), float(labels.shape[0] * t),
                              device=h.device)


def _cache_stacks(cfg: ModelConfig, lead: tuple, device) -> dict:
    """Zeroed cache entries per layer stack, each leaf [L, *lead, ...]:
    {"latent"} under MLA (kv_lora + rope wide), else {"k", "v"}."""
    if cfg.mla is not None:
        tail = {"latent": (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim,)}
    else:
        kv = (cfg.n_kv_heads, cfg.head_dim)
        tail = {"k": kv, "v": kv}

    def mk(n):
        return {leaf: torch.zeros((n, *lead, *t), dtype=dtype_of(cfg),
                                  device=device) for leaf, t in tail.items()}

    out = {"layers": mk(cfg.n_layers - _n_dense(cfg))}
    if _n_dense(cfg):
        out["dense_layers"] = mk(_n_dense(cfg))
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """The slot cache (zeros): "pos" an int32 scalar on the device, per
    layer stack K/V [L, batch, max_len, KH, dh] (the latent [L, batch,
    max_len, kv_lora + rope] under MLA), and with cross-attention the
    encoder's K/V "cross" [n_layers, batch, encoder_len, KH, dh]."""
    dev = resolve_device(device)
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=dev),
             **_cache_stacks(cfg, (batch, max_len), dev)}
    if cfg.cross_attention:
        shape = (cfg.n_layers, batch, cfg.encoder_len, cfg.n_kv_heads,
                 cfg.head_dim)
        cache["cross"] = {leaf: torch.zeros(shape, dtype=dtype_of(cfg),
                                            device=dev)
                          for leaf in ("k", "v")}
    return cache


def decode_step(params: dict, tokens: torch.Tensor, cache: dict,
                cfg: ModelConfig):
    """One decode step at the shared position cache["pos"] for every slot:
    tokens [B, 1] → (logits [B, V], cache). K/V rows are written in place
    (at row max_len − 1 once pos reaches max_len, as the reference's
    dynamic_update_slice clamps); the returned dict carries pos + 1.
    Learned positions are read at row pos, clamped into [0, max_seq − 1] as
    dynamic_slice clamps its start; a decoder with cross-attention attends
    to cache["cross"], which comes back unchanged."""
    pos = cache["pos"]
    x = embed_lookup(params["tok"], tokens.long(), cfg)
    b = x.shape[0]
    positions = torch.arange(1, device=x.device).expand(b, 1) + pos
    if cfg.pos_embed == "learned":
        table = params["dec_pos"]["pos_embed"]
        x = x + table.index_select(
            0, pos.long().clamp(0, table.shape[0] - 1).reshape(1))
    cross = cache.get("cross")
    for name, stack in _stacks(params):
        kv = cache[name]
        for i, lp in enumerate(stack):
            x, _, _ = _layer(lp, x, cfg, positions=positions,
                             cache={leaf: t[i] for leaf, t in kv.items()},
                             cache_index=pos,
                             cross=None if cross is None
                             else {leaf: t[i] for leaf, t in cross.items()})
    x = norm(params["final_norm"], x, cfg)
    logits = unembed(params["tok"], x[:, 0], cfg)
    return logits, {**cache, "pos": pos + 1}


def prefill(params: dict, batch: dict, cfg: ModelConfig,
            max_len: int | None = None):
    """A whole prompt in one forward → (last-token logits [B, V], its
    cache): per layer stack K/V [L, B, T, KH, dh] (the latent [L, B, T,
    lat] under MLA) zero-padded to max_len (left as is when T >= max_len),
    "pos" = T; with cross-attention also "cross" {"k", "v": [L, B, frames,
    KH, dh]}, the encoder's K/V per decoder layer, unpadded."""
    x, positions = _embed_inputs(params, batch, cfg)
    t = x.shape[1]
    max_len = max_len or t
    enc_out = _encode(params, batch, cfg) if cfg.encoder_layers else None
    cache = {"pos": torch.full((), t, dtype=torch.int32, device=x.device)}
    h = x
    for name, stack in _stacks(params):
        entries = []
        for lp in stack:
            h, kv, _ = _layer(lp, h, cfg, positions=positions, cache={},
                              enc_out=enc_out)
            entries.append(kv)
        kv = {leaf: torch.stack([e[leaf] for e in entries])
              for leaf in entries[0]}
        if "xk" in kv:
            cache["cross"] = {"k": kv.pop("xk"), "v": kv.pop("xv")}
        cache[name] = pad_cache(kv, max_len)
    h = norm(params["final_norm"], h, cfg)
    return unembed(params["tok"], h[:, -1], cfg), cache


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------
def supports_paged(cfg: ModelConfig) -> bool:
    return cfg.mla is None and not cfg.cross_attention


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device=None) -> dict:
    """Physical KV block pools [L, NB, bs, KH, dh] (zeros) per layer stack;
    NB includes the trash block (physical id 0). MLA's latent cache has no
    paged layout, as in the reference."""
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"paged KV serving not implemented for arch {cfg.arch!r} "
            "(MLA latent / cross-attention caches)")
    return _cache_stacks(cfg, (num_blocks, block_size),
                         resolve_device(device))


def cow_copy_block(cache: dict, src: int, dst: int) -> dict:
    """Copy one physical block's K/V (every layer) from `src` to `dst`, IN
    PLACE — the copy-on-write primitive behind prefix sharing."""
    for _, pools in _stacks(cache):
        for pool in pools.values():
            pool[:, dst] = pool[:, src]
    return cache


def _layer_paged(lp: dict, h, layer_pool: dict, cfg: ModelConfig, *,
                 index: common.PagedIndex):
    a, _ = common.paged_attention_apply(
        lp["attn"], norm(lp["norm1"], h, cfg), cfg, cache=layer_pool,
        index=index)
    h = h + a
    return h + _ffn(lp["ffn"], norm(lp["norm2"], h, cfg), cfg)[0]


def paged_step(params: dict, tokens: torch.Tensor, cache: dict,
               tables: torch.Tensor, lens: torch.Tensor, valid: torch.Tensor,
               cfg: ModelConfig, all_logits: bool = False):
    """One serving step over the paged pool; prefill chunks and decode are
    the same function (decode is C = 1).

    tokens [B, C]; lens [B] tokens already cached per slot; valid [B] new
    tokens this step (0 = idle lane). Writes each slot's new K/V through
    its block table (masked lanes → the trash block), attends per slot, and
    returns (logits, cache) with the cache updated in place. Logits are
    [B, V] at each slot's last valid position, or [B, C, V] with
    `all_logits`. It adds no learned positions: whisper, the one arch
    with them, has no paged cache (`supports_paged`).
    """
    b, c = tokens.shape
    block_size = cache["layers"]["k"].shape[2]
    window = tables.shape[1] * block_size
    # the attention kernel's operands are int32 (no copy when the server
    # hands them over as such); torch.gather and index_put take int64
    tables32 = tables.to(torch.int32).contiguous()
    lens32 = lens.to(torch.int32).contiguous()
    tables = tables.long()
    lens = lens.long()
    valid = valid.long()
    positions = lens[:, None] + torch.arange(c, device=tokens.device)[None, :]

    x = embed_lookup(params["tok"], tokens.long(), cfg)
    pos_w = torch.clamp(positions, max=window - 1)
    blk = torch.gather(tables, 1, pos_w // block_size)
    flat_idx = blk * block_size + pos_w % block_size
    in_valid = torch.arange(c, device=tokens.device)[None, :] < valid[:, None]
    flat_idx = torch.where(in_valid & (positions < window), flat_idx,
                           torch.zeros((), dtype=flat_idx.dtype,
                                       device=tokens.device))
    kv_len = lens + valid
    index = common.PagedIndex(positions, flat_idx, tables32, lens32,
                              kv_len.to(torch.int32),
                              flat_idx.to(torch.int32))

    for name, stack in _stacks(params):
        pools = cache[name]
        for i, lp in enumerate(stack):
            x = _layer_paged(lp, x, {"k": pools["k"][i],
                                     "v": pools["v"][i]}, cfg, index=index)
    x = norm(params["final_norm"], x, cfg)
    if all_logits:
        return unembed(params["tok"], x, cfg), cache          # [B, C, V]
    last = torch.clamp(valid - 1, min=0)
    h_last = x[torch.arange(b, device=x.device), last]
    return unembed(params["tok"], h_last, cfg), cache
