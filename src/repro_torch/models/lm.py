"""The LM stack in PyTorch: the port's counterpart of the JAX package's
``models/lm.py``, every family.

Families (``cfg.family``):
  dense  — GQA transformer (qwen1.5-*, deepseek-7b, mistral-nemo-12b)
  moe    — GQA attention + sort-based MoE FFN (llama4-scout, grok-1)
  audio  — decoder over EnCodec frame embeddings (musicgen-large; LN+GELU)
  vlm    — dense + gated cross-attention to image embeddings every
           ``cross_attn_interval`` layers (llama-3.2-vision-11b)
  hybrid — Mamba2 backbone + one *shared* attention block applied after
           every ``attn_interval`` Mamba layers (zamba2-7b)
  ssm    — RWKV6 time-mix + channel-mix (rwkv6-3b)

The params tree has the reference's layout, shapes and dtypes: plain
dicts of tensors, layer leaves stacked on a leading axis (vlm's ``plain``
and the hybrid's ``mamba`` stacked ``(groups, per group, ...)``), so
``convert.lm_params_from_numpy`` carries the reference's weights over leaf
for leaf. The stacked layers run as a Python loop, where the reference
scans. Three entry points, as the reference's: ``forward`` (logits over a
sequence), ``prefill`` (the prompt's last logits and a decode cache) and
``decode_step`` (one token).

The decode cache is allocated at capacity and written in place: keys and
values at ``pos`` (``index_copy_`` with a device index, so a captured step
never reads ``pos`` on the host), the SSM, conv and RWKV states and the
token-shift rows with ``copy_``; ``decode_step`` returns the same dict it
was given. ``prefill`` writes the prompt's keys and values into the first
rows of a zeroed cache: bitwise the reference's padded cache.

The state-space families follow the reference where it departs from
``forward``: ``forward`` pads the sequence to a multiple of the chunk
(``rwkv.CHUNK``, ``ssm.CHUNK``) before the scan, and ``prefill`` keeps the
states after the pad tokens (rwkv also the pad position's token-shift
rows) and, for the hybrid, the pad tokens' keys and values: its KV cache
holds ``max(capacity, ceil(S / 32) · 32)`` rows. So after a prompt off the
chunk, decode continues the padded sequence, not ``forward``; on the
chunk it continues ``forward``. TP head layouts
(``cfg.tp > 1``) wait for the distributed slice (ROADMAP item 17) and
raise; so do the sharding constraints, which are identities here.

``forward`` and ``loss_fn`` are differentiable (``launch/train.py`` trains
through them). The stacked leaves are unbound once per call
(:func:`_unstack`), so the backward costs bytes linear in depth; the
embedding's gradient, and the MoE dispatch's, go through P4
(``kernels/gather_backward.py``), a fixed-order sum where autograd's
backward of a row gather would scatter with atomics; attention's is the
reference's recomputing backward (``attention._Flash``). So a training
step on the card gives the same bits every run. ``cfg.remat`` (the
reference's ``jax.checkpoint`` of each scanned layer) is not applied: it
trades memory for recomputation and changes no value, and the port keeps
every layer's activations for the backward.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.gather_backward import gather_rows
from repro_torch.models import rwkv as rk
from repro_torch.models import ssm
from repro_torch.models.attention import (chunked_attention,
                                          decode_attention, rope_tables,
                                          rotate)
from repro_torch.models.backend import resolve_device
from repro_torch.models.layers import (dense_init, embed_init, layer_norm,
                                       linear, mlp_apply, mlp_init, rms_norm,
                                       upcast)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.optim.optimizer import tree_map

__all__ = ["FAMILIES", "init", "forward", "loss_fn", "init_cache",
           "prefill", "decode_step", "block_apply", "block_decode",
           "cross_attn", "project_image_kv", "kv_rows", "mamba_block_init",
           "rwkv_block_init"]

Params = Any

#: the families the port runs: all of the reference's
FAMILIES = ("dense", "moe", "audio", "vlm", "hybrid", "ssm")


def _check(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    if cfg.tp > 1:
        raise ValueError(
            f"{cfg.name}: tp={cfg.tp} needs the TP head layout and a launch "
            f"mesh, which wait for the distributed slice (ROADMAP item 17); "
            f"the port runs tp=1")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _norm(p, x, cfg):
    if cfg.norm == "rms":
        return rms_norm(x, p["g"], cfg.norm_eps)
    return layer_norm(x, p["g"], p["b"], cfg.norm_eps)


def _norm_init(cfg, device, d=None):
    d = d or cfg.d_model
    p = {"g": torch.ones((d,), dtype=cfg.jdtype, device=device)}
    if cfg.norm == "ln":
        p["b"] = torch.zeros((d,), dtype=cfg.jdtype, device=device)
    return p


def _stacked(n: int, make):
    """``make()`` called ``n`` times, its trees' leaves stacked on a new
    leading axis, one layer at a time (the peak is the stack and one layer,
    not twice the stack). ``n`` = 0 gives leading axes of 0, as the
    reference's ``vmap`` over no keys."""
    first = make()
    out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    for i in range(n):
        layer = first if i == 0 else make()
        tree_map(lambda dst, src: dst[i].copy_(src), out, layer)
    return out


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, each leaf unbound once along
    its leading axis (views). Indexing ``t[i]`` per layer would give each
    layer's gradient a zero tensor of the whole stack (``select``'s
    backward): O(L²) bytes; ``unbind``'s backward is one ``stack``."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(tree.unbind(0))


# ---------------------------------------------------------------------------
# attention block (self-attention, GQA, RoPE)
# ---------------------------------------------------------------------------

def attn_init(gen, cfg, *, cross: bool = False):
    d, dh = cfg.d_model, cfg.head_dim
    kv_src = cfg.d_image if cross and cfg.d_image else d
    return {
        "ln": _norm_init(cfg, gen.device),
        "q": dense_init(gen, d, cfg.n_heads * dh, cfg.jdtype,
                        bias=cfg.qkv_bias),
        "k": dense_init(gen, kv_src, cfg.n_kv_heads * dh, cfg.jdtype,
                        bias=cfg.qkv_bias),
        "v": dense_init(gen, kv_src, cfg.n_kv_heads * dh, cfg.jdtype,
                        bias=cfg.qkv_bias),
        "o": dense_init(gen, cfg.n_heads * dh, d, cfg.jdtype),
    }


def _qkv(p, cfg, x):
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = linear(p["q"], x).reshape(b, s, cfg.n_heads, dh)
    k = linear(p["k"], x).reshape(b, s, cfg.n_kv_heads, dh)
    v = linear(p["v"], x).reshape(b, s, cfg.n_kv_heads, dh)
    return q, k, v


def _finish_attn(p, cfg, out):
    b, s, h = out.shape[:3]
    return linear(p["o"], out.reshape(b, s, h * cfg.head_dim))


def _rope(cfg, positions, dtype):
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta, dtype)


def self_attn(p, cfg, x, positions, rope=None):
    """``rope``: the call's :func:`rope_tables` for ``positions``, made
    here when not given."""
    q, k, v = _qkv(p, cfg, x)
    rope = rope if rope is not None else _rope(cfg, positions, q.dtype)
    q, k = rotate(q, *rope), rotate(k, *rope)
    out = chunked_attention(q, k, v, q_positions=positions,
                            kv_positions=positions, causal=True,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return _finish_attn(p, cfg, out), (k, v)


def self_attn_decode(p, cfg, x1, k_cache, v_cache, pos, rope=None):
    """x1 (B,1,D); caches (B,S,Hkv,D), written in place at ``pos`` (a 0-d
    int64 tensor on the caches' device)."""
    q, k, v = _qkv(p, cfg, x1)
    posv = pos.reshape(1)
    rope = rope if rope is not None else _rope(cfg, posv, q.dtype)
    q, k = rotate(q, *rope), rotate(k, *rope)
    k_cache.index_copy_(1, posv, k.to(k_cache.dtype))
    v_cache.index_copy_(1, posv, v.to(v_cache.dtype))
    out = decode_attention(q, k_cache, v_cache, pos)
    return _finish_attn(p, cfg, out), (k_cache, v_cache)


def cross_attn(p, cfg, x, img_kv):
    """Non-causal attention to fixed image keys/values (already projected):
    img_kv = (k, v) each (B, S_img, Hkv, D). Only the projections' weights
    are read, as the reference reads them."""
    b, s, _ = x.shape
    q = linear({"w": p["q"]["w"]}, x).reshape(b, s, cfg.n_heads,
                                              cfg.head_dim)
    k, v = img_kv
    zeros = lambda n: torch.zeros((n,), dtype=torch.int32, device=x.device)
    out = chunked_attention(
        q, k, v, q_positions=zeros(s), kv_positions=zeros(k.shape[1]),
        causal=False, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return _finish_attn({"o": {"w": p["o"]["w"]}}, cfg, out)


def project_image_kv(p_cross, cfg, image_embeds):
    """Project image embeddings once into a cross layer's K/V."""
    b, si, _ = image_embeds.shape
    k = linear({"w": p_cross["k"]["w"]}, image_embeds
               ).reshape(b, si, cfg.n_kv_heads, cfg.head_dim)
    v = linear({"w": p_cross["v"]["w"]}, image_embeds
               ).reshape(b, si, cfg.n_kv_heads, cfg.head_dim)
    return (k, v)


# ---------------------------------------------------------------------------
# decoder blocks
# ---------------------------------------------------------------------------

def block_init(gen, cfg, *, cross: bool = False):
    p = {"attn": attn_init(gen, cfg), "ln2": _norm_init(cfg, gen.device)}
    if cfg.family == "moe":
        p["moe"] = moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                            cfg.jdtype)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.jdtype,
                            kind=cfg.mlp_kind)
    if cross:
        p["xattn"] = attn_init(gen, cfg, cross=True)
        p["ln_x"] = _norm_init(cfg, gen.device)
        p["gate_x"] = torch.zeros((1,), dtype=cfg.jdtype, device=gen.device)
    return p


def _ffn(p, cfg, x):
    if cfg.family == "moe":
        b, s, d = x.shape
        y = moe_apply(p["moe"], x.reshape(b * s, d),
                      top_k=cfg.experts_per_token,
                      capacity_factor=cfg.capacity_factor,
                      shard_axes=cfg.batch_axes, groups=cfg.dp_shards)
        return y.reshape(b, s, d)
    return mlp_apply(p["mlp"], x, cfg.mlp_kind)


def block_apply(p, cfg, x, positions, img_kv=None, rope=None):
    h, kv = self_attn(p["attn"], cfg, _norm(p["attn"]["ln"], x, cfg),
                      positions, rope)
    x = x + h
    if img_kv is not None and "xattn" in p:
        hx = cross_attn(p["xattn"], cfg, _norm(p["ln_x"], x, cfg), img_kv)
        x = x + torch.tanh(p["gate_x"]) * hx
    x = x + _ffn(p, cfg, _norm(p["ln2"], x, cfg))
    return x, kv


def block_decode(p, cfg, x1, k_cache, v_cache, pos, img_kv=None,
                 rope=None):
    h, (k_cache, v_cache) = self_attn_decode(
        p["attn"], cfg, _norm(p["attn"]["ln"], x1, cfg), k_cache, v_cache,
        pos, rope)
    x1 = x1 + h
    if img_kv is not None and "xattn" in p:
        hx = cross_attn(p["xattn"], cfg, _norm(p["ln_x"], x1, cfg), img_kv)
        x1 = x1 + torch.tanh(p["gate_x"]) * hx
    x1 = x1 + _ffn(p, cfg, _norm(p["ln2"], x1, cfg))
    return x1, (k_cache, v_cache)


# --- hybrid (zamba2): mamba blocks + shared attention block; ssm (rwkv6) ---

def mamba_block_init(gen, cfg):
    return {"ln": _norm_init(cfg, gen.device),
            "mamba": ssm.mamba_init(gen, cfg.d_model, cfg.ssm_state,
                                    cfg.jdtype)}


def rwkv_block_init(gen, cfg):
    p = rk.rwkv_init(gen, cfg.d_model, cfg.head_size, cfg.d_ff, cfg.jdtype)
    p["ln1"] = _norm_init(cfg, gen.device)
    p["ln2"] = _norm_init(cfg, gen.device)
    return p


def _mamba_layer(blk, cfg, h, state=None, conv=None):
    """One Mamba block over ``h``: prefill (no state) or one decode step;
    -> (h + y, the state, the conv state)."""
    x = _norm(blk["ln"], h, cfg)
    if state is None:
        y, st, cv = ssm.mamba_forward(blk["mamba"], x,
                                      ssm_state=cfg.ssm_state)
    else:
        y, st, cv = ssm.mamba_decode_step(blk["mamba"], x, state, conv,
                                          ssm_state=cfg.ssm_state)
    return h + y, st, cv


def _rwkv_layer(blk, cfg, h, state=None, last_t=None, last_c=None):
    """One RWKV block over ``h``: prefill (no state) or one decode step;
    -> (h, the state, the time-mix and channel-mix shift rows)."""
    x = _norm(blk["ln1"], h, cfg)
    if state is None:
        y, st, lt = rk.rwkv_time_mix(blk["time"], x, head_size=cfg.head_size)
    else:
        y, st, lt = rk.rwkv_time_mix_step(blk["time"], x, state, last_t,
                                          head_size=cfg.head_size)
    h = h + y
    y2, lc = rk.rwkv_channel_mix(blk["channel"], _norm(blk["ln2"], h, cfg),
                                 last_x=last_c)
    return h + y2, st, lt, lc


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init(seed: int, cfg, *, device=None) -> Params:
    """Random weights in the reference's layout, shapes, dtypes and
    distributions, drawn from a ``torch.Generator`` on ``device`` (the card
    unless ``device="cpu"``) seeded by ``seed``. The numbers are the
    port's own; to run the reference's weights, convert them with
    ``convert.lm_params_from_numpy``."""
    _check(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    p: dict = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                   cfg.jdtype),
               "ln_f": _norm_init(cfg, dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                  cfg.jdtype)
    fam = cfg.family
    if fam in ("dense", "moe", "audio"):
        p["blocks"] = _stacked(cfg.n_layers, lambda: block_init(gen, cfg))
    elif fam == "vlm":
        g, r = divmod(cfg.n_layers, cfg.cross_attn_interval)
        if r:
            raise ValueError("vlm n_layers must divide cross_attn_interval")
        p["plain"] = _stacked(g, lambda: _stacked(
            cfg.cross_attn_interval - 1, lambda: block_init(gen, cfg)))
        p["crossed"] = _stacked(g, lambda: block_init(gen, cfg, cross=True))
        p["img_proj"] = dense_init(gen, cfg.d_image, cfg.d_image,
                                   cfg.jdtype)
    elif fam == "hybrid":
        n_super, trail = divmod(cfg.n_layers, cfg.attn_interval)
        p["mamba"] = _stacked(n_super, lambda: _stacked(
            cfg.attn_interval, lambda: mamba_block_init(gen, cfg)))
        p["mamba_trail"] = _stacked(trail,
                                    lambda: mamba_block_init(gen, cfg))
        p["shared_attn"] = block_init(gen, cfg)     # ONE shared block
    else:
        p["blocks"] = _stacked(cfg.n_layers, lambda: rwkv_block_init(gen, cfg))
    return p


def _logits(p, cfg, x):
    w = (p["embed"]["w"].T if cfg.tie_embeddings
         else p["lm_head"]["w"])
    return _norm(p["ln_f"], x, cfg) @ w


def _embed_in(p, cfg, ids=None, embeds=None):
    """The rows of the embedding at ``ids`` (or ``embeds`` in the model's
    dtype). The lookup's gradient goes through P4 (``gather_rows``), a
    fixed-order sum per vocabulary row in float32 rounded once to the
    table's dtype: ``index_select``'s backward on the card is an atomic
    ``index_add_`` in no fixed order, and the reference's scatter-add
    rounds a bf16 table's row after every addition."""
    if embeds is not None:
        return embeds.to(cfg.jdtype)
    return gather_rows(p["embed"]["w"], ids)


def _pad_to(x, chunk: int):
    """x (B, S, D) zero-padded on S to a multiple of ``chunk``, as the
    reference's state-space ``forward`` pads it."""
    pad = (-x.shape[1]) % chunk
    return F.pad(x, (0, 0, 0, pad)) if pad else x


def kv_rows(cfg, seq: int) -> int:
    """Key/value rows the reference's ``forward`` collects for ``seq``
    tokens: the hybrid's shared attention runs over the sequence padded to
    ``ssm.CHUNK``; every other family over ``seq``."""
    if cfg.family == "hybrid":
        return -(-seq // ssm.CHUNK) * ssm.CHUNK
    return seq


def _run(p, cfg, x, image_embeds=None, store=None):
    """The blocks over embedded inputs ``x`` (B, S, D): the final hidden
    state. With ``store`` (a cache with at least ``kv_rows(cfg, S)`` rows)
    each layer's keys and values are written into its first rows, vlm's
    image keys and values into ``img_k``/``img_v``, and the state-space
    families' states into theirs."""
    if cfg.family == "hybrid":
        return _run_hybrid(p, cfg, x, store)
    if cfg.family == "ssm":
        return _run_rwkv(p, cfg, x, store)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    rope = _rope(cfg, positions, cfg.jdtype)
    if cfg.family in ("dense", "moe", "audio"):
        for i, blk in enumerate(_unstack(p["blocks"], cfg.n_layers)):
            x, (k, v) = block_apply(blk, cfg, x, positions, rope=rope)
            if store is not None:
                store["k"][i, :, :s] = k
                store["v"][i, :, :s] = v
        return x
    img = linear(p["img_proj"], image_embeds.to(cfg.jdtype))
    groups = cfg.n_layers // cfg.cross_attn_interval
    for gi, (plain, crossed) in enumerate(zip(
            _unstack(p["plain"], groups), _unstack(p["crossed"], groups))):
        for j, blk in enumerate(_unstack(plain,
                                         cfg.cross_attn_interval - 1)):
            x, (k, v) = block_apply(blk, cfg, x, positions, rope=rope)
            if store is not None:
                store["k_plain"][gi, j, :, :s] = k
                store["v_plain"][gi, j, :, :s] = v
        img_kv = project_image_kv(crossed["xattn"], cfg, img)
        x, (k, v) = block_apply(crossed, cfg, x, positions, img_kv=img_kv,
                                rope=rope)
        if store is not None:
            store["k_cross"][gi, :, :s] = k
            store["v_cross"][gi, :, :s] = v
            store["img_k"][gi] = img_kv[0]
            store["img_v"][gi] = img_kv[1]
    return x


def _run_hybrid(p, cfg, x, store):
    s = x.shape[1]
    h = _pad_to(x, ssm.CHUNK)
    sp = h.shape[1]
    positions = torch.arange(sp, dtype=torch.int32, device=x.device)
    rope = _rope(cfg, positions, cfg.jdtype)
    n_super, trail = divmod(cfg.n_layers, cfg.attn_interval)
    for gi, group in enumerate(_unstack(p["mamba"], n_super)):
        for j, blk in enumerate(_unstack(group, cfg.attn_interval)):
            h, st, cv = _mamba_layer(blk, cfg, h)
            if store is not None:
                store["ssm"][gi, j].copy_(st)
                store["conv"][gi, j].copy_(cv)
        h, (k, v) = block_apply(p["shared_attn"], cfg, h, positions,
                                rope=rope)
        if store is not None:
            store["k"][gi, :, :sp] = k
            store["v"][gi, :, :sp] = v
    for t, blk in enumerate(_unstack(p["mamba_trail"], trail)):
        h, st, cv = _mamba_layer(blk, cfg, h)
        if store is not None:
            store["ssm_trail"][t].copy_(st)
            store["conv_trail"][t].copy_(cv)
    return h[:, :s]


def _run_rwkv(p, cfg, x, store):
    s = x.shape[1]
    h = _pad_to(x, rk.CHUNK)
    for i, blk in enumerate(_unstack(p["blocks"], cfg.n_layers)):
        h, st, lt, lc = _rwkv_layer(blk, cfg, h)
        if store is not None:
            store["state"][i].copy_(st)
            store["last_t"][i].copy_(lt)
            store["last_c"][i].copy_(lc)
    return h[:, :s]


def forward(p, cfg, ids=None, *, embeds=None, image_embeds=None,
            collect_cache: bool = False):
    """-> (logits (B,S,V), cache | None). The collected cache holds every
    layer's keys and values over the sequence (the hybrid's over the
    padded sequence) and the state-space families' final states, as the
    reference's."""
    _check(cfg)
    x = _embed_in(p, cfg, ids, embeds)
    store = (init_cache(cfg, x.shape[0], kv_rows(cfg, x.shape[1]),
                        device=x.device)
             if collect_cache else None)
    x = _run(p, cfg, x, image_embeds, store)
    if store is not None and cfg.family == "vlm":
        del store["img_k"], store["img_v"]   # prefill's, not forward's
    return _logits(p, cfg, x), store


def loss_fn(p, cfg, ids, labels, *, embeds=None, image_embeds=None):
    """Mean next-token cross-entropy: -> (loss, {"loss", "ppl"})."""
    logits, _ = forward(p, cfg, ids, embeds=embeds,
                        image_embeds=image_embeds)
    logits = upcast(logits)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = (logz - gold).mean()
    return loss, {"loss": loss, "ppl": torch.exp(loss)}


# ---- caches / decode ----

def _cache_device(device) -> torch.device:
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")      # shapes only (``input_specs``)
    return resolve_device(device)


def init_cache(cfg, batch: int, max_seq: int, dtype=None, *,
               device=None) -> Params:
    """Empty decode cache sized for ``max_seq`` context, on ``device`` (the
    card unless ``device="cpu"``; ``"meta"`` for shapes only). The SSM and
    RWKV states are float32, as the reference's."""
    _check(cfg)
    dev = _cache_device(device)
    dt = dtype or cfg.jdtype
    fam = cfg.family
    dh, hkv = cfg.head_dim, cfg.n_kv_heads
    zeros = lambda shape, dtype=dt: torch.zeros(shape, dtype=dtype,
                                                device=dev)
    if fam in ("dense", "moe", "audio"):
        shape = (cfg.n_layers, batch, max_seq, hkv, dh)
        return {"k": zeros(shape), "v": zeros(shape)}
    if fam == "vlm":
        g = cfg.n_layers // cfg.cross_attn_interval
        sp = (g, cfg.cross_attn_interval - 1, batch, max_seq, hkv, dh)
        sc = (g, batch, max_seq, hkv, dh)
        si = (g, batch, cfg.n_image_tokens, hkv, dh)
        return {"k_plain": zeros(sp), "v_plain": zeros(sp),
                "k_cross": zeros(sc), "v_cross": zeros(sc),
                "img_k": zeros(si), "img_v": zeros(si)}
    f32 = torch.float32
    if fam == "hybrid":
        n_super, trail = divmod(cfg.n_layers, cfg.attn_interval)
        h = 2 * cfg.d_model // 64
        cchan = 2 * cfg.d_model + 2 * cfg.ssm_state
        kv = (n_super, batch, max_seq, hkv, dh)
        return {
            "ssm": zeros((n_super, cfg.attn_interval, batch, h, 64,
                          cfg.ssm_state), f32),
            "conv": zeros((n_super, cfg.attn_interval, batch,
                           ssm.CONV_K - 1, cchan)),
            "ssm_trail": zeros((trail, batch, h, 64, cfg.ssm_state), f32),
            "conv_trail": zeros((trail, batch, ssm.CONV_K - 1, cchan)),
            "k": zeros(kv), "v": zeros(kv),
        }
    h = cfg.d_model // cfg.head_size
    return {"state": zeros((cfg.n_layers, batch, h, cfg.head_size,
                            cfg.head_size), f32),
            "last_t": zeros((cfg.n_layers, batch, 1, cfg.d_model)),
            "last_c": zeros((cfg.n_layers, batch, 1, cfg.d_model))}


def decode_step(p, cfg, cache, ids1=None, pos=None, *, embeds1=None,
                image_embeds=None):
    """One serving step: ids1 (B, 1) int32 (or ``embeds1`` (B, 1, D) for the
    audio frontend stub), ``pos`` the new token's position (an int or a 0-d
    int32 tensor; the RWKV family reads none). -> (logits (B, V), cache),
    the cache written in place. ``image_embeds`` is accepted for the
    reference's signature and not read: the image keys and values are in
    the cache since ``prefill`` (the reference projects ``image_embeds``
    here into a value nothing reads)."""
    _check(cfg)
    x = _embed_in(p, cfg, ids1, embeds1)
    fam = cfg.family
    if fam == "ssm":
        for i, blk in enumerate(_unstack(p["blocks"], cfg.n_layers)):
            x, st, lt, lc = _rwkv_layer(
                blk, cfg, x, cache["state"][i], cache["last_t"][i],
                cache["last_c"][i])
            cache["state"][i].copy_(st)
            cache["last_t"][i].copy_(lt)
            cache["last_c"][i].copy_(lc)
        return _logits(p, cfg, x)[:, 0], cache
    # one conversion a step: index_copy_ wants an int64 index
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    rope = _rope(cfg, pos.reshape(1), cfg.jdtype)
    if fam in ("dense", "moe", "audio"):
        for i, blk in enumerate(_unstack(p["blocks"], cfg.n_layers)):
            x, _ = block_decode(blk, cfg, x, cache["k"][i], cache["v"][i],
                                pos, rope=rope)
        return _logits(p, cfg, x)[:, 0], cache
    if fam == "hybrid":
        n_super, trail = divmod(cfg.n_layers, cfg.attn_interval)

        def mamba(blk, state, conv, h):
            h, st, cv = _mamba_layer(blk, cfg, h, state, conv)
            state.copy_(st)
            conv.copy_(cv)
            return h
        for gi, group in enumerate(_unstack(p["mamba"], n_super)):
            for j, blk in enumerate(_unstack(group, cfg.attn_interval)):
                x = mamba(blk, cache["ssm"][gi, j], cache["conv"][gi, j], x)
            x, _ = block_decode(p["shared_attn"], cfg, x, cache["k"][gi],
                                cache["v"][gi], pos, rope=rope)
        for t, blk in enumerate(_unstack(p["mamba_trail"], trail)):
            x = mamba(blk, cache["ssm_trail"][t], cache["conv_trail"][t], x)
        return _logits(p, cfg, x)[:, 0], cache
    groups = cfg.n_layers // cfg.cross_attn_interval
    for gi, (plain, crossed) in enumerate(zip(
            _unstack(p["plain"], groups), _unstack(p["crossed"], groups))):
        for j, blk in enumerate(_unstack(plain,
                                         cfg.cross_attn_interval - 1)):
            x, _ = block_decode(blk, cfg, x, cache["k_plain"][gi, j],
                                cache["v_plain"][gi, j], pos, rope=rope)
        x, _ = block_decode(crossed, cfg, x,
                            cache["k_cross"][gi], cache["v_cross"][gi], pos,
                            img_kv=(cache["img_k"][gi], cache["img_v"][gi]),
                            rope=rope)
    return _logits(p, cfg, x)[:, 0], cache


def prefill(p, cfg, ids=None, *, embeds=None, image_embeds=None,
            max_seq: int | None = None, cache=None):
    """Run the prompt, return (last-token logits (B,V), decode cache). The
    cache's capacity is the prompt length unless ``max_seq`` extends it
    (the hybrid's is at least ``kv_rows(cfg, S)``: the padded prompt's keys
    and values are kept, as the reference keeps them); its rows past
    those are zero. ``cache``, if given (a cache of that capacity, e.g. a
    captured step's), is written in place instead of a new one. Only the
    last position's logits are computed."""
    _check(cfg)
    x = _embed_in(p, cfg, ids, embeds)
    b, s = x.shape[:2]
    rows = kv_rows(cfg, s)
    cap = max(max_seq or s, rows)
    if cache is None:
        cache = init_cache(cfg, b, cap, device=x.device)
    else:
        for key, t in cache.items():
            if key in ("k", "v") or key.startswith(("k_", "v_")):
                if t.shape[-3] != cap:
                    raise ValueError(f"cache {key!r} holds {t.shape[-3]} "
                                     f"positions; this prefill needs {cap}")
                t[..., rows:, :, :].zero_()
    x = _run(p, cfg, x, image_embeds, cache)
    return _logits(p, cfg, x[:, -1:])[:, 0], cache
