"""The LM stack's dense, audio and vlm families in PyTorch: the port's
counterpart of those paths of the JAX package's ``models/lm.py``.

Families (``cfg.family``):
  dense  — GQA transformer (qwen1.5-*, deepseek-7b, mistral-nemo-12b)
  audio  — decoder over EnCodec frame embeddings (musicgen-large; LN+GELU)
  vlm    — dense + gated cross-attention to image embeddings every
           ``cross_attn_interval`` layers (llama-3.2-vision-11b)
The moe, hybrid and ssm families raise ``NotImplementedError`` (ROADMAP
item 16b).

The params tree has the reference's layout, shapes and dtypes: plain
dicts of tensors, layer leaves stacked on a leading axis (vlm's ``plain``
stacked ``(g, interval - 1, ...)``), so ``convert.lm_params_from_numpy``
carries the reference's weights over leaf for leaf. The stacked layers run
as a Python loop, where the reference scans. Three entry points, as the
reference's: ``forward`` (logits over a sequence), ``prefill`` (the
prompt's last logits and a decode cache) and ``decode_step`` (one token).

The decode cache is allocated at capacity and written in place at ``pos``
(``index_copy_`` with a device index, so a captured step never reads
``pos`` on the host); ``decode_step`` returns the same dict it was given.
``prefill`` writes the prompt's keys and values into the first rows of a
zeroed cache: bitwise the reference's padded cache. TP head layouts
(``cfg.tp > 1``) wait for the distributed slice (ROADMAP item 17) and
raise; so do the sharding constraints, which are identities here, and
``remat``, a training matter, is ignored.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.attention import (chunked_attention,
                                          decode_attention, rope_tables,
                                          rotate)
from repro_torch.models.backend import resolve_device
from repro_torch.models.layers import (dense_init, embed_init, layer_norm,
                                       linear, mlp_apply, mlp_init, rms_norm)
from repro_torch.optim.optimizer import tree_map

__all__ = ["FAMILIES", "init", "forward", "loss_fn", "init_cache",
           "prefill", "decode_step", "block_apply", "block_decode",
           "cross_attn", "project_image_kv"]

Params = Any

#: the families this slice of the port runs
FAMILIES = ("dense", "audio", "vlm")


def _check(cfg) -> None:
    if cfg.family in ("moe", "hybrid", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP item 16b); the port runs {', '.join(FAMILIES)}")
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


def _stack(trees: list):
    """Leaves of equal-structure trees stacked on a new leading axis."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views)."""
    return tree_map(lambda t: t[i], tree)


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
    p = {"attn": attn_init(gen, cfg), "ln2": _norm_init(cfg, gen.device),
         "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.jdtype,
                         kind=cfg.mlp_kind)}
    if cross:
        p["xattn"] = attn_init(gen, cfg, cross=True)
        p["ln_x"] = _norm_init(cfg, gen.device)
        p["gate_x"] = torch.zeros((1,), dtype=cfg.jdtype, device=gen.device)
    return p


def block_apply(p, cfg, x, positions, img_kv=None, rope=None):
    h, kv = self_attn(p["attn"], cfg, _norm(p["attn"]["ln"], x, cfg),
                      positions, rope)
    x = x + h
    if img_kv is not None and "xattn" in p:
        hx = cross_attn(p["xattn"], cfg, _norm(p["ln_x"], x, cfg), img_kv)
        x = x + torch.tanh(p["gate_x"]) * hx
    x = x + mlp_apply(p["mlp"], _norm(p["ln2"], x, cfg), cfg.mlp_kind)
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
    x1 = x1 + mlp_apply(p["mlp"], _norm(p["ln2"], x1, cfg), cfg.mlp_kind)
    return x1, (k_cache, v_cache)


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
    if cfg.family in ("dense", "audio"):
        p["blocks"] = _stack([block_init(gen, cfg)
                              for _ in range(cfg.n_layers)])
    else:
        g, r = divmod(cfg.n_layers, cfg.cross_attn_interval)
        if r:
            raise ValueError("vlm n_layers must divide cross_attn_interval")
        p["plain"] = _stack([
            _stack([block_init(gen, cfg)
                    for _ in range(cfg.cross_attn_interval - 1)])
            for _ in range(g)])
        p["crossed"] = _stack([block_init(gen, cfg, cross=True)
                               for _ in range(g)])
        p["img_proj"] = dense_init(gen, cfg.d_image, cfg.d_image,
                                   cfg.jdtype)
    return p


def _logits(p, cfg, x):
    w = (p["embed"]["w"].T if cfg.tie_embeddings
         else p["lm_head"]["w"])
    return _norm(p["ln_f"], x, cfg) @ w


def _embed_in(p, cfg, ids=None, embeds=None):
    if embeds is not None:
        return embeds.to(cfg.jdtype)
    w = p["embed"]["w"]
    return w.index_select(0, ids.reshape(-1)).reshape(*ids.shape, -1)


def _run(p, cfg, x, image_embeds=None, store=None):
    """The blocks over embedded inputs ``x`` (B, S, D): the final hidden
    state. With ``store`` (a cache of capacity >= S) each layer's keys and
    values are written into its first S rows, and vlm's image keys and
    values into ``img_k``/``img_v``."""
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    rope = _rope(cfg, positions, cfg.jdtype)
    if cfg.family in ("dense", "audio"):
        for i in range(cfg.n_layers):
            x, (k, v) = block_apply(_layer(p["blocks"], i), cfg, x,
                                    positions, rope=rope)
            if store is not None:
                store["k"][i, :, :s] = k
                store["v"][i, :, :s] = v
        return x
    img = linear(p["img_proj"], image_embeds.to(cfg.jdtype))
    for gi in range(cfg.n_layers // cfg.cross_attn_interval):
        plain = _layer(p["plain"], gi)
        for j in range(cfg.cross_attn_interval - 1):
            x, (k, v) = block_apply(_layer(plain, j), cfg, x, positions,
                                    rope=rope)
            if store is not None:
                store["k_plain"][gi, j, :, :s] = k
                store["v_plain"][gi, j, :, :s] = v
        crossed = _layer(p["crossed"], gi)
        img_kv = project_image_kv(crossed["xattn"], cfg, img)
        x, (k, v) = block_apply(crossed, cfg, x, positions, img_kv=img_kv,
                                rope=rope)
        if store is not None:
            store["k_cross"][gi, :, :s] = k
            store["v_cross"][gi, :, :s] = v
            store["img_k"][gi] = img_kv[0]
            store["img_v"][gi] = img_kv[1]
    return x


def forward(p, cfg, ids=None, *, embeds=None, image_embeds=None,
            collect_cache: bool = False):
    """-> (logits (B,S,V), cache | None). The collected cache holds every
    layer's keys and values over the sequence, as the reference's."""
    _check(cfg)
    x = _embed_in(p, cfg, ids, embeds)
    store = (init_cache(cfg, x.shape[0], x.shape[1], device=x.device)
             if collect_cache else None)
    x = _run(p, cfg, x, image_embeds, store)
    if store is not None and cfg.family == "vlm":
        del store["img_k"], store["img_v"]   # prefill's, not forward's
    return _logits(p, cfg, x), store


def loss_fn(p, cfg, ids, labels, *, embeds=None, image_embeds=None):
    """Mean next-token cross-entropy: -> (loss, {"loss", "ppl"})."""
    logits, _ = forward(p, cfg, ids, embeds=embeds,
                        image_embeds=image_embeds)
    logits = logits.float()
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
    card unless ``device="cpu"``; ``"meta"`` for shapes only)."""
    _check(cfg)
    dev = _cache_device(device)
    dt = dtype or cfg.jdtype
    dh, hkv = cfg.head_dim, cfg.n_kv_heads
    zeros = lambda shape: torch.zeros(shape, dtype=dt, device=dev)
    if cfg.family in ("dense", "audio"):
        shape = (cfg.n_layers, batch, max_seq, hkv, dh)
        return {"k": zeros(shape), "v": zeros(shape)}
    g = cfg.n_layers // cfg.cross_attn_interval
    sp = (g, cfg.cross_attn_interval - 1, batch, max_seq, hkv, dh)
    sc = (g, batch, max_seq, hkv, dh)
    si = (g, batch, cfg.n_image_tokens, hkv, dh)
    return {"k_plain": zeros(sp), "v_plain": zeros(sp),
            "k_cross": zeros(sc), "v_cross": zeros(sc),
            "img_k": zeros(si), "img_v": zeros(si)}


def decode_step(p, cfg, cache, ids1=None, pos=None, *, embeds1=None,
                image_embeds=None):
    """One serving step: ids1 (B, 1) int32 (or ``embeds1`` (B, 1, D) for the
    audio frontend stub), ``pos`` the new token's position (an int or a 0-d
    int32 tensor). -> (logits (B, V), cache), the cache written in place.
    ``image_embeds`` is accepted for the reference's signature and not read:
    the image keys and values are in the cache since ``prefill`` (the
    reference projects ``image_embeds`` here into a value nothing reads)."""
    _check(cfg)
    x = _embed_in(p, cfg, ids1, embeds1)
    # one conversion a step: index_copy_ wants an int64 index
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    rope = _rope(cfg, pos.reshape(1), cfg.jdtype)
    if cfg.family in ("dense", "audio"):
        for i in range(cfg.n_layers):
            x, _ = block_decode(_layer(p["blocks"], i), cfg, x,
                                cache["k"][i], cache["v"][i], pos,
                                rope=rope)
        return _logits(p, cfg, x)[:, 0], cache
    for gi in range(cfg.n_layers // cfg.cross_attn_interval):
        plain = _layer(p["plain"], gi)
        for j in range(cfg.cross_attn_interval - 1):
            x, _ = block_decode(_layer(plain, j), cfg, x,
                                cache["k_plain"][gi, j],
                                cache["v_plain"][gi, j], pos, rope=rope)
        x, _ = block_decode(_layer(p["crossed"], gi), cfg, x,
                            cache["k_cross"][gi], cache["v_cross"][gi], pos,
                            img_kv=(cache["img_k"][gi], cache["img_v"][gi]),
                            rope=rope)
    return _logits(p, cfg, x)[:, 0], cache


def prefill(p, cfg, ids=None, *, embeds=None, image_embeds=None,
            max_seq: int | None = None, cache=None):
    """Run the prompt, return (last-token logits (B,V), decode cache). The
    cache's capacity is the prompt length unless ``max_seq`` extends it; its
    rows past the prompt are zero. ``cache``, if given (a cache of that
    capacity, e.g. a captured step's), is written in place instead of a
    new one. Only the last position's logits are computed."""
    _check(cfg)
    x = _embed_in(p, cfg, ids, embeds)
    b, s = x.shape[:2]
    cap = max(max_seq or s, s)
    if cache is None:
        cache = init_cache(cfg, b, cap, device=x.device)
    else:
        for key, t in cache.items():
            if key.startswith(("k", "v")):
                if t.shape[-3] != cap:
                    raise ValueError(f"cache {key!r} holds {t.shape[-3]} "
                                     f"positions; this prefill needs {cap}")
                t[..., s:, :, :].zero_()
    x = _run(p, cfg, x, image_embeds, cache)
    return _logits(p, cfg, x[:, -1:])[:, 0], cache
