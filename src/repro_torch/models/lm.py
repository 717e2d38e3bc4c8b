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
chunk it continues ``forward``.

``cfg.tp > 1`` runs the reference's TP head layout: query heads
zero-padded, and KV heads repeated (GQA with fewer KV heads than the TP
degree) or zero-padded (MHA), up to ``cfg.head_layout()``'s counts. The
layout is made on the WEIGHTS at each call (:func:`_eff_attn_params`), by
slices, zero blocks and broadcasts, so the gradients land on the published
parameters (a pad slot's are dropped) and sum in a fixed order; the
arranged o-projection's pad rows are zero, so padded heads never reach the
residual. The decode cache holds ``cfg.eff_kv_heads`` heads.

``forward`` and ``loss_fn`` take ``par``, the sharded train step's
``launch.tp.ParamShards``: the model then reads each parameter leaf
through ``par.gather`` where its block runs it (a stacked leaf one layer
at a time), on the rank's shards. A block dict marked ``"tp"`` (a
``TensorParallel``) computes on the ranks' shards, on a leading rank axis
(``launch/tp.py``), where the reference's ``_wshard`` and the rules pin
its weights over 'model': attention on the ranks' heads of the TP head
layout (q, k and v column-parallel, each rank's attention unchanged on its
heads, o row-parallel; :func:`tp_heads` arranges a whole leaf into them),
the MLP's gate and up column-parallel and down row-parallel, the MoE
experts on the ranks' part of ``f`` (``models/moe.py``), vlm's
cross-attention on the ranks' heads (q from the residual, k and v from the
image, o row-parallel), RWKV6's time mix on the ranks' heads and its
channel mix on their part of ``d_ff`` (``models/rwkv.py``), Mamba2 on the
ranks' heads (``models/ssm.py``), the embedding looked up on each rank's
vocabulary range and the logits and cross-entropy kept
vocabulary-sharded (the reference's iota compare, split over the ranks),
vlm's ``img_proj`` column-parallel with its columns gathered. RWKV6's and
Mamba2's heads are padded at the end to a multiple of the 'model' size
(:func:`pad_perm`; rwkv6-3b's 40 to 48 at tp 16): a pad head's weights
are zero and its output exactly zero. An attention dict marked
``"arranged"`` comes in the TP head layout already (the gather arranged
it, :func:`arrange_leaf`, so that no arranged copy is kept for the
backward).
Where a block's weights are not all 'model'-sharded (under the rules'
floor, and every leaf at ``reduced()``), the block computes whole on every
rank. :func:`tp_block_params` makes a whole block's TP form for a
one-process emulation of the ranks.

The reference's ``_shard_batch`` cut of the block-boundary activations
over 'model' (Megatron sequence-parallel style) is the port's too, under
the reference's condition (:func:`_boundary_tp`: ``cfg.batch_axes`` set,
``par`` a 'model' axis of more than one rank, ``d_model`` a multiple of
its size): the input of each layer the reference scans (the dense, moe
and audio blocks, vlm's plain layers, the hybrid's Mamba2 layers, RWKV6's
blocks; the first one's the embedding's output, padded to the chunk in
the state-space families) is held as the rank's d_model slice
(``TensorParallel.cut``, in a storage of its own) and joined whole inside
:func:`_layer` before the block (``gather_out``). So a layer checkpointed
under ``cfg.remat`` keeps the slice as its input, and its recompute joins
again. ``decode_step`` cuts the embedding's output and joins it for its
first block. vlm's crossed layers, the hybrid's shared block, the head
and every cache write read the whole. Neither direction sums anything, so
no value changes; in the one-process emulation (``launch.tp.EmulatedTP``)
the boundary is every rank's slice, ``(tp, B, S, D/tp)``.

``prefill`` and ``decode_step`` take ``par`` too: the sharded prefill and
decode step's forward-only ``ParamShards`` (``launch/serve.py``), each rank
on its part of the batch, the blocks gathered and computed as in the
sharded train step, the cache the rank's shards of it
(``launch.sharding.cache_pspecs``, ``par.cache`` a ``launch.tp.CacheShards``):
keys and values of the rank's KV heads, which its attention attends over
(a block in TP form computes those heads; one computed whole takes them
from its whole q, k and v and joins the heads over 'model' before o), the
state-space states the rank's heads where 'model' cuts them (a Mamba2 or
RWKV6 block in TP form computes on them; else they are taken from the
whole state and the ranks' new heads joined over 'model', :func:`_load`,
:func:`_save`), the conv rows and token-shift rows gathered whole over
'model' for the step and the rank's part written back, vlm's image keys
and values the rank's heads; where the batch does not split over the
batch's mesh dims and the rows do, each rank holds its rows of the
sequence, writes the new token
only where it holds its row, and the ranks' partial attentions are merged
by log-sum-exp (``attention.decode_attention_split``). The logits are the
rank's rows, whole over the vocabulary.

``forward`` and ``loss_fn`` are differentiable (``launch/train.py`` trains
through them). The stacked leaves are unbound once per call
(:func:`_unstack`), so the backward costs bytes linear in depth; the
embedding's gradient, and the MoE dispatch's, go through P4
(``kernels/gather_backward.py``), a fixed-order sum where autograd's
backward of a row gather would scatter with atomics; attention's is the
reference's recomputing backward (``attention._Flash``). So a training
step on the card gives the same bits every run. ``cfg.remat`` (every
published config's default) checkpoints the layers the reference's
``jax.checkpoint`` does (:func:`_layer`, under grad mode only): each of
those layers keeps its input for the backward and recomputes the rest,
its gather included; the loss and gradients are bit for bit those
without it.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.gather_backward import gather_rows
from repro_torch.models import rwkv as rk
from repro_torch.models import ssm
from repro_torch.models.attention import (chunked_attention,
                                          decode_attention,
                                          decode_attention_split,
                                          rope_tables, rotate)
from repro_torch.models.backend import resolve_device
from repro_torch.models.layers import (dense_init, embed_init, layer_norm,
                                       linear, linear_col, linear_row,
                                       mlp_apply, mlp_init, rank_matmul,
                                       rms_norm, upcast)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.optim.optimizer import tree_map

__all__ = ["FAMILIES", "init", "forward", "loss_fn", "init_cache",
           "cache_shapes",
           "prefill", "decode_step", "block_apply", "block_decode",
           "cross_attn", "project_image_kv", "kv_rows", "mamba_block_init",
           "rwkv_block_init", "tp_heads", "tp_sub_params", "tp_block_params",
           "pad_perm", "tp_aligned", "arrange_leaf", "STACK_DIMS",
           "TP_LEAVES", "TP_SUBS", "TP_WHOLE"]

Params = Any

#: the families the port runs: all of the reference's
FAMILIES = ("dense", "moe", "audio", "vlm", "hybrid", "ssm")


def _check(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    cfg.head_layout()           # raises for a tp the KV heads cannot meet


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


#: the leading layer dims of :func:`init`'s stacked trees, by top-level key
#: (:func:`_unstack` unbinds them, one layer at a time)
STACK_DIMS = {"blocks": 1, "plain": 2, "crossed": 1, "mamba": 2,
              "mamba_trail": 1}


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


def _head_perm(cfg) -> tuple:
    eff, _, _, slots = cfg.head_layout()
    perm = [cfg.n_heads] * eff            # n_heads = the zero pad slot
    for i, sl in enumerate(slots):
        perm[sl] = i
    return tuple(perm)


def _take_heads(w3: torch.Tensor, perm: tuple, dim: int) -> torch.Tensor:
    """``w3``'s slices along ``dim`` in the order ``perm``, the index
    ``w3.shape[dim]`` a zero slice: the reference's concatenated zero head
    gathered by ``perm``, as runs of consecutive heads (``narrow``) and of
    pad slots (zeros) joined by one ``cat``. A gather's backward would
    scatter-add; a ``cat``'s slices its gradient."""
    pad, pieces, i = w3.shape[dim], [], 0
    while i < len(perm):
        j = i + 1
        if perm[i] == pad:
            while j < len(perm) and perm[j] == pad:
                j += 1
            shape = list(w3.shape)
            shape[dim] = j - i
            pieces.append(w3.new_zeros(shape))
        else:
            while (j < len(perm) and perm[j] != pad
                   and perm[j] == perm[i] + (j - i)):
                j += 1
            pieces.append(w3.narrow(dim, perm[i], j - i))
        i = j
    return torch.cat(pieces, dim=dim)


def _arrange_wq(w, cfg):
    """q projection weights (d, Hq*dh) -> the TP head layout (d, eff*dh):
    done on the weights, not the activations, so gradients flow back to
    the published parameters (pad-slot gradients are dropped)."""
    eff, _, _, _ = cfg.head_layout()
    if eff == cfg.n_heads:
        return w
    dh = cfg.head_dim
    d = w.shape[0]
    w3 = w.reshape(d, cfg.n_heads, dh)
    return _take_heads(w3, _head_perm(cfg), 1).reshape(d, eff * dh)


def _arrange_wq_bias(b, cfg):
    eff, _, _, _ = cfg.head_layout()
    if eff == cfg.n_heads:
        return b
    dh = cfg.head_dim
    b3 = b.reshape(cfg.n_heads, dh)
    return _take_heads(b3, _head_perm(cfg), 0).reshape(eff * dh)


def _repeat_or_pad(w3: torch.Tensor, cfg, dim: int) -> torch.Tensor:
    """KV heads along ``dim`` -> ``eff_kv``: each repeated ``r`` times in
    place (``jnp.repeat``; a broadcast, whose backward sums the copies) for
    GQA, zero-padded at the end for MHA."""
    _, eff_kv, r, _ = cfg.head_layout()
    shape = list(w3.shape)
    if r > 1:
        shape.insert(dim + 1, r)
        return w3.unsqueeze(dim + 1).expand(shape).flatten(dim, dim + 1)
    shape[dim] = eff_kv - cfg.n_kv_heads
    return torch.cat([w3, w3.new_zeros(shape)], dim=dim)


def _arrange_wkv(w, cfg):
    """k/v projection weights -> eff_kv heads (contiguous repeat for GQA,
    zero-pad for MHA)."""
    _, eff_kv, _, _ = cfg.head_layout()
    if eff_kv == cfg.n_kv_heads:
        return w
    dh = cfg.head_dim
    d = w.shape[0]
    w3 = w.reshape(d, cfg.n_kv_heads, dh)
    return _repeat_or_pad(w3, cfg, 1).reshape(d, eff_kv * dh)


def _arrange_kv_bias(b, cfg):
    _, eff_kv, _, _ = cfg.head_layout()
    if eff_kv == cfg.n_kv_heads:
        return b
    dh = cfg.head_dim
    b3 = b.reshape(cfg.n_kv_heads, dh)
    return _repeat_or_pad(b3, cfg, 0).reshape(eff_kv * dh)


def _arrange_wo(w, cfg):
    """(Hq*dh, d) o-projection -> (eff*dh, d); pad slots are zero rows, so
    garbage in padded attention heads never reaches the residual."""
    eff, _, _, _ = cfg.head_layout()
    if eff == cfg.n_heads:
        return w
    dh = cfg.head_dim
    d = w.shape[1]
    w3 = w.reshape(cfg.n_heads, dh, d)
    return _take_heads(w3, _head_perm(cfg), 0).reshape(eff * dh, d)


_ARRANGE = {("q", "w"): _arrange_wq, ("q", "b"): _arrange_wq_bias,
            ("k", "w"): _arrange_wkv, ("k", "b"): _arrange_kv_bias,
            ("v", "w"): _arrange_wkv, ("v", "b"): _arrange_kv_bias,
            ("o", "w"): _arrange_wo}


def arrange_leaf(t, cfg, proj: str, leaf: str):
    """An attention leaf ``t`` (``proj`` "q", "k", "v" or "o", ``leaf``
    "w" or "b") in the TP head layout."""
    return _ARRANGE[proj, leaf](t, cfg)


def _arranged(p, cfg, proj: str):
    """``p[proj]["w"]`` in the TP head layout; as it stands where the
    sharded step's gather arranged it (``p`` marked ``"arranged"``)."""
    w = p[proj]["w"]
    return w if "arranged" in p else arrange_leaf(w, cfg, proj, "w")


def _eff_attn_params(p, cfg):
    """Attention params in the TP head layout (identity fast-path when the
    arch's heads already divide the TP degree, or when the sharded step's
    gather arranged them: ``p`` marked ``"arranged"``)."""
    eff, eff_kv, _, _ = cfg.head_layout()
    if "arranged" in p or (eff == cfg.n_heads and eff_kv == cfg.n_kv_heads):
        return p
    return dict(p, **{proj: {leaf: arrange_leaf(t, cfg, proj, leaf)
                             for leaf, t in p[proj].items()}
                      for proj in "qkvo"})


#: the leaves that a block's TP form cuts (their paths under a block, by
#: sub-block: attention, vlm's cross-attention, the MLP, the MoE experts,
#: RWKV6's time and channel mix, Mamba2): ``(kind, dim, weight)``, the dim
#: of one layer's slice that a rank's part cuts, how (``kind``: "q", "kv"
#: the TP head layout's query or KV heads; "rwkv", "ssm" RWKV6's or
#: Mamba2's heads, padded at the end to a multiple of the 'model' size;
#: "ssm_in", "ssm_conv" Mamba2's packed ``[z | x | B | C | dt]`` and ``[x
#: | B | C]``, the rank's heads of z, x and dt and the whole B and C; None
#: equal chunks of columns or rows) and whether it is a weight that the
#: rules shard (a block computes on 'model' shards only where all of its
#: weights are 'model'-sharded; the others, under the rules' floor, are
#: read whole and cut). A leaf not here (a norm's gain, RWKV6's ``mix``) is
#: read whole
_ATTN_LEAVES = {"q/w": ("q", 1, True), "q/b": ("q", 0, False),
                "k/w": ("kv", 1, True), "k/b": ("kv", 0, False),
                "v/w": ("kv", 1, True), "v/b": ("kv", 0, False),
                "o/w": ("q", 0, True)}
TP_LEAVES = {
    **{f"attn/{k}": v for k, v in _ATTN_LEAVES.items()},
    **{f"xattn/{k}": v for k, v in _ATTN_LEAVES.items()},
    "mlp/gate/w": (None, 1, True), "mlp/up/w": (None, 1, True),
    "mlp/down/w": (None, 0, True),
    "moe/gate": (None, 2, True), "moe/up": (None, 2, True),
    "moe/down": (None, 1, True),
    **{f"time/{k}/w": ("rwkv", 1, True) for k in "rkvgw"},
    "time/out/w": ("rwkv", 0, True), "time/u": ("rwkv", 0, False),
    "time/ln_g": ("rwkv", 0, False),
    "channel/k/w": (None, 1, True), "channel/v/w": (None, 0, True),
    "mamba/in_proj/w": ("ssm_in", 1, True),
    "mamba/conv_w": ("ssm_conv", 1, False),
    "mamba/out_proj/w": ("ssm", 0, True), "mamba/A_log": ("ssm", 0, False),
    "mamba/D": ("ssm", 0, False), "mamba/dt_bias": ("ssm", 0, False),
    "mamba/norm": ("ssm", 0, False)}
#: the sub-blocks that compute on 'model' shards, by the first key of
#: their leaves' paths in :data:`TP_LEAVES`
TP_SUBS = ("attn", "xattn", "mlp", "moe", "time", "channel", "mamba")
#: the unstacked leaves that compute on a rank's part whole (:func:`_embed_tp`,
#: :func:`_head`, :func:`_img_proj`): the dim it cuts, the vocabulary's or
#: the columns'
TP_WHOLE = {"embed/w": 0, "lm_head/w": 1, "img_proj/w": 1}
#: Mamba2's layout (``ssm.mamba_init``'s defaults)
_SSM_EXPAND, _SSM_HEAD = 2, 64


def _kv_perm(cfg) -> tuple:
    """The TP head layout's KV heads as source heads: each repeated ``r``
    times in place (GQA), or zero-padded at the end (MHA; the index
    ``n_kv_heads`` a zero slot), as :func:`_repeat_or_pad` arranges them."""
    _, eff_kv, r, _ = cfg.head_layout()
    hkv = cfg.n_kv_heads
    if r > 1:
        return tuple(j // r for j in range(eff_kv))
    return tuple(range(hkv)) + (hkv,) * (eff_kv - hkv)


def _part_heads(cfg, kind: str) -> int:
    """The heads a state-space block's ``kind`` of leaf holds: RWKV6's
    ``d_model / head_size``, Mamba2's ``2 d_model / 64``."""
    if kind == "rwkv":
        return cfg.d_model // cfg.head_size
    return _SSM_EXPAND * cfg.d_model // _SSM_HEAD


def pad_perm(heads: int, tp: int) -> tuple:
    """``heads`` heads in a layout of a multiple of ``tp`` slots, padded at
    the end (the index ``heads`` a zero slot): rank r takes the r-th of
    ``tp`` equal runs. RWKV6's 40 heads at tp 16: 48 slots, 3 a rank."""
    return tuple(range(heads)) + (heads,) * ((-heads) % tp)


def tp_aligned(cfg, tp: int, kind) -> bool:
    """Whether the rules' even 'model' cut of a ``kind`` of leaf (on the dim
    a rank's part cuts) is each rank's part: the rank computes on its shard
    as it is."""
    if kind is None:
        return True
    if kind in ("q", "kv"):
        return cfg.head_layout()[:2] == (cfg.n_heads, cfg.n_kv_heads)
    if kind in ("rwkv", "ssm"):
        return _part_heads(cfg, kind) % tp == 0
    return tp == 1


def _runs(t: torch.Tensor, perm: tuple, heads: int, dim: int, tp):
    """``t`` (``heads`` heads flattened along ``dim``) as ``tp``'s ranks'
    runs of ``perm``, each a list of one tensor a rank."""
    per = len(perm) // tp.tp
    t3 = t.unflatten(dim, (heads, t.shape[dim] // heads))
    return [_take_heads(t3, perm[r * per:(r + 1) * per], dim
                        ).flatten(dim, dim + 1) for r in tp.ranks]


def _ssm_packed(t: torch.Tensor, cfg, tp, dim: int, kind: str):
    """Mamba2's packed ``in_proj`` columns ``[z | x | B | C | dt]``
    (``kind`` "ssm_in") or conv channels ``[x | B | C]`` ("ssm_conv")
    along ``dim`` as each rank's ``[z_r | x_r | B | C | dt_r]`` (``[x_r |
    B | C]``): its heads of z, x and dt, padded, and the whole B and C."""
    h = _part_heads(cfg, "ssm")
    d_inner, n = h * _SSM_HEAD, cfg.ssm_state
    perm = pad_perm(h, tp.tp)
    if kind == "ssm_in":
        z, x, b, c, dt = t.split([d_inner, d_inner, n, n, h], dim)
        parts = zip(_runs(z, perm, h, dim, tp), _runs(x, perm, h, dim, tp),
                    _runs(dt, perm, h, dim, tp))
        return torch.stack([torch.cat([zr, xr, b, c, dtr], dim=dim)
                            for zr, xr, dtr in parts])
    x, b, c = t.split([d_inner, n, n], dim)
    return torch.stack([torch.cat([xr, b, c], dim=dim)
                        for xr in _runs(x, perm, h, dim, tp)])


def tp_heads(t: torch.Tensor, cfg, tp, kind: str, dim: int) -> torch.Tensor:
    """A whole leaf ``t`` (heads flattened along ``dim``: dim 1 of the
    q/k/v weights, dim 0 of their biases and of o's weights; the
    state-space blocks' per :data:`TP_LEAVES`) as ``tp``'s ranks' parts on
    a new leading axis: rank r the r-th of ``tp.tp`` equal runs of the
    layout's query heads (``kind`` "q"), KV heads ("kv"), or RWKV6's or
    Mamba2's heads padded at the end (:func:`pad_perm`; "rwkv", "ssm"),
    pad slots zero; Mamba2's packed leaves by :func:`_ssm_packed`. Slices
    and zero blocks (:func:`_take_heads`), so the gradient lands on the
    published leaf."""
    if kind in ("ssm_in", "ssm_conv"):
        return _ssm_packed(t, cfg, tp, dim, kind)
    if kind in ("q", "kv"):
        perm = _head_perm(cfg) if kind == "q" else _kv_perm(cfg)
        heads = cfg.n_heads if kind == "q" else cfg.n_kv_heads
    else:
        heads = _part_heads(cfg, kind)
        perm = pad_perm(heads, tp.tp)
    return torch.stack(_runs(t, perm, heads, dim, tp))


def tp_sub_params(p, cfg, tp, sub: str) -> dict:
    """Whole sub-block params ``p`` (``sub`` one of :data:`TP_SUBS`) in the
    TP form of ``tp``'s ranks (marked ``"tp"``): each leaf of
    :data:`TP_LEAVES` under ``sub`` cut into the ranks' parts (equal chunks
    where its kind is None, else :func:`tp_heads`), the others as they
    are."""
    out = dict(p, tp=tp)
    for path, (kind, dim, _) in TP_LEAVES.items():
        head, _, rest = path.partition("/")
        if head != sub:
            continue
        *mid, leaf = rest.split("/")
        src, dst = p, out
        for m in mid:
            src = src.get(m, {})
            dst[m] = dst = dict(dst[m]) if m in dst else {}
        if leaf in src:
            t = src[leaf]
            dst[leaf] = (tp.split(t, dim) if kind is None
                         else tp_heads(t, cfg, tp, kind, dim))
    return out


def tp_block_params(p, cfg, tp) -> dict:
    """A whole block ``p`` with every sub-block of :data:`TP_SUBS` it holds
    in the TP form of ``tp``'s ranks: the one-process emulation of a
    tensor-parallel layer (``tp.ranks`` all of them), through the sharded
    step's code."""
    return dict(p, **{sub: tp_sub_params(p[sub], cfg, tp, sub)
                      for sub in TP_SUBS if sub in p})


def _qkv(p, cfg, x):
    """Projects straight into the TP head layout (p pre-arranged)."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = linear(p["q"], x).reshape(b, s, cfg.eff_heads, dh)
    k = linear(p["k"], x).reshape(b, s, cfg.eff_kv_heads, dh)
    v = linear(p["v"], x).reshape(b, s, cfg.eff_kv_heads, dh)
    return q, k, v


def _finish_attn(p, cfg, out):
    b, s, h = out.shape[:3]
    return linear(p["o"], out.reshape(b, s, h * cfg.head_dim))


def _rope(cfg, positions, dtype):
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta, dtype)


def _self_attn_tp(p, cfg, x, positions, rope):
    """Self-attention in TP form: the replicated input copied in, q, k, v
    column-parallel, each rank's attention over its heads, o row-parallel;
    the keys and values rank-local ``(n·B, S, heads, D)``."""
    tp = p["tp"]
    n, (b, s, _) = tp.n, x.shape
    xr = tp.copy_in(x)
    q, k, v = (linear_col(p[name], xr).reshape(n * b, s, -1, cfg.head_dim)
               for name in "qkv")
    rope = rope if rope is not None else _rope(cfg, positions, q.dtype)
    q, k = rotate(q, *rope), rotate(k, *rope)
    out = chunked_attention(q, k, v, q_positions=positions,
                            kv_positions=positions, causal=True,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return linear_row(p["o"], out.reshape(n, b, s, -1), tp), (k, v)


def self_attn(p, cfg, x, positions, rope=None):
    """``rope``: the call's :func:`rope_tables` for ``positions``, made
    here when not given. ``p`` marked ``"tp"``: :func:`_self_attn_tp`."""
    if "tp" in p:
        return _self_attn_tp(p, cfg, x, positions, rope)
    p = _eff_attn_params(p, cfg)
    q, k, v = _qkv(p, cfg, x)
    rope = rope if rope is not None else _rope(cfg, positions, q.dtype)
    q, k = rotate(q, *rope), rotate(k, *rope)
    out = chunked_attention(q, k, v, q_positions=positions,
                            kv_positions=positions, causal=True,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return _finish_attn(p, cfg, out), (k, v)


def _cache(par):
    """The sharded prefill's or decode step's ``CacheShards``, or None."""
    return getattr(par, "cache", None)


def _heads_cut(par, kv: torch.Tensor, cfg):
    """The 'model' axis's ``TensorParallel`` where the cached keys or
    values ``kv`` (B, S, heads, D) hold the rank's KV heads only, else
    None."""
    if _cache(par) is None or par.tp is None or kv.shape[2] == \
            cfg.eff_kv_heads:
        return None
    return par.tp


def _rank_heads(t: torch.Tensor, tp) -> torch.Tensor:
    """The rank's heads of ``t`` (B, S, heads, D): its ``tp``-th part."""
    size = t.shape[2] // tp.tp
    return t.narrow(2, tp.ranks[0] * size, size)


def _write_at(cache: torch.Tensor, t: torch.Tensor, posv, par) -> None:
    """The new token's keys or values ``t`` (B, 1, heads, D) written into
    ``cache`` at ``posv``; where the rows are cut over ranks, into the
    rank's row if it holds it (no host read: a write of the row's own
    value elsewhere)."""
    t = t.to(cache.dtype)
    seq = None if _cache(par) is None else par.cache.seq
    if seq is None:
        cache.index_copy_(1, posv, t)
        return
    local = posv - seq.lo
    at = local.clamp(0, seq.rows - 1)
    inside = (local >= 0) & (local < seq.rows)
    cache.index_copy_(1, at, torch.where(inside, t, cache.index_select(1, at)))


def _attend(q, k_cache, v_cache, pos, par):
    seq = None if _cache(par) is None else par.cache.seq
    if seq is None:
        return decode_attention(q, k_cache, v_cache, pos)
    return decode_attention_split(q, k_cache, v_cache, pos, seq.lo,
                                  seq.reduce)


def self_attn_decode(p, cfg, x1, k_cache, v_cache, pos, rope=None,
                     par=None):
    """x1 (B,1,D); caches (B,S,Hkv_eff,D), written in place at ``pos`` (a 0-d
    int64 tensor on the caches' device). Sharded (``par``; module
    docstring): the caches hold the rank's KV heads, a block in TP form
    (``p`` marked ``"tp"``) computes them, one computed whole takes them
    from its whole q, k and v and joins the heads over 'model' before o."""
    cut = _heads_cut(par, k_cache, cfg)
    if "tp" in p:
        tp, b = p["tp"], x1.shape[0]
        xr = tp.copy_in(x1)
        q, k, v = (linear_col(p[name], xr).reshape(tp.n * b, 1, -1,
                                                  cfg.head_dim)
                   for name in "qkv")
    else:
        p = _eff_attn_params(p, cfg)
        q, k, v = _qkv(p, cfg, x1)
        if cut is not None:
            q, k, v = (_rank_heads(t, cut) for t in (q, k, v))
    posv = pos.reshape(1)
    rope = rope if rope is not None else _rope(cfg, posv, q.dtype)
    q, k = rotate(q, *rope), rotate(k, *rope)
    _write_at(k_cache, k, posv, par)
    _write_at(v_cache, v, posv, par)
    out = _attend(q, k_cache, v_cache, pos, par)
    if "tp" in p:
        return (linear_row(p["o"], out.reshape(tp.n, b, 1, -1), tp),
                (k_cache, v_cache))
    if cut is not None:
        out = par.cache.heads(out)
    return _finish_attn(p, cfg, out), (k_cache, v_cache)


def _cross_attn_tp(p, cfg, x, img_kv):
    """Cross-attention in TP form: the replicated input copied in, q
    column-parallel (the rank's heads of the TP head layout), attended
    over the rank's image keys and values (:func:`project_image_kv`'s, or
    a decode cache's shards: the rank's KV heads), o row-parallel."""
    tp = p["tp"]
    n, (b, s, _) = tp.n, x.shape
    q = linear_col({"w": p["q"]["w"]}, tp.copy_in(x)
                   ).reshape(n * b, s, -1, cfg.head_dim)
    k, v = img_kv
    zeros = lambda m: torch.zeros((m,), dtype=torch.int32, device=x.device)
    out = chunked_attention(
        q, k, v, q_positions=zeros(s), kv_positions=zeros(k.shape[1]),
        causal=False, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return linear_row({"w": p["o"]["w"]}, out.reshape(n, b, s, -1), tp)


def cross_attn(p, cfg, x, img_kv, par=None):
    """Non-causal attention to fixed image keys/values (already projected):
    img_kv = (k, v) each (B, S_img, Hkv_eff, D). Only the projections'
    weights are read, as the reference reads them. Sharded decode
    (``par``): image keys and values of the rank's heads, attended by its
    heads of the whole q, the heads joined over 'model' before o. ``p``
    marked ``"tp"``: :func:`_cross_attn_tp`."""
    if "tp" in p:
        return _cross_attn_tp(p, cfg, x, img_kv)
    b, s, _ = x.shape
    q = linear({"w": _arranged(p, cfg, "q")}, x
               ).reshape(b, s, cfg.eff_heads, cfg.head_dim)
    k, v = img_kv
    cut = _heads_cut(par, k, cfg)
    if cut is not None:
        q = _rank_heads(q, cut)
    zeros = lambda n: torch.zeros((n,), dtype=torch.int32, device=x.device)
    out = chunked_attention(
        q, k, v, q_positions=zeros(s), kv_positions=zeros(k.shape[1]),
        causal=False, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    if cut is not None:
        out = par.cache.heads(out)
    return _finish_attn({"o": {"w": _arranged(p, cfg, "o")}}, cfg, out)


def project_image_kv(p_cross, cfg, image_embeds):
    """Project image embeddings once into a cross layer's K/V; in TP form
    (``p_cross`` marked ``"tp"``) column-parallel, the rank's KV heads
    ``(n·B, S_img, heads, D)``."""
    b, si, _ = image_embeds.shape
    if "tp" in p_cross:
        tp = p_cross["tp"]
        img = tp.copy_in(image_embeds)
        return tuple(linear_col({"w": p_cross[name]["w"]}, img).reshape(
            tp.n * b, si, -1, cfg.head_dim) for name in "kv")
    k = linear({"w": _arranged(p_cross, cfg, "k")}, image_embeds
               ).reshape(b, si, cfg.eff_kv_heads, cfg.head_dim)
    v = linear({"w": _arranged(p_cross, cfg, "v")}, image_embeds
               ).reshape(b, si, cfg.eff_kv_heads, cfg.head_dim)
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
        # routing groups that span ranks (``p["moe"]["span"]``, the sharded
        # step's ``launch.tp.TokenSpan``): route every rank's tokens, keep
        # this rank's rows
        b, s, d = x.shape
        span = p["moe"].get("span")
        xt = x.reshape(b * s, d)
        if span is not None:
            xt = span.gather(xt)
        y = moe_apply(p["moe"], xt, top_k=cfg.experts_per_token,
                      capacity_factor=cfg.capacity_factor,
                      shard_axes=cfg.batch_axes, groups=cfg.dp_shards)
        if span is not None:
            y = span.mine(y)
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
                 rope=None, par=None):
    h, (k_cache, v_cache) = self_attn_decode(
        p["attn"], cfg, _norm(p["attn"]["ln"], x1, cfg), k_cache, v_cache,
        pos, rope, par)
    x1 = x1 + h
    if img_kv is not None and "xattn" in p:
        hx = cross_attn(p["xattn"], cfg, _norm(p["ln_x"], x1, cfg), img_kv,
                        par)
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
    unless ``device="cpu"``; ``"meta"`` for shapes only) seeded by
    ``seed``. The numbers are the port's own; to run the reference's
    weights, convert them with ``convert.lm_params_from_numpy``."""
    _check(cfg)
    dev = _target_device(device)
    gen = (_MetaGenerator() if dev.type == "meta"
           else torch.Generator(device=dev))
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


def _at(par, tree, path: str):
    """``tree`` (at ``path`` in the params) as its block computes on it:
    the sharded step's gather (``par.gather``), or as it is."""
    return tree if par is None else par.gather(tree, path)


def _head(p, cfg, x, par=None):
    """``(logits, tp)``: the logits (B, S, V) and None; with the head in TP
    form, the ranks' vocabulary slices (n, B, S, V/tp) and its
    ``TensorParallel``."""
    key = "embed" if cfg.tie_embeddings else "lm_head"
    head = _at(par, p[key], key)
    h = _norm(_at(par, p["ln_f"], "ln_f"), x, cfg)
    w = head["w"].transpose(-2, -1) if cfg.tie_embeddings else head["w"]
    if "tp" in head:
        return rank_matmul(head["tp"].copy_in(h), w), head["tp"]
    return h @ w, None


def _last_logits(p, cfg, x, par=None):
    """The logits of ``x``'s one position (B, 1, D) -> (B, V), whole over
    the vocabulary (a TP head's slices joined over 'model')."""
    logits, tp = _head(p, cfg, x, par)
    if tp is not None:
        logits = tp.gather_out(logits)
    return logits[:, 0]


def _embed_tp(e, ids):
    """The vocab-parallel lookup: each rank reads the ids in its vocabulary
    range through ``gather_rows`` (an id outside reads the clamped row,
    zeroed by the mask after the gather, so P4 sums zeros into it), and the
    ranks' rows are summed: one term non-zero, so exact."""
    tp, w = e["tp"], e["w"]
    vl = w.shape[1]
    lo = torch.tensor(tp.ranks, device=ids.device).mul(vl)
    local = ids.long() - lo.reshape(-1, *([1] * ids.ndim))
    inside = (local >= 0) & (local < vl)
    rows = gather_rows(w, local.clamp(0, vl - 1))
    return tp.reduce_out(rows * inside.unsqueeze(-1).to(rows.dtype))


def _embed_in(p, cfg, ids=None, embeds=None, par=None):
    """The rows of the embedding at ``ids`` (or ``embeds`` in the model's
    dtype). The lookup's gradient goes through P4 (``gather_rows``), a
    fixed-order sum per vocabulary row in float32 rounded once to the
    table's dtype: ``index_select``'s backward on the card is an atomic
    ``index_add_`` in no fixed order, and the reference's scatter-add
    rounds a bf16 table's row after every addition."""
    if embeds is not None:
        return embeds.to(cfg.jdtype)
    e = _at(par, p["embed"], "embed")
    if "tp" in e:
        return _embed_tp(e, ids)
    return gather_rows(e["w"], ids)


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


def _layers(tree, n: int, par, path: str):
    """The ``n`` layers of a stacked tree (:func:`_unstack`), each gathered
    as it runs (:func:`_at`): a layer is gathered while the one before is
    still bound, so at most two are at once."""
    for blk in _unstack(tree, n):
        yield _at(par, blk, path)


def _remat(cfg) -> bool:
    """Whether the scanned layers are checkpointed: ``cfg.remat`` in grad
    mode (training; serving, ``prefill`` and ``decode_step`` never)."""
    return bool(cfg.remat) and torch.is_grad_enabled()


def _boundary_tp(cfg, par):
    """The 'model' axis (``par.tp``, a ``TensorParallel``) over which the
    reference's ``_shard_batch`` cuts the block-boundary activations'
    d_model: where ``cfg.batch_axes`` is set (the launch layer pinned the
    batch), the axis has more than one rank and divides ``d_model``; else
    None (the boundaries stay whole)."""
    tp = None if par is None else par.tp
    if tp is None or tp.tp < 2 or not cfg.batch_axes or cfg.d_model % tp.tp:
        return None
    return tp


def _layer(fn, blk, par, path: str, remat: bool, x, cut=None):
    """``fn(blk, x)`` with ``blk`` (one layer's slices) gathered as its
    block computes on it (:func:`_at`) inside the call. With ``cut``
    (:func:`_boundary_tp`'s axis), the reference's boundary cut: ``x``
    enters as the ranks' d_model slices (``cut.cut``) and is joined whole
    inside the call, before the block (``cut.gather_out``). With ``remat``,
    the reference's ``jax.checkpoint`` of a scanned layer: the call runs
    under ``torch.utils.checkpoint`` (non-reentrant, no RNG state: no model
    draws in its forward), which keeps the layer's inputs (the slices,
    where cut) and recomputes the rest in the backward, the gather and the
    join included. Its saved-tensor hooks are the innermost, so a sharded
    step's re-gather hooks (``launch/tp.py``) see none of the layer's
    tensors: each of its leaves is gathered once in the forward and once in
    the recompute, which serves the backward."""
    def run(blk, x):
        if cut is not None:
            x = cut.gather_out(x)
        return fn(_at(par, blk, path), x)
    if cut is not None:
        x = cut.cut(x)
    if not remat:
        return run(blk, x)
    return checkpoint(run, blk, x, use_reentrant=False,
                      preserve_rng_state=False)


def _img_proj(p, x):
    """vlm's image projection; in TP form column-parallel, the ranks'
    columns gathered for the cross layers, which read the whole."""
    if "tp" in p:
        tp = p["tp"]
        return tp.gather_out(linear_col(p, tp.copy_in(x)))
    return linear(p, x)


def _store(store, key: str, index, t: torch.Tensor, par=None) -> None:
    """One layer's value ``t`` (a state, whole) into ``store[key][index]``;
    sharded, the rank's part of it."""
    dst = store[key][index]
    if _cache(par) is not None:
        t = par.cache.cut(key, t, dst)
    dst.copy_(t)


def _store_rows(store, key: str, index, t: torch.Tensor, par=None) -> None:
    """One layer's keys or values ``t`` (B, S, heads, D) into the first S
    rows of ``store[key][index]``; sharded, the rank's heads (of ``t``'s
    whole heads, or ``t`` as it is) and, where the rows are cut over ranks,
    the ones the rank holds."""
    dst = store[key][index]
    cache = _cache(par)
    if cache is not None:
        t = cache.cut(key, t, dst)
        if cache.seq is not None:
            t = t[:, cache.seq.lo:cache.seq.lo + cache.seq.rows]
    dst[:, :t.shape[1]] = t


def _whole(store, key: str, index, par=None) -> torch.Tensor:
    """``store[key][index]``; sharded, whole over 'model'."""
    t = store[key][index]
    return t if _cache(par) is None else par.cache.whole(key, t)


def _block_tp(par, path: str, sub: str):
    """The ``TensorParallel`` of the sub-block ``sub`` of the layers at
    ``path`` where it computes on 'model' shards, else None."""
    if par is None or sub not in par.blocks.get(path, ()):
        return None
    return par.tp


#: the decode cache's state-space states, whose heads are dim -3
_STATES = ("state", "ssm", "ssm_trail")


def _load(store, key: str, index, par, tp, cfg, kind: str):
    """One layer's state-space state ``store[key][index]`` as its block
    reads it: whole (:func:`_whole`); for a block in TP form (``tp``) the
    rank's part, which its heads' cut holds where 'model' cuts the heads
    (their count a multiple of its size) and else is taken from the whole:
    the rank's heads (:func:`tp_heads`, ``(n·B, heads, ...)``) or, for
    the conv rows, the rank's channels (``(n, B, CONV_K-1, C)``)."""
    if tp is None:
        return _whole(store, key, index, par)
    if key in _STATES:
        t = store[key][index]
        if par.cache.dims.get(key) == -3:
            return t
        return tp_heads(t, cfg, tp, kind, 1).flatten(0, 1)
    return tp_heads(_whole(store, key, index, par), cfg, tp, "ssm_conv", 2)


def _save(store, key: str, index, t: torch.Tensor, par, tp, cfg,
          kind: str) -> None:
    """:func:`_load`'s converse: a block's new state ``t`` into
    ``store[key][index]`` (:func:`_store`); in TP form the rank's heads
    written where its shard holds them, else the ranks' parts joined over
    'model' (the pad heads dropped; the conv rows' x channels joined, B
    and C the rank's own) and the rank's shard of the whole written."""
    if tp is None:
        _store(store, key, index, t, par)
        return
    if key in _STATES:
        t = t.unflatten(0, (tp.n, -1))
        if par.cache.dims.get(key) == -3:
            store[key][index].copy_(t[0])
            return
        t = tp.join(t, 1).narrow(1, 0, _part_heads(cfg, kind))
    else:
        d_inner = _part_heads(cfg, "ssm") * _SSM_HEAD
        per = t.shape[-1] - 2 * cfg.ssm_state
        t = torch.cat([tp.join(t[..., :per], -1)[..., :d_inner],
                       t[0, ..., per:]], dim=-1)
    _store(store, key, index, t, par)


def _run(p, cfg, x, image_embeds=None, store=None, par=None):
    """The blocks over embedded inputs ``x`` (B, S, D): the final hidden
    state. With ``store`` (a cache with at least ``kv_rows(cfg, S)`` rows)
    each layer's keys and values are written into its first rows, vlm's
    image keys and values into ``img_k``/``img_v``, and the state-space
    families' states into theirs. Under :func:`_remat` the reference's
    checkpointed layers run through :func:`_layer`'s checkpoint: the dense,
    moe and audio blocks, vlm's plain layers (not the crossed ones)."""
    if cfg.family == "hybrid":
        return _run_hybrid(p, cfg, x, store, par)
    if cfg.family == "ssm":
        return _run_rwkv(p, cfg, x, store, par)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    rope = _rope(cfg, positions, cfg.jdtype)
    remat, cut = _remat(cfg), _boundary_tp(cfg, par)

    def block(blk, x):
        return block_apply(blk, cfg, x, positions, rope=rope)
    if cfg.family in ("dense", "moe", "audio"):
        for i, blk in enumerate(_unstack(p["blocks"], cfg.n_layers)):
            x, (k, v) = _layer(block, blk, par, "blocks", remat, x, cut)
            if store is not None:
                _store_rows(store, "k", i, k, par)
                _store_rows(store, "v", i, v, par)
        return x
    img = _img_proj(_at(par, p["img_proj"], "img_proj"),
                    image_embeds.to(cfg.jdtype))
    groups = cfg.n_layers // cfg.cross_attn_interval
    for gi, (plain, crossed) in enumerate(zip(
            _unstack(p["plain"], groups), _unstack(p["crossed"], groups))):
        for j, blk in enumerate(_unstack(plain,
                                         cfg.cross_attn_interval - 1)):
            x, (k, v) = _layer(block, blk, par, "plain", remat, x, cut)
            if store is not None:
                _store_rows(store, "k_plain", (gi, j), k, par)
                _store_rows(store, "v_plain", (gi, j), v, par)
        crossed = _at(par, crossed, "crossed")
        img_kv = project_image_kv(crossed["xattn"], cfg, img)
        x, (k, v) = block_apply(crossed, cfg, x, positions, img_kv=img_kv,
                                rope=rope)
        if store is not None:
            _store_rows(store, "k_cross", gi, k, par)
            _store_rows(store, "v_cross", gi, v, par)
            _store(store, "img_k", gi, img_kv[0], par)
            _store(store, "img_v", gi, img_kv[1], par)
    return x


def _run_hybrid(p, cfg, x, store, par=None):
    """The hybrid's layers; under :func:`_remat` each Mamba layer (the
    groups' and the trail's) checkpointed, the shared block not, as the
    reference checkpoints them."""
    s = x.shape[1]
    h = _pad_to(x, ssm.CHUNK)
    sp = h.shape[1]
    positions = torch.arange(sp, dtype=torch.int32, device=x.device)
    rope = _rope(cfg, positions, cfg.jdtype)
    remat, cut = _remat(cfg), _boundary_tp(cfg, par)
    n_super, trail = divmod(cfg.n_layers, cfg.attn_interval)

    def mamba(blk, h):
        return _mamba_layer(blk, cfg, h)

    def save(keys, index, st, cv, path):
        tp = _block_tp(par, path, "mamba")
        _save(store, keys[0], index, st, par, tp, cfg, "ssm")
        _save(store, keys[1], index, cv, par, tp, cfg, "ssm")
    for gi, group in enumerate(_unstack(p["mamba"], n_super)):
        for j, blk in enumerate(_unstack(group, cfg.attn_interval)):
            h, st, cv = _layer(mamba, blk, par, "mamba", remat, h, cut)
            if store is not None:
                save(("ssm", "conv"), (gi, j), st, cv, "mamba")
        h, (k, v) = block_apply(_at(par, p["shared_attn"], "shared_attn"),
                                cfg, h, positions, rope=rope)
        if store is not None:
            _store_rows(store, "k", gi, k, par)
            _store_rows(store, "v", gi, v, par)
    for t, blk in enumerate(_unstack(p["mamba_trail"], trail)):
        h, st, cv = _layer(mamba, blk, par, "mamba_trail", remat, h, cut)
        if store is not None:
            save(("ssm_trail", "conv_trail"), t, st, cv, "mamba_trail")
    return h[:, :s]


def _run_rwkv(p, cfg, x, store, par=None):
    """RWKV6's blocks, each checkpointed under :func:`_remat`."""
    s = x.shape[1]
    h = _pad_to(x, rk.CHUNK)
    remat, cut = _remat(cfg), _boundary_tp(cfg, par)

    def block(blk, h):
        return _rwkv_layer(blk, cfg, h)
    tp = _block_tp(par, "blocks", "time")
    for i, blk in enumerate(_unstack(p["blocks"], cfg.n_layers)):
        h, st, lt, lc = _layer(block, blk, par, "blocks", remat, h, cut)
        if store is not None:
            _save(store, "state", i, st, par, tp, cfg, "rwkv")
            _store(store, "last_t", i, lt, par)
            _store(store, "last_c", i, lc, par)
    return h[:, :s]


def _forward(p, cfg, ids, embeds, image_embeds, collect_cache, par):
    """:func:`forward`, with the head's ``TensorParallel`` (or None)."""
    _check(cfg)
    x = _embed_in(p, cfg, ids, embeds, par)
    store = (init_cache(cfg, x.shape[0], kv_rows(cfg, x.shape[1]),
                        device=x.device)
             if collect_cache else None)
    x = _run(p, cfg, x, image_embeds, store, par)
    if store is not None and cfg.family == "vlm":
        del store["img_k"], store["img_v"]   # prefill's, not forward's
    logits, tp = _head(p, cfg, x, par)
    return logits, store, tp


def forward(p, cfg, ids=None, *, embeds=None, image_embeds=None,
            collect_cache: bool = False, par=None):
    """-> (logits (B,S,V), cache | None). The collected cache holds every
    layer's keys and values over the sequence (the hybrid's over the
    padded sequence) and the state-space families' final states, as the
    reference's. ``par``: the sharded step's ``ParamShards`` (module
    docstring); with the head in TP form the logits are the ranks'
    vocabulary slices (n, B, S, V/tp)."""
    logits, store, _ = _forward(p, cfg, ids, embeds, image_embeds,
                                collect_cache, par)
    return logits, store


class _VocabLogSumExp(torch.autograd.Function):
    """``logsumexp`` of vocabulary-sharded logits ``(n, B, S, V/tp)`` over
    the whole vocabulary: the row max reduced with MAX, the sum of ``exp``
    over the ranks accumulated in float64 and ``log(sum) + max`` rounded
    once, so that a row's value does not depend on how its vocabulary is
    split (but for a double rounding now and then); backward
    ``torch.logsumexp``'s own, ``g · exp(l - logz)`` on each rank's slice.
    Where ``logz`` rounds as the unsplit one does, the gradient is the
    unsplit step's bit for bit."""

    @staticmethod
    def forward(ctx, logits, tp):
        m = tp.reduce(logits.amax(dim=-1), "max")
        e = torch.exp(logits - m[..., None])
        total = tp.reduce(e.sum(dim=-1, dtype=torch.float64))
        logz = (torch.log(total) + m).to(logits.dtype)
        ctx.save_for_backward(logits, logz)
        return logz

    @staticmethod
    def backward(ctx, grad):
        logits, logz = ctx.saved_tensors
        return grad[..., None] * torch.exp(logits - logz[..., None]), None


def _vocab_parallel_ce(logits, labels, tp):
    """The mean cross-entropy of vocabulary-sharded float32 logits ``(n, B,
    S, V/tp)``: :class:`_VocabLogSumExp` less the gold logit (the
    reference's iota compare on each rank's range, summed over the
    ranks)."""
    vl = logits.shape[-1]
    lo = torch.tensor(tp.ranks, device=logits.device).mul(vl)
    vocab = torch.arange(vl, device=logits.device) + lo.reshape(-1, 1, 1, 1)
    gold = tp.reduce_out(torch.where(vocab == labels.long()[..., None],
                                     logits, 0.0).sum(dim=-1))
    return (_VocabLogSumExp.apply(logits, tp) - gold).mean()


def loss_fn(p, cfg, ids, labels, *, embeds=None, image_embeds=None,
            par=None):
    """Mean next-token cross-entropy: -> (loss, {"loss", "ppl"}).
    ``par``: the sharded step's ``ParamShards`` (module docstring)."""
    logits, _, tp = _forward(p, cfg, ids, embeds, image_embeds, False, par)
    logits = upcast(logits)
    if tp is not None:
        loss = _vocab_parallel_ce(logits, labels, tp)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
        loss = (logz - gold).mean()
    return loss, {"loss": loss, "ppl": torch.exp(loss)}


# ---- caches / decode ----

def _target_device(device) -> torch.device:
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")      # shapes only (``input_specs``)
    return resolve_device(device)


class _MetaGenerator(torch.Generator):
    """A CPU generator whose draws land on the ``meta`` device (shapes and
    dtypes, no storage): ``init(..., device="meta")``."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def cache_shapes(cfg, batch: int, max_seq: int, dtype=None) -> dict:
    """The decode cache's leaves for ``max_seq`` context as ``{key:
    (shape, dtype)}``, allocating nothing (:func:`init_cache` allocates
    them). The SSM and RWKV states are float32, as the reference's."""
    dt = dtype or cfg.jdtype
    f32 = torch.float32
    dh, hkv = cfg.head_dim, cfg.eff_kv_heads
    fam = cfg.family
    if fam in ("dense", "moe", "audio"):
        shape = (cfg.n_layers, batch, max_seq, hkv, dh)
        return {"k": (shape, dt), "v": (shape, dt)}
    if fam == "vlm":
        g = cfg.n_layers // cfg.cross_attn_interval
        sp = (g, cfg.cross_attn_interval - 1, batch, max_seq, hkv, dh)
        sc = (g, batch, max_seq, hkv, dh)
        si = (g, batch, cfg.n_image_tokens, hkv, dh)
        return {"k_plain": (sp, dt), "v_plain": (sp, dt),
                "k_cross": (sc, dt), "v_cross": (sc, dt),
                "img_k": (si, dt), "img_v": (si, dt)}
    if fam == "hybrid":
        n_super, trail = divmod(cfg.n_layers, cfg.attn_interval)
        h = 2 * cfg.d_model // 64
        cchan = 2 * cfg.d_model + 2 * cfg.ssm_state
        kv = (n_super, batch, max_seq, hkv, dh)
        return {
            "ssm": ((n_super, cfg.attn_interval, batch, h, 64,
                     cfg.ssm_state), f32),
            "conv": ((n_super, cfg.attn_interval, batch, ssm.CONV_K - 1,
                      cchan), dt),
            "ssm_trail": ((trail, batch, h, 64, cfg.ssm_state), f32),
            "conv_trail": ((trail, batch, ssm.CONV_K - 1, cchan), dt),
            "k": (kv, dt), "v": (kv, dt),
        }
    h = cfg.d_model // cfg.head_size
    return {"state": ((cfg.n_layers, batch, h, cfg.head_size,
                       cfg.head_size), f32),
            "last_t": ((cfg.n_layers, batch, 1, cfg.d_model), dt),
            "last_c": ((cfg.n_layers, batch, 1, cfg.d_model), dt)}


def init_cache(cfg, batch: int, max_seq: int, dtype=None, *,
               device=None) -> Params:
    """Empty decode cache sized for ``max_seq`` context, on ``device`` (the
    card unless ``device="cpu"``; ``"meta"`` for shapes only): the leaves
    of :func:`cache_shapes`, zeroed."""
    _check(cfg)
    dev = _target_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=dev)
            for k, (shape, dt) in cache_shapes(cfg, batch, max_seq,
                                               dtype).items()}


def decode_step(p, cfg, cache, ids1=None, pos=None, *, embeds1=None,
                image_embeds=None, par=None):
    """One serving step: ids1 (B, 1) int32 (or ``embeds1`` (B, 1, D) for the
    audio frontend stub), ``pos`` the new token's position (an int or a 0-d
    int32 tensor; the RWKV family reads none). -> (logits (B, V), cache),
    the cache written in place. ``image_embeds`` is accepted for the
    reference's signature and not read: the image keys and values are in
    the cache since ``prefill`` (the reference projects ``image_embeds``
    here into a value nothing reads). ``par``: the sharded decode step's
    ``ParamShards``, ``cache`` the rank's shards (module docstring)."""
    _check(cfg)
    x = _embed_in(p, cfg, ids1, embeds1, par)
    cut = _boundary_tp(cfg, par)
    if cut is not None:
        # the reference's boundary at the embedding, whole for the block
        x = cut.gather_out(cut.cut(x))
    fam = cfg.family
    if fam == "ssm":
        tp = _block_tp(par, "blocks", "time")
        for i, blk in enumerate(_layers(p["blocks"], cfg.n_layers, par,
                                        "blocks")):
            x, st, lt, lc = _rwkv_layer(
                blk, cfg, x, _load(cache, "state", i, par, tp, cfg, "rwkv"),
                _whole(cache, "last_t", i, par),
                _whole(cache, "last_c", i, par))
            _save(cache, "state", i, st, par, tp, cfg, "rwkv")
            _store(cache, "last_t", i, lt, par)
            _store(cache, "last_c", i, lc, par)
        return _last_logits(p, cfg, x, par), cache
    # one conversion a step: index_copy_ wants an int64 index
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    rope = _rope(cfg, pos.reshape(1), cfg.jdtype)
    if fam in ("dense", "moe", "audio"):
        for i, blk in enumerate(_layers(p["blocks"], cfg.n_layers, par,
                                        "blocks")):
            x, _ = block_decode(blk, cfg, x, cache["k"][i], cache["v"][i],
                                pos, rope=rope, par=par)
        return _last_logits(p, cfg, x, par), cache
    if fam == "hybrid":
        n_super, trail = divmod(cfg.n_layers, cfg.attn_interval)

        def mamba(blk, keys, index, h, path):
            tp = _block_tp(par, path, "mamba")
            h, st, cv = _mamba_layer(blk, cfg, h, *(
                _load(cache, k, index, par, tp, cfg, "ssm") for k in keys))
            _save(cache, keys[0], index, st, par, tp, cfg, "ssm")
            _save(cache, keys[1], index, cv, par, tp, cfg, "ssm")
            return h
        for gi, group in enumerate(_unstack(p["mamba"], n_super)):
            for j, blk in enumerate(_layers(group, cfg.attn_interval, par,
                                            "mamba")):
                x = mamba(blk, ("ssm", "conv"), (gi, j), x, "mamba")
            x, _ = block_decode(_at(par, p["shared_attn"], "shared_attn"),
                                cfg, x, cache["k"][gi], cache["v"][gi], pos,
                                rope=rope, par=par)
        for t, blk in enumerate(_layers(p["mamba_trail"], trail, par,
                                        "mamba_trail")):
            x = mamba(blk, ("ssm_trail", "conv_trail"), t, x, "mamba_trail")
        return _last_logits(p, cfg, x, par), cache
    groups = cfg.n_layers // cfg.cross_attn_interval
    for gi, (plain, crossed) in enumerate(zip(
            _unstack(p["plain"], groups), _unstack(p["crossed"], groups))):
        for j, blk in enumerate(_layers(plain, cfg.cross_attn_interval - 1,
                                        par, "plain")):
            x, _ = block_decode(blk, cfg, x, cache["k_plain"][gi, j],
                                cache["v_plain"][gi, j], pos, rope=rope,
                                par=par)
        x, _ = block_decode(_at(par, crossed, "crossed"), cfg, x,
                            cache["k_cross"][gi], cache["v_cross"][gi], pos,
                            img_kv=(cache["img_k"][gi], cache["img_v"][gi]),
                            rope=rope, par=par)
    return _last_logits(p, cfg, x, par), cache


def prefill(p, cfg, ids=None, *, embeds=None, image_embeds=None,
            max_seq: int | None = None, cache=None, par=None):
    """Run the prompt, return (last-token logits (B,V), decode cache). The
    cache's capacity is the prompt length unless ``max_seq`` extends it
    (the hybrid's is at least ``kv_rows(cfg, S)``: the padded prompt's keys
    and values are kept, as the reference keeps them); its rows past
    those are zero. ``cache``, if given (a cache of that capacity, e.g. a
    captured step's), is written in place instead of a new one. Only the
    last position's logits are computed. ``par``: the sharded prefill's
    ``ParamShards``, ``cache`` the rank's zeroed shards of a cache of that
    capacity (module docstring)."""
    _check(cfg)
    x = _embed_in(p, cfg, ids, embeds, par)
    b, s = x.shape[:2]
    rows = kv_rows(cfg, s)
    cap = max(max_seq or s, rows)
    if par is not None:
        if cache is None:
            raise ValueError("a sharded prefill writes into the rank's "
                             "cache shards: pass cache=")
    elif cache is None:
        cache = init_cache(cfg, b, cap, device=x.device)
    else:
        for key, t in cache.items():
            if key in ("k", "v") or key.startswith(("k_", "v_")):
                if t.shape[-3] != cap:
                    raise ValueError(f"cache {key!r} holds {t.shape[-3]} "
                                     f"positions; this prefill needs {cap}")
                t[..., rows:, :, :].zero_()
    x = _run(p, cfg, x, image_embeds, cache, par)
    return _last_logits(p, cfg, x[:, -1:], par), cache
