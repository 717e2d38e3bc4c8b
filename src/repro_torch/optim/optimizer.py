"""AdamW with a configurable moment dtype, a warmup-cosine schedule and
global-norm clipping, over the model's nested parameter trees.

The counterpart of the JAX package's ``repro.optim.optimizer``, with the
same functional API over the same ``{"sa": [[{"w", "b"}, …], …],
"head": […]}`` trees, here of tensors. The arithmetic is the reference's,
not ``torch.optim.AdamW``'s (whose decoupled decay, clipping and schedule
round in another order): float32 math whatever the storage dtypes, bias
corrections ``1 - b ** step`` in float32, weight decay on every leaf
(biases included), and ``moment_dtype='bfloat16'`` moments updated in
float32 and stored in bfloat16.

Every constant enters as a float32 tensor on the leaf's device, and every
division is by a tensor: PyTorch's CUDA division by a Python scalar
multiplies by its reciprocal instead, an ulp off the reference.

:func:`adamw_update` updates the parameters and moments in place, under
``torch.no_grad()`` (so a compiled model that holds the parameter tensors
reads the new values on its next call), and returns ``(params, state,
{"grad_norm", "lr"})`` as the reference does; ``step_in_place=True``
advances the step counter in place too, which a step captured into a CUDA
graph needs.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "tree_leaves", "tree_map",
           "warmup_cosine"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"     # 'bfloat16' halves the moments
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


# ---------------------------------------------------------------------------
# trees: nested dicts, lists and tuples with tensors at the leaves
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in the JAX package's order: dict entries by
    sorted key, list and tuple entries by position."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``
    (the same structure), in a tree of ``tree``'s structure; called in
    :func:`tree_leaves`' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d float32 tensor on ``like``'s device (a fill, not
    a copy from the host)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# schedule, clipping, AdamW
# ---------------------------------------------------------------------------

@functools.cache
def _cosf():
    """The C library's float32 cosine (what the JAX package's CPU backend
    calls; PyTorch's differs from it by an ulp at some arguments), or None
    where there is no C math library to load."""
    name = ctypes.util.find_library("m")
    if name is None:
        return None
    f = ctypes.CDLL(name).cosf
    f.restype, f.argtypes = ctypes.c_float, [ctypes.c_float]
    return f


@functools.cache
def _lr_table(cfg: AdamWConfig) -> np.ndarray:
    """float32 learning rates of steps ``0 .. n-1``, each computed as the
    reference computes it, in float32 with the C library's cosine; from
    step ``n - 1`` on the rate no longer changes."""
    f32 = np.float32
    n = max(cfg.total_steps, cfg.warmup_steps + 1) + 1
    cosf = _cosf()
    out = np.empty(n, np.float32)
    for i in range(n):
        step = f32(i)
        warm = step / f32(max(1.0, cfg.warmup_steps))
        t = (step - f32(cfg.warmup_steps)) / f32(
            max(1.0, cfg.total_steps - cfg.warmup_steps))
        x = f32(math.pi) * min(max(t, f32(0.0)), f32(1.0))
        c = f32(cosf(float(x))) if cosf is not None else f32(math.cos(x))
        cos = f32(cfg.min_lr_frac) + f32((1 - cfg.min_lr_frac) * 0.5) * (
            f32(1.0) + c)
        out[i] = f32(cfg.lr) * (warm if step < f32(cfg.warmup_steps)
                                else cos)
    return out


@functools.cache
def _lr_table_on(cfg: AdamWConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_lr_table(cfg)).to(device)


def warmup_cosine(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d integer tensor or an int, at
    least 0): linear warmup over ``warmup_steps``, then a cosine from
    ``lr`` down to ``min_lr_frac * lr`` at ``total_steps``; a float32 0-d
    tensor on ``step``'s device. The rates are tabled once per config on
    the host (:func:`_lr_table`) and the step reads its own on the device,
    so a step on the card makes no host transfer."""
    step = torch.as_tensor(step)
    table = _lr_table_on(cfg, step.device)
    idx = torch.clamp(step.to(torch.int64), 0, table.numel() - 1)
    return torch.take(table, idx)


def clip_by_global_norm(grads, max_norm: float):
    """``grads`` scaled so that their global L2 norm is at most
    ``max_norm`` (each leaf in float32, back in its own dtype), and the
    norm before clipping: ``(tree, gn)``."""
    gn, scale = _clip_scale(grads, max_norm)
    return tree_map(lambda g: _clipped(g, scale), grads), gn


#: elements of a leaf squared and summed, or updated, at a time (1 GiB of
#: float32): the float32 temporaries stay this size whatever the leaf's
#: (llama4-scout's stacked experts are 671 M elements a layer). A leaf no
#: larger is one piece, whose arithmetic is the whole leaf's.
PIECE = 1 << 28


def _pieces(t: torch.Tensor, read_only: bool = False) -> tuple:
    """``t`` whole, or the consecutive flat pieces of a larger ``t``: views
    of it, so that writes into them write ``t`` (a ``read_only`` ``t`` may
    be non-contiguous, and is then copied)."""
    if t.numel() <= PIECE:
        return (t,)
    return (t.reshape(-1) if read_only else t.view(-1)).split(PIECE)


def _clip_scale(grads, max_norm: float):
    """The global norm of ``grads`` (each leaf's squares summed piece by
    piece, :data:`PIECE`) and the factor that clips it."""
    gn = torch.sqrt(sum(torch.sum(torch.square(c.to(torch.float32)))
                        for g in tree_leaves(grads)
                        for c in _pieces(g, read_only=True)))
    return gn, torch.clamp_max(
        _f32(max_norm, gn) / torch.clamp_min(gn, 1e-12), 1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """One leaf clipped: in float32, back in its own dtype."""
    return (g.to(torch.float32) * scale).to(g.dtype)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.moment_dtype`` beside each leaf, and an int32
    0-d ``step`` of 0."""
    dt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt,        # noqa: E731
                                  device=p.device)
    first = tree_leaves(params)[0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig, *,
                 step_in_place: bool = False):
    """One AdamW step: ``(params, state, {"grad_norm", "lr"})``. float32
    math; the parameters keep their dtype and the moments
    ``moment_dtype``, both updated in place. The returned state's
    ``step`` is a new tensor, the reference's ``step + 1``; with
    ``step_in_place`` it is ``state["step"]`` itself, advanced in place,
    as a captured step needs (a replay reads the state's own tensors, so a
    new one would leave the next replay at the same step)."""
    step = state["step"].add_(1) if step_in_place else state["step"] + 1
    lr = warmup_cosine(cfg, step)
    # each leaf clipped inside its update, as clip_by_global_norm clips it:
    # no second tree of gradients
    gnorm, scale = _clip_scale(grads, cfg.clip_norm)
    c = lambda v: _f32(v, lr)                               # noqa: E731
    s32 = step.to(torch.float32)
    bc1 = c(1.0) - torch.pow(c(cfg.b1), s32)
    bc2 = c(1.0) - torch.pow(c(cfg.b2), s32)
    b1, b2, nb1, nb2 = c(cfg.b1), c(cfg.b2), c(1 - cfg.b1), c(1 - cfg.b2)
    eps, wd = c(cfg.eps), c(cfg.weight_decay)

    def upd(p, g, m, v):
        for pieces in zip(_pieces(p), _pieces(g, read_only=True),
                          _pieces(m), _pieces(v)):
            upd_piece(*pieces)

    def upd_piece(p, g, m, v):
        # the reference's expressions, each product and sum the same
        # (commuted where IEEE arithmetic is exact under it) but computed
        # in place into the float32 temporaries: a piece's update holds
        # four float32 copies of it at most (1 GiB each)
        g32 = _clipped(g, scale).to(torch.float32)
        m32 = m.to(torch.float32, copy=True).mul_(b1).add_(g32 * nb1)
        v32 = v.to(torch.float32, copy=True).mul_(b2).add_(
            (g32 * nb2).mul_(g32))
        del g32
        m.copy_(m32)
        v.copy_(v32)
        delta = m32.div_(bc1).div_(v32.div_(bc2).sqrt_().add_(eps))
        del v32
        p32 = p.to(torch.float32)     # ``p`` itself when float32
        delta.add_(wd * p32)
        p.copy_(p32.sub_(delta.mul_(lr)))

    tree_map(upd, params, grads, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
