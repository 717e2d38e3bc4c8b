"""INT8 error-feedback gradient compression: the port's counterpart of the
JAX package's ``optim/compression.py``.

Quantizing gradients to int8 cuts a cross-pod all-reduce's bytes 4x
against float32. Error feedback (Karimireddy et al., 2019) carries each
step's quantization residual into the next step's gradient, so the
compression error telescopes instead of compounding.
:func:`compress_error_feedback` is the pure tree transform the trainer
applies right before the optimizer (where the cross-pod reduction sits);
the collective that quantizes around an all-reduce is
``launch/collectives.py::compressed_psum``.

The arithmetic is the reference's bit for bit: float32 throughout, the
scale ``max(max|x|, 1e-12) / 127`` divided by a float32 tensor (PyTorch's
CUDA division by a Python scalar multiplies by its reciprocal instead),
``x / scale`` rounded half to even (``torch.round``, as ``jnp.round``),
clipped to ``[-127, 127]``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .optimizer import _f32, tree_leaves, tree_map

__all__ = ["CompressionState", "int8_quantize", "int8_dequantize",
           "compress_error_feedback"]


@dataclass
class CompressionState:
    error: Any       # a tree like the gradients', float32 residuals

    @classmethod
    def init(cls, params):
        """Zero residuals in float32 beside each leaf of ``params``."""
        return cls(error=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))


def int8_quantize(x: torch.Tensor, amax=None):
    """float32 ``x`` -> (int8 values, the float32 0-d scale). ``amax``:
    the largest |x| of the whole tensor when ``x`` is a shard of it."""
    amax = x.abs().max() if amax is None else amax
    scale = torch.clamp_min(amax, 1e-12) / _f32(127.0, x)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_error_feedback(grads, state: CompressionState, *,
                            amax_reduce=None):
    """Quantize (gradient + carried residual) to int8 per leaf; return the
    dequantized gradient in each leaf's dtype (what the cross-pod
    reduction would carry) and the new residuals, ``(grads,
    CompressionState)``. For shards of a sharded tree, ``amax_reduce``
    takes the vector of every leaf's largest |value| and returns each
    leaf's over all its shards (a MAX all-reduce), so each leaf keeps one
    scale."""
    amax = None
    if amax_reduce is not None:
        amax = iter(amax_reduce(torch.stack(
            [(g.to(torch.float32) + e).abs().max() for g, e in
             zip(tree_leaves(grads), tree_leaves(state.error))])))

    def one(g, e):
        g32 = g.to(torch.float32) + e
        deq = int8_dequantize(*int8_quantize(
            g32, None if amax is None else next(amax)))
        return deq.to(g.dtype), g32 - deq

    pairs = tree_map(one, grads, state.error)
    return (tree_map(lambda _, pe: pe[0], grads, pairs),
            CompressionState(error=tree_map(lambda _, pe: pe[1], grads,
                                            pairs)))
