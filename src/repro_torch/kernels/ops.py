"""``reram_linear``: one float layer through the crossbar matmul K6.

The counterpart of the JAX package's ``repro.kernels.ops.reram_linear``
(without ``fault_model``): INT8 symmetric quantization of both operands,
the bit-sliced crossbar matmul in the integer domain (exact), dequantized
output. The weights are quantized and plane-encoded anew on every call, as
in the JAX package; the weight-stationary path is the fused MLP, which
programs them once.
"""
from __future__ import annotations

import torch

from .program import _quantize, _scale, encode_planes, quantize_tensor
from .reram_mlp import reram_matmul_int

__all__ = ["reram_linear"]


def reram_linear(x, w, b=None, *, batched: bool = False):
    """Float ``(…, K) @ (K, N)`` through the bit-sliced crossbar matmul.

    All rows share one activation scale, or, with ``batched``, axis 0 is a
    batch of independent inputs, each quantized under its own scale (what
    a per-input loop would give, bit for bit) — and the whole batch still
    runs as one matmul launch."""
    k, n = w.shape
    w_int, sw = quantize_tensor(w)
    planes = encode_planes(w_int)
    if batched:
        batch = x.shape[0]
        x3 = x.reshape(batch, -1, k)
        sx = _scale(x3.abs().amax(dim=(1, 2)), 127.0)[:, None, None]
        x_int = _quantize(x3, sx, 127.0)
    else:
        x_int, sx = quantize_tensor(x.reshape(-1, k))
    y = reram_matmul_int(x_int.reshape(-1, k).to(torch.int8), planes)
    out = y.reshape(x_int.shape[:-1] + (n,)).to(torch.float32) * (sx * sw)
    if b is not None:
        out = out + b
    return out.reshape(*x.shape[:-1], n)
