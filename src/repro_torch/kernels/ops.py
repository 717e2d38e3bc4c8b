"""Public wrappers over the kernels: ``reram_linear`` (one float layer
through the crossbar matmul K6), ``fps`` (farthest point sampling through
K7) and ``count_dma_elisions`` (the gather's DMA-elision count, NumPy).

``reram_linear`` is the counterpart of the JAX package's
``repro.kernels.ops.reram_linear``: INT8 symmetric quantization of both
operands, the bit-sliced crossbar matmul in the integer domain (exact),
dequantized output. The weights are quantized and plane-encoded anew on
every call, as in the JAX package; the weight-stationary path is the fused
MLP, which programs them once. A ``fault_model`` lands on the freshly
encoded ``(P, K, N)`` planes before K6's own s8 pre-pass combines them.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .fps_update import fps_batched
from .program import _quantize, _scale, encode_planes, quantize_tensor
from .reram_mlp import reram_matmul_int

__all__ = ["count_dma_elisions", "fps", "reram_linear"]


def reram_linear(x, w, b=None, *, batched: bool = False,
                 check_weights: bool = True, fault_model=None,
                 fault_key=()):
    """Float ``(…, K) @ (K, N)`` through the bit-sliced crossbar matmul.

    All rows share one activation scale, or, with ``batched``, axis 0 is a
    batch of independent inputs, each quantized under its own scale (what
    a per-input loop would give, bit for bit) — and the whole batch still
    runs as one matmul launch. ``check_weights=False`` skips the NaN/Inf
    check of ``w`` (a host sync on the card), for weights the caller has
    checked once already.

    ``fault_model`` (a :class:`repro_torch.reliability.FaultModel`, read
    through its ``is_ideal_for``/``transform_planes``) injects ReRAM
    non-idealities into the encoded planes before the product;
    ``fault_key`` is its site tuple (drawn on the CPU in this call) or the
    site's :class:`~repro_torch.reliability.faults.FaultDraws`, made
    before — what a captured call passes, so that it draws nothing."""
    k, n = w.shape
    w_int, sw = quantize_tensor(w, check_finite=check_weights)
    planes = encode_planes(w_int)
    if fault_model is not None and not fault_model.is_ideal_for(2):
        planes = fault_model.transform_planes(planes, fault_key,
                                              cell_bits=2)
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


def fps(points, n_samples: int, *, start: int = 0):
    """Farthest point sampling over one cloud ``(N, 3)`` from row ``start``
    -> int64 ``(n_samples,)``: :func:`~.fps_update.fps_batched` at batch 1,
    one launch on the card (the JAX package drives its step kernel once
    per sample)."""
    return fps_batched(points[None], n_samples, start)[0]


def count_dma_elisions(nbr_idx: np.ndarray, window: int = 1) -> dict:
    """TPU-native twin of the paper's buffer hit rate. ``window=1`` models
    strict Pallas revisit elision (consecutive grid steps mapping to the
    same block skip the copy); ``window=W`` models a W-row VMEM working
    set (multi-buffered blocks / a VMEM-resident row cache — e.g. W=72
    rows ~ the paper's 9 KB buffer at 128 B/row). Reordering rows of
    ``nbr_idx`` (the paper's intra-layer reordering) changes this number
    and nothing else."""
    flat = np.asarray(nbr_idx).reshape(-1)
    if window <= 1:
        elided = int(np.sum(flat[1:] == flat[:-1]))
    else:
        lru: OrderedDict = OrderedDict()
        elided = 0
        for v in flat.tolist():
            if v in lru:
                elided += 1
                lru.move_to_end(v)
            else:
                if len(lru) >= window:
                    lru.popitem(last=False)
                lru[v] = True
    return {"steps": int(flat.size), "elided": elided,
            "dma": int(flat.size) - elided,
            "elision_rate": elided / max(1, flat.size)}
