"""K6: the bit-sliced INT8 crossbar matmul (``csrc/reram_mlp.cu``).

Replaces the TPU kernel ``repro/kernels/reram_mlp.py::_kernel``
(``reram_matmul_int``): int8 activations ``(M, K)`` times 8-bit weights
held as four 2-bit offset-binary cell planes ``(P, K, N)``, exactly, in
int32 — ``x @ (combine(planes) - 2^(weight_bits - 1))``. It is the matmul
of the per-layer 'reram' backend (:func:`~.ops.reram_linear`).

The JAX package pads M, K and N to multiples of 128 for its block specs;
the integers are the same without, so neither the kernel nor the plain
version (:func:`~.ref.ref_reram_matmul_int`) pads. On CPU tensors the
wrapper runs the plain version; on CUDA tensors it launches the kernel (or
raises). ``LAUNCHES["reram_matmul_int"]`` counts the launches.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from .ref import ref_reram_matmul_int

__all__ = ["LAUNCHES", "reram_matmul_int", "reram_matmul_int_cuda"]

#: Kernel launches (plain runs never count).
LAUNCHES = {"reram_matmul_int": 0}


@functools.cache
def _lib():
    lib = _build.library("reram_mlp")
    _build.bind(lib, "reram_matmul_int", 3, 6)
    return lib


def reram_matmul_int_cuda(x_int, planes, *, cell_bits: int = 2,
                          weight_bits: int = 8):
    """Launch the kernel: int8 ``(M, K)`` and int8 ``(P, K, N)``, contiguous
    on one CUDA device -> int32 ``(M, N)``."""
    m, k = x_int.shape
    n_planes, k2, n = planes.shape
    if x_int.dtype != torch.int8 or planes.dtype != torch.int8:
        raise TypeError(f"need int8 activations and planes; got "
                        f"{x_int.dtype}, {planes.dtype}")
    if k2 != k:
        raise ValueError(f"activations {tuple(x_int.shape)} do not match "
                         f"planes {tuple(planes.shape)}")
    if n_planes * cell_bits > 8 or weight_bits > 8:
        raise ValueError(f"{n_planes} planes of {cell_bits} bits do not fit "
                         f"the kernel's u8 weights")
    if not (x_int.is_contiguous() and planes.is_contiguous()):
        raise ValueError("reram_matmul_int_cuda needs contiguous tensors")
    if max(m * k, n_planes * k * n, m * n) >= 2 ** 31:
        raise ValueError("reram_matmul_int_cuda indexes rows with 32-bit "
                         "ints; the tensors are too large")
    out = torch.empty((m, n), dtype=torch.int32, device=x_int.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x_int.device):
        err = _lib().reram_matmul_int(
            x_int.data_ptr(), planes.data_ptr(), out.data_ptr(), m, k, n,
            n_planes, cell_bits, weight_bits, _build.stream_of(x_int))
    if err:
        raise RuntimeError(f"reram_matmul_int launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["reram_matmul_int"] += 1
    return out


def reram_matmul_int(x_int, planes, *, cell_bits: int = 2,
                     weight_bits: int = 8):
    """``x_int`` ``(M, K)`` integer activations times ``planes``
    ``(P, K, N)`` int8 offset-binary cell planes (LSB first) -> int32
    ``(M, N)`` equal to ``x_int @ (combine(planes) - 2**(weight_bits-1))``.
    """
    if _build.runs_plain(x_int, planes):
        return ref_reram_matmul_int(x_int, planes, cell_bits, weight_bits)
    return reram_matmul_int_cuda(x_int, planes, cell_bits=cell_bits,
                                 weight_bits=weight_bits)
