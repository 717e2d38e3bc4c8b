"""K6: the bit-sliced INT8 crossbar matmul (``csrc/reram_mlp.cu``).

Replaces the TPU kernel ``repro/kernels/reram_mlp.py::_kernel``
(``reram_matmul_int``): int8 activations ``(M, K)`` times 8-bit weights
held as four 2-bit offset-binary cell planes ``(P, K, N)``, exactly, in
int32 — ``x @ (combine(planes) - 2^(weight_bits - 1))``. It is the matmul
of the per-layer 'reram' backend (:func:`~.ops.reram_linear`).

One call is one C call with two launches: the s8 pre-pass, which combines
the planes once into ``w_s8[n][k] = combine_planes(planes)[k][n]`` in a
scratch buffer (row pitch K rounded up to 16), and the product on the
H100's tensor cores (``mma.sync`` s8 x s8 -> s32), written as int32 from
the accumulators. Where the row tiles and column chunks alone would leave
most SMs idle (the head's 8 or 1 rows), or K is wider than one stripe,
:func:`~.program.plan_reram` splits K over blocks that add their partial
sums with int32 atomics (exact in any order). On the H100 it is bound by
the bytes of its int32 output.

The JAX package pads M, K and N to multiples of 128 for its block specs;
the integers are the same without, so neither the kernel nor the plain
version (:func:`~.ref.ref_reram_matmul_int`) pads. On CPU tensors the
wrapper runs the plain version; on CUDA tensors it launches the kernel (or
raises). ``LAUNCHES["reram_matmul_int"]`` counts the products,
``LAUNCHES["reram_combine"]`` the pre-pass's launches (one per product, or
one per :func:`reram_combine_cuda` call).
"""
from __future__ import annotations

import functools

import torch

from . import _build
from .program import (BLOCK_M, MMA_BLOCK_K, MMA_BLOCK_N, MMA_STRIPE_K,
                      plan_reram)
from .ref import combine_planes, ref_reram_matmul_int

__all__ = ["LAUNCHES", "reram_combine_cuda", "reram_combine_plain",
           "reram_matmul_int", "reram_matmul_int_cuda"]

#: Kernel launches (plain runs never count).
LAUNCHES = {"reram_matmul_int": 0, "reram_combine": 0}

#: C functions of ``csrc/reram_mlp.cu``: name -> (pointer args, int args),
#: each followed by the stream.
_FUNCTIONS = {"reram_matmul_int": (4, 7), "reram_combine": (2, 5)}


@functools.cache
def _lib():
    lib = _build.library("reram_mlp")
    for fn, (n_ptrs, n_ints) in _FUNCTIONS.items():
        _build.bind(lib, fn, n_ptrs, n_ints)
    tiles = tuple(_build.int_fn(lib, "reram_mlp_tile")(i) for i in range(4))
    want = (BLOCK_M, MMA_BLOCK_N, MMA_BLOCK_K, MMA_STRIPE_K)
    if tiles != want:
        raise RuntimeError(f"reram_mlp.cu tiles {tiles} disagree with "
                           f"program.py's {want}")
    return lib


def _k_pad(k: int) -> int:
    return -(-k // 16) * 16


def _check_planes(planes, cell_bits: int, weight_bits: int) -> None:
    n_planes = planes.shape[0]
    if planes.dtype != torch.int8 or planes.dim() != 3:
        raise TypeError(f"need int8 (P, K, N) planes; got {planes.dtype} "
                        f"{tuple(planes.shape)}")
    if n_planes * cell_bits > 8 or weight_bits > 8:
        raise ValueError(f"{n_planes} planes of {cell_bits} bits do not fit "
                         f"the kernel's s8 weights")
    if not planes.is_contiguous():
        raise ValueError("K6 needs contiguous planes")


def reram_combine_plain(planes, cell_bits: int = 2, weight_bits: int = 8):
    """The pre-pass's plain version: ``(P, K, N)`` planes -> the s8
    weights transposed, int8 ``(N, K)``."""
    return combine_planes(planes, cell_bits, weight_bits).to(torch.int8).T


def reram_combine_cuda(planes, *, cell_bits: int = 2, weight_bits: int = 8):
    """The pre-pass alone, one launch (K6 launches it itself): int8 ``(P,
    K, N)`` planes on a CUDA device -> int8 ``(N, K)``, a view of the
    kernel's ``(N, K rounded up to 16)`` buffer."""
    _check_planes(planes, cell_bits, weight_bits)
    n_planes, k, n = planes.shape
    wt = torch.empty((n, _k_pad(k)), dtype=torch.int8, device=planes.device)
    if wt.numel() == 0:
        return wt[:, :k]
    with torch.cuda.device(planes.device):
        err = _lib().reram_combine(planes.data_ptr(), wt.data_ptr(), k, n,
                                   n_planes, cell_bits, weight_bits,
                                   _build.stream_of(planes))
    if err:
        raise RuntimeError(f"reram_combine launch failed: CUDA error {err}")
    LAUNCHES["reram_combine"] += 1
    return wt[:, :k]


def reram_matmul_int_cuda(x_int, planes, *, cell_bits: int = 2,
                          weight_bits: int = 8):
    """Launch the kernel: int8 ``(M, K)`` and int8 ``(P, K, N)``, contiguous
    on one CUDA device -> int32 ``(M, N)``."""
    m, k = x_int.shape
    n_planes, k2, n = planes.shape
    if x_int.dtype != torch.int8:
        raise TypeError(f"need int8 activations; got {x_int.dtype}")
    _check_planes(planes, cell_bits, weight_bits)
    if k2 != k:
        raise ValueError(f"activations {tuple(x_int.shape)} do not match "
                         f"planes {tuple(planes.shape)}")
    if not x_int.is_contiguous():
        raise ValueError("reram_matmul_int_cuda needs contiguous tensors")
    if max(m * k, n_planes * k * n, m * n) >= 2 ** 31 or -(-m // BLOCK_M) \
            > 65535:
        raise ValueError("reram_matmul_int_cuda indexes rows with 32-bit "
                         "ints; the tensors are too large")
    out = torch.empty((m, n), dtype=torch.int32, device=x_int.device)
    if out.numel() == 0:
        return out
    if k == 0:
        raise ValueError("reram_matmul_int_cuda needs K >= 1")
    split = plan_reram(m, k, n, _build.sm_count(x_int))
    wt = torch.empty((n, split.k_pad), dtype=torch.int8, device=x_int.device)
    with torch.cuda.device(x_int.device):
        err = _lib().reram_matmul_int(
            x_int.data_ptr(), planes.data_ptr(), wt.data_ptr(),
            out.data_ptr(), m, k, n, n_planes, cell_bits, weight_bits,
            split.k_step, _build.stream_of(x_int))
    if err:
        raise RuntimeError(f"reram_matmul_int launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["reram_combine"] += 1
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
