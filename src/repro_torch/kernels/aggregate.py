"""K4/K5: index-driven neighbor gather + difference (``csrc/aggregate.cu``).

The aggregation step of PointNet++ — for output point i with neighbors j:
``D(F_i, F_j) = F[nbr[i, j]] - F[ctr[i]]`` — is the irregular access
pattern the paper's reordering optimizes. Planned execution runs it in
plan order: given ``order``, row i of the output is centre ``order[i]``'s,
``F[nbr[order[i], j]] - F[ctr[order[i]]]``, and the indices stay in index
order (the geometry's own kNN and FPS outputs, int64 or int32); the kernel
composes the two itself. Without ``order`` the indices are taken as they
are.

Replaces the TPU kernels ``repro/kernels/aggregate.py::_kernel_batched``
(K4, :func:`aggregate_diff_batched`) and ``::_kernel`` (K5,
:func:`aggregate_diff`); one CUDA kernel serves both, K5 as batch 1. See
the source note in ``csrc/aggregate.cu`` for its bound and design.

On CPU tensors the wrappers run the plain torch version (the indices
permuted by ``order`` first); on CUDA tensors they launch the kernel (or
raise). ``LAUNCHES`` counts kernel launches per wrapper:
:func:`aggregate_diff_cuda` adds one to the wrapper's counter after a
launch that returned no error, and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .record import launch_site

__all__ = ["LAUNCHES", "aggregate_diff", "aggregate_diff_batched",
           "aggregate_diff_batched_plain", "aggregate_diff_cuda",
           "aggregate_diff_plain", "gather_launch", "plan_ordered"]

#: Kernel launches by wrapper (plain-version calls never count).
LAUNCHES = {"aggregate_diff": 0, "aggregate_diff_batched": 0}

#: Threads of a block (``kThreads`` in ``csrc/aggregate.cu``).
GATHER_THREADS = 256


def aggregate_diff_plain(features, nbr_idx, ctr_idx):
    """(N, C), (M, K), (M,) -> (M, K, C)."""
    return features[nbr_idx.long()] - features[ctr_idx.long()][:, None, :]


def aggregate_diff_batched_plain(features, nbr_idx, ctr_idx):
    """(B, N, C), (B, M, K), (B, M) -> (B, M, K, C)."""
    b = torch.arange(features.shape[0], device=features.device)
    f_nbr = features[b[:, None, None], nbr_idx.long()]
    f_ctr = features[b[:, None], ctr_idx.long()]
    return f_nbr - f_ctr[:, :, None, :]


def _bind(lib):
    """Type ``lib.aggregate_diff`` (:func:`_lib`'s library, or a stand-in
    in the tests)."""
    f = lib.aggregate_diff
    f.restype = ctypes.c_int
    # feats, nbr, ctr, order, out; batch, n, m, k, c; the nbr, ctr and
    # order strides; idx64, vec, blocks; the stream
    f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                  + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p])
    return lib


@functools.cache
def _lib():
    return _bind(_build.library("aggregate"))


def gather_launch(m: int, k: int, c: int,
                  aligned: bool = True) -> tuple[int, int]:
    """The kernel's launch for ``m`` centres of ``k`` rows of ``c`` floats:
    ``(vec, blocks)``, ``vec`` the floats a thread writes (4 when ``c`` is
    a multiple of 4 and the rows are 16-byte ``aligned``, else 1) and
    ``blocks`` the blocks a cloud, one thread a ``vec``-float chunk of an
    output row (the grid is ``(blocks, batch)``)."""
    vec = 4 if c % 4 == 0 and aligned else 1
    return vec, -(-m * k * (c // vec) // GATHER_THREADS)


def plan_ordered(nbr_idx, ctr_idx, order):
    """The indices in plan order: ``nbr_idx[..., order, :]`` and
    ``ctr_idx[..., order]`` (``order`` ``(M,)`` or ``(B, M)``)."""
    o = order.long()
    if nbr_idx.ndim == 3 and o.ndim == 1:
        o = o.expand(nbr_idx.shape[0], -1)
    if nbr_idx.ndim == 2:
        return nbr_idx[o], ctr_idx[o]
    return (torch.take_along_dim(nbr_idx, o[:, :, None], dim=1),
            torch.take_along_dim(ctr_idx, o, dim=1))


def aggregate_diff_cuda(features, nbr_idx, ctr_idx, order=None, *,
                        counter: str = "aggregate_diff_batched"):
    """Launch the kernel on batched CUDA tensors: float32 ``(B, N, C)``
    contiguous; int64 or int32 ``(B, M, K)`` and ``(B, M)`` of one type
    (unit stride along K and M); ``order`` int32 ``(B, M)`` or ``(M,)`` (one
    order batch-wide; unit stride along M), or None. A launch adds one to
    ``LAUNCHES[counter]``; an empty output launches nothing."""
    if counter not in LAUNCHES:
        raise ValueError(f"unknown launch counter {counter!r}")
    b, n, c = features.shape
    _, m, k = nbr_idx.shape
    if features.dtype != torch.float32:
        raise TypeError(f"features must be float32; got {features.dtype}")
    if nbr_idx.dtype != ctr_idx.dtype or nbr_idx.dtype not in (
            torch.int32, torch.int64):
        raise TypeError(f"indices must be int32 or int64, both alike; got "
                        f"{nbr_idx.dtype}, {ctr_idx.dtype}")
    if order is not None and order.dtype != torch.int32:
        raise TypeError(f"the order must be int32; got {order.dtype}")
    if not features.is_contiguous():
        raise ValueError("aggregate_diff_cuda needs contiguous features")
    if (nbr_idx.stride(2) != 1 and k > 1) or (m > 1 and (
            ctr_idx.stride(1) != 1
            or (order is not None and order.stride(-1) != 1))):
        raise ValueError("aggregate_diff_cuda needs unit stride along K, "
                         "the centres and the order")
    if max(b * n * c, m * k * c) >= 2 ** 31 or b > 65535:
        raise ValueError("aggregate_diff_cuda indexes with 32-bit ints; "
                         "the tensors are too large")
    out = torch.empty((b, m, k, c), dtype=torch.float32,
                      device=features.device)
    if out.numel() == 0:
        return out
    if n == 0:
        raise ValueError("aggregate_diff_cuda: the features have no rows")
    order_bs = 0 if order is None or order.ndim == 1 else order.stride(0)
    vec, blocks = gather_launch(m, k, c, aligned=(
        features.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0))
    with torch.cuda.device(features.device):
        err = _lib().aggregate_diff(
            features.data_ptr(), nbr_idx.data_ptr(), ctr_idx.data_ptr(),
            None if order is None else order.data_ptr(), out.data_ptr(),
            b, n, m, k, c, nbr_idx.stride(0), nbr_idx.stride(1),
            ctr_idx.stride(0), order_bs,
            int(nbr_idx.dtype == torch.int64), vec, blocks,
            _build.stream_of(features))
    if err:
        raise RuntimeError(f"aggregate_diff kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES[counter] += 1
    return out


def _check_order(order, m: int, batch: int | None) -> None:
    if order is None:
        return
    ok = order.shape == (m,) or (batch is not None
                                 and order.shape == (batch, m))
    if not ok:
        raise ValueError(f"order {tuple(order.shape)} does not match "
                         f"{m} centers")


@launch_site("aggregate_diff")
def aggregate_diff(features, nbr_idx, ctr_idx, order=None):
    """features (N, C); nbr_idx (M, K); ctr_idx (M,); order (M,) or None
    -> (M, K, C) with ``out[i, j] = features[nbr_idx[o, j]] -
    features[ctr_idx[o]]``, ``o = order[i]`` (``i`` without an order)."""
    if features.ndim != 2 or nbr_idx.ndim != 2 or ctr_idx.shape != (
            nbr_idx.shape[0],):
        raise ValueError(f"shape mismatch: features {tuple(features.shape)}, "
                         f"nbr {tuple(nbr_idx.shape)}, "
                         f"ctr {tuple(ctr_idx.shape)}")
    _check_order(order, nbr_idx.shape[0], None)
    extra = () if order is None else (order,)
    if _build.runs_plain(features, nbr_idx, ctr_idx, *extra):
        if order is not None:
            nbr_idx, ctr_idx = plan_ordered(nbr_idx, ctr_idx, order)
        return aggregate_diff_plain(features, nbr_idx, ctr_idx)
    out = aggregate_diff_cuda(features[None], nbr_idx[None], ctr_idx[None],
                              order, counter="aggregate_diff")
    return out[0]


@launch_site("aggregate_diff_batched")
def aggregate_diff_batched(features, nbr_idx, ctr_idx, order=None):
    """features (B, N, C); nbr_idx (B, M, K); ctr_idx (B, M); order (B, M),
    (M,) or None -> (B, M, K, C), the whole batch in one launch."""
    if (features.ndim != 3 or nbr_idx.ndim != 3
            or nbr_idx.shape[0] != features.shape[0]
            or ctr_idx.shape != nbr_idx.shape[:2]):
        raise ValueError(f"batch mismatch: features {tuple(features.shape)}, "
                         f"nbr {tuple(nbr_idx.shape)}, "
                         f"ctr {tuple(ctr_idx.shape)}")
    _check_order(order, nbr_idx.shape[1], nbr_idx.shape[0])
    extra = () if order is None else (order,)
    if _build.runs_plain(features, nbr_idx, ctr_idx, *extra):
        if order is not None:
            nbr_idx, ctr_idx = plan_ordered(nbr_idx, ctr_idx, order)
        return aggregate_diff_batched_plain(features, nbr_idx, ctr_idx)
    return aggregate_diff_cuda(features, nbr_idx, ctr_idx, order,
                               counter="aggregate_diff_batched")
