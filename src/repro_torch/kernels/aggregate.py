"""K4/K5: index-driven neighbor gather + difference (``csrc/aggregate.cu``).

The aggregation step of PointNet++ — for output point i with neighbors j:
``D(F_i, F_j) = F[nbr[i, j]] - F[ctr[i]]`` — is the irregular access
pattern the paper's reordering optimizes. Planned execution hands these
wrappers its indices in plan order.

Replaces the TPU kernels ``repro/kernels/aggregate.py::_kernel_batched``
(K4, :func:`aggregate_diff_batched`) and ``::_kernel`` (K5,
:func:`aggregate_diff`); one CUDA kernel serves both, K5 as batch 1. See
the source note in ``csrc/aggregate.cu`` for its bound and design.

On CPU tensors the wrappers run the plain torch version; on CUDA tensors
they launch the kernel (or raise). ``LAUNCHES`` counts kernel launches per
wrapper: :func:`aggregate_diff_cuda` adds one to the wrapper's counter
after a launch that returned no error, and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["LAUNCHES", "aggregate_diff", "aggregate_diff_batched",
           "aggregate_diff_batched_plain", "aggregate_diff_cuda",
           "aggregate_diff_plain"]

#: Kernel launches by wrapper (plain-version calls never count).
LAUNCHES = {"aggregate_diff": 0, "aggregate_diff_batched": 0}

#: Grid sizing: a block walks about this many output floats, and the
#: wrapper halves the centers per block until the grid covers the card.
_BLOCK_FLOATS = 2048
_MIN_BLOCKS = 2 * 132


def aggregate_diff_plain(features, nbr_idx, ctr_idx):
    """(N, C), (M, K), (M,) -> (M, K, C)."""
    return features[nbr_idx.long()] - features[ctr_idx.long()][:, None, :]


def aggregate_diff_batched_plain(features, nbr_idx, ctr_idx):
    """(B, N, C), (B, M, K), (B, M) -> (B, M, K, C)."""
    b = torch.arange(features.shape[0], device=features.device)
    f_nbr = features[b[:, None, None], nbr_idx.long()]
    f_ctr = features[b[:, None], ctr_idx.long()]
    return f_nbr - f_ctr[:, :, None, :]


def _lib():
    lib = _build.library("aggregate")
    fn = lib.aggregate_diff
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
    return lib


def centers_per_block(batch: int, m: int, k: int, c: int) -> int:
    cpb = max(1, min(m, _BLOCK_FLOATS // max(1, k * c)))
    while cpb > 1 and batch * -(-m // cpb) < _MIN_BLOCKS:
        cpb //= 2
    return cpb


def aggregate_diff_cuda(features, nbr_idx, ctr_idx, *,
                        counter: str = "aggregate_diff_batched"):
    """Launch the kernel on batched CUDA tensors: float32 ``(B, N, C)``,
    int32 ``(B, M, K)`` and ``(B, M)``, all contiguous on one device. A
    launch adds one to ``LAUNCHES[counter]``; an empty output launches
    nothing."""
    if counter not in LAUNCHES:
        raise ValueError(f"unknown launch counter {counter!r}")
    b, n, c = features.shape
    _, m, k = nbr_idx.shape
    if features.dtype != torch.float32:
        raise TypeError(f"features must be float32; got {features.dtype}")
    if nbr_idx.dtype != torch.int32 or ctr_idx.dtype != torch.int32:
        raise TypeError(f"indices must be int32; got {nbr_idx.dtype}, "
                        f"{ctr_idx.dtype}")
    for t in (features, nbr_idx, ctr_idx):
        if not t.is_contiguous():
            raise ValueError("aggregate_diff_cuda needs contiguous tensors")
    if max(b * n * c, b * m * k * c) >= 2 ** 31:
        raise ValueError("aggregate_diff_cuda indexes with 32-bit ints; "
                         "the tensors are too large")
    out = torch.empty((b, m, k, c), dtype=torch.float32,
                      device=features.device)
    if out.numel() == 0:
        return out
    cpb = centers_per_block(b, m, k, c)
    with torch.cuda.device(features.device):
        err = _lib().aggregate_diff(
            features.data_ptr(), nbr_idx.data_ptr(), ctr_idx.data_ptr(),
            out.data_ptr(), b, n, m, k, c, cpb, _build.stream_of(features))
    if err:
        raise RuntimeError(f"aggregate_diff kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES[counter] += 1
    return out


def aggregate_diff(features, nbr_idx, ctr_idx):
    """features (N, C); nbr_idx (M, K); ctr_idx (M,) -> (M, K, C) with
    ``out[i, j] = features[nbr_idx[i, j]] - features[ctr_idx[i]]``."""
    if features.ndim != 2 or nbr_idx.ndim != 2 or ctr_idx.shape != (
            nbr_idx.shape[0],):
        raise ValueError(f"shape mismatch: features {tuple(features.shape)}, "
                         f"nbr {tuple(nbr_idx.shape)}, "
                         f"ctr {tuple(ctr_idx.shape)}")
    if _build.runs_plain(features, nbr_idx, ctr_idx):
        return aggregate_diff_plain(features, nbr_idx, ctr_idx)
    out = aggregate_diff_cuda(features[None], nbr_idx[None], ctr_idx[None],
                              counter="aggregate_diff")
    return out[0]


def aggregate_diff_batched(features, nbr_idx, ctr_idx):
    """features (B, N, C); nbr_idx (B, M, K); ctr_idx (B, M) ->
    (B, M, K, C), the whole batch in one launch."""
    if (features.ndim != 3 or nbr_idx.ndim != 3
            or nbr_idx.shape[0] != features.shape[0]
            or ctr_idx.shape != nbr_idx.shape[:2]):
        raise ValueError(f"batch mismatch: features {tuple(features.shape)}, "
                         f"nbr {tuple(nbr_idx.shape)}, "
                         f"ctr {tuple(ctr_idx.shape)}")
    if _build.runs_plain(features, nbr_idx, ctr_idx):
        return aggregate_diff_batched_plain(features, nbr_idx, ctr_idx)
    return aggregate_diff_cuda(features, nbr_idx, ctr_idx,
                               counter="aggregate_diff_batched")
