"""P4: the backward of a row gather as a fixed-order segment sum
(``csrc/gather_backward.cu``), and :func:`gather_rows`, the gather whose
backward it is: PointNet++'s feature gathers, the LM's embedding lookup
and the MoE dispatch's gathers all take their rows through it.

The forward of :func:`gather_rows` takes rows ``x[l, idx[l, p]]``; its
gradient with respect to ``x`` gives row ``n`` of
batch row ``l`` the sum of the upstream gradient rows at the positions
``p`` with ``idx[l, p] == n``. Autograd's own backward for the gather is a
scatter-add, whose order of summation on the card is not fixed, so two
runs of the same training steps part after the first. Here each row's sum
is taken left to right in increasing ``p``, starting from ``0.0``: the
order of the CPU's sequential scatter-add, so on the CPU this gradient
equals autograd's bit for bit, and on the card it is the same every run.

The algorithm: a stable sort of the flat keys ``l * n_rows + idx[l, p]``
gives the positions grouped by output row and, within a row, in increasing
``p`` (:func:`segments`); a search of the sorted keys gives each row's
segment. Then one sum per (row, channel) over its segment, in order: the
kernel on the card (one thread an output), the plain version
(:func:`gather_rows_backward_plain`, one vectorized step per segment
depth) on the CPU. No replaced ``pallas_call``: the port's own kernel,
as P1 and P2 are. See the source note for its bound.

On CPU tensors :func:`gather_rows_backward` runs the plain version; on
CUDA tensors it launches the kernel (or raises). ``LAUNCHES`` counts the
kernel's launches: :func:`gather_rows_backward_cuda` adds one after a
launch that returned no error, and nowhere else.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .record import launch_site

__all__ = ["LAUNCHES", "gather_rows", "gather_rows_backward",
           "gather_rows_backward_cuda", "gather_rows_backward_plain",
           "segments"]

#: Kernel launches (plain-version calls never count).
LAUNCHES = {"gather_rows_backward": 0}


def segments(idx: torch.Tensor, n_rows: int):
    """The summation order of ``idx`` ``(L, P)`` (row indices into
    ``n_rows`` rows a batch row): ``perm`` ``(L * P,)`` int64, the flat
    positions ordered by output row ``l * n_rows + idx[l, p]`` and, within
    a row, by position; and ``starts`` ``(L * n_rows + 1,)`` int64, output
    row ``r``'s positions being ``perm[starts[r]:starts[r + 1]]``. Torch
    ops only, no host read (a ``bincount`` on the card reads its maximum
    back), so the backward can be captured."""
    lead = idx.shape[0]
    rows = torch.arange(lead, dtype=torch.int64, device=idx.device)
    keys = (idx.long() + rows[:, None] * n_rows).reshape(-1)
    ordered, perm = torch.sort(keys, stable=True)
    bounds = torch.arange(lead * n_rows + 1, dtype=torch.int64,
                          device=idx.device)
    return perm, torch.searchsorted(ordered, bounds)


def gather_rows_backward_plain(grad, perm, starts):
    """``grad`` ``(P, C)``, :func:`segments`' ``perm`` and ``starts`` ->
    ``(R, C)``, ``R = starts.numel() - 1``: each output row the sum of its
    segment's gradient rows, added in segment order from ``0.0``. One
    vectorized step per depth: at step ``j`` every row with more than ``j``
    positions adds its ``j``-th (the rows taking part, each once, are
    found on the host: the work is the positions', not rows x depth)."""
    counts = starts[1:] - starts[:-1]
    out = torch.zeros((counts.numel(), grad.shape[1]), dtype=grad.dtype,
                      device=grad.device)
    depth = int(counts.max()) if counts.numel() else 0
    for j in range(depth):
        rows = torch.nonzero(counts > j).squeeze(1)
        out[rows] = out[rows] + grad[perm[starts[rows] + j]]
    return out


@functools.cache
def _launch():
    """The kernel's C entry, typed (:func:`_build.bind`)."""
    return _build.bind(_build.library("gather_backward"),
                       "gather_rows_backward", 4, 3)


def gather_rows_backward_cuda(grad, perm, starts):
    """Launch the kernel on CUDA tensors: ``grad`` float32 ``(P, C)``,
    ``perm`` int64 ``(P,)``, ``starts`` int64 ``(R + 1,)``, all contiguous
    -> float32 ``(R, C)``. A launch adds one to ``LAUNCHES``; an empty
    output launches nothing."""
    if grad.dtype != torch.float32:
        raise TypeError(f"the gradient must be float32; got {grad.dtype}")
    if perm.dtype != torch.int64 or starts.dtype != torch.int64:
        raise TypeError(f"perm and starts must be int64; got {perm.dtype}, "
                        f"{starts.dtype}")
    if grad.ndim != 2 or perm.shape != (grad.shape[0],) or starts.ndim != 1:
        raise ValueError(f"shape mismatch: grad {tuple(grad.shape)}, perm "
                         f"{tuple(perm.shape)}, starts {tuple(starts.shape)}")
    if not (grad.is_contiguous() and perm.is_contiguous()
            and starts.is_contiguous()):
        raise ValueError("gather_rows_backward_cuda needs contiguous inputs")
    positions, c = grad.shape
    rows = starts.numel() - 1
    if max(rows, positions) * c >= 2 ** 31:
        raise ValueError("gather_rows_backward_cuda indexes with 32-bit "
                         "ints; the tensors are too large")
    out = torch.empty((rows, c), dtype=torch.float32, device=grad.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(grad.device):
        err = _launch()(grad.data_ptr(), perm.data_ptr(), starts.data_ptr(),
                        out.data_ptr(), rows, c, positions,
                        _build.stream_of(grad))
    if err:
        raise RuntimeError(f"gather_rows_backward kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES["gather_rows_backward"] += 1
    return out


@launch_site("gather_rows_backward")
def gather_rows_backward(grad, idx, n_rows: int):
    """The gradient of ``x`` ``(…, n_rows, C)`` for ``out = x[..., idx, :]``
    (``idx`` ``(…, P)``, the same leading dimensions), given ``grad`` of
    ``out`` ``(…, P, C)`` -> ``(…, n_rows, C)``, each row summed in
    increasing position."""
    lead, c = grad.shape[:-2], grad.shape[-1]
    if idx.shape != grad.shape[:-1]:
        raise ValueError(f"shape mismatch: grad {tuple(grad.shape)}, idx "
                         f"{tuple(idx.shape)}")
    flat_idx = idx.reshape(math.prod(lead), -1)
    perm, starts = segments(flat_idx, n_rows)
    g = grad.reshape(-1, c).contiguous()
    if _build.runs_plain(g, perm, starts):
        out = gather_rows_backward_plain(g, perm, starts)
    else:
        out = gather_rows_backward_cuda(g, perm, starts)
    return out.reshape(*lead, n_rows, c)


class _GatherRows(torch.autograd.Function):
    """``take_along_dim`` rows forward; backward through P4
    (:func:`gather_rows_backward`), each source row's gradient summed in
    increasing position, where autograd's own backward (a scatter-add)
    sums on the card in an order that changes run to run. P4 sums in
    float32: a gradient of another dtype (bf16) is upcast, summed, and
    rounded once to ``x``'s dtype, where a scatter-add in bf16 rounds
    after every addition (a float64 one, on the CPU, sums in float64)."""

    @staticmethod
    def forward(ctx, x, flat):
        ctx.save_for_backward(flat)
        ctx.n_rows = x.shape[-2]
        return torch.take_along_dim(x, flat[..., None], dim=-2)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (flat,) = ctx.saved_tensors
        acc = torch.promote_types(grad.dtype, torch.float32)
        out = gather_rows_backward(grad.to(acc), flat, ctx.n_rows)
        return out.to(grad.dtype), None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, :]`` per batch row: x ``(…, N, C)``, idx ``(…, *S)``
    -> ``(…, *S, C)``; with ``x`` ``(N, C)`` any ``idx`` gives
    ``x[idx]``. Its gradient with respect to ``x`` is summed in a fixed
    order (:class:`_GatherRows`), so training is reproducible on the card;
    the values are ``take_along_dim``'s."""
    lead = x.shape[:-2]
    flat = idx.reshape(*lead, -1).long()
    out = _GatherRows.apply(x, flat)
    return out.reshape(*idx.shape, x.shape[-1])
