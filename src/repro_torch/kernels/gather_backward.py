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
``p``, and each row's segment of them (:func:`segments`: ``perm`` and
``starts``). Then one sum per (row, channel) over its segment, in order.
On the card both stages are hand-written (the source note says what bounds
each): where a batch row's rows and positions fit in shared memory
(:func:`fused_fits`: PointNet++'s SA gathers, the MoE dispatch) one launch
sorts and sums (:func:`gather_rows_backward_fused_cuda`); elsewhere (the
LM embedding) a stable radix sort and a boundary pass on the card
(:func:`segments_cuda`), then the segment sum
(:func:`gather_rows_backward_cuda`), which keeps 16 gradient-row loads in
flight a warp. No ``torch.sort``, ``searchsorted`` or ``arange`` runs on
the card's path. On the CPU, :func:`segments` (torch's stable sort and a
search) and :func:`gather_rows_backward_plain` (one vectorized step per
segment depth) are the plain versions. No replaced ``pallas_call``: the
port's own kernel, as P1 and P2 are.

On CPU tensors :func:`gather_rows_backward` runs the plain versions; on
CUDA tensors it launches the kernels (or raises); on ``meta`` tensors
(shapes only: the dry run, ``launch/dryrun.py``) it gives an empty tensor
of the result's shape and dtype, as the plain version would, which reads
the segments' depth on the host. ``LAUNCHES`` counts the kernels'
launches, each where a launch returned no error and nowhere else:
``gather_rows_backward`` one per sum (fused or not: one per backward),
and the radix sort's ``segments_count`` and ``segments_scatter`` (one each
a pass) and ``segments_bounds``. Scratch memory depends on the shapes alone and no
call reads the card back, so a backward captures into a CUDA graph.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .record import launch_site

__all__ = ["FUSED_MAX_POSITIONS", "FUSED_MAX_ROWS", "LAUNCHES", "fused_fits",
           "gather_rows", "gather_rows_backward",
           "gather_rows_backward_cuda", "gather_rows_backward_fused_cuda",
           "gather_rows_backward_plain", "segments", "segments_cuda"]

#: Kernel launches (plain-version calls never count).
LAUNCHES = {"gather_rows_backward": 0, "segments_count": 0,
            "segments_scatter": 0, "segments_bounds": 0}

#: The fused path's limits (``kFusedMaxRows``, ``kFusedMaxPositions`` in
#: the source): a batch row of at most this many rows and positions is
#: sorted in shared memory and summed in the same launch.
FUSED_MAX_ROWS = 4096
FUSED_MAX_POSITIONS = 4096


def fused_fits(batch: int, positions: int, n_rows: int) -> bool:
    """Whether ``batch`` batch rows of ``positions`` indices into
    ``n_rows`` rows take the fused launch (else the radix sort)."""
    return (batch >= 1 and 1 <= n_rows <= FUSED_MAX_ROWS
            and 0 <= positions <= FUSED_MAX_POSITIONS)


def segments(idx: torch.Tensor, n_rows: int):
    """The summation order of ``idx`` ``(L, P)`` (row indices into
    ``n_rows`` rows a batch row): ``perm`` ``(L * P,)`` int64, the flat
    positions ordered by output row ``l * n_rows + idx[l, p]`` and, within
    a row, by position; and ``starts`` ``(L * n_rows + 1,)`` int64, output
    row ``r``'s positions being ``perm[starts[r]:starts[r + 1]]``. Torch
    ops only, no host read: the plain version of :func:`segments_cuda`."""
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


#: The C entries, typed: (name, restype, argument types). ``int``
#: entries return the launch's ``cudaError_t``; the plan's two functions
#: give the radix sort's passes and int32 scratch words for ``n`` keys
#: below ``k``.
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ENTRIES = {
    "gather_rows_backward": (_I, [_P] * 4 + [_I] * 3 + [_P]),
    "gather_rows_backward_fused": (_I, [_P] * 3 + [_I] * 4 + [_P]),
    "gather_rows_segments": (_I, [_P] * 4 + [_I] * 3 + [_L, _P]),
    "gather_rows_radix_passes": (_I, [_I, _I]),
    "gather_rows_radix_words": (_L, [_I, _I]),
}


@functools.cache
def _entries() -> dict:
    """The library's C entries, typed as :data:`_ENTRIES` says (pointers
    and the stream ``c_void_p``, or ctypes passes them as 32-bit ints)."""
    lib = _build.library("gather_backward")
    out = {}
    for name, (res, args) in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
        out[name] = fn
    return out


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _check_idx(idx: torch.Tensor) -> None:
    if idx.dtype != torch.int64 or idx.ndim != 2:
        raise TypeError(f"idx must be int64 (L, P); got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if not idx.is_contiguous():
        raise ValueError("idx must be contiguous")


def segments_cuda(idx: torch.Tensor, n_rows: int):
    """:func:`segments` on the card, ``torch.equal`` to it, at any size:
    the radix sort (two launches a pass) and the boundary pass. ``idx``
    int64 ``(L, P)``, contiguous."""
    _check_idx(idx)
    lead, positions = idx.shape
    n, k = lead * positions, lead * n_rows
    if n >= 2 ** 31 or k >= 2 ** 31:
        raise ValueError("segments_cuda sorts 32-bit keys; the tensors are "
                         "too large")
    if n and n_rows < 1:
        raise ValueError("indices into no rows")
    perm = torch.empty(n, dtype=torch.int64, device=idx.device)
    starts = torch.empty(k + 1, dtype=torch.int64, device=idx.device)
    fns, stream = _entries(), _build.stream_of(idx)
    with torch.cuda.device(idx.device):
        passes = fns["gather_rows_radix_passes"](n, k) if n else 0
        words = fns["gather_rows_radix_words"](n, k)
        scratch = torch.empty(words, dtype=torch.int32, device=idx.device)
        _raise_on(fns["gather_rows_segments"](
            idx.data_ptr(), perm.data_ptr(), starts.data_ptr(),
            scratch.data_ptr(), lead, positions, n_rows, words, stream),
            "segments radix sort")
    LAUNCHES["segments_count"] += passes
    LAUNCHES["segments_scatter"] += passes
    LAUNCHES["segments_bounds"] += 1
    return perm, starts


def _check_grad(grad: torch.Tensor) -> None:
    if grad.dtype != torch.float32:
        raise TypeError(f"the gradient must be float32; got {grad.dtype}")
    if grad.ndim != 2 or not grad.is_contiguous():
        raise ValueError(f"the gradient must be a contiguous (P, C) "
                         f"tensor; got {tuple(grad.shape)}")


def gather_rows_backward_cuda(grad, perm, starts):
    """Launch the segment sum on CUDA tensors: ``grad`` float32 ``(P, C)``,
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
        err = _entries()["gather_rows_backward"](
            grad.data_ptr(), perm.data_ptr(), starts.data_ptr(),
            out.data_ptr(), rows, c, positions, _build.stream_of(grad))
    _raise_on(err, "gather_rows_backward")
    LAUNCHES["gather_rows_backward"] += 1
    return out


def gather_rows_backward_fused_cuda(grad, idx, n_rows: int):
    """The fused launch on CUDA tensors: ``grad`` float32 ``(L * P, C)``
    and ``idx`` int64 ``(L, P)``, contiguous, with :func:`fused_fits` ->
    float32 ``(L * n_rows, C)``, sorted and summed in one launch. A launch
    adds one to ``LAUNCHES["gather_rows_backward"]``; an empty output
    launches nothing."""
    _check_grad(grad)
    _check_idx(idx)
    lead, positions = idx.shape
    if grad.shape[0] != lead * positions:
        raise ValueError(f"shape mismatch: grad {tuple(grad.shape)}, idx "
                         f"{tuple(idx.shape)}")
    return _fused(grad, idx, lead, positions, n_rows,
                  (lead * n_rows, grad.shape[1]))


def _fused(grad, idx, lead: int, positions: int, n_rows: int, shape):
    """The fused launch on checked operands (float32 ``grad`` of ``lead *
    positions`` rows, int64 ``idx``, both contiguous), into a new tensor
    of ``shape`` (``lead * n_rows`` rows of ``C``, any leading dims)."""
    c = shape[-1]
    if not fused_fits(lead, positions, n_rows):
        raise ValueError(f"{lead} x {positions} indices into {n_rows} rows "
                         f"do not fit the fused launch")
    if max(n_rows, positions) * lead * c >= 2 ** 31:
        raise ValueError("gather_rows_backward_fused_cuda indexes with "
                         "32-bit ints; the tensors are too large")
    out = torch.empty(shape, dtype=torch.float32, device=grad.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(grad.device):
        err = _entries()["gather_rows_backward_fused"](
            grad.data_ptr(), idx.data_ptr(), out.data_ptr(), lead,
            positions, n_rows, c, _build.stream_of(grad))
    _raise_on(err, "gather_rows_backward_fused")
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
    if grad.device.type == "meta":
        # the meta rule: the result's shape and dtype (no launch, no data)
        return grad.new_empty((*lead, n_rows, c))
    batch = lead.numel()
    if _build.runs_plain(grad, idx):
        flat_idx = idx.reshape(batch, -1).long()
        perm, starts = segments(flat_idx, n_rows)
        out = gather_rows_backward_plain(grad.reshape(-1, c), perm, starts)
        return out.reshape(*lead, n_rows, c)
    positions = grad.shape[-2]
    if grad.dtype != torch.float32:
        raise TypeError(f"the gradient must be float32; got {grad.dtype}")
    grad, idx = grad.contiguous(), idx.long().contiguous()
    if fused_fits(batch, positions, n_rows):
        # no views: the launch reads the operands' storage and writes
        # the output in its final shape (host time is most of its call)
        return _fused(grad, idx, batch, positions, n_rows, (*lead, n_rows, c))
    perm, starts = segments_cuda(idx.view(batch, positions), n_rows)
    out = gather_rows_backward_cuda(grad.view(-1, c), perm, starts)
    return out.view(*lead, n_rows, c)


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
