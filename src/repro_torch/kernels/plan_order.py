"""P1/P2: the plan's greedy order and coordination walk (``csrc/plan.cu``).

The two loops of paper Algorithm 1 that build an execution plan on the
device. In the JAX package they are ``lax`` loops inside
``repro/core/schedule.py``, not Pallas kernels: ``device_order_greedy``
(a ``fori_loop`` of masked argmins, lines 1-8) and ``device_coordinate``
(a ``scan``/``cond`` walk of the receptive fields, lines 9-13). Here each
is one hand-written kernel launch for a whole batch of clouds:

- :func:`plan_greedy` (P1): points ``(B, n, 3)`` float32 -> int32
  ``(B, n)``, the greedy nearest-neighbour chain from row ``start``; one
  warp per cloud up to :data:`GREEDY_WARP_POINTS` points, one block past
  that, the points in registers, the ``n x n`` distance matrix never
  built;
- :func:`plan_coordinate` (P2): the last layer's order ``(B, n_L)`` and
  the receptive fields ``neighbors[k-1]`` ``(B, n_k, K_k)`` of layers
  k = 1..L -> per layer the completed int32 order ``(B, n_k)`` and its
  inverse; one block per cloud walks every layer in shared memory (in a
  device-memory workspace where the walk does not fit there).

The coordination walk is computed level by level, without recursion:
layer L's partial order is the first-occurrence order of the last-layer
order; layer k-1's is the first-occurrence order of the stream
``neighbors[k-1][o_k]`` flattened row-major, ``o_k`` layer k's partial
order. Points that never occur (orphans) then follow in ascending order.
This equals the reference's recursive walk (``coordinate_layers``): a
point runs at its first visit, a visited point is skipped and never walks
its own members again (held against the recursion in the tests).

On CPU tensors the wrappers run the plain torch versions
(:func:`plan_greedy_plain`, :func:`plan_coordinate_plain`); on CUDA
tensors they launch the kernels (or raise). ``LAUNCHES`` counts the
launches, one per call of a wrapper that reached its kernel.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from . import _build
from .record import launch_site

__all__ = ["GREEDY_MAX_POINTS", "GREEDY_PER_THREAD", "GREEDY_THREADS",
           "GREEDY_WARP_POINTS", "LAUNCHES", "coordinate_smem_bytes",
           "coordinate_workspace", "device_complete", "device_inverse",
           "greedy_launch", "plan_coordinate", "plan_coordinate_cuda",
           "plan_coordinate_plain", "plan_greedy", "plan_greedy_cuda",
           "plan_greedy_plain"]

#: Kernel launches (plain runs never count).
LAUNCHES = {"plan_greedy": 0, "plan_coordinate": 0}

#: The most points P1 holds in one block's registers (256 threads x 8):
#: the reference's dense-sweep limit (``GREEDY_DENSE_LIMIT``).
GREEDY_MAX_POINTS = 2048

#: P1's threads a block at most, and the points a thread may hold (the
#: kernels' instantiations in ``csrc/plan.cu``).
GREEDY_THREADS = 256
GREEDY_PER_THREAD = (1, 2, 4, 8)

#: The most points one warp runs a cloud of (32 lanes x 8 points): the
#: one-warp chain, with no barrier; past it a block of up to
#: :data:`GREEDY_THREADS` threads.
GREEDY_WARP_POINTS = 32 * GREEDY_PER_THREAD[-1]

#: The most layers one P2 launch walks.
COORD_MAX_LAYERS = 8

#: Shared memory a block may have on the H100, in bytes.
_MAX_SMEM_BYTES = 232448


def _bind(lib):
    """Type P1's and P2's entries in ``lib`` (:func:`_lib`'s library, or a
    stand-in in the tests)."""
    _build.bind(lib, "plan_greedy", 2, 5)
    # the last order, the output, a host array of the layers' neighbor
    # addresses, sizes, K and strides, the workspace; batch, layers, the
    # workspace's int32 a cloud
    _build.bind(lib, "plan_coordinate", 4, 3)
    return lib


def _on_device(t):
    """``torch.cuda.device`` of ``t``'s card where another card is
    current, else a context that does nothing (``torch.cuda.device`` itself
    is a large part of a P1 or P2 launch's host time)."""
    index = t.device.index
    if index is None or index == torch._C._cuda_getDevice():
        return contextlib.nullcontext()
    return torch.cuda.device(index)


@functools.cache
def _lib():
    return _bind(_build.library("plan"))


# ---------------------------------------------------------------------------
# P1: the greedy order
# ---------------------------------------------------------------------------

@functools.cache
def greedy_launch(n: int) -> tuple[int, int]:
    """P1's block for clouds of ``n`` points: ``(threads, points a
    thread)``. One warp (32 threads) up to :data:`GREEDY_WARP_POINTS`
    points; past that the fewest threads (a multiple of 32, at most
    :data:`GREEDY_THREADS`); then the fewest points a thread."""
    if not 1 <= n <= GREEDY_MAX_POINTS:
        raise ValueError(f"plan_greedy takes 1 to {GREEDY_MAX_POINTS} "
                         f"points a cloud; got {n}")
    threads = (32 if n <= GREEDY_WARP_POINTS
               else min(GREEDY_THREADS, -(-n // 32) * 32))
    per = next(p for p in GREEDY_PER_THREAD if threads * p >= n)
    return threads, per


def plan_greedy_plain(points, start: int = 0):
    """The plain loop: ``(B, n, d)`` -> int32 ``(B, n)``. Row ``cur`` of
    the squared-distance matrix is summed coordinate by coordinate, as the
    reference's matrix is; removed points count as ``+inf``; the argmin
    takes the first minimum, and a NaN distance before every number, as
    ``np.argmin`` does."""
    batch, n, dims = points.shape
    out = torch.empty((batch, n), dtype=torch.int32, device=points.device)
    if n == 0:
        return out
    rows = torch.arange(batch, device=points.device)
    remaining = torch.ones((batch, n), dtype=torch.bool,
                           device=points.device)
    cur = torch.full((batch,), int(start), dtype=torch.int64,
                     device=points.device)
    for i in range(n):
        out[:, i] = cur.to(torch.int32)
        remaining[rows, cur] = False
        if i == n - 1:
            break
        c = points[rows, cur][:, None, :]                # (B, 1, d)
        diff = c[..., 0] - points[..., 0]
        d = diff * diff
        for k in range(1, dims):
            diff = c[..., k] - points[..., k]
            d = d + diff * diff
        d = torch.where(remaining, d, float("inf"))
        d = torch.where(torch.isnan(d), -1.0, d)         # NaN first
        cur = torch.argmin(d, dim=1)
    return out


def plan_greedy_cuda(points, start: int = 0):
    """Launch P1 on float32 ``(B, n, 3)`` on a CUDA device -> int32
    ``(B, n)``: one block per cloud."""
    batch, n, dims = points.shape
    if points.dtype != torch.float32 or dims != 3:
        raise TypeError(f"plan_greedy wants float32 (B, n, 3) points on the "
                        f"card; got {points.dtype} {tuple(points.shape)}")
    if batch > 2 ** 31 - 1:
        raise ValueError("too many clouds for one launch")
    points = points.contiguous()
    out = torch.empty((batch, n), dtype=torch.int32, device=points.device)
    if out.numel() == 0:
        return out
    threads, per = greedy_launch(n)
    with _on_device(points):
        err = _lib().plan_greedy(points.data_ptr(), out.data_ptr(), batch, n,
                                 int(start), threads, per,
                                 _build.stream_of(points))
    if err:
        raise RuntimeError(f"plan_greedy launch failed: CUDA error {err}")
    LAUNCHES["plan_greedy"] += 1
    return out


@launch_site("plan_greedy")
def plan_greedy(points, start: int = 0):
    """The greedy nearest-neighbour order (paper Algorithm 1, lines 1-8) of
    each cloud of ``points`` ``(B, n, 3)`` from row ``start`` -> int32
    ``(B, n)``, at most :data:`GREEDY_MAX_POINTS` points a cloud."""
    if points.ndim != 3:
        raise ValueError(f"plan_greedy wants points (B, n, d); got "
                         f"{tuple(points.shape)}")
    n = points.shape[1]
    if n > GREEDY_MAX_POINTS:
        raise ValueError(f"plan_greedy is limited to n <= "
                         f"{GREEDY_MAX_POINTS}; got n={n}")
    if n and not 0 <= start < n:
        raise ValueError(f"start={start} must lie in [0, {n})")
    if _build.runs_plain(points):
        return plan_greedy_plain(points, start)
    return plan_greedy_cuda(points, start)


# ---------------------------------------------------------------------------
# P2: the coordination walk
# ---------------------------------------------------------------------------

def device_inverse(order):
    """``inv[..., order] = arange(n)`` over the last axis, int32."""
    n = order.shape[-1]
    ar = torch.arange(n, dtype=torch.int32, device=order.device)
    return torch.empty_like(order).scatter_(-1, order.long(),
                                            ar.expand_as(order))


def device_complete(order, ptr, done):
    """Complete partial orders ``(…, n)`` (their first ``ptr`` entries
    hold the walk's order) with the points not ``done``, ascending, in
    the slots from ``ptr`` on."""
    n = order.shape[-1]
    orphan = ~done
    step = orphan.to(torch.int64)
    offs = torch.cumsum(step, dim=-1) - step
    pos = torch.where(orphan, ptr[..., None].to(torch.int64) + offs, n)
    ar = torch.arange(n, dtype=order.dtype, device=order.device)
    out = torch.cat([order, order[..., :1]], dim=-1)     # slot n: dropped
    out.scatter_(-1, pos, ar.expand_as(order))
    return out[..., :n]


def _first_occurrence(stream, valid, n: int):
    """The completed order of ``n`` points by their first position in
    ``stream`` ``(B, S)`` (entries with ``valid`` False do not occur), as
    P2 builds it: first positions by a minimum, the first occurrences
    compacted in stream order by a scan, then the orphans. Returns
    ``(order, ptr)``, ``ptr`` ``(B,)`` the points that occur."""
    batch, s = stream.shape
    stream = stream.long()
    pos = torch.arange(s, device=stream.device).expand(batch, s)
    first = torch.full((batch, n), s, dtype=torch.int64,
                       device=stream.device)
    first.scatter_reduce_(1, stream, torch.where(valid, pos, s), "amin")
    is_first = valid & (first.gather(1, stream) == pos)
    step = is_first.to(torch.int64)
    slot = torch.where(is_first, torch.cumsum(step, dim=1) - step, n)
    partial = torch.zeros((batch, n + 1), dtype=torch.int32,
                          device=stream.device)    # slot n: dropped
    partial.scatter_(1, slot, stream.to(torch.int32))
    done = first < s
    ptr = done.sum(dim=1)
    return device_complete(partial[:, :n], ptr, done), ptr


def plan_coordinate_plain(neighbors, last_order):
    """The plain walk, level by level: ``neighbors[k-1]`` ``(B, n_k, K)``
    (k = 1..L; layer 1's is never read), ``last_order`` ``(B, n_L)`` ->
    ``(orders, inverses)``, per layer int32 ``(B, n_k)``."""
    L = len(neighbors)
    batch = last_order.shape[0]
    dev = last_order.device
    orders = [None] * L
    o, ptr = _first_occurrence(last_order,
                               torch.ones_like(last_order, dtype=torch.bool),
                               neighbors[-1].shape[1])
    orders[L - 1] = o
    for k in range(L, 1, -1):                 # layer k walks into k-1
        nb = neighbors[k - 1]
        n_k, kk = nb.shape[1], nb.shape[2]
        rows = torch.take_along_dim(nb, o.long()[:, :, None], dim=1)
        valid = (torch.arange(n_k, device=dev)[None] < ptr[:, None])
        valid = valid[:, :, None].expand(batch, n_k, kk)
        o, ptr = _first_occurrence(rows.reshape(batch, -1),
                                   valid.reshape(batch, -1),
                                   neighbors[k - 2].shape[1])
        orders[k - 2] = o
    return orders, [device_inverse(o) for o in orders]


def _coordinate_parts(sizes, ks) -> list:
    """P2's three parts of a cloud's walk, in int32
    (``csrc/plan.cu::plan_coordinate``): the levels' arrays (two
    first-position and two order buffers and an inverse of the widest
    layer), the marks of the longest stream (the last order, or a layer's
    fields), and the receptive fields of layers 2..L."""
    fields = [n * k for n, k in zip(sizes[1:], ks[1:])]
    return [5 * max(sizes), max([sizes[-1], *fields]), sum(fields)]


def coordinate_smem_bytes(sizes, ks) -> int:
    """The shared memory P2 takes for layers of ``sizes`` points and
    ``ks`` neighbours where all of the walk fits there, in bytes: the
    scan's counts and the walk's three parts."""
    return 4 * (32 + sum(_coordinate_parts(sizes, ks)))


def coordinate_workspace(sizes, ks) -> int:
    """The int32 a cloud's walk keeps in device memory: shared memory
    keeps the longest prefix of the levels' arrays, the marks and the
    fields that fits, and a workspace, one a cloud, the rest."""
    parts = _coordinate_parts(sizes, ks)
    room = _MAX_SMEM_BYTES // 4 - 32
    for i, part in enumerate(parts):
        if part > room:
            return sum(parts[i:])
        room -= part
    return 0


def plan_coordinate_cuda(neighbors, last_order):
    """Launch P2: int64 (or int32) ``neighbors[k-1]`` ``(B, n_k, K)`` with
    unit stride along K, int32 ``last_order`` ``(B, n_L)``, on one CUDA
    device -> ``(orders, inverses)``; one block per cloud walks every
    layer."""
    L = len(neighbors)
    batch = last_order.shape[0]
    if not 1 <= L <= COORD_MAX_LAYERS:
        raise ValueError(f"plan_coordinate walks 1 to {COORD_MAX_LAYERS} "
                         f"layers; got {L}")
    nbrs = [nb if nb.dtype == torch.int64 and nb.stride(2) == 1
            else nb.to(torch.int64).contiguous() for nb in neighbors]
    _, sizes, ks = zip(*[nb.shape for nb in nbrs])
    strides = [nb.stride() for nb in nbrs]
    if min(sizes) < 1:
        raise ValueError(f"plan_coordinate wants layers of 1 point or more; "
                         f"got {sizes}")
    span = coordinate_workspace(sizes, ks)
    if max(n * k for n, k in zip(sizes, ks)) >= 2 ** 31 or \
            sum(_coordinate_parts(sizes, ks)) >= 2 ** 31:
        raise ValueError("a layer's stream is too long for 32-bit positions")
    last = last_order
    if last.dtype != torch.int32 or not last.is_contiguous():
        last = last.to(torch.int32).contiguous()
    flat = torch.empty(2 * batch * sum(sizes), dtype=torch.int32,
                       device=last.device)
    work = None if span == 0 else torch.empty(
        batch * span, dtype=torch.int32, device=last.device)
    args = (ctypes.c_longlong * (5 * L))(
        *[nb.data_ptr() for nb in nbrs], *sizes, *ks,
        *[st[0] for st in strides], *[st[1] for st in strides])
    with _on_device(last):
        err = _lib().plan_coordinate(
            last.data_ptr(), flat.data_ptr(), args,
            None if work is None else work.data_ptr(), batch, L, span,
            _build.stream_of(last))
    if err:
        raise RuntimeError(f"plan_coordinate launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["plan_coordinate"] += 1
    parts, at = [], 0
    for n in sizes + sizes:
        parts.append(flat.as_strided((batch, n), (n, 1), at))
        at += batch * n
    return parts[:L], parts[L:]


@launch_site("plan_coordinate", output=lambda r: r[0][0])
def plan_coordinate(neighbors, last_order):
    """Paper Algorithm 1, lines 9-13, for a batch: ``neighbors[k-1]``
    ``(B, n_k, K_k)`` layer k's receptive fields into layer k-1 (k =
    1..L), ``last_order`` ``(B, n_L)`` the last layer's order -> per layer
    the completed int32 order and its inverse, ``(B, n_k)`` each."""
    neighbors = list(neighbors)
    if not neighbors or last_order.ndim != 2 or any(
            nb.ndim != 3 or nb.shape[0] != last_order.shape[0]
            for nb in neighbors) or last_order.shape[1] != \
            neighbors[-1].shape[1]:
        raise ValueError(
            f"plan_coordinate wants neighbors (B, n_k, K) per layer and a "
            f"last order (B, n_L); got "
            f"{[tuple(nb.shape) for nb in neighbors]} and "
            f"{tuple(last_order.shape)}")
    if _build.runs_plain(last_order, *neighbors):
        return plan_coordinate_plain(neighbors, last_order)
    return plan_coordinate_cuda(neighbors, last_order)
