"""P1/P2: the plan's greedy order and coordination walk (``csrc/plan.cu``).

The two loops of paper Algorithm 1 that build an execution plan on the
device. In the JAX package they are ``lax`` loops inside
``repro/core/schedule.py``, not Pallas kernels: ``device_order_greedy``
(a ``fori_loop`` of masked argmins, lines 1-8) and ``device_coordinate``
(a ``scan``/``cond`` walk of the receptive fields, lines 9-13). Here each
is one hand-written kernel launch for a whole batch of clouds:

- :func:`plan_greedy` (P1): points ``(B, n, 3)`` float32 -> int32
  ``(B, n)``, the greedy nearest-neighbour chain from row ``start``; one
  block per cloud, the points in registers, the ``n x n`` distance matrix
  never built;
- :func:`plan_coordinate` (P2): the last layer's order ``(B, n_L)`` and
  the receptive fields ``neighbors[k-1]`` ``(B, n_k, K_k)`` of layers
  k = 1..L -> per layer the completed int32 order ``(B, n_k)`` and its
  inverse; one block per cloud walks every layer.

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

import ctypes
import functools

import torch

from . import _build
from .record import launch_site

__all__ = ["GREEDY_MAX_POINTS", "GREEDY_PER_THREAD", "GREEDY_THREADS",
           "LAUNCHES", "device_complete", "device_inverse",
           "greedy_launch", "plan_coordinate", "plan_coordinate_cuda",
           "plan_coordinate_plain", "plan_greedy", "plan_greedy_cuda",
           "plan_greedy_plain"]

#: Kernel launches (plain runs never count).
LAUNCHES = {"plan_greedy": 0, "plan_coordinate": 0}

#: The most points P1 holds in one block's registers (256 threads x 8):
#: the reference's dense-sweep limit (``GREEDY_DENSE_LIMIT``).
GREEDY_MAX_POINTS = 2048

#: P1's threads a block at most, and the points a thread may hold (the
#: kernel's instantiations, ``GREEDY_PER`` in ``csrc/plan.cu``).
GREEDY_THREADS = 256
GREEDY_PER_THREAD = (1, 2, 4, 8)

#: The most layers one P2 launch walks.
COORD_MAX_LAYERS = 8

#: Shared memory a block may have on the H100, in bytes (P2 keeps one int
#: per point of the widest layer there).
_MAX_SMEM_BYTES = 232448


def _bind(lib):
    """Type P1's and P2's entries in ``lib`` (:func:`_lib`'s library, or a
    stand-in in the tests)."""
    _build.bind(lib, "plan_greedy", 2, 5)
    f = lib.plan_coordinate
    f.restype = ctypes.c_int
    # the last order; host arrays of the layers' neighbor, order and
    # inverse pointers and of their sizes, K and neighbor strides; batch,
    # layers, stream
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    return lib


@functools.cache
def _lib():
    return _bind(_build.library("plan"))


# ---------------------------------------------------------------------------
# P1: the greedy order
# ---------------------------------------------------------------------------

def greedy_launch(n: int) -> tuple[int, int]:
    """P1's block for clouds of ``n`` points: ``(threads, points a
    thread)``, the fewest threads (a multiple of 32, at most
    :data:`GREEDY_THREADS`) and then the fewest points a thread."""
    if not 1 <= n <= GREEDY_MAX_POINTS:
        raise ValueError(f"plan_greedy takes 1 to {GREEDY_MAX_POINTS} "
                         f"points a cloud; got {n}")
    threads = min(GREEDY_THREADS, -(-n // 32) * 32)
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
    with torch.cuda.device(points.device):
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


def plan_coordinate_cuda(neighbors, last_order):
    """Launch P2: int64 (or int32) ``neighbors[k-1]`` ``(B, n_k, K)`` with
    unit stride along K, int32 ``last_order`` ``(B, n_L)``, on one CUDA
    device -> ``(orders, inverses)``; one block per cloud walks every
    layer."""
    L = len(neighbors)
    batch = last_order.shape[0]
    dev = last_order.device
    if not 1 <= L <= COORD_MAX_LAYERS:
        raise ValueError(f"plan_coordinate walks 1 to {COORD_MAX_LAYERS} "
                         f"layers; got {L}")
    sizes = [int(nb.shape[1]) for nb in neighbors]
    if min(sizes) < 1:
        raise ValueError(f"plan_coordinate wants layers of 1 point or more; "
                         f"got {sizes}")
    if 4 * max(sizes) + 256 > _MAX_SMEM_BYTES:
        raise ValueError(f"plan_coordinate keeps a layer's points in shared "
                         f"memory; {max(sizes)} points do not fit")
    nbrs = []
    for nb in neighbors:
        if nb.dtype != torch.int64:
            nb = nb.to(torch.int64)
        if nb.stride(2) != 1:
            nb = nb.contiguous()
        nbrs.append(nb)
    if max(n * nb.shape[2] for n, nb in zip(sizes, nbrs)) >= 2 ** 31:
        raise ValueError("a layer's stream is too long for 32-bit positions")
    last = last_order.to(torch.int32).contiguous()
    flat = torch.empty(2 * batch * sum(sizes), dtype=torch.int32, device=dev)
    orders, inverses, at = [], [], 0
    for n in sizes:
        orders.append(flat[at:at + batch * n].view(batch, n))
        at += batch * n
    for n in sizes:
        inverses.append(flat[at:at + batch * n].view(batch, n))
        at += batch * n
    ptrs = (ctypes.c_void_p * L)(*[nb.data_ptr() for nb in nbrs])
    outs = (ctypes.c_void_p * L)(*[o.data_ptr() for o in orders])
    invs = (ctypes.c_void_p * L)(*[i.data_ptr() for i in inverses])
    ints = (ctypes.c_longlong * (4 * L))(
        *sizes, *[nb.shape[2] for nb in nbrs],
        *[nb.stride(0) for nb in nbrs], *[nb.stride(1) for nb in nbrs])
    with torch.cuda.device(dev):
        err = _lib().plan_coordinate(
            last.data_ptr(), ctypes.addressof(ptrs), ctypes.addressof(outs),
            ctypes.addressof(invs), ctypes.addressof(ints), batch, L,
            _build.stream_of(last))
    if err:
        raise RuntimeError(f"plan_coordinate launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["plan_coordinate"] += 1
    return orders, inverses


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
