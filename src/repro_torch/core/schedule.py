"""Scheduling Order Generation (paper Algorithm 1), on the host and on
the device.

The port's copy of the planner in ``repro.core.schedule``: the
``ExecutionPlan`` an Algorithm-1 walk produces, its three intra-layer
orders ('index', 'greedy', 'morton'), inter-layer coordination, and the
``MODE_PRESETS`` design points, in NumPy (the host oracles; a host-planned
forward pulls its geometry with ``.cpu()`` and lowers the plan with
:meth:`DevicePlan.lower`), and their ``device_*`` twins in torch, which
build a :class:`DevicePlan` from the forward's own geometry tensors
without leaving the device: :func:`device_build_plan`. On the card the
greedy order runs through P1 and the coordination walk through P2
(``kernels/plan_order.py``); on CPU tensors their plain versions run.
The serving tier's plan reuse lives here too: :class:`PlanCache`, keyed by
:func:`cloud_content_key`, and :class:`FrameTracker`, keyed by
:func:`frame_fingerprint` (hashlib and NumPy; their keys are the JAX
package's strings).

Contract: on the same coordinates every function returns the permutation
the JAX package's planner returns, bit for bit, the device twins included
(tested); ties go to the first index, orphans are appended ascending.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Literal, Sequence

import numpy as np
import torch

from ..kernels.plan_order import (GREEDY_MAX_POINTS, plan_coordinate,
                                  plan_greedy)
from ..kernels.plan_order import device_complete as _device_complete
from ..kernels.plan_order import device_inverse as _device_inverse
from .workload import PointNetWorkload

__all__ = [
    "ExecutionPlan",
    "DevicePlan",
    "PlanCache",
    "FrameTracker",
    "cloud_content_key",
    "frame_fingerprint",
    "GREEDY_DENSE_LIMIT",
    "greedy_nn_order",
    "morton_order",
    "coordinate_layers",
    "build_plan",
    "complete_order",
    "inverse_permutation",
    "MODE_PRESETS",
    "device_build_plan",
    "device_coordinate",
    "device_order_greedy",
    "device_order_morton",
]

IntraMode = Literal["index", "greedy", "morton"]


@dataclass(frozen=True)
class ExecutionPlan:
    """orders[k-1]: execution order (point indices) of layer k (k=1..L).
    trace: the interleaved execution sequence [(layer, point_idx), ...] —
    Eq. (1)/(2) of the paper. Each point appears exactly once."""

    orders: list[np.ndarray]
    trace: list[tuple[int, int]]
    intra: str
    coordinated: bool

    @property
    def n_layers(self) -> int:
        return len(self.orders)

    def order_of(self, layer: int) -> np.ndarray:
        """Execution order of layer ``layer`` (1-based, like the paper)."""
        _check_layer(layer, self.n_layers)
        return self.orders[layer - 1]


def _check_layer(layer: int, n_layers: int) -> None:
    if not 1 <= layer <= n_layers:
        raise ValueError(
            f"layer must be in 1..{n_layers} (1-based SA layer index); "
            f"got {layer}")


def inverse_permutation(order: np.ndarray) -> np.ndarray:
    """Inverse of a permutation: ``inv[order] = arange(n)`` — the scatter
    that puts plan-ordered results back into index order."""
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0], dtype=order.dtype)
    return inv


def complete_order(order: np.ndarray, n: int, layer: int = 0) -> np.ndarray:
    """Complete a (possibly partial) layer order into a full permutation of
    ``range(n)``: points outside every last-layer receptive field are
    appended at the tail in ascending order. Duplicate or out-of-range
    indices raise ``ValueError``."""
    order = np.asarray(order)
    if order.ndim != 1:
        raise ValueError(f"layer-{layer} order must be 1-D; got shape "
                         f"{order.shape}")
    if order.shape[0] > n or (order.size
                              and (order.min() < 0 or order.max() >= n)):
        raise ValueError(
            f"ExecutionPlan layer-{layer} order has {order.shape[0]} "
            f"indices; expected at most {n} distinct values in [0, {n})")
    if np.unique(order).shape[0] != order.shape[0]:
        raise ValueError(
            f"ExecutionPlan layer-{layer} order contains duplicate "
            f"indices; each point must be scheduled exactly once")
    if order.shape[0] == n:
        return order
    missing = np.setdiff1d(np.arange(n, dtype=order.dtype), order)
    return np.concatenate([order, missing])


class DevicePlan:
    """An ``ExecutionPlan`` lowered to int32 torch tensors on a device.

    orders[k-1]   : (n_k,) — or (B, n_k) when batched — int32 permutation
                    executing layer k (completed to the layer size)
    inverses[k-1] : matching inverse permutations (the scatter back to
                    index order that keeps logits order-invariant)
    """

    def __init__(self, orders, inverses, layer_sizes, intra="custom",
                 coordinated=False):
        self.orders = tuple(orders)
        self.inverses = tuple(inverses)
        self.layer_sizes = tuple(int(s) for s in layer_sizes)
        self.intra = intra
        self.coordinated = coordinated

    @classmethod
    def lower(cls, plans, layer_sizes: Sequence[int], *,
              device="cpu") -> "DevicePlan":
        """Lower one ``ExecutionPlan`` (-> unbatched) or a sequence of
        same-shape plans (-> batched, leading batch axis) into int32
        tensors on ``device``. ``layer_sizes[k-1]`` is layer k's point
        count — partial coordinated orders are completed to it."""
        single = isinstance(plans, ExecutionPlan)
        plan_list = [plans] if single else list(plans)
        if not plan_list:
            raise ValueError("DevicePlan.lower needs at least one plan")
        layer_sizes = tuple(int(s) for s in layer_sizes)
        if any(p.n_layers != len(layer_sizes) for p in plan_list):
            raise ValueError(
                f"plan layer count does not match layer_sizes "
                f"{layer_sizes}")
        orders, inverses = [], []
        for k, n in enumerate(layer_sizes, start=1):
            per = np.stack([complete_order(np.asarray(p.order_of(k)), n, k)
                            for p in plan_list])
            inv = np.stack([inverse_permutation(o) for o in per])
            if single:
                per, inv = per[0], inv[0]
            orders.append(torch.as_tensor(per.astype(np.int32),
                                          device=device))
            inverses.append(torch.as_tensor(inv.astype(np.int32),
                                            device=device))
        p0 = plan_list[0]
        return cls(orders, inverses, layer_sizes,
                   intra=p0.intra, coordinated=p0.coordinated)

    @classmethod
    def stack(cls, plans: Sequence["DevicePlan"]) -> "DevicePlan":
        """Stack single-cloud plans along a new leading batch axis. All
        must share ``layer_sizes`` and be unbatched."""
        plan_list = list(plans)
        if not plan_list:
            raise ValueError("DevicePlan.stack needs at least one plan")
        p0 = plan_list[0]
        for p in plan_list:
            if p.batched:
                raise ValueError("DevicePlan.stack takes single-cloud "
                                 "plans; got a batched one")
            if p.layer_sizes != p0.layer_sizes:
                raise ValueError(
                    f"cannot stack plans with layer sizes {p.layer_sizes} "
                    f"and {p0.layer_sizes}")
        orders = [torch.stack([p.orders[k] for p in plan_list])
                  for k in range(p0.n_layers)]
        inverses = [torch.stack([p.inverses[k] for p in plan_list])
                    for k in range(p0.n_layers)]
        return cls(orders, inverses, p0.layer_sizes,
                   intra=p0.intra, coordinated=p0.coordinated)

    def to(self, device) -> "DevicePlan":
        return DevicePlan([o.to(device) for o in self.orders],
                          [i.to(device) for i in self.inverses],
                          self.layer_sizes, self.intra, self.coordinated)

    @property
    def n_layers(self) -> int:
        return len(self.orders)

    @property
    def batched(self) -> bool:
        return self.orders[0].ndim == 2

    @property
    def batch_size(self) -> int | None:
        return int(self.orders[0].shape[0]) if self.batched else None

    def order_of(self, layer: int) -> torch.Tensor:
        _check_layer(layer, self.n_layers)
        return self.orders[layer - 1]

    def inverse_of(self, layer: int) -> torch.Tensor:
        _check_layer(layer, self.n_layers)
        return self.inverses[layer - 1]


# ---------------------------------------------------------------------------
# the plan cache and frame-coherent plan reuse (serving tier)
# ---------------------------------------------------------------------------

def host_array(cloud) -> np.ndarray:
    """``cloud`` as a NumPy array. A torch tensor, on any device, is pulled
    to the host here, explicitly: the one device-to-host copy a key or a
    fingerprint of a tensor costs."""
    if isinstance(cloud, torch.Tensor):
        return cloud.detach().cpu().numpy()
    return np.asarray(cloud)


def cloud_content_key(cloud, n_valid: int | None = None) -> str:
    """Content hash of one cloud's real rows, the plan-cache key: blake2b
    over the trimmed shape, dtype and raw bytes of ``cloud[:n_valid]``, so
    a cloud and its padded copy hash alike and any byte change of a real
    coordinate misses. Row-order sensitive, since FPS is. The same hex
    string as the JAX package's key for the same NumPy input."""
    arr = np.ascontiguousarray(host_array(cloud))
    if n_valid is not None:
        arr = np.ascontiguousarray(arr[:int(n_valid)])
    h = hashlib.blake2b(digest_size=16)
    h.update(str((arr.shape, arr.dtype.str)).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


class PlanCache:
    """Content-keyed LRU cache of single-cloud :class:`DevicePlan` s, kept
    on the model's device. A hit skips geometry-driven planning; inserting
    past ``capacity`` drops the least recently used entry (``evictions``).
    One cache per compiled model: a key maps to the plan of one schedule."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = int(capacity)
        self._entries: OrderedDict[str, DevicePlan] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def get(self, key: str) -> DevicePlan | None:
        """The cached plan for ``key`` (refreshing its recency), or None —
        counted as a hit or a miss."""
        plan = self._entries.get(key)
        if plan is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return plan

    def put(self, key: str, plan: DevicePlan) -> None:
        """Insert (or refresh) ``key``, evicting the coldest entry past
        capacity."""
        if key in self._entries:
            self._entries.move_to_end(key)
        self._entries[key] = plan
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    def get_or_build(self, key: str,
                     build: Callable[[], DevicePlan]) -> DevicePlan:
        """``get(key)``, calling ``build()`` and caching its result on a
        miss."""
        plan = self.get(key)
        if plan is None:
            plan = build()
            self.put(key, plan)
        return plan

    def clear(self) -> None:
        """Drop every entry; the counters keep accumulating."""
        self._entries.clear()

    def stats(self) -> dict:
        """``{'size', 'capacity', 'hits', 'misses', 'evictions',
        'hit_rate'}``, the hit rate over all lookups so far."""
        total = self.hits + self.misses
        return {"size": len(self._entries), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": self.hits / total if total else 0.0}


def frame_fingerprint(cloud, n_valid: int | None = None, *,
                      cell: float = 1e-3) -> str:
    """Coarse fingerprint of one cloud's real rows: each coordinate floored
    onto a float64 grid of pitch ``cell``, the int64 buckets blake2b-hashed
    with the trimmed shape. Equal fingerprints certify that every point
    moved less than ``cell`` per axis. The same hex string as the JAX
    package's for the same NumPy input."""
    if cell <= 0.0:
        raise ValueError(f"cell must be > 0; got {cell}")
    arr = host_array(cloud)
    if n_valid is not None:
        arr = arr[:int(n_valid)]
    q = np.floor(np.asarray(arr, np.float64) / cell).astype(np.int64)
    h = hashlib.blake2b(digest_size=16)
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(q).tobytes())
    return h.hexdigest()


class FrameTracker:
    """Frame-coherent :class:`DevicePlan` reuse for streaming LiDAR: one
    anchor (the last cloud a plan was built for) whose plan serves any
    frame within ``tol`` of it — first by :func:`frame_fingerprint`
    equality, then by the exact largest per-coordinate displacement. A
    miss re-anchors (:meth:`update`), so drift stays within ``tol``.
    Logits are bitwise invariant to the plan (it only permutes), so reuse
    never changes a served row."""

    def __init__(self, tol: float = 1e-3, *, cell: float | None = None):
        if tol <= 0.0:
            raise ValueError(f"tol must be > 0; got {tol}")
        self.tol = float(tol)
        self.cell = self.tol if cell is None else float(cell)
        if self.cell <= 0.0:
            raise ValueError(f"cell must be > 0; got {cell}")
        self._anchor: np.ndarray | None = None
        self._anchor_fp: str | None = None
        self._anchor_plan: DevicePlan | None = None
        self.frame_hits = 0
        self.frame_misses = 0
        self.fingerprint_hits = 0
        self.reanchors = 0

    @staticmethod
    def _trim(cloud, n_valid):
        arr = host_array(cloud)
        return arr if n_valid is None else arr[:int(n_valid)]

    def lookup(self, cloud, n_valid: int | None = None) -> DevicePlan | None:
        """The anchor's plan if ``cloud``'s real rows are within ``tol`` of
        the anchor frame (a ``frame_hit``), else None (a ``frame_miss``:
        build or fetch a plan and :meth:`update` with it)."""
        arr = self._trim(cloud, n_valid)
        if (self._anchor is None or arr.shape != self._anchor.shape
                or arr.dtype != self._anchor.dtype):
            self.frame_misses += 1
            return None
        if frame_fingerprint(arr, cell=self.cell) == self._anchor_fp:
            self.fingerprint_hits += 1
            self.frame_hits += 1
            return self._anchor_plan
        disp = np.max(np.abs(np.asarray(arr, np.float64)
                             - np.asarray(self._anchor, np.float64)))
        if disp <= self.tol:
            self.frame_hits += 1
            return self._anchor_plan
        self.frame_misses += 1
        return None

    def update(self, cloud, plan: DevicePlan,
               n_valid: int | None = None) -> None:
        """Re-anchor on ``cloud``'s real rows and its freshly built
        ``plan``."""
        arr = np.array(self._trim(cloud, n_valid), copy=True)
        self._anchor = arr
        self._anchor_fp = frame_fingerprint(arr, cell=self.cell)
        self._anchor_plan = plan
        self.reanchors += 1

    def clear(self) -> None:
        """Drop the anchor; the counters keep accumulating."""
        self._anchor = None
        self._anchor_fp = None
        self._anchor_plan = None

    def stats(self) -> dict:
        """``{'frame_hits', 'frame_misses', 'fingerprint_hits',
        'reanchors', 'hit_rate'}``, the hit rate over all lookups so far."""
        total = self.frame_hits + self.frame_misses
        return {"frame_hits": self.frame_hits,
                "frame_misses": self.frame_misses,
                "fingerprint_hits": self.fingerprint_hits,
                "reanchors": self.reanchors,
                "hit_rate": self.frame_hits / total if total else 0.0}


#: Above this many points ``greedy_nn_order`` recomputes distances per step
#: instead of materializing the O(n^2) pairwise matrix (n=2048 -> 32 MB).
GREEDY_DENSE_LIMIT = GREEDY_MAX_POINTS


def greedy_nn_order(points: np.ndarray, start: int = 0) -> np.ndarray:
    """Paper Algorithm 1, lines 1-8: repeatedly append the unscheduled point
    nearest to the last scheduled one. For n <= GREEDY_DENSE_LIMIT the
    pairwise distance matrix is precomputed once (coordinate-wise, which
    reproduces ``np.sum(..., axis=1)`` rounding exactly)."""
    n = points.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.int64)
    dense = n <= GREEDY_DENSE_LIMIT
    if dense:
        d2 = (points[:, 0, None] - points[None, :, 0]) ** 2
        for c in range(1, points.shape[1]):
            d2 += (points[:, c, None] - points[None, :, c]) ** 2
    remaining = np.ones(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    cur = int(start)
    for i in range(n):
        order[i] = cur
        remaining[cur] = False
        if i == n - 1:
            break
        if dense:
            d = np.where(remaining, d2[cur], np.inf)
        else:
            d = np.sum((points - points[cur]) ** 2, axis=1)
            d[~remaining] = np.inf
        cur = int(np.argmin(d))
    return order


def _interleave_bits(v: np.ndarray, nbits: int) -> np.ndarray:
    out = np.zeros(v.shape[0], dtype=np.uint64)
    for b in range(nbits):
        out |= ((v[:, 0].astype(np.uint64) >> b) & 1) << np.uint64(3 * b + 2)
        out |= ((v[:, 1].astype(np.uint64) >> b) & 1) << np.uint64(3 * b + 1)
        out |= ((v[:, 2].astype(np.uint64) >> b) & 1) << np.uint64(3 * b)
    return out


def morton_order(points: np.ndarray, nbits: int = 10) -> np.ndarray:
    """Beyond-paper: order points along a Morton (Z-order) curve.
    Degenerate axes (``hi == lo``) are clamped to bucket 0."""
    lo = points.min(axis=0, keepdims=True)
    hi = points.max(axis=0, keepdims=True)
    extent = hi - lo
    safe = np.where(extent > 0, extent, np.ones_like(extent))
    q = ((points - lo) / safe * (2**nbits - 1)).astype(np.uint64)
    return np.argsort(_interleave_bits(q, nbits), kind="stable")


def coordinate_layers(workload: PointNetWorkload, last_order: np.ndarray,
                      *, intra: str = "custom") -> ExecutionPlan:
    """Paper Algorithm 1, lines 9-13: walk the last layer in
    ``last_order``; recursively schedule each point's receptive-field
    members in lower layers immediately before it, skipping members
    already executed."""
    L = workload.n_layers
    done = [np.zeros(workload.points[k].shape[0], dtype=bool)
            for k in range(L + 1)]
    orders: list[list[int]] = [[] for _ in range(L + 1)]
    trace: list[tuple[int, int]] = []

    def execute(layer: int, i: int) -> None:
        if done[layer][i]:
            return
        if layer > 1:
            for m in workload.neighbors[layer][i]:
                execute(layer - 1, int(m))
        done[layer][i] = True
        orders[layer].append(i)
        trace.append((layer, i))

    for j in last_order:
        execute(L, int(j))
    return ExecutionPlan(
        orders=[np.asarray(orders[k], dtype=np.int64) for k in range(1, L + 1)],
        trace=trace, intra=intra, coordinated=True)


def _layer_by_layer(workload: PointNetWorkload, last_order: np.ndarray,
                    *, intra: str = "custom") -> ExecutionPlan:
    """No coordination: each SA layer completes before the next begins.
    Lower layers run in index order; the last layer runs in
    ``last_order``."""
    L = workload.n_layers
    orders = [np.arange(workload.points[k].shape[0], dtype=np.int64)
              for k in range(1, L + 1)]
    orders[L - 1] = np.asarray(last_order, dtype=np.int64)
    trace = [(k, int(i)) for k in range(1, L + 1) for i in orders[k - 1]]
    return ExecutionPlan(orders=orders, trace=trace, intra=intra,
                         coordinated=False)


def build_plan(workload: PointNetWorkload, *, intra: IntraMode = "index",
               coordinated: bool = False, start: int = 0) -> ExecutionPlan:
    last_pts = workload.points[workload.n_layers]
    if intra == "index":
        last_order = np.arange(last_pts.shape[0], dtype=np.int64)
    elif intra == "greedy":
        last_order = greedy_nn_order(last_pts, start=start)
    elif intra == "morton":
        last_order = morton_order(last_pts)
    else:
        raise ValueError(f"unknown intra mode {intra!r}")
    return (coordinate_layers(workload, last_order, intra=intra) if coordinated
            else _layer_by_layer(workload, last_order, intra=intra))


#: Paper design points: ``(intra, coordinated)``.
MODE_PRESETS: dict[str, dict] = {
    "baseline":   dict(intra="index", coordinated=False),
    "pointer-1":  dict(intra="index", coordinated=False),
    "pointer-12": dict(intra="index", coordinated=True),
    "pointer":    dict(intra="greedy", coordinated=True),
    # beyond-paper
    "pointer-morton": dict(intra="morton", coordinated=True),
}


# ---------------------------------------------------------------------------
# on-device planning: the same passes as torch computations
# ---------------------------------------------------------------------------
#
# The ``device_*`` twins of the NumPy oracles above. Each takes a leading
# batch axis (the reference vmaps a single-cloud function) or none, and
# returns int32 tensors in DevicePlan layout on the input's device, with
# no host transfer: on the card the greedy order is P1 and the
# coordination walk P2, one launch each for the whole batch.

def _batched(x, ndim: int):
    """``(x with a leading batch axis, whether one was added)``."""
    return (x[None], True) if x.ndim == ndim else (x, False)


def device_order_greedy(points, start: int = 0):
    """Device twin of :func:`greedy_nn_order`: ``(n, 3)`` or ``(B, n, 3)``
    -> int32 ``(n,)`` or ``(B, n)``, limited to n <=
    ``GREEDY_DENSE_LIMIT`` as the reference's dense sweep is."""
    pts, single = _batched(points, 2)
    n = pts.shape[1]
    if n > GREEDY_DENSE_LIMIT:
        raise ValueError(
            f"device_order_greedy is limited to n <= {GREEDY_DENSE_LIMIT} "
            f"(one block holds the cloud); got n={n} (use the host "
            f"greedy_nn_order fallback)")
    out = plan_greedy(pts, start)
    return out[0] if single else out


def device_order_morton(points, nbits: int = 10):
    """Device twin of :func:`morton_order`: quantize each axis to ``nbits``
    buckets (degenerate axes to bucket 0), interleave the bits into a key,
    stable-sort. Keys are int64: torch has no full uint32 arithmetic."""
    if 3 * nbits > 32:
        raise ValueError(f"3*nbits must fit a uint32 key; got nbits={nbits}")
    pts, single = _batched(points, 2)
    lo = pts.amin(dim=1, keepdim=True)
    hi = pts.amax(dim=1, keepdim=True)
    extent = hi - lo
    safe = torch.where(extent > 0, extent, torch.ones_like(extent))
    q = ((pts - lo) / safe * (2 ** nbits - 1)).to(torch.int64)
    b = torch.arange(nbits, device=pts.device)
    bits = (q[..., None] >> b) & 1                       # (B, n, 3, nbits)
    axis = torch.arange(3, device=pts.device)[:, None]
    key = (bits << (3 * b + 2 - axis)).sum(dim=(2, 3))   # disjoint bits
    out = torch.sort(key, dim=1, stable=True).indices.to(torch.int32)
    return out[0] if single else out


def _coordinated(neighbors, last_order):
    nbrs = list(neighbors)
    single = last_order.ndim == 1
    if single:
        nbrs = [nb[None] for nb in nbrs]
        last_order = last_order[None]
    orders, inverses = plan_coordinate(nbrs, last_order)
    if single:
        orders, inverses = [o[0] for o in orders], [i[0] for i in inverses]
    return orders, inverses


def device_coordinate(neighbors, last_order):
    """Device twin of :func:`coordinate_layers`: ``neighbors[k-1]`` layer
    k's receptive fields ``(n_k, K)`` (or ``(B, n_k, K)``; layer 1's is
    carried for its size only), ``last_order`` ``(n_L,)`` (or ``(B,
    n_L)``) -> one int32 full permutation per layer 1..L, the walk's order
    completed with the orphans in ascending order."""
    return _coordinated(neighbors, last_order)[0]


def device_build_plan(neighbors, last_points, *, intra: IntraMode = "index",
                      coordinated: bool = False, start: int = 0,
                      nbits: int = 10) -> DevicePlan:
    """The whole of :func:`build_plan` + :meth:`DevicePlan.lower` on the
    device: ``neighbors[k-1]`` layer k's receptive fields ``(n_k, K)``,
    ``last_points`` the layer-L coordinates ``(n_L, 3)`` — or both with a
    leading batch axis, for a batched plan."""
    pts, single = _batched(last_points, 2)
    nbrs = [nb[None] for nb in neighbors] if single else list(neighbors)
    sizes = tuple(int(nb.shape[1]) for nb in nbrs)
    batch, dev = pts.shape[0], pts.device
    if intra == "index":
        last = torch.arange(sizes[-1], dtype=torch.int32,
                            device=dev).expand(batch, -1)
    elif intra == "greedy":
        last = device_order_greedy(pts, start=start)
    elif intra == "morton":
        last = device_order_morton(pts, nbits=nbits)
    else:
        raise ValueError(f"unknown intra mode {intra!r}")
    if coordinated:
        orders, inverses = _coordinated(nbrs, last)
    else:
        orders = [torch.arange(n, dtype=torch.int32,
                               device=dev).expand(batch, -1)
                  for n in sizes[:-1]] + [last]
        inverses = orders[:-1] + [_device_inverse(last)]
    if single:
        orders, inverses = [o[0] for o in orders], [i[0] for i in inverses]
    return DevicePlan(orders, inverses, sizes, intra=intra,
                      coordinated=coordinated)
