"""K7: farthest point sampling (``csrc/fps.cu``).

Replaces the TPU kernel ``repro/kernels/fps_update.py::_kernel`` — one FPS
relaxation step, ``d = min(d, |p - c|^2)`` — and the loop of
``repro/kernels/ops.py::fps`` that drives it once per sample:

- :func:`fps_update` is the step, with the JAX signature (``block_n``, a
  TPU tile edge, is dropped): points ``(3, N)``, centroid ``(3, 1)``,
  distances ``(1, N)``, float32;
- :func:`fps_batched` is the whole sampling loop over a batch ``(B, N, 3)``,
  one kernel launch for the batch, whatever ``n_samples`` and N. It is the
  model's ``farthest_point_sample``. :func:`plan_fps` chooses the launch:
  one block per cloud, a thread-block cluster per cloud, or a cluster that
  streams the cloud from device memory (:class:`FpsPlan`).

The squared distance is summed left to right, ``(dx² + dy²) + dz²`` as
XLA reduces the three terms, and the argmax takes the first maximum
(``torch.argmax`` documents it), so the indices equal the JAX package's
bit for bit. On CPU tensors the wrappers run their plain torch versions;
on CUDA tensors they launch the kernels (or raise). ``LAUNCHES`` counts
the launches: ``"fps_update"`` the steps, ``"fps"`` the whole loops.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import _build
from .record import launch_site

__all__ = ["FPS_BLOCK_POINTS", "FPS_BLOCK_THREADS", "FPS_PER_THREAD",
           "FPS_REGS", "FPS_STREAM_REGS", "FPS_STREAM_THREADS", "FPS_TIERS",
           "FpsPlan", "LAUNCHES", "check_plan", "fps_batched",
           "fps_batched_cuda", "fps_batched_plain", "fps_update", "fps_update_cuda", "fps_update_plain", "plan_fps",
           "sq_dist", "valid_rows"]

#: Kernel launches (plain runs never count).
LAUNCHES = {"fps_update": 0, "fps": 0}

#: The launch tiers of the sampling loop, in the order of cloud size.
FPS_TIERS = ("block", "cluster", "streamed")

#: Threads of a register-tier block, and the points a thread may hold at
#: each: the kernel's instantiations (``FPS_SHAPES`` in ``csrc/fps.cu``).
#: A thread keeps 4 registers a point (x, y, z and its running distance).
FPS_PER_THREAD = {128: (1, 2, 4, 8), 256: (1, 2, 4, 8, 16),
                  512: (1, 2, 4, 8, 16)}

#: Threads of a streamed-tier block (``fps_stream_kernel``'s).
FPS_STREAM_THREADS = 1024

#: Registers a thread of the register tiers takes, by points a thread: 4
#: a point (x, y, z and its running distance) beside the center, the
#: candidate tree and the loop's state, as ``ptxas`` reports them for
#: ``sm_90a`` (the most over threads, tiers and the measurement variant
#: without the relaxation; ``chip_smoke.py`` checks them at every build). The plan keeps them
#: within ``65536 / threads`` (one block an SM, ``__launch_bounds__(T,
#: 1)``), at most 255.
FPS_REGS = {1: 36, 2: 40, 4: 48, 8: 64, 16: 104}

#: Registers a thread of the streamed tier takes (the same report).
FPS_STREAM_REGS = 56

#: Threads of a block-tier block where the cloud allows it.
FPS_BLOCK_THREADS = 256

#: The most points one block holds in registers (512 x 16): the block
#: tier up to here, the cluster tier to 16 blocks of it, the streamed tier
#: beyond.
FPS_BLOCK_POINTS = 8192

#: Blocks of a cluster: at most 16 (beyond 8 a non-portable size the H100
#: allows), and the streamed tier's.
FPS_MAX_CLUSTER = 16
FPS_STREAM_CLUSTER = 8

#: Shared memory a block may have on the H100, in bytes.
_MAX_SMEM_BYTES = 232448


@dataclass(frozen=True)
class FpsPlan:
    """One launch of the sampling loop (``fps_run`` in ``csrc/fps.cu``):
    ``tier`` (one of :data:`FPS_TIERS`), ``threads`` a block, ``cluster``
    blocks a cloud (1 in the block tier) and ``per_thread`` points a
    thread: held in registers for the whole loop in the block and cluster
    tiers, visited in device memory every step in the streamed tier."""

    tier: str
    threads: int
    per_thread: int
    cluster: int

    @property
    def slots(self) -> int:
        """Candidate slots of a block: one per warp of the cluster."""
        return self.threads // 32 * self.cluster

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block: two buffers of slots, each a
        float4 candidate and an int64 index."""
        return 2 * self.slots * (16 + 8)

    @property
    def regs(self) -> int:
        """Registers a thread takes (:data:`FPS_REGS`,
        :data:`FPS_STREAM_REGS`)."""
        if self.tier == "streamed":
            return FPS_STREAM_REGS
        return FPS_REGS[self.per_thread]

    @property
    def reg_budget(self) -> int:
        """Registers a thread may have at one block an SM."""
        return min(255, 65536 // self.threads)

    @property
    def capacity(self) -> int | None:
        """Points a cloud may have under this plan (None: any)."""
        if self.tier == "streamed":
            return None
        return self.threads * self.per_thread * self.cluster


def _register_shape(n_block: int) -> tuple[int, int]:
    """The fewest threads from :data:`FPS_BLOCK_THREADS` up, then the
    fewest points a thread, that hold ``n_block`` points in one block."""
    for t in sorted(FPS_PER_THREAD):
        if t < FPS_BLOCK_THREADS:
            continue
        for per in FPS_PER_THREAD[t]:
            if t * per >= n_block:
                return t, per
    raise ValueError(f"{n_block} points do not fit one block's registers "
                     f"(at most {FPS_BLOCK_POINTS})")


@functools.lru_cache(maxsize=256)
def plan_fps(batch: int, n: int, sms: int) -> FpsPlan:
    """The launch of FPS over ``batch`` clouds of ``n`` points on a card of
    ``sms`` SMs. Tiers by N:

    - ``n <= FPS_BLOCK_POINTS`` (8192): 'block', one block per cloud;
    - up to ``FPS_MAX_CLUSTER * FPS_BLOCK_POINTS`` (131072), and no more
      blocks a cluster than ``sms``: 'cluster', ``ceil(n / 8192)`` blocks a
      cloud, each holding ``ceil(n / cluster)`` points;
    - beyond: 'streamed', :data:`FPS_STREAM_CLUSTER` blocks of
      :data:`FPS_STREAM_THREADS` threads a cloud.

    Within a block, :data:`FPS_BLOCK_THREADS` threads where they hold the
    points at no more than 16 a thread, else 512. ``batch`` does not move
    the choice: each cloud is one block or one cluster."""
    if batch < 1 or n < 1 or sms < 1:
        raise ValueError(f"plan_fps wants batch, n, sms >= 1; got {batch}, "
                         f"{n}, {sms}")
    if n <= FPS_BLOCK_POINTS:
        t, per = _register_shape(n)
        return FpsPlan("block", t, per, 1)
    cluster = -(-n // FPS_BLOCK_POINTS)
    if cluster <= min(FPS_MAX_CLUSTER, sms):
        t, per = _register_shape(-(-n // cluster))
        return FpsPlan("cluster", t, per, cluster)
    cluster = min(FPS_STREAM_CLUSTER, sms)
    return FpsPlan("streamed", FPS_STREAM_THREADS,
                   -(-n // (FPS_STREAM_THREADS * cluster)), cluster)


@functools.lru_cache(maxsize=256)
def check_plan(plan: FpsPlan, n: int) -> None:
    """Raise ``ValueError`` unless the kernel takes ``plan`` for clouds of
    ``n`` points."""
    if plan.tier not in FPS_TIERS:
        raise ValueError(f"tier={plan.tier!r} must be one of {FPS_TIERS}")
    if not 1 <= plan.cluster <= FPS_MAX_CLUSTER:
        raise ValueError(f"a cluster has 1 to {FPS_MAX_CLUSTER} blocks; "
                         f"got {plan.cluster}")
    if (plan.tier == "block") != (plan.cluster == 1):
        raise ValueError(f"the 'block' tier, and only it, has one block a "
                         f"cloud; got {plan}")
    if plan.tier == "streamed":
        if plan.threads != FPS_STREAM_THREADS:
            raise ValueError(f"the streamed tier is built for "
                             f"{FPS_STREAM_THREADS} threads; got {plan}")
    elif plan.per_thread not in FPS_PER_THREAD.get(plan.threads, ()):
        raise ValueError(f"no register-tier kernel of {plan.threads} "
                         f"threads x {plan.per_thread} points; built: "
                         f"{FPS_PER_THREAD}")
    elif plan.capacity < n:
        raise ValueError(f"{plan} holds {plan.capacity} points; the cloud "
                         f"has {n}")
    if plan.regs > plan.reg_budget or plan.smem_bytes > _MAX_SMEM_BYTES:
        raise ValueError(f"{plan} exceeds a block's registers or shared "
                         f"memory")


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum((a - b) ** 2, -1)`` over 3 coordinates, summed left to right."""
    diff = a - b
    sq = diff * diff
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def valid_rows(n: int, n_valid, device) -> torch.Tensor:
    """Bool ``(…, n)``: row index < ``n_valid`` (an int or a ``(B,)``
    vector, broadcast over a leading batch axis)."""
    nv = torch.as_tensor(n_valid, device=device).reshape(-1, 1)
    return torch.arange(n, device=device) < nv


def _bind_run(lib) -> None:
    """Type ``fps_run``: 4 pointers, batch, N, samples and start as int64,
    tier, threads, points a thread and cluster as int, the stream."""
    f = lib.fps_run
    f.restype = ctypes.c_int
    f.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])


@functools.cache
def _lib():
    lib = _build.library("fps")
    _build.bind(lib, "fps_update", 4, 1)
    _bind_run(lib)
    return lib


# ---------------------------------------------------------------------------
# one relaxation step
# ---------------------------------------------------------------------------

def fps_update_plain(points_t, centroid, dist):
    """``min(dist, (dx² + dy²) + dz²)``: (3, N), (3, 1), (1, N) -> (1, N)."""
    return torch.minimum(dist, sq_dist(points_t.T, centroid.T)[None])


def fps_update_cuda(points_t, centroid, dist):
    """Launch the step kernel on float32 CUDA tensors."""
    n = points_t.shape[1]
    for t in (points_t, centroid, dist):
        if t.dtype != torch.float32:
            raise TypeError(f"fps_update needs float32 tensors; got "
                            f"{t.dtype}")
    if 3 * n >= 2 ** 31:
        raise ValueError("fps_update indexes with 32-bit ints; the cloud "
                         "is too large")
    points_t, centroid, dist = (t.contiguous()
                                for t in (points_t, centroid, dist))
    out = torch.empty_like(dist)
    if n == 0:
        return out
    with torch.cuda.device(points_t.device):
        err = _lib().fps_update(points_t.data_ptr(), centroid.data_ptr(),
                                dist.data_ptr(), out.data_ptr(), n,
                                _build.stream_of(points_t))
    if err:
        raise RuntimeError(f"fps_update launch failed: CUDA error {err}")
    LAUNCHES["fps_update"] += 1
    return out


@launch_site("fps_update")
def fps_update(points_t, centroid, dist):
    """points_t (3, N); centroid (3, 1); dist (1, N) -> relaxed dist
    (1, N)."""
    n = points_t.shape[-1]
    if (points_t.shape != (3, n) or centroid.shape != (3, 1)
            or dist.shape != (1, n)):
        raise ValueError(f"fps_update wants (3, N), (3, 1), (1, N); got "
                         f"{tuple(points_t.shape)}, {tuple(centroid.shape)}, "
                         f"{tuple(dist.shape)}")
    if _build.runs_plain(points_t, centroid, dist):
        return fps_update_plain(points_t, centroid, dist)
    return fps_update_cuda(points_t, centroid, dist)


# ---------------------------------------------------------------------------
# the whole sampling loop
# ---------------------------------------------------------------------------

def fps_batched_plain(points, n_samples: int, start: int = 0,
                      n_valid=None):
    """The plain loop: ``n_samples`` relax-then-argmax steps over the batch
    ``(B, N, 3)`` -> int64 ``(B, n_samples)``."""
    batch, n, _ = points.shape
    dev = points.device
    dist = torch.full((batch, n), float("inf"), dtype=points.dtype,
                      device=dev)
    if n_valid is not None:
        dist = torch.where(valid_rows(n, n_valid, dev), dist, float("-inf"))
    idx = torch.empty((batch, n_samples), dtype=torch.int64, device=dev)
    cur = torch.full((batch,), int(start), dtype=torch.int64, device=dev)
    rows = torch.arange(batch, device=dev)
    for i in range(n_samples):
        idx[:, i] = cur
        dist = torch.minimum(dist, sq_dist(points,
                                           points[rows, cur][:, None, :]))
        cur = torch.argmax(dist, dim=1)
    return idx


def fps_batched_cuda(points, n_samples: int, start: int = 0, n_valid=None,
                     plan: FpsPlan | None = None):
    """Launch the loop kernel on float32 ``(B, N, 3)`` on a CUDA device,
    any N: under ``plan``, or :func:`plan_fps`'s where it is None (a pinned
    plan runs any tier that holds the cloud)."""
    batch, n, _ = points.shape
    if points.dtype != torch.float32:
        raise TypeError(f"fps needs float32 points on the card; got "
                        f"{points.dtype}")
    points = points.contiguous()
    dev = points.device
    if plan is None:
        plan = plan_fps(batch, n, _build.sm_count(points))
    check_plan(plan, n)
    out = torch.empty((batch, n_samples), dtype=torch.int64, device=dev)
    if out.numel() == 0:
        return out
    nv = None
    if n_valid is not None:
        nv = torch.as_tensor(n_valid, device=dev).reshape(-1)
        nv = torch.clamp(nv, 0, n).to(torch.int64).expand(batch).contiguous()
    dist = (torch.empty((batch, n), dtype=torch.float32, device=dev)
            if plan.tier == "streamed" else None)
    with torch.cuda.device(dev):
        err = _lib().fps_run(
            points.data_ptr(), None if nv is None else nv.data_ptr(),
            out.data_ptr(), None if dist is None else dist.data_ptr(),
            batch, n, n_samples, int(start), FPS_TIERS.index(plan.tier),
            plan.threads, plan.per_thread, plan.cluster,
            _build.stream_of(points))
    if err:
        raise RuntimeError(f"fps launch failed under {plan}: CUDA error "
                           f"{err}")
    LAUNCHES["fps"] += 1
    return out


@launch_site("fps_batched")
def fps_batched(points, n_samples: int, start: int = 0, n_valid=None):
    """FPS over each cloud of ``points`` ``(B, N, 3)`` from row ``start``
    -> int64 ``(B, n_samples)``. ``n_valid`` (an int or a ``(B,)`` vector)
    masks trailing pad rows: they start at ``-inf`` distance, so the
    running argmax never selects them and each row equals FPS on the
    unpadded cloud."""
    if points.ndim != 3 or points.shape[-1] != 3:
        raise ValueError(f"fps wants points (B, N, 3); got "
                         f"{tuple(points.shape)}")
    n = points.shape[1]
    if not 0 <= n_samples <= n:
        raise ValueError(f"n_samples={n_samples} must lie in [0, {n}]")
    if not 0 <= start < n:
        raise ValueError(f"start={start} must lie in [0, {n})")
    if _build.runs_plain(points):
        return fps_batched_plain(points, n_samples, start, n_valid)
    return fps_batched_cuda(points, n_samples, start, n_valid)
