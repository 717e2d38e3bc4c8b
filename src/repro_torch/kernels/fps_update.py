"""K7: farthest point sampling (``csrc/fps.cu``).

Replaces the TPU kernel ``repro/kernels/fps_update.py::_kernel`` — one FPS
relaxation step, ``d = min(d, |p - c|^2)`` — and the loop of
``repro/kernels/ops.py::fps`` that drives it once per sample:

- :func:`fps_update` is the step, with the JAX signature (``block_n``, a
  TPU tile edge, is dropped): points ``(3, N)``, centroid ``(3, 1)``,
  distances ``(1, N)``, float32;
- :func:`fps_batched` is the whole sampling loop over a batch ``(B, N, 3)``,
  one kernel launch for the batch, whatever ``n_samples``. It is the
  model's ``farthest_point_sample``.

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

import torch

from . import _build

__all__ = ["LAUNCHES", "MAX_POINTS", "fps_batched", "fps_batched_cuda",
           "fps_batched_plain", "fps_update", "fps_update_cuda",
           "fps_update_plain", "sq_dist", "valid_rows"]

#: Kernel launches (plain runs never count).
LAUNCHES = {"fps_update": 0, "fps": 0}

#: The largest cloud the loop kernel takes: 1024 threads of 16 running
#: distances each, and the coordinates (12 bytes a point) in shared memory
#: (``fps_max_points()`` in ``csrc/fps.cu``).
MAX_POINTS = 16384


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


@functools.cache
def _lib():
    lib = _build.library("fps")
    _build.bind(lib, "fps_update", 4, 1)
    _build.bind(lib, "fps_loop", 3, 4)
    lib.fps_max_points.restype = ctypes.c_int
    lib.fps_max_points.argtypes = []
    return lib


def max_points_of_kernel() -> int:
    """:data:`MAX_POINTS` as the built kernel states it (builds it)."""
    return int(_lib().fps_max_points())


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


def fps_batched_cuda(points, n_samples: int, start: int = 0, n_valid=None):
    """Launch the loop kernel: float32 ``(B, N, 3)`` on a CUDA device, one
    block per cloud, N at most :data:`MAX_POINTS`."""
    batch, n, _ = points.shape
    if points.dtype != torch.float32:
        raise TypeError(f"fps needs float32 points on the card; got "
                        f"{points.dtype}")
    if n > MAX_POINTS:
        raise ValueError(f"the FPS kernel takes clouds of at most "
                         f"{MAX_POINTS} points; got {n}")
    if batch * n * 3 >= 2 ** 31:
        raise ValueError("fps indexes with 32-bit ints; the batch is too "
                         "large")
    points = points.contiguous()
    dev = points.device
    out = torch.empty((batch, n_samples), dtype=torch.int64, device=dev)
    if out.numel() == 0:
        return out
    nv = None
    if n_valid is not None:
        nv = torch.as_tensor(n_valid, device=dev).reshape(-1)
        nv = torch.clamp(nv, 0, n).to(torch.int32).expand(batch).contiguous()
    with torch.cuda.device(dev):
        err = _lib().fps_loop(points.data_ptr(),
                              None if nv is None else nv.data_ptr(),
                              out.data_ptr(), batch, n, n_samples, int(start),
                              _build.stream_of(points))
    if err:
        raise RuntimeError(f"fps launch failed: CUDA error {err}")
    LAUNCHES["fps"] += 1
    return out


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
