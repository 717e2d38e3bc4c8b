"""Synthetic ModelNet40-like point-cloud dataset (NumPy only).

The port's copy of ``repro.data.pointcloud``: the same generators, so the
same seeds give the same arrays, bit for bit (tested).

ModelNet40 itself is not bundled with the repository; we generate a
40-class dataset of parametric *surfaces* with matched statistics (1024
points per cloud, unit-scale objects, CAD-like 2-manifold geometry — the
property the paper's locality optimizations exploit). Classes are
(primitive x deformation) combinations so that classification is learnable
but not trivial. A loader hook (``PointCloudDataset.from_modelnet40``)
accepts the real dataset when a path is provided.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["synthetic_cloud", "PointCloudDataset", "request_stream",
           "N_CLASSES"]

N_CLASSES = 40
_PRIMITIVES = 8     # x 5 deformation levels = 40 classes


def _unit_sphere(rng, n):
    p = rng.normal(size=(n, 3))
    return p / np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1e-9)


def _primitive(rng, prim: int, n: int) -> np.ndarray:
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(-1, 1, n)
    if prim == 0:      # sphere
        return _unit_sphere(rng, n)
    if prim == 1:      # ellipsoid
        return _unit_sphere(rng, n) * np.array([1.0, 0.6, 0.35])
    if prim == 2:      # cylinder (side + caps)
        side = np.stack([np.cos(u), np.sin(u), v], axis=1)
        ncap = n // 5
        r = np.sqrt(rng.uniform(0, 1, ncap))
        a = rng.uniform(0, 2 * np.pi, ncap)
        caps = np.stack([r * np.cos(a), r * np.sin(a),
                         np.sign(rng.uniform(-1, 1, ncap))], axis=1)
        out = side
        out[:ncap] = caps
        return out
    if prim == 3:      # cone
        h = rng.uniform(0, 1, n)
        return np.stack([(1 - h) * np.cos(u), (1 - h) * np.sin(u),
                         2 * h - 1], axis=1)
    if prim == 4:      # torus
        w = rng.uniform(0, 2 * np.pi, n)
        return np.stack([(1 + 0.35 * np.cos(w)) * np.cos(u),
                         (1 + 0.35 * np.cos(w)) * np.sin(u),
                         0.35 * np.sin(w)], axis=1) / 1.35
    if prim == 5:      # box surface
        face = rng.integers(0, 6, n)
        a = rng.uniform(-1, 1, n)
        b = rng.uniform(-1, 1, n)
        s = np.where(face % 2 == 0, 1.0, -1.0)
        out = np.empty((n, 3))
        ax = face // 2
        for d in range(3):
            m = ax == d
            cols = [c for c in range(3) if c != d]
            out[m, d] = s[m]
            out[m, cols[0]] = a[m]
            out[m, cols[1]] = b[m]
        return out
    if prim == 6:      # helix tube
        t = rng.uniform(-2, 2, n)
        jitter = 0.15 * _unit_sphere(rng, n)
        return (np.stack([np.cos(3 * t), np.sin(3 * t), t / 2], axis=1)
                + jitter) / 1.4
    # 7: two-sphere dumbbell
    p = _unit_sphere(rng, n) * 0.55
    p[:, 0] += np.sign(rng.uniform(-1, 1, n)) * 0.55
    return p


def synthetic_cloud(label: int, n_points: int = 1024,
                    seed: int = 0) -> np.ndarray:
    """One (n_points, 3) float32 cloud of class ``label`` in [0, 40)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, label]))
    prim, deform = label % _PRIMITIVES, label // _PRIMITIVES
    p = _primitive(rng, prim, n_points)
    # deformation level: twist + bump amplitude distinguish classes
    amp = 0.05 + 0.06 * deform
    p = p + amp * np.sin((2 + deform) * p[:, [1, 2, 0]])
    theta = 0.15 * deform * p[:, 2]
    rot = np.stack([np.cos(theta), -np.sin(theta)], axis=1)
    x = p[:, 0] * rot[:, 0] + p[:, 1] * rot[:, 1]
    y = p[:, 0] * -rot[:, 1] + p[:, 1] * rot[:, 0]
    p = np.stack([x, y, p[:, 2]], axis=1)
    p -= p.mean(axis=0, keepdims=True)
    p /= np.max(np.linalg.norm(p, axis=1))
    return p.astype(np.float32)


@dataclass
class PointCloudDataset:
    """Seeded, epoch-reshuffled synthetic dataset with a NumPy batch
    iterator (host-side)."""

    n_points: int = 1024
    n_clouds: int = 2048
    seed: int = 0

    def sample(self, idx: int) -> tuple[np.ndarray, int]:
        label = idx % N_CLASSES
        return synthetic_cloud(label, self.n_points,
                               seed=self.seed * 100003 + idx), label

    def batches(self, batch_size: int, n_batches: int, *, augment=True,
                seed: int | None = None):
        rng = np.random.default_rng(self.seed if seed is None else seed)
        for _ in range(n_batches):
            idx = rng.integers(0, self.n_clouds, batch_size)
            clouds = np.stack([self.sample(int(i))[0] for i in idx])
            labels = (idx % N_CLASSES).astype(np.int32)
            if augment:   # random rotation around z + jitter
                ang = rng.uniform(0, 2 * np.pi, batch_size)
                c, s = np.cos(ang), np.sin(ang)
                x = clouds[..., 0] * c[:, None] - clouds[..., 1] * s[:, None]
                y = clouds[..., 0] * s[:, None] + clouds[..., 1] * c[:, None]
                clouds = np.stack([x, y, clouds[..., 2]], axis=-1)
                clouds += rng.normal(0, 0.005, clouds.shape)
            yield clouds.astype(np.float32), labels

    @staticmethod
    def from_modelnet40(path: str):  # pragma: no cover - needs real data
        raise NotImplementedError(
            "ModelNet40 is not bundled: drop its .npz files under "
            f"{path} and implement the trivial loader here")


def request_stream(n_requests: int, *, rate_hz: float = 200.0,
                   n_points=(1024,), pool: int = 8,
                   repeat_p: float = 0.7, seed: int = 0,
                   mode: str = "pool", drift: float = 2e-5,
                   jitter: float = 5e-6):
    """Timed request arrivals for the serving tier: yields ``n_requests``
    tuples ``(t_arrival, cloud, label)``.

    ``mode="pool"`` (default): Poisson arrivals at ``rate_hz``
    (exponential inter-arrival gaps) drawn from a ``pool`` of distinct
    synthetic clouds; each request repeats an already-seen pool member
    with probability ``repeat_p`` — the temporally-coherent stream of the
    paper's driving setting (consecutive sweeps see the same objects),
    and exactly what the content-keyed plan cache exploits: a repeated
    cloud is a guaranteed cache hit, so a stream at ``repeat_p > 0``
    measures hit-rate > 0. Pool members draw their point count from
    ``n_points`` (cycled), so a multi-bucket stream exercises bucketed
    batching too.

    ``mode="lidar"``: one periodic sensor at ``rate_hz`` frames/s —
    arrivals at ``f / rate_hz`` and the third tuple element is the frame
    index, not a label. Each frame is the SAME scene evolved slightly: a
    ``pool`` of object clusters (scaled synthetic clouds at fixed
    centers) whose centers translate by ``drift`` per frame along fixed
    per-cluster headings, plus i.i.d. per-point gaussian ``jitter`` per
    frame. Consecutive frames therefore differ by a bounded per-point
    displacement (~``drift + 3*jitter``) — never bitwise-equal (every
    frame defeats the exact-key plan cache) but within a
    :class:`~repro_torch.core.schedule.FrameTracker` tolerance, which is the
    reuse structure real LiDAR has and the frame-coherent fast path
    exists for. Frame point count is ``n_points[0]``; ``repeat_p`` is
    ignored."""
    if not 0.0 <= repeat_p <= 1.0:
        raise ValueError(f"repeat_p must be in [0, 1]; got {repeat_p}")
    if mode not in ("pool", "lidar"):
        raise ValueError(f"mode must be 'pool' or 'lidar'; got {mode!r}")
    rng = np.random.default_rng(seed)
    sizes = tuple(int(n) for n in n_points)

    if mode == "lidar":
        if drift < 0 or jitter < 0:
            raise ValueError("drift and jitter must be >= 0")
        n = sizes[0]
        per = n // pool
        counts = [per + (1 if i < n - per * pool else 0)
                  for i in range(pool)]
        clusters = [0.25 * synthetic_cloud(i % N_CLASSES, counts[i],
                                           seed=seed * 7919 + i)
                    for i in range(pool)]
        centers = rng.uniform(-0.7, 0.7, size=(pool, 3))
        heading = rng.normal(size=(pool, 3))
        heading /= np.maximum(
            np.linalg.norm(heading, axis=1, keepdims=True), 1e-9)
        for f in range(n_requests):
            shifted = [c + (centers[i] + f * drift * heading[i])
                       for i, c in enumerate(clusters)]
            cloud = np.concatenate(shifted, axis=0)
            if jitter > 0:
                cloud = cloud + rng.normal(0.0, jitter, cloud.shape)
            yield f / rate_hz, cloud.astype(np.float32), f
        return

    members = [synthetic_cloud(i % N_CLASSES, sizes[i % len(sizes)],
                               seed=seed * 7919 + i)
               for i in range(pool)]
    seen: list[int] = []
    t = 0.0
    for _ in range(n_requests):
        t += float(rng.exponential(1.0 / rate_hz))
        if seen and rng.uniform() < repeat_p:
            idx = int(seen[int(rng.integers(len(seen)))])
        else:
            idx = int(rng.integers(pool))
        seen.append(idx)
        yield t, members[idx], idx % N_CLASSES
