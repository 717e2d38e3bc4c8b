"""PointNet++ workload description for the Pointer accelerator model.

This module is deliberately NumPy-only: it is the host-side view of the
workload that the paper's "order generator" hardware unit would see (point
coordinates, FPS-selected centers, neighbor lists). The torch model in
``repro_torch.models.pointnet2`` implements the same geometry on-device;
tests cross-check the two implementations. This file is the port's own
copy of the JAX package's ``repro.core.workload``, kept identical in
behaviour so the port imports nothing of that package.

Terminology follows the paper:
  - layer 0 is the input point cloud (1024 points in the paper's models),
  - layer k (k >= 1) is the output of the k-th set-abstraction (SA) layer,
  - ``centers[k][i]`` is the index *into layer k-1's point set* of the i-th
    output point of layer k (FPS selects a subset),
  - ``neighbors[k][i]`` are the K nearest layer-(k-1) points of that center
    (the receptive field of one SA step),
  - features of layer k-1 are fetched per neighbor during aggregation; this
    fetch is the DRAM-traffic bottleneck the paper attacks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

__all__ = [
    "SALayerSpec",
    "PointNetConfig",
    "PointNetWorkload",
    "farthest_point_sample_np",
    "knn_np",
    "PAPER_MODELS",
]


@dataclass(frozen=True)
class SALayerSpec:
    """One set-abstraction layer (paper Table 1)."""

    n_centers: int                 # "The Number of Central Point"
    n_neighbors: int               # "The Number of Neighbors" (K)
    in_features: int               # input feature vector length
    mlp: tuple[int, ...]           # widths, e.g. (4, 64, 64, 128) = 3 matmuls
    # ``mlp[0]`` must equal ``in_features``; ``mlp[-1]`` is the output length.

    @property
    def out_features(self) -> int:
        return self.mlp[-1]

    @property
    def mlp_shapes(self) -> tuple[tuple[int, int], ...]:
        return tuple(zip(self.mlp[:-1], self.mlp[1:]))

    @property
    def weights(self) -> int:
        return sum(n * m for n, m in self.mlp_shapes)

    @property
    def macs_per_vector(self) -> int:
        return self.weights


@dataclass(frozen=True)
class PointNetConfig:
    name: str
    n_points: int
    layers: tuple[SALayerSpec, ...]

    @property
    def n_layers(self) -> int:
        return len(self.layers)


def _paper_model(name: str, f0: int, w1: int, w2: int) -> PointNetConfig:
    """Paper Table 1 models. f0 in {4,8,16}; w1/w2 are layer-1/2 base widths.

    Note: Table 1 lists Model 0's layer-2 "Input Feature Vector Length" as
    129, which is inconsistent with its own MLP shape (128*128). We follow
    the MLP shape (the authoritative one for both compute and fetch traffic).
    """
    return PointNetConfig(
        name=name,
        n_points=1024,
        layers=(
            SALayerSpec(
                n_centers=512, n_neighbors=16, in_features=f0,
                mlp=(f0, w1, w1, 2 * w1),
            ),
            SALayerSpec(
                n_centers=128, n_neighbors=16, in_features=2 * w1,
                mlp=(2 * w1, w2, w2, 2 * w2),
            ),
        ),
    )


#: The three PointNet++ configurations evaluated in the paper (Table 1).
PAPER_MODELS: dict[str, PointNetConfig] = {
    "model0": _paper_model("model0", f0=4, w1=64, w2=128),
    "model1": _paper_model("model1", f0=8, w1=128, w2=256),
    "model2": _paper_model("model2", f0=16, w1=256, w2=512),
}


def farthest_point_sample_np(points: np.ndarray, n_samples: int,
                             start: int = 0) -> np.ndarray:
    """Classic FPS. ``points``: (N, 3). Returns indices (n_samples,).

    Deterministic given ``start``. O(N * n_samples).
    """
    n = points.shape[0]
    if n_samples > n:
        raise ValueError(f"n_samples {n_samples} > n points {n}")
    idx = np.empty(n_samples, dtype=np.int64)
    dist = np.full(n, np.inf)
    cur = int(start)
    for i in range(n_samples):
        idx[i] = cur
        d = np.sum((points - points[cur]) ** 2, axis=1)
        dist = np.minimum(dist, d)
        cur = int(np.argmax(dist))
    return idx


def knn_np(queries: np.ndarray, points: np.ndarray, k: int) -> np.ndarray:
    """Indices (Q, k) of the k nearest ``points`` for each query (includes
    the query itself when it is a member of ``points``)."""
    d = np.sum((queries[:, None, :] - points[None, :, :]) ** 2, axis=-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


@dataclass
class PointNetWorkload:
    """A concrete (point cloud x config) instance: everything the scheduler
    and the simulator need.

    points[k]   : (n_k, 3) coordinates of layer-k point set (k = 0..L)
    centers[k]  : (n_k,)  index into layer k-1 of each layer-k point (k>=1)
    neighbors[k]: (n_k, K) indices into layer k-1 (the receptive field)
    """

    config: PointNetConfig
    points: list[np.ndarray]
    centers: list[np.ndarray | None]
    neighbors: list[np.ndarray | None]

    @classmethod
    def build(cls, cloud: np.ndarray, config: PointNetConfig) -> "PointNetWorkload":
        if cloud.shape[0] != config.n_points:
            raise ValueError(
                f"cloud has {cloud.shape[0]} points, config wants {config.n_points}")
        points: list[np.ndarray] = [np.asarray(cloud, dtype=np.float64)]
        centers: list[np.ndarray | None] = [None]
        neighbors: list[np.ndarray | None] = [None]
        for spec in config.layers:
            prev = points[-1]
            c = farthest_point_sample_np(prev, spec.n_centers)
            nb = knn_np(prev[c], prev, spec.n_neighbors)
            points.append(prev[c])
            centers.append(c)
            neighbors.append(nb)
        return cls(config=config, points=points, centers=centers,
                   neighbors=neighbors)

    @classmethod
    def random(cls, config: PointNetConfig, seed: int = 0,
               kind: str = "surface") -> "PointNetWorkload":
        """Random workload. ``kind='surface'`` (default) samples a deformed
        ellipsoid surface — ModelNet40 clouds are sampled from CAD mesh
        *surfaces*, and surface (2-manifold) geometry is what gives
        receptive fields their strong overlap; volume sampling ('ball') is
        kept as a pessimistic stress case."""
        rng = np.random.default_rng(seed)
        cloud = rng.normal(size=(config.n_points, 3))
        cloud /= np.maximum(np.linalg.norm(cloud, axis=1, keepdims=True), 1e-9)
        if kind == "surface":
            cloud *= rng.uniform(np.array([[0.4, 0.3, 0.2]]),
                                 np.array([[1.0, 0.8, 0.6]]))
            cloud += 0.1 * np.sin(5.0 * cloud[:, [1, 2, 0]])
        elif kind == "ball":
            cloud *= rng.uniform(0.2, 1.0, size=(config.n_points, 1))
        else:
            raise ValueError(f"unknown cloud kind {kind!r}")
        return cls.build(cloud, config)

    @property
    def n_layers(self) -> int:
        return self.config.n_layers

    def receptive_field(self, layer: int, i: int) -> np.ndarray:
        """Direct (one-level) receptive field of point i of layer ``layer``:
        the layer-(layer-1) indices it aggregates over."""
        return self.neighbors[layer][i]

    def pyramid_receptive_field(self, layer: int, i: int) -> list[np.ndarray]:
        """Full pyramid receptive field (paper Fig. 4): for each lower layer
        j < layer, the set of layer-j point indices point (layer, i) depends
        on, outermost (layer-1) first."""
        fields: list[np.ndarray] = []
        frontier = np.asarray([i])
        for k in range(layer, 0, -1):
            members = np.unique(np.concatenate(
                [self.neighbors[k][int(p)] for p in frontier]))
            fields.append(members)
            frontier = members
        return fields
