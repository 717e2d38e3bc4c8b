"""The port's host-side core: the PointNet++ workload description and the
Algorithm-1 planner (NumPy), with :class:`DevicePlan` lowering plans into
torch tensors.

- ``workload`` : PointNet++ workload description (FPS/kNN geometry,
                 Table-1 configs) — the port's copy of ``repro.core.workload``
- ``schedule`` : Algorithm 1 — intra-layer reordering + inter-layer
                 coordination, host half; the serving tier's plan cache
                 and frame tracker
"""
from .workload import (PAPER_MODELS, PointNetConfig, PointNetWorkload,
                       SALayerSpec, farthest_point_sample_np, knn_np)
from .schedule import (DevicePlan, ExecutionPlan, FrameTracker,
                       GREEDY_DENSE_LIMIT, MODE_PRESETS, PlanCache,
                       build_plan, cloud_content_key, complete_order,
                       coordinate_layers, frame_fingerprint,
                       greedy_nn_order, inverse_permutation, morton_order)

__all__ = [
    "PAPER_MODELS", "PointNetConfig", "PointNetWorkload", "SALayerSpec",
    "farthest_point_sample_np", "knn_np",
    "DevicePlan", "ExecutionPlan", "FrameTracker", "GREEDY_DENSE_LIMIT",
    "MODE_PRESETS", "PlanCache", "build_plan", "cloud_content_key",
    "complete_order", "coordinate_layers", "frame_fingerprint",
    "greedy_nn_order", "inverse_permutation", "morton_order",
]
