"""The port's host-side core: the PointNet++ workload description and the
Algorithm-1 planner (NumPy), with :class:`DevicePlan` lowering plans into
torch tensors.

- ``workload`` : PointNet++ workload description (FPS/kNN geometry,
                 Table-1 configs) — the port's copy of ``repro.core.workload``
- ``schedule`` : Algorithm 1 — intra-layer reordering + inter-layer
                 coordination, host half; the serving tier's plan cache
                 and frame tracker
- ``buffer``   : on-chip buffer models (FIFO / LRU / Belady oracle)
- ``reram``    : ReRAM crossbar functional + capacity model (NumPy)
- ``energy``   : the simulated accelerator's constants (``HWParams``) and
                 the card's roofline (``RooflineParams``, the H100's)
- ``policy``   : ``PlanPolicy``, the cost model of the scheduling decisions
- ``simulator``: the trace-driven cycle/energy simulator of the paper's
                 design points
"""
from .workload import (PAPER_MODELS, PointNetConfig, PointNetWorkload,
                       SALayerSpec, farthest_point_sample_np, knn_np)
from .schedule import (DevicePlan, ExecutionPlan, FrameTracker,
                       GREEDY_DENSE_LIMIT, MODE_PRESETS, PlanCache,
                       build_plan, cloud_content_key, complete_order,
                       coordinate_layers, frame_fingerprint,
                       greedy_nn_order, inverse_permutation, morton_order)
from .buffer import BeladyBuffer, BufferModel
from .energy import (DEFAULT_HW, DEFAULT_ROOFLINE, TPU_ROOFLINE, HWParams,
                     RooflineParams)
from .policy import DEFAULT_POLICY, PlanPolicy
from .reram import (CrossbarMapping, bit_slice, crossbar_matmul,
                    map_mlp_to_arrays, quantize_weights)
from .simulator import DESIGN_POINTS, SimResult, run_design, simulate

__all__ = [
    "PAPER_MODELS", "PointNetConfig", "PointNetWorkload", "SALayerSpec",
    "farthest_point_sample_np", "knn_np",
    "DevicePlan", "ExecutionPlan", "FrameTracker", "GREEDY_DENSE_LIMIT",
    "MODE_PRESETS", "PlanCache", "build_plan", "cloud_content_key",
    "complete_order", "coordinate_layers", "frame_fingerprint",
    "greedy_nn_order", "inverse_permutation", "morton_order",
    "BeladyBuffer", "BufferModel",
    "DEFAULT_HW", "DEFAULT_ROOFLINE", "HWParams", "RooflineParams",
    "TPU_ROOFLINE",
    "DEFAULT_POLICY", "PlanPolicy",
    "CrossbarMapping", "bit_slice", "crossbar_matmul", "map_mlp_to_arrays",
    "quantize_weights",
    "DESIGN_POINTS", "SimResult", "run_design", "simulate",
]
