"""Launch-side tiers of the port: the point-cloud serving engine
(``serve``), the counterpart of ``repro.launch``'s point-cloud half.

>>> import numpy as np
>>> import repro_torch
>>> from repro_torch.core.workload import PointNetConfig, SALayerSpec
>>> from repro_torch.launch import (PointCloudServable, ServingEngine,
...                                 ShapeBuckets)
>>> from repro_torch.models.pointnet2 import init_params
>>> cfg = PointNetConfig(name="tiny", n_points=64, layers=(
...     SALayerSpec(n_centers=24, n_neighbors=4, in_features=4,
...                 mlp=(4, 8, 8, 16)),
...     SALayerSpec(n_centers=8, n_neighbors=4, in_features=16,
...                 mlp=(16, 16, 16, 32))))
>>> model = repro_torch.compile_model(init_params(cfg, seed=0, n_classes=10),
...                                   cfg, backend="reram-fused",
...                                   schedule="pointer", device="cpu")
>>> cloud = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
>>> eng = ServingEngine(PointCloudServable(
...     model, buckets=ShapeBuckets(points=(64,), batch=(1, 2))),
...     scheduler="edf", max_batch=1)
>>> slow = eng.submit(cloud, t=0.0, deadline_us=100_000)
>>> urgent = eng.submit(cloud * 0.5, t=0.0, deadline_us=1_000)
>>> [r.id for r in eng.drain()]                 # earliest deadline first
[1, 0]
"""
from repro_torch.launch.serve import (EDFScheduler, FIFOScheduler,
                                      PointCloudServable, Request,
                                      SCHEDULERS, Scheduler, Servable,
                                      ServingEngine, ShapeBuckets,
                                      VirtualClock)

__all__ = [
    "EDFScheduler",
    "FIFOScheduler",
    "PointCloudServable",
    "Request",
    "SCHEDULERS",
    "Scheduler",
    "Servable",
    "ServingEngine",
    "ShapeBuckets",
    "VirtualClock",
]
