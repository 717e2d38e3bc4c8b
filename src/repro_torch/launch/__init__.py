"""Launch-side tiers of the port: the serving engine (``serve``) over
point clouds and LMs, the counterpart of ``repro.launch.serve``; LM
training (``train``: the train state, the step captured on the card, the
sharded step, the fault-tolerant loop), the counterpart of
``repro.launch.train``; preemption and retries (``fault``); and the
distributed layer over ``torch.distributed``, one process per device:
meshes (``mesh``), sharding rules and placements (``sharding``),
collectives (``collectives``), tensor parallelism and the sharded step's
per-layer gathers (``tp``) and the GPipe schedule (``pipeline``).

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
from repro_torch.launch.mesh import (MESH_AXES, batch_axes,
                                     make_production_mesh, make_replica_mesh,
                                     make_test_mesh)
from repro_torch.launch.serve import (EDFScheduler, FIFOScheduler,
                                      LMServable, PointCloudServable,
                                      Request, SCHEDULERS, Scheduler,
                                      Servable, ServingEngine, ShapeBuckets,
                                      VirtualClock, generate,
                                      make_serve_step)
from repro_torch.launch.sharding import (cache_pspecs, input_pspecs,
                                         named_shardings, param_pspecs,
                                         replica_pspecs, shard_batch,
                                         state_pspecs)
from repro_torch.launch.train import (TrainLoopConfig, init_train_state,
                                      make_train_step, run_training)

__all__ = [
    "EDFScheduler",
    "FIFOScheduler",
    "LMServable",
    "MESH_AXES",
    "PointCloudServable",
    "Request",
    "SCHEDULERS",
    "Scheduler",
    "Servable",
    "ServingEngine",
    "ShapeBuckets",
    "TrainLoopConfig",
    "VirtualClock",
    "batch_axes",
    "cache_pspecs",
    "generate",
    "init_train_state",
    "input_pspecs",
    "make_production_mesh",
    "make_replica_mesh",
    "make_serve_step",
    "make_test_mesh",
    "make_train_step",
    "named_shardings",
    "param_pspecs",
    "replica_pspecs",
    "run_training",
    "shard_batch",
    "state_pspecs",
]
