"""repro_torch — the Pointer reproduction ported to PyTorch and CUDA.

PointNet++ inference on an NVIDIA H100, beside the JAX package ``repro``
(the reference, which this package never imports). The entry point mirrors
the reference's::

    import repro_torch
    from repro_torch.models.pointnet2 import init_params
    cfg = repro_torch.PAPER_MODELS["model1"]
    params = init_params(cfg, seed=0)
    model = repro_torch.compile_model(params, cfg, backend="reram-fused",
                                      schedule="pointer")
    logits = model.batched_forward(clouds)        # (B, N, 3) -> (B, 40)

The model runs on ``cuda`` unless ``device="cpu"`` is passed. On the card
the fused crossbar MLP and the plan-ordered gather run as hand-written
CUDA kernels (``repro_torch/csrc``), built with ``nvcc`` at first use; on
the CPU their plain torch versions run instead.

The serving tier (``repro_torch.launch``) batches requests into shape
buckets behind a FIFO or EDF scheduler and reuses plans through a
content-keyed :class:`PlanCache` and a :class:`FrameTracker`; on the card
each bucket shape replays one captured CUDA graph.

:class:`PlanPolicy` is the cost model behind the scheduling decisions (the
Hopper dataflow each fused MLP launches, the intra-layer order), and
``repro_torch.reliability`` injects ReRAM faults (:class:`FaultModel`)
and protects the crossbar programs with ECC.

Training runs on the 'float' backend under the 'baseline' schedule, as the
reference's does: ``repro_torch.optim`` (AdamW, its schedule and
clipping), ``repro_torch.checkpoint`` (the reference's checkpoint format)
and ``repro_torch.launch.fault`` (preemption, stragglers, retries);
``examples/train_pointnet_torch.py`` is the trainer. ``repro_torch.analysis``
holds :func:`verify_contracts`, which checks a compiled model's launch
contracts on one recorded call.
"""
from repro_torch.core.energy import RooflineParams
from repro_torch.core.policy import PlanPolicy
from repro_torch.core.schedule import (DevicePlan, ExecutionPlan,
                                       FrameTracker, MODE_PRESETS,
                                       PlanCache, build_plan,
                                       cloud_content_key, frame_fingerprint)
from repro_torch.core.workload import (PAPER_MODELS, PointNetConfig,
                                       PointNetWorkload)
from repro_torch.kernels import CrossbarProgram
from repro_torch.launch.serve import (EDFScheduler, FIFOScheduler,
                                      LMServable, PointCloudServable,
                                      Request, Scheduler, Servable,
                                      ServingEngine, ShapeBuckets,
                                      VirtualClock)
from repro_torch.models.backend import (Backend, CompiledModel,
                                        available_backends, compile_model,
                                        register_backend)
from repro_torch import analysis
from repro_torch import reliability
from repro_torch.analysis import verify_contracts
from repro_torch.reliability import FaultModel

#: the API version: the JAX package's, whose public names this one mirrors
__version__ = "0.10.0"

__all__ = [
    "Backend", "CompiledModel", "CrossbarProgram", "DevicePlan",
    "EDFScheduler", "ExecutionPlan", "FIFOScheduler", "FaultModel",
    "FrameTracker", "LMServable", "MODE_PRESETS", "PAPER_MODELS",
    "PlanCache",
    "PlanPolicy", "PointCloudServable", "PointNetConfig",
    "PointNetWorkload", "Request", "RooflineParams", "Scheduler",
    "Servable", "ServingEngine", "ShapeBuckets", "VirtualClock",
    "__version__", "analysis", "available_backends", "build_plan",
    "cloud_content_key", "compile_model", "frame_fingerprint",
    "register_backend", "reliability", "verify_contracts",
]
