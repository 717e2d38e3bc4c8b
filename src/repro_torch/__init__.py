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
"""
from repro_torch.core.schedule import (DevicePlan, ExecutionPlan,
                                       MODE_PRESETS, build_plan)
from repro_torch.core.workload import PAPER_MODELS
from repro_torch.models.backend import (CompiledModel, available_backends,
                                        compile_model, register_backend)

__all__ = [
    "CompiledModel", "DevicePlan", "ExecutionPlan", "MODE_PRESETS",
    "PAPER_MODELS", "available_backends", "build_plan", "compile_model",
    "register_backend",
]
