"""PointNet++ on the port: geometry and parameters (``pointnet2``) and the
execution entry point (``backend``: the backend registry and
``compile_model`` returning a ``CompiledModel``)."""
from repro_torch.models.backend import (Backend, CompiledModel,
                                        available_backends, compile_model,
                                        register_backend)

__all__ = [
    "Backend", "CompiledModel", "available_backends", "compile_model",
    "register_backend",
]
