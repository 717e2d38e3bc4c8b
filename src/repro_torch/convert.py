"""Weights from the JAX package's parameter layout into the port's.

The JAX package's ``init_params`` returns a pytree
``{"sa": [[{"w", "b"}, …], …], "head": […]}`` of device arrays. Pulled to
NumPy (``np.asarray`` on each leaf, or ``jax.device_get`` on the tree), it
becomes the port's parameters here, so both packages run the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy"]


def _layer(lyr) -> dict:
    return {k: torch.from_numpy(np.array(lyr[k], dtype=np.float32))
            for k in ("w", "b")}


def params_from_numpy(params) -> dict:
    """``{"sa": [[{"w", "b"}, …], …], "head": […]}`` of array-likes ->
    the same layout of CPU float32 tensors (copies)."""
    return {"sa": [[_layer(l) for l in mlp] for mlp in params["sa"]],
            "head": [_layer(l) for l in params["head"]]}
