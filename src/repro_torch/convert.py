"""Weights from the JAX package's parameter layouts into the port's.

The JAX package's ``init_params`` returns a pytree
``{"sa": [[{"w", "b"}, …], …], "head": […]}`` of device arrays, and its
``lm.init`` a tree of dicts of arrays. Pulled to NumPy (``np.asarray`` on
each leaf, or ``jax.device_get`` on the tree), each becomes the port's
parameters here, so both packages run the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["lm_params_from_numpy", "params_from_numpy"]


def _layer(lyr) -> dict:
    return {k: torch.from_numpy(np.array(lyr[k], dtype=np.float32))
            for k in ("w", "b")}


def params_from_numpy(params) -> dict:
    """``{"sa": [[{"w", "b"}, …], …], "head": […]}`` of array-likes ->
    the same layout of CPU float32 tensors (copies)."""
    return {"sa": [[_layer(l) for l in mlp] for mlp in params["sa"]],
            "head": [_layer(l) for l in params["head"]]}


def _lm_leaf(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # an ml_dtypes array, which torch.from_numpy refuses: its bits,
        # viewed as bfloat16 again on the torch side (bit for bit)
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device=device)
    t = torch.from_numpy(a.copy())
    if a.dtype == np.float32:
        return t.to(device=device)
    return t.to(device=device, dtype=dtype)


def lm_params_from_numpy(tree, cfg, device=None) -> dict:
    """The JAX package's ``lm.init`` tree, pulled to NumPy, as the port's
    LM params (``repro_torch.models.lm``): the same dicts, leaf for leaf, on
    ``device`` (the card unless ``device="cpu"``). A bfloat16 or float32
    leaf keeps its dtype, as the reference holds it: a bf16 model keeps
    its router, decays and RWKV ``u`` in float32. Any other leaf (a NumPy
    float64, say) takes the config's dtype."""
    from repro_torch.models.backend import resolve_device
    from repro_torch.optim.optimizer import tree_map
    dev = resolve_device(device)
    return tree_map(lambda a: _lm_leaf(a, cfg.jdtype, dev), tree)
