"""The comparison that decides ``correct``.

The program's logits for a sample of what the window produced, drawn
from the seed, against the plain reference's logits of the same clouds
under the same float weights. The reference runs once the window has
closed and the program's state is freed.

Numbers compared, each with its limit:

- ``logit_gap``: over the sampled clouds, the largest
  ``max_j |program_j - reference_j| / max_j |reference_j|``; its limit is
  the configuration file's ``limits.logit_gap``;
- ``missing``: requests of the window that were never served; limit 0.
"""
from __future__ import annotations

import importlib.util

import torch

from .manifest import BENCH


def reference(config: dict):
    """The configuration's plain reference module
    (``bench/references/<reference>.py``)."""
    name = config["reference"]
    spec = importlib.util.spec_from_file_location(
        f"bench_reference_{name}", BENCH / "references" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def logit_gap(program_logits: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest per-cloud gap, relative to the cloud's largest
    reference logit (NaN where the program gave NaN)."""
    prog = program_logits.to(ref.device, torch.float32)
    gap = (prog - ref).abs().amax(dim=1)
    scale = torch.clamp_min(ref.abs().amax(dim=1), 1e-30)
    return float((gap / scale).amax())


def control_logits(config: dict, weights: dict, clouds: torch.Tensor):
    """The control in the program's place: the reference one precision
    below the configuration's (int4 for int8)."""
    return reference(config).logits(config, weights, clouds,
                                    bits=config["control_bits"])


def compare(config: dict, weights: dict, judged, missing: int) -> dict:
    """``{name: {"value", "limit"}}`` over ``judged``, a list of
    ``(clouds, program logits)``."""
    ref_mod = reference(config)
    gap = 0.0
    for clouds, prog in judged:
        ref = ref_mod.logits(config, weights, clouds,
                             bits=config["weight_bits"])
        g = logit_gap(prog, ref)
        gap = g if g != g else max(gap, g)   # NaN stays
        if gap != gap:
            break
    return {"logit_gap": {"value": gap,
                          "limit": config["limits"]["logit_gap"]},
            "missing": {"value": missing, "limit": 0}}


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
