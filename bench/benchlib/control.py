"""The control: the reference, one precision below the configuration's,
put in the program's place, so that ``correct`` is shown to fail."""
from __future__ import annotations

import contextlib

import torch

from . import judge, program


class ControlModel:
    """What the timed path calls, answered by the reference at the
    configuration's ``control_bits``: the offline loop's and the serving
    tier's ``jit_batched_forward``."""

    planned = True
    device_plan = None
    device_planning = True

    def __init__(self, config: dict, weights: dict, device):
        self.config, self.weights = config, weights
        self.device = torch.device(device)

    def jit_batched_forward(self, clouds, *, n_valid=None, dplan=None):
        x = torch.as_tensor(clouds, dtype=torch.float32, device=self.device)
        return judge.control_logits(self.config, self.weights, x)


@contextlib.contextmanager
def in_place_of_the_program():
    """Within the block, every model the harness builds is the control."""
    build = program.build_model
    program.build_model = ControlModel
    try:
        yield
    finally:
        program.build_model = build


def _half_batch(out):
    """Half of the batch left out, the mean of the rest in its place."""
    kept = out[:max(out.shape[0] // 2, 1)]
    return torch.cat([kept, kept.mean(dim=0, keepdim=True)
                      .expand(out.shape[0] - kept.shape[0], -1)])


def _altered(out):
    """One answer altered where it is produced."""
    out = out.clone()
    out[0, 0] += out[0].abs().max()
    return out


#: faults planted under the timed path: each must make ``correct`` false
FAULTS = {"half_batch": _half_batch, "altered": _altered}


@contextlib.contextmanager
def planted(fault: str):
    """Within the block, every model the harness builds has ``fault`` in
    its ``jit_batched_forward``."""
    build = program.build_model

    def broken(*a, **k):
        model = build(*a, **k)
        step = model.jit_batched_forward
        model.jit_batched_forward = \
            lambda *x, **y: FAULTS[fault](step(*x, **y))
        return model

    program.build_model = broken
    try:
        yield
    finally:
        program.build_model = build
