"""What the contract verifier (``repro_torch.analysis.trace``) reads of a
call that the dispatcher cannot show it.

The hand kernels are called through raw pointers, so no PyTorch op names
them, and the ``LAUNCHES`` counters move only where a CUDA kernel
launches. So each public kernel entry point records ``(name, out_shape,
dtype)`` into the innermost active :func:`recording`, on either branch
(kernel or plain version): the port's counterpart of the JAX package's
named ``pallas_call`` sites. :func:`launch_site` marks an entry point.
What runs inside one is the launch's interior (the reference's verifier
does not look into a ``pallas_call``'s kernel body either): the plain
versions' own ops, such as the crossbar products' exact float64
arithmetic on the CPU, are not the pipeline's, and a launch made inside
another (``reram_linear`` -> K6) is recorded once, by the outermost
site. Marking costs a counter and a list check per call.

:func:`as_captured` runs a call as a CUDA-graph capture would: the
host-side checks that a capture skips (the activations' NaN/Inf check,
:func:`~.program.require_finite`) are skipped too, on any device, as the
reference's cannot raise on a traced value.
"""
from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["as_captured", "capturing", "inside_launch", "launch_site",
           "recording"]

_LOGS: list[list] = []
_AS_CAPTURED = [0]
_DEPTH = [0]


def launch_site(name, *, output=None):
    """Decorator: the function is the public entry point of a kernel named
    ``name`` (or ``name(*args, **kwargs)`` where the name depends on the
    call); a call records ``(name, out_shape, dtype)`` of its result (of
    ``output(result)`` when given) into the active :func:`recording`."""
    def deco(fn):
        @functools.wraps(fn)
        def site(*args, **kwargs):
            outer = _DEPTH[0] == 0
            _DEPTH[0] += 1
            try:
                result = fn(*args, **kwargs)
            finally:
                _DEPTH[0] -= 1
            if outer and _LOGS:
                out = result if output is None else output(result)
                label = name if isinstance(name, str) else name(*args,
                                                                **kwargs)
                _LOGS[-1].append((label, tuple(out.shape), out.dtype))
            return result
        return site
    return deco


def inside_launch() -> bool:
    """True while a :func:`launch_site` entry point runs."""
    return _DEPTH[0] > 0


@contextlib.contextmanager
def recording():
    """Collect the launches recorded inside the block, in order, as
    ``(name, out_shape, dtype)`` tuples in the yielded list."""
    log: list = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


@contextlib.contextmanager
def as_captured():
    """Run the block as a capture would (see the module's docstring)."""
    _AS_CAPTURED[0] += 1
    try:
        yield
    finally:
        _AS_CAPTURED[0] -= 1


def capturing(x: torch.Tensor) -> bool:
    """True inside :func:`as_captured`, or while a CUDA graph is being
    captured on the current stream and ``x`` lies on the card."""
    return bool(_AS_CAPTURED[0]) or (
        x.is_cuda and torch.cuda.is_current_stream_capturing())
