"""Hand-written Hopper kernels of the port, each beside its plain version.

- ``program``   : CrossbarProgram — weights quantized + plane-encoded once
                  at program time; the fused kernel's launch geometry
- ``fused_mlp`` : K1, the whole crossbar MLP, one launch per layer
                  (``csrc/fused_mlp.cu``)
- ``aggregate`` : K4/K5, the plan-ordered neighbor gather + difference
                  (``csrc/aggregate.cu``)
- ``_build``    : nvcc build at first use + ctypes binding

Every wrapper runs its plain torch version on CPU tensors and launches its
kernel on CUDA tensors; :func:`launch_counts` reads the kernel launch
counters, :func:`reset_launch_counts` zeroes them.
"""
from . import aggregate, fused_mlp
from .aggregate import aggregate_diff, aggregate_diff_batched
from .fused_mlp import reram_mlp_fused, reram_mlp_fused_batched
from .program import (CrossbarProgram, LaunchGeometry, build_program,
                      encode_planes, plan_launch, quantize_tensor)
from .ref import combine_planes

__all__ = [
    "CrossbarProgram", "LaunchGeometry", "aggregate_diff",
    "aggregate_diff_batched", "build_program", "combine_planes",
    "encode_planes", "launch_counts", "plan_launch", "quantize_tensor",
    "reram_mlp_fused", "reram_mlp_fused_batched", "reset_launch_counts",
]

#: The CUDA sources of the kernels (``csrc/<name>.cu``).
KERNEL_SOURCES = ("fused_mlp", "aggregate")


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by counter."""
    return {"fused_mlp": fused_mlp.LAUNCHES["mlp"],
            "fused_mlp_layer": fused_mlp.LAUNCHES["layer"],
            "aggregate_diff": aggregate.LAUNCHES["aggregate_diff"],
            "aggregate_diff_batched":
                aggregate.LAUNCHES["aggregate_diff_batched"]}


def reset_launch_counts() -> None:
    for counts in (fused_mlp.LAUNCHES, aggregate.LAUNCHES):
        for key in counts:
            counts[key] = 0
