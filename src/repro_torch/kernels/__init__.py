"""Hand-written Hopper kernels of the port, each beside its plain version.

- ``program``   : CrossbarProgram — weights quantized + plane-encoded once
                  at program time; the TPU's dataflow choice
                  (``plan_fused_mlp``), the kernels' launch geometry and
                  what a call moves, computes and launches (the cost
                  model's inputs)
- ``fused_mlp`` : the whole crossbar MLP, one launch per layer, in three
                  dataflows: K1 'whole'/'tiled' (``csrc/fused_mlp.cu``),
                  K2 'mtiled' (``csrc/fused_mlp_mtiled.cu``), K3 'wstat'
                  (``csrc/fused_mlp_wstat.cu``); all on the tensor cores
                  after an s8 weight pre-pass (``combine_weights`` in
                  ``csrc/fused_mlp.cu``)
- ``reram_mlp`` : K6, one bit-sliced INT8 crossbar matmul on the tensor
                  cores after its own s8 pre-pass (``csrc/reram_mlp.cu``);
                  ``ops.reram_linear`` is the float layer over it
- ``aggregate`` : K4/K5, the plan-ordered neighbor gather + difference
                  (``csrc/aggregate.cu``), composing the plan order with
                  the index-order indices itself
- ``plan_order``: P1 and P2, the plan's greedy order and coordination walk
                  (``csrc/plan.cu``; Algorithm 1 on the card)
- ``fps_update``: K7, farthest point sampling (``csrc/fps.cu``): one
                  relaxation step (``fps_update``), and the whole sampling
                  loop in one launch (``fps_batched``; ``ops.fps`` is one
                  cloud)
- ``ops``       : ``reram_linear``, ``fps``, ``count_dma_elisions``
- ``_build``    : nvcc build at first use + ctypes binding

Every wrapper runs its plain torch version on CPU tensors and launches its
kernel on CUDA tensors; :func:`launch_counts` reads the kernel launch
counters, :func:`reset_launch_counts` zeroes them.
"""
from . import (aggregate, fps_update as _fps_update, fused_mlp, plan_order,
               reram_mlp)
from .aggregate import aggregate_diff, aggregate_diff_batched
from .fps_update import fps_batched, fps_update
from .fused_mlp import reram_mlp_fused, reram_mlp_fused_batched
from .ops import count_dma_elisions, fps, reram_linear
from .plan_order import plan_coordinate, plan_greedy
from .program import (FUSED_MODES, CrossbarProgram, FusedPlan,
                      LaunchGeometry, LaunchWork, build_program,
                      encode_planes, fused_vmem_bytes, launch_bytes,
                      launch_count, launch_work, plan_fused_mlp,
                      plan_launch, quantize_tensor)
from .ref import combine_planes, ref_fps_update, ref_reram_matmul_int
from .reram_mlp import reram_matmul_int

__all__ = [
    "FUSED_MODES", "CrossbarProgram", "FusedPlan", "LaunchGeometry",
    "LaunchWork",
    "aggregate_diff", "aggregate_diff_batched", "build_program",
    "combine_planes", "count_dma_elisions", "encode_planes", "fps",
    "fps_batched", "fps_update", "fused_vmem_bytes", "launch_bytes",
    "launch_count", "launch_counts", "launch_work",
    "plan_coordinate", "plan_fused_mlp", "plan_greedy", "plan_launch",
    "quantize_tensor", "ref_fps_update",
    "ref_reram_matmul_int", "reram_linear", "reram_matmul_int",
    "reram_mlp_fused", "reram_mlp_fused_batched", "reset_launch_counts",
]

#: The CUDA sources of the kernels (``csrc/<name>.cu``).
KERNEL_SOURCES = ("fused_mlp", "fused_mlp_mtiled", "fused_mlp_wstat",
                  "reram_mlp", "aggregate", "fps", "plan")


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by counter: per fused-MLP
    kernel its MLP calls and its layers, the s8 weight pre-pass of K1, K2
    and K3 (``fused_mlp_combine``), the gathers' launches, K6's products
    and its pre-pass (``reram_combine``), K7's (``fps_update`` the
    single steps, ``fps`` the whole loops), and P1's and P2's
    (``plan_greedy``, ``plan_coordinate``)."""
    f = fused_mlp.LAUNCHES
    return {"fused_mlp": f["mlp"], "fused_mlp_layer": f["layer"],
            "fused_mlp_mtiled": f["mtiled"],
            "fused_mlp_mtiled_layer": f["mtiled_layer"],
            "fused_mlp_wstat": f["wstat"],
            "fused_mlp_wstat_layer": f["wstat_layer"],
            "fused_mlp_combine": f["combine"],
            "aggregate_diff": aggregate.LAUNCHES["aggregate_diff"],
            "aggregate_diff_batched":
                aggregate.LAUNCHES["aggregate_diff_batched"],
            "reram_matmul_int": reram_mlp.LAUNCHES["reram_matmul_int"],
            "reram_combine": reram_mlp.LAUNCHES["reram_combine"],
            "fps_update": _fps_update.LAUNCHES["fps_update"],
            "fps": _fps_update.LAUNCHES["fps"],
            "plan_greedy": plan_order.LAUNCHES["plan_greedy"],
            "plan_coordinate": plan_order.LAUNCHES["plan_coordinate"]}


def reset_launch_counts() -> None:
    for counts in (fused_mlp.LAUNCHES, aggregate.LAUNCHES,
                   reram_mlp.LAUNCHES, _fps_update.LAUNCHES,
                   plan_order.LAUNCHES):
        for key in counts:
            counts[key] = 0
