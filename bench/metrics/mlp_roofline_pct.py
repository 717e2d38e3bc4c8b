"""The fused MLP's share of its roofline: the least time of the window's
MLP calls (``work.mlp_least_seconds``) over the device time of the
kernels in the fused MLP's name table."""
from benchlib import manifest, work


def read(ctx):
    if ctx.trace_reading is None:
        return None
    t = ctx.trace_reading.seconds(manifest.kernel_table("fused_mlp")
                                  ["patterns"])
    if t <= 0:
        return None
    least = work.mlp_least_seconds(ctx.config, ctx.traffic["batch"])
    return 100.0 * least * ctx.batches / t
