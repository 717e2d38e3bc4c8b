"""Device time a batch of the geometry layer's kernels (FPS, the sorts of
kNN), from the profiler."""
from benchlib import manifest


def read(ctx):
    if ctx.trace_reading is None:
        return None
    t = ctx.trace_reading.seconds(manifest.kernel_table("geometry")
                                  ["patterns"])
    return 1e3 * t / ctx.batches if t > 0 else None
