"""The whole step's share of the card's int8 peak: 2 operations a
multiply-add, the model's multiply-adds a cloud counted from the
configuration's shapes, times the clouds completed, over the window."""
from benchlib import work


def read(ctx):
    ops = 2 * work.macs_per_cloud(ctx.config) * ctx.clouds
    return 100.0 * ops / ctx.window_s / work.INT8_OPS_PER_S
