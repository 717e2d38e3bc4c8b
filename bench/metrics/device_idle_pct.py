"""Share of the traced window in which no kernel, copy or set ran on the
device (the union of the profiler's device intervals). Serves every
``device_idle_pct.<split>`` name: the splits differ by the end-to-end
metric they move, not by how they are read."""


def read(ctx):
    t = ctx.trace_reading
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)
