"""Host time of each ``ServingEngine.step`` to its return, before the
synchronize (the harness's spans), mean over steps."""


def read(ctx):
    d = ctx.spans.durations("bench.step")
    return 1e3 * sum(d) / len(d) if d else None
