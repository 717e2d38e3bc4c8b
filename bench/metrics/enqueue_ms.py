"""Host time of each ``jit_batched_forward`` call to its return (the
harness's span around it), all calls over their count."""


def read(ctx):
    d = ctx.spans.durations("bench.enqueue")
    return 1e3 * sum(d) / len(d) if d else None
