"""Mean over the window's served requests of the wait from the due time
to the start of the ``ServingEngine.step`` that serves the request (the
harness's spans)."""


def read(ctx):
    w = ctx.queue_wait_s
    return 1e3 * float(w.mean()) if len(w) else None
