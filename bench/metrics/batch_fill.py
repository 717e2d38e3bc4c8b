"""Requests a served batch: ``PointCloudServable.stats()``'s ``requests``
over ``batches``, the program's own counters, read at the window's
ends."""


def read(ctx):
    b = ctx.counters.get("batches", 0)
    return ctx.counters["requests"] / b if b else None
