"""Set-up: process start to the first timed step (host clock): imports,
the kernels' libraries (built on a checkout's first run), weights and
inputs from the seed, ``compile_model``, and the warm-up and capture of
the cell's own shapes."""


def read(ctx):
    return ctx.setup_s
