"""Clouds whose logits completed in the window, over the window's seconds
(host clock, from the first call to the end of the last)."""


def read(ctx):
    return ctx.clouds / ctx.window_s
