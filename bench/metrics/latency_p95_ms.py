"""The 95th percentile of every request's latency in the window, from its
due time to its logits on the host; a request never served counts as
infinitely late."""
from benchlib.stats import nearest_rank


def read(ctx):
    return 1e3 * nearest_rank(ctx.latency_s, 95)
