"""Median time to first token, in ms, over every request due in the
window, from when it was due (``Context.ttfts``: a request with no first
token when the window closes, or refused, enters at the close minus its
due time)."""
from perfbench.stats import percentile


def read(ctx):
    vals = ctx.ttfts()
    return 1e3 * percentile(vals, 50) if vals else None
