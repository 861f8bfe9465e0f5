"""95th percentile, in ms, of every gap between consecutive output tokens
that ended in the window, across all requests."""
from perfbench.stats import percentile


def read(ctx):
    gaps = ctx.gaps()
    return 1e3 * percentile(gaps, 95) if gaps else None
