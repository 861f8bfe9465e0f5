"""Model operations of every window step's real rows over the steps' wall
time at the card's published bf16 peak, in percent.  Also read as
``mfu_pct.prefill`` in a cell whose steps are bound by prefill."""
from perfbench import yardstick


def read(ctx):
    if ctx.peak is None or not ctx.steps:
        return None
    return yardstick.mfu_pct(ctx.kind, ctx.model, ctx.steps, ctx.peak)
