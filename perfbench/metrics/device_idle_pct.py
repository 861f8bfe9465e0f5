"""Share, in percent, of an unprofiled window step in which no kernel runs:
the whole traced steps' busy time (the union of the kernels each forward
launched) over what the same steps take unprofiled, each at the mean wall
time of the window's steps of its kind (with a prefill chunk or without).
A step is whole when the trace holds a device record for every launch it
made (``harness.read_events``).  Also read as ``device_idle_pct.prefill``
in a cell whose steps are bound by prefill."""
from perfbench import yardstick


def read(ctx):
    if ctx.trace is None or not ctx.trace["steps"] or not ctx.steps:
        return None
    return yardstick.idle_pct(ctx.trace["step_busy_s"], ctx.trace["steps"],
                              ctx.steps)
