"""Share, in percent, of the window's ``engine.step()`` wall time outside
the step's device-synchronised forward (``StepReport.compute_s``): the
scheduler's planning, the packing, and the argmax and commit after it."""


def read(ctx):
    wall = sum(s.end - s.start for s in ctx.steps)
    if not wall:
        return None
    return 100.0 * (wall - sum(s.compute_s for s in ctx.steps)) / wall
