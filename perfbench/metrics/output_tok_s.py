"""Output tokens emitted in the window over the window's seconds."""


def read(ctx):
    n = sum(1 for r in ctx.reqs.values() for t in r.emits
            if ctx.w0 <= t < ctx.w1)
    return n / (ctx.w1 - ctx.w0)
