"""Seconds from the process's start until the window opens: imports, the
weights, the engine and its page pools, the kernels' build or load, the
warm requests and the preamble."""


def read(ctx):
    return ctx.setup_s
