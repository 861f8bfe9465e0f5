"""Share, in percent, of the prompt tokens of requests admitted in the
window that the prefix cache served (``StepReport.prefix_hit_tokens``)."""


def read(ctx):
    admitted = [rid for s in ctx.steps for rid in s.admitted]
    prompt = sum(ctx.reqs[rid].src.tokens.size for rid in admitted)
    if not prompt:
        return None
    return 100.0 * sum(s.prefix_hit for s in ctx.steps) / prompt
