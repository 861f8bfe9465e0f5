"""Share, in percent, of the requests due in the window (up to 200 ms
before its close) whose time to first token is within the mix's
``slo.ttft_ms`` and whose own mean gap between tokens is within
``slo.mean_gap_ms``.  A refused request misses; an unfinished one counts
its open gap up to the close."""


def read(ctx):
    ttft, gap = ctx.slo["ttft_ms"] / 1e3, ctx.slo["mean_gap_ms"] / 1e3
    reqs = ctx.window_requests(until=ctx.w1 - 0.2)
    if not reqs:
        return None
    met = 0
    for r in reqs:
        ts = [t for t in r.emits if t < ctx.w1]
        if r.refused or not ts or ts[0] - r.src.due > ttft:
            continue
        end = ts[-1] if r.finished is not None and r.finished < ctx.w1 \
            else ctx.w1
        n = len(ts) - 1 + (end > ts[-1])
        if n == 0 or (end - ts[0]) / n <= gap:
            met += 1
    return 100.0 * met / len(reqs)
