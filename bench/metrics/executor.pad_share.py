"""executor.pad_share: the rows the replays computed for no request,
(bucket rows - requests) over bucket rows, summed over the window's
steps, in % (``RealExecutor``'s bucket ladder)."""


def read(ctx):
    rows = sum(s.bucket for s in ctx.steps)
    return 100.0 * (rows - ctx.requests) / rows
