"""executor.window_misses: bucket-cache misses inside the window
(``RealExecutor.cache_stats``): the captures the window paid for, 0 when
set-up warmed every bucket the controller reaches."""


def read(ctx):
    return float(sum(s.misses for s in ctx.steps))
