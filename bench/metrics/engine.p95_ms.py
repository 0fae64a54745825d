"""engine.p95_ms: the 95th percentile of every request's latency in the
window, each request counted once at the host-clock time of the step that
served it (``serving/engine.py``'s loop, timed by the benchmark)."""


def read(ctx):
    return ctx.request_quantile(0.95) * 1e3
