"""engine.attainment: the share of the window's requests whose step
returned within the cell's SLO, in %."""


def read(ctx):
    return 100.0 * ctx.good / ctx.requests
