"""device.idle_share: 1 - (the union of the device's activity / the traced
span from the first step's start to the last one's end), in %."""


def read(ctx):
    tr = ctx.trace
    if not tr.events:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.span_us)
