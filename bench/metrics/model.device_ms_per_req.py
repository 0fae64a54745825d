"""model.device_ms_per_req: device busy ms over the traced steps (the
union of every device activity between the first step's start and the
last one's end), per request they served (``models/api.py::generate``
and below)."""


def read(ctx):
    tr = ctx.trace
    if not tr.events:
        return None
    return tr.busy_us / 1e3 / sum(s.items for s in tr.steps)
