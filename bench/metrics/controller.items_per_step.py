"""controller.items_per_step: requests served over steps in the window,
where DNNScaler's Scaler (``core/scaler.py``) settled and how it got
there."""


def read(ctx):
    return ctx.requests / len(ctx.steps)
