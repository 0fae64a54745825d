"""controller.host_ms: host-clock ms a step spends in the controller's
``set_slo``, ``action`` and ``observe`` (``core/controller.py``), timed by
the benchmark around each call."""


def read(ctx):
    return ctx.controller_s / len(ctx.steps) * 1e3
