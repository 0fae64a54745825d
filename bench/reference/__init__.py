"""Plain float32 PyTorch references of the benchmark's configurations,
written from the published descriptions.  They import nothing of the
program: they read the benchmark's own weights (``bench.weights``), laid
out as the served model takes them, and work everything else out again.
``forward(conf, params, tokens, positions, prec)`` gives float32 logits at
``positions``; ``prec="fp8"`` is the control, every product's operands
rounded to float8 e4m3 (``common.matmul``, ``common.einsum``)."""

import importlib


def module(conf: dict):
    """The reference of a configuration file's ``family``."""
    return importlib.import_module(f"bench.reference.{conf['family']}")
