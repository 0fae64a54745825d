"""PyTorch / CUDA port of the DNNScaler reproduction (``repro``).

Module names mirror the JAX package: ``repro_torch.models.api`` is the
counterpart of ``repro.models.api`` and so on.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; without a GPU they
raise instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU.  A CUDA device with no GPU present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the plain PyTorch path on the CPU")
    return dev
