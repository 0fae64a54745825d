"""The Mamba2 SSD scan as a plain PyTorch recurrence.

``ssd_ref`` is the counterpart of ``repro.kernels.ssd_scan.ref.ssd_ref``:
the token-by-token recurrence, independent of any chunking,

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t B_t^T
    y_t = h_t . C_t

It runs in float32 and only the tests use it.  The kernel's plain chunked
version is ``repro_torch.models.mamba.ssd_chunked``: the wrapper runs it on
a CPU tensor, and ``chip_smoke.py`` holds the CUDA kernel against it.
"""

from __future__ import annotations

from typing import Optional

import torch


def ssd_ref(x, dt, A, Bm, Cm, init_state: Optional[torch.Tensor] = None):
    """x: (B,T,H,P); dt: (B,T,H); A: (H,); Bm/Cm: (B,T,N).

    Returns (y (B,T,H,P) f32, final_state (B,H,P,N) f32)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    x, dt, Bm, Cm = x.float(), dt.float(), Bm.float(), Cm.float()
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(T):
        dA = torch.exp(dt[:, t] * A)                             # (B,H)
        h = (h * dA[:, :, None, None]
             + torch.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], Bm[:, t]))
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h

