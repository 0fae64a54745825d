"""Public wrapper of the SSD-scan kernel, in the model's layout.

Counterpart of ``repro.kernels.ssd_scan.ops.ssd_scan``, with its
signature and results.  The reference forms ``xdt = x * dt`` and
``dA = dt * A`` in float32 and moves heads before time outside its
``pallas_call``; here the Hopper kernel reads x, dt and A in the model's
layout through their strides and forms both itself, so a call launches
the scan's kernels and no elementwise pass.  A CPU tensor goes to the plain
chunked version (``models.mamba.ssd_chunked``, in float32), which takes
what the reference's wrapper takes; a CUDA tensor launches the kernel, and
anything the kernel does not take (dtype, head or state size, chunk,
layout, device) raises on it.  Nothing falls back.

``chunk=None`` consults the autotune cache (``repro_torch.perf.autotune``)
for the best-known chunk of this shape class, dtype and device, else takes
``DEFAULT_CHUNK``, and cuts it to the largest divisor of T, as the
reference does.  An explicit chunk wins.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ssd_scan import ssd_scan as _kernel
from repro_torch.models.mamba import ssd_chunked
from repro_torch.perf import autotune

DEFAULT_CHUNK = autotune.DEFAULTS["ssd_scan"]["chunk"]


def _largest_dividing_chunk(T: int, chunk: int) -> int:
    chunk = min(chunk, T)
    while T % chunk:
        chunk -= 1
    return chunk


def _check(x, dt, A, Bm, Cm, chunk: int) -> None:
    """The shapes, chunk and devices every call needs, as the reference's
    wrapper needs them; on a tensor that is not on the CPU also the
    kernel's own limits (dtypes, head and state sizes, longest chunk,
    layout).  A CPU tensor goes to the plain version."""
    if x.ndim != 4 or Bm.ndim != 3 or Bm.shape != Cm.shape:
        raise ValueError(f"ssd_scan: shapes {tuple(x.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(dt.shape) != (B, T, H) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape[:2]) != (B, T):
        raise ValueError("ssd_scan: x, dt, A, Bm and Cm disagree on batch, "
                         "time or heads")
    if chunk < 1 or T % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} must divide T={T}")
    if len({t.device for t in (x, dt, A, Bm, Cm)}) != 1:
        raise ValueError("ssd_scan: tensors on different devices")
    if x.device.type == "cpu":
        return
    if x.dtype not in _kernel._DTYPES or dt.dtype != torch.float32 \
            or A.dtype != torch.float32:
        raise ValueError(f"ssd_scan: x/dt/A dtype {x.dtype}/{dt.dtype}/"
                         f"{A.dtype} (x float32 or bfloat16, dt and A "
                         "float32)")
    if Bm.dtype != Cm.dtype or Bm.dtype not in _kernel._DTYPES:
        raise ValueError(f"ssd_scan: Bm/Cm dtype {Bm.dtype}/{Cm.dtype} "
                         "(float32 or bfloat16, both alike)")
    if P not in _kernel.HEAD_DIMS or N not in _kernel.STATE_SIZES:
        raise ValueError(f"ssd_scan: head_dim {P} / state size {N} (head_dim "
                         f"in {_kernel.HEAD_DIMS}, state in "
                         f"{_kernel.STATE_SIZES})")
    if chunk > _kernel.MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} must be at most "
                         f"{_kernel.MAX_CHUNK}")
    if Bm.stride(-1) != 1 or Cm.stride(-1) != 1 or x.stride(-1) != 1 \
            or not A.is_contiguous():
        raise ValueError("ssd_scan: x, Bm and Cm need a contiguous last dim "
                         "and A must be contiguous")


def ssd_scan(
    x: torch.Tensor,      # (B, T, H, P)
    dt: torch.Tensor,     # (B, T, H)  (already softplus'd)
    A: torch.Tensor,      # (H,) negative reals
    Bm: torch.Tensor,     # (B, T, N)
    Cm: torch.Tensor,     # (B, T, N)
    *,
    chunk: Optional[int] = None,
) -> tuple:
    """Returns (y (B,T,H,P) f32, final_state (B,H,P,N) f32), from a zero
    initial state."""
    _, T, H, P = x.shape
    if chunk is None:
        cfg = autotune.lookup("ssd_scan", x.dtype, device=x.device, H=H, P=P,
                              N=Bm.shape[-1], T=T)
        chunk = _largest_dividing_chunk(
            T, cfg["chunk"] if cfg else DEFAULT_CHUNK)
    chunk = min(chunk, T)
    _check(x, dt, A, Bm, Cm, chunk)
    if x.device.type == "cpu":
        return ssd_chunked(x.float(), dt.float(), A.float(), Bm, Cm, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    return _kernel.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
