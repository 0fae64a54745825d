"""Hopper SSD chunked scan: launcher for ``csrc/ssd_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan/ssd_scan.py::
ssd_scan_fwd``.  The CUDA source's header says what bounds it on the card
(float32 arithmetic on the CUDA cores) and what its design does about
that: one block per (batch, head) looping over the chunks in order with
the state in shared memory, the chunk tiled 64 x 64 below the diagonal
only, C and B streamed 16 state columns at a time.

Takes ``Bm``/``Cm`` through their strides (the model passes slices of the
convolution's output) and writes y and the final state as new tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0          # launches of the CUDA kernel since the last reset

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # of Bm / Cm
HEAD_DIMS = (32, 64)                               # P the source instantiates
STATE_SIZES = (16, 32, 64, 128)                    # N
MAX_CHUNK = 1024


def _lib():
    lib = build.library("ssd_scan")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_fwd.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I,
                                     P, P]
        lib.ssd_scan_fwd.restype = I
        lib._typed = True
    return lib


def ssd_scan_fwd(
    xdt: torch.Tensor,   # (B, H, T, P) float32 contiguous, CUDA
    dA: torch.Tensor,    # (B, H, T, 1) float32 contiguous
    Bm: torch.Tensor,    # (B, T, N), last dim contiguous
    Cm: torch.Tensor,    # (B, T, N)
    *,
    chunk: int,
) -> tuple:
    """Returns (y (B, H, T, P) f32, final_state (B, H, P, N) f32)."""
    global LAUNCHES
    B, H, T, P = xdt.shape
    N = Bm.shape[-1]
    y = torch.empty_like(xdt)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=xdt.device)
    strides = (ctypes.c_longlong * 4)(*Bm.stride()[:2], *Cm.stride()[:2])
    err = _lib().ssd_scan_fwd(
        xdt.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), state.data_ptr(), _DTYPES[Bm.dtype], B, H, T, P, N,
        chunk, strides, torch.cuda.current_stream(xdt.device).cuda_stream)
    build.check(err, "ssd_scan_fwd")
    LAUNCHES += 1
    return y, state
