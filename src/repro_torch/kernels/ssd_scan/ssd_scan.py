"""Hopper SSD chunked scan: launcher for ``csrc/ssd_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan/ssd_scan.py::
ssd_scan_fwd``, together with its wrapper's forming of ``xdt`` and ``dA``.
The CUDA source's header says what bounds it on the card and what its
design does about that: the standard SSD split in two launches (each
chunk's own state and C Bᵀ once per batch and chunk, the state carried
across the chunks by the last block of each batch and head; then the
output), every product on the tensor cores (bf16 C Bᵀ for bf16 B/C, TF32
with float32 operands split in two halves).

Takes x (B, T, H, P) in the model's dtype, dt (B, T, H) and A (H,) in
float32, and ``Bm``/``Cm`` (B, T, N), all through their strides (the model
passes slices of the convolution's output), and writes y (B, T, H, P) and
the final state as new float32 tensors.  ``LAUNCHES`` counts calls; each
call issues ``KERNELS_PER_CALL`` CUDA kernels.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.perf.roofline import BF16_FLOPS, TF32_FLOPS

LAUNCHES = 0          # calls that launched the kernels since the last reset

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # of x, and of Bm / Cm
HEAD_DIMS = (32, 64)                               # P the source instantiates
STATE_SIZES = (16, 32, 64, 128)                    # N
MAX_CHUNK = 1024
# the CUDA source's constants; ``_lib`` holds them against the library's
# ``ssd_scan_config`` and raises where they differ
TILE = 64             # rows of a chunk per tile (C Bᵀ tiles are TILE x TILE)
HEADS_PER_BLOCK = 2   # heads one block of the output kernel computes
SLICE_ROWS = 32       # rows of a slice of the chunk-state kernel's ring
SLICE_STAGES = 2      # slices in that ring
KERNELS_PER_CALL = 2  # chunk state + C Bᵀ + state carry, output

_COUNTERS: dict = {}  # (device, stream) -> int32 counters, zero between calls


def _lib():
    lib = build.library("ssd_scan")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_fwd.argtypes = [P] * 9 + [I] * 8 + [P, P]
        lib.ssd_scan_fwd.restype = I
        got = (ctypes.c_int * 3)()
        lib.ssd_scan_config(got)
        want = (TILE, HEADS_PER_BLOCK, KERNELS_PER_CALL)
        if tuple(got) != want:
            raise RuntimeError(f"ssd_scan: the library's constants "
                               f"{tuple(got)} are not the launcher's {want}")
        lib._typed = True
    return lib


def workspace_elems(B: int, H: int, T: int, P: int, N: int,
                    chunk: int) -> int:
    """float32 elements of the call's workspace: each chunk's state
    (B, nc, H, P, N), C Bᵀ (B, nc, cpad, cpad) with the chunk padded to
    whole tiles, each chunk's decay total (B, H, nc), and the cumsums of
    dA within the chunks (B, H, T)."""
    nc = T // chunk
    cpad = -(-chunk // TILE) * TILE
    return B * nc * (H * P * N + cpad * cpad + H) + B * H * T


def smem_bytes(x_size: int, bc_size: int, P: int, N: int,
               chunk: int) -> int:
    """Shared memory of the larger of the chunk-state and output kernels'
    blocks, as the CUDA source sizes them (``smem1``, ``smem3``): raw
    tiles in the inputs' dtypes, rows padded by 8 elements, and the
    output kernel's A operand as TF32 big and small halves."""
    cpad = -(-chunk // TILE) * TILE
    nh = HEADS_PER_BLOCK
    row = lambda n, size: (n + 8) * size          # noqa: E731  (8-element pad)
    state = 4 * (1024 + 1024 + 32) + SLICE_STAGES * SLICE_ROWS * (
        row(P, x_size) + row(N, bc_size))
    cb = 2 * TILE * row(N, bc_size)
    inter = TILE * row(N, bc_size) + 2 * 4 * P * (N + 4)
    intra = (2 * (TILE * (TILE + 4) * 4 + nh * TILE * row(P, x_size))
             + 4 * 2 * TILE * (TILE + 4))
    return max(state, cb, 4 * 2 * nh * cpad + max(inter, intra))


def work(B: int, T: int, H: int, P: int, N: int, chunk: int, x_size: int,
         bc_size: int) -> tuple:
    """(bytes, [(FLOP, peak FLOP/s), ...]) the kernel needs: x in its
    dtype, dt, A, B and C read once, y and the final state written once
    (float32); each product over the causal half of a chunk's (t, s)
    pairs, a multiply-add counted as 2, at the peak of the unit and
    precision it runs on.  C Bᵀ once per (batch, chunk): bf16 for bf16
    B/C, else three TF32 products (split); the products with xdt and the
    state in TF32, three where both operands are split (C Bᵀ against xdt),
    two where one is (xdt against bf16 B, the entering state against bf16
    C), three against float32 B or C.  The entering-state term counts
    only after the first chunk, where the state entering is zero."""
    nc = T // chunk
    pairs = nc * chunk * (chunk + 1) // 2     # causal (t, s) pairs
    nbytes = (x_size * B * T * H * P + 4 * B * T * H + 4 * H
              + 2 * bc_size * B * T * N + 4 * B * T * H * P + 4 * B * H * P * N)
    bf16 = bc_size == 2
    one_side = 2 if bf16 else 3       # products against B or C
    cb = (2 * B * pairs * N * (1 if bf16 else 3),
          BF16_FLOPS if bf16 else TF32_FLOPS)
    tf32 = 2 * B * H * (3 * pairs * P                    # C Bᵀ (decayed) xdt
                        + one_side * T * P * N           # the chunk states
                        + one_side * (nc - 1) * chunk * P * N)
    return nbytes, [cb, (tf32, TF32_FLOPS)]


def _counters(n: int, device, stream: int) -> torch.Tensor:
    """int32 counters the chunk-state kernel finds its last block by, one
    per (batch, head), left zero by every call.  Outside a CUDA-graph
    capture: allocated zero once per device, stream and size, and kept.
    Inside one: fresh zeros for this call alone, so the graph holds the
    zeroing and its own block of memory, and replacing a kept tensor with
    a larger one never frees a block that a captured graph still writes."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(n, dtype=torch.int32, device=device)
    key = (device, stream)
    cnt = _COUNTERS.get(key)
    if cnt is None or cnt.numel() < n:
        cnt = torch.zeros(n, dtype=torch.int32, device=device)
        _COUNTERS[key] = cnt
    return cnt


def ssd_scan_fwd(
    x: torch.Tensor,     # (B, T, H, P) float32 or bf16, last dim contiguous, CUDA
    dt: torch.Tensor,    # (B, T, H) float32
    A: torch.Tensor,     # (H,) float32 contiguous
    Bm: torch.Tensor,    # (B, T, N), last dim contiguous
    Cm: torch.Tensor,    # (B, T, N)
    *,
    chunk: int,
) -> tuple:
    """Returns (y (B, T, H, P) f32, final_state (B, H, P, N) f32)."""
    global LAUNCHES
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty((B, T, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    ws = torch.empty(workspace_elems(B, H, T, P, N, chunk),
                     dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 10)(*x.stride()[:3], *dt.stride(),
                                       *Bm.stride()[:2], *Cm.stride()[:2])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    cnt = _counters(B * H, x.device, stream)
    err = _lib().ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), state.data_ptr(), ws.data_ptr(),
        cnt.data_ptr(), _DTYPES[x.dtype], _DTYPES[Bm.dtype], B, H, T, P, N,
        chunk, strides, stream)
    build.check(err, "ssd_scan_fwd")
    LAUNCHES += 1
    return y, state
