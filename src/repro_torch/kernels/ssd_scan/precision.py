"""Which float32 operands of the SSD-scan kernel need split TF32.

    PYTHONPATH=src python -m repro_torch.kernels.ssd_scan.precision

Builds ``csrc/ssd_scan.cu`` as it is and once more for each operand with
its split turned off (``-DSSD_SPLIT_<NAME>=0``: plain TF32, one product),
each into ``build/kernels/ssd_variants/``, all nvcc processes started
together.  Then it runs every build on the same inputs, the Mamba2-1.3B
serving shape with bf16 x, B and C (as the bf16 model passes them) and
with float32 ones, and holds each against ``ssd_chunked`` run on the card
in float32 (TF32 off).  It prints, per build and input, the largest share
of the reference's bound |got - want| <= 2e-3 + 2e-3 |want| that y or the
final state uses: above 1 fails.  An operand whose plain-TF32 build
passes everywhere does not need its split.  Needs an NVIDIA GPU.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ssd_scan as k4
from repro_torch.models.mamba import ssd_chunked

OPERANDS = ("X", "W", "S", "F32BC")      # the source's SSD_SPLIT_* names
SHAPE = (8, 512, 64, 64, 128, 256)             # Mamba2-1.3B: B, T, H, P, N, chunk
TOL = 2e-3


def _build_all() -> dict:
    out = build.build_dir() / "ssd_variants"
    out.mkdir(parents=True, exist_ok=True)
    flags = {"split": []}
    flags.update({f"plain_{n}": [f"-DSSD_SPLIT_{n}=0"] for n in OPERANDS})
    procs = {name: subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, *f, "-o", str(out / f"{name}.so"),
         str(build.CSRC / "ssd_scan.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, f in flags.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_fwd.argtypes = [P] * 9 + [I] * 8 + [P, P]
        lib.ssd_scan_fwd.restype = I
        lib._typed = True
        libs[name] = lib
    return libs


def _inputs(gen, dtype) -> tuple:
    B, T, H, P, N, _ = SHAPE
    dev = torch.device("cuda")
    rand = lambda *s, scale=0.5: torch.randn(  # noqa: E731
        s, generator=gen, device=dev) * scale
    x = rand(B, T, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rand(B, T, H, scale=1.0))
    A = -torch.exp(rand(H))
    return x, dt, A, rand(B, T, N).to(dtype), rand(B, T, N).to(dtype)


def _share(got, want) -> float:
    return ((got - want).abs() / (TOL + TOL * want.abs())).max().item()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("precision: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = _build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {str(dt)[6:]: _inputs(gen, dt)
             for dt in (torch.bfloat16, torch.float32)}
    refs = {k: ssd_chunked(v[0].float(), *v[1:], SHAPE[-1])
            for k, v in cases.items()}
    saved = k4._lib
    try:
        for name, lib in libs.items():
            k4._lib = lambda lib=lib: lib
            row = []
            for k, args in cases.items():
                y, st = k4.ssd_scan_fwd(*args, chunk=SHAPE[-1])
                torch.cuda.synchronize()
                yr, sr = refs[k]
                row.append(f"{k} x/B/C: y {_share(y, yr):.3f}, state "
                           f"{_share(st, sr):.3f}")
            print(f"[precision] {name:12s} " + "; ".join(row), flush=True)
    finally:
        k4._lib = saved
    print(f"[precision] shares of the bound {TOL:g} + {TOL:g} |want| at "
          f"(B, T, H, P, N, chunk) {SHAPE}; {torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main()
