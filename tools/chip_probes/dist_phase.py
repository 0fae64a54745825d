"""Phase 9 of ``chip_smoke.py`` alone: the toolchain check, the flash and
decode kernels built, then ``phase_dist`` (the sharded prefill, decode and
train steps on a (1, 1) mesh over an NCCL group of one rank).

    python3 tools/chip_probes/dist_phase.py        # on a machine with a GPU
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

t0 = time.perf_counter()
chip_smoke.phase_toolchain()
build.build("flash_attention", "decode_attention", force=True)
print(f"[probe] build {time.perf_counter() - t0:.1f}s")
chip_smoke.phase_dist()
print(f"[probe] total {time.perf_counter() - t0:.1f}s")
