"""The card's constants, and the roofline terms the cost model reads.

The constants are one NVIDIA H100 SXM's, from NVIDIA's data sheet: the
counterpart of the hardware constants of ``repro.perf.roofline``, which
are a TPU's.  These are published peaks at the card's full 700 W power
limit; a card set below it reaches less.  ``perf.autotune`` prices its
candidates with them and ``chip_smoke.py`` computes its kernels' bounds
from them.

``bound_time_features`` and ``model_flops`` are verbatim copies of the
reference's.  ``bound_time_features`` keeps the reference's TPU v5e rates
as its defaults (``PEAK_FLOPS``, ``HBM_BW``, ``ICI_BW``): the cost model
always passes the priced device's own rates, and its simulated devices are
the reference's.  The reference's ``Roofline`` dataclass, ``analyze`` and
``save_json`` are not ported yet: their only caller is ``launch/dryrun.py``,
which comes with training and distribution (ROADMAP queue 1, item 5).
"""

from __future__ import annotations

# --- TPU v5e constants, the reference's defaults for bound_time_features ---
PEAK_FLOPS = 197e12        # bf16 FLOP/s
HBM_BW = 819e9             # bytes/s
ICI_BW = 50e9              # bytes/s per link

# --- the card ---------------------------------------------------------------
BF16_FLOPS = 989e12         # dense bf16 tensor-core peak, FLOP/s
TF32_FLOPS = 495e12         # dense TF32 tensor-core peak, FLOP/s
F32_FLOPS = 67e12           # float32 peak outside the tensor cores, FLOP/s
HBM_BPS = 3.35e12           # device memory, bytes/s
SMEM_PER_BLOCK = 232_448    # shared memory one block can use (227 KB), bytes
NUM_SMS = 132               # streaming multiprocessors


def bound_time_features(flops: float, hbm_bytes: float,
                        coll_bytes: float = 0.0, *,
                        peak_flops: float = PEAK_FLOPS,
                        hbm_bw: float = HBM_BW,
                        ici_bw: float = ICI_BW) -> dict:
    """Roofline-derived scalars for the learned cost model
    (``perf/cost_model.py``): the three bound times on the given device,
    which of them binds, and the arithmetic intensity.  Accepts explicit
    device rates so the same op counts can be priced per device class."""
    t_comp = flops / peak_flops
    t_mem = hbm_bytes / hbm_bw
    t_coll = coll_bytes / ici_bw
    return {
        "t_compute": t_comp,
        "t_memory": t_mem,
        "t_collective": t_coll,
        "bound_time": max(t_comp, t_mem, t_coll),
        # FLOP/byte; degenerate inputs fall back to balanced intensity
        "intensity": (flops / hbm_bytes) if hbm_bytes > 0
        else (peak_flops / hbm_bw),
    }


def model_flops(cfg, shape) -> float:
    """Analytic 'useful' FLOPs per step: 6*N*D train, 2*N*D inference
    (N = active params, D = tokens processed)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n * tokens
