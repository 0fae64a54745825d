"""The card's constants: one NVIDIA H100 SXM, from NVIDIA's data sheet.

Counterpart of the hardware constants of ``repro.perf.roofline``, which
are a TPU's.  These are published peaks at the card's full 700 W power
limit; a card set below it reaches less.  ``perf.autotune`` prices its
candidates with them and ``chip_smoke.py`` computes its kernels' bounds
from them.

The reference's ``Roofline`` analysis (FLOPs, bytes and collective bytes
read from a compiled XLA module) is not ported: it needs an extractor of
the same operation classes from a PyTorch program, which comes with the
cost model (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

BF16_FLOPS = 989e12         # dense bf16 tensor-core peak, FLOP/s
TF32_FLOPS = 495e12         # dense TF32 tensor-core peak, FLOP/s
F32_FLOPS = 67e12           # float32 peak outside the tensor cores, FLOP/s
HBM_BPS = 3.35e12           # device memory, bytes/s
SMEM_PER_BLOCK = 232_448    # shared memory one block can use (227 KB), bytes
NUM_SMS = 132               # streaming multiprocessors
