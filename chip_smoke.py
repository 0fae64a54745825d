"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Twelve phases, any failure fatal, all in a temporary autotune store, so a
stale ``.profile_store/`` in the working directory changes nothing:
  1. toolchain: torch / CUDA / nvcc versions, the card, TF32 off;
  2. build the four CUDA kernels from src/repro_torch/kernels/csrc with
     nvcc, one process per source, all started together; each wgmma
     instance of the flash kernel's registers, spills (none allowed) and
     shared memory;
  3. kernels: each kernel against its plain PyTorch version over the
     reference case lists and the shapes of the serving paths (attention,
     paged attention included: float32 at 2e-5, bfloat16 at 2e-2; SSD
     scan: float32 or bfloat16 x and B/C, x also as a strided slice, at
     2e-3), the split-K decode kernel also at every split length 64-1024
     of a 1,024-key cache, the flash kernel also over cases of its wgmma
     body (each tile at head_dim 64, 128 and 256, ragged edges, q_offset,
     window, cap, GQA groups 1-8) and views at head_dim 64 and 256 that
     must take its CUDA-core body, each asserting which body ran, the
     paged kernel also past a full cluster of splits, at G 48 and on a
     pool view off the 16-byte rule; then timed beside its
     plain version, one PyTorch library call where there is one (for the
     paged kernel, which no library call matches, the split-K decode
     kernel at the same geometry, in turns), and its bound (the SSD scan's
     also beside the float32-CUDA-core bound of its first body); the
     paged kernel's split plan and the CUDA kernels of one traced call
     printed.  Each time is taken twice:
     eager (20 calls between two CUDA events, the wrapper's host work
     included) and on the device alone (the same 20 calls captured once in
     a CUDA graph and replayed between two events).  K1 and K2 also at the
     call shapes of InternVL2-2B (hd 128, G 2), Qwen3-MoE-30B-A3B (hd 128,
     G 8), Whisper-medium (hd 64, G 1: its bidirectional encoder over
     1500 frames, its decoder's self-attention, its cross-attention at
     prefill through K1 and at decode through K2 over a transposed view of
     the encoder's cache), Gemma-2-2B (hd 256, cap 50: K1's wgmma body,
     held at each of its two tiles and timed at each, without the cap and
     at one sequence, beside its CUDA-core body on a view; K2 over a
     1,024-position cache) and the examples phase's
     full-width quickstart (K1 at 128 x 32 tokens, hd 64, G 3: a partial q
     tile), each held against its plain
     version in both dtypes with the body asserted, and timed on the
     device alone beside SDPA with its bound;
  4. model: full-width SmolLM-360M, Mamba2-1.3B, Zamba2-1.2B, InternVL2-2B
     (a prompt of 256 patch embeddings and 256 text tokens),
     Whisper-medium (1500 encoder frames, a 512-token decoder prompt) and
     last Qwen3-MoE-30B-A3B (48 layers, 128 experts, top-8; its float32
     check cut to 8 layers, as all 48 are 122 GB in float32),
     random weights from a seed, prefill 8 x 512 and decode steps through
     the kernels, held against the plain path on the card (float32 at 1e-4;
     bf16 at the JAX bounds or twice the plain path's own rounding floor,
     whichever is larger; argmax equal but at near-ties), with the
     kernels' launch counts checked, every bf16 flash launch through the
     wgmma body, and from torch.profiler's traces of the card, of one bf16
     prefill and one bf16 decode step: the flash, decode and SSD-scan
     kernels' time and count (one decode kernel per attention call: 24
     self and 24 cross per Whisper step; two SSD-scan kernels per Mamba
     block; Whisper's 72 flash kernels per prefill: 24 encoder, 24 self,
     24 cross), and the device's idle share; for Qwen3-MoE also its
     init's peak memory (under its parameters' bytes + 2 GB), the routing
     decisions that differ between the two paths at each MoE layer, a
     logits row past its bound passed only as a stated routing near-tie
     (``ROUTE_DRIFT``), and the MoE blocks' share of the traced prefill and
     step beside their bounds (the step's: reading every expert);
  5. graphs: the same six models (bf16, 8 x 512 + 32 steps) through
     ``serve``'s executor, which captures each batch bucket's request
     (``api.generate``) once in a CUDA graph: the replayed tokens equal
     the eager path's on the same batch; one replayed and one eager
     request on the host clock, in turns; one replay under
     ``torch.profiler``: its CUDA kernels counted by name (one flash per
     attention layer, one decode per attention layer and step, two
     SSD-scan per Mamba block) against the launches the wrappers recorded
     in the capture, and the device's idle share;
  6. serving: RealExecutor + DNNScaler (``serve``'s default controller,
     the paper's loop: the Profiler picks Batching or Multi-Tenancy and a
     1-D scaler tunes it; estimator seeded as ``serve`` seeds it) +
     ServingEngine at full width, SmolLM-360M (flash
     + decode attention) and then Mamba2-1.3B (SSD scan), at buckets up to
     64 and 40 steps, then InternVL2-2B, Whisper-medium and Qwen3-MoE-30B-A3B
     (flash + decode attention) at buckets up to 16 and 10 steps, each
     bucket
     captured in a CUDA graph at warm-up and replayed by every step, with
     zero bucket-cache misses and stale hits after warm-up and its
     kernels' launches over the engine's run counted from the replays
     (each bucket's launches recorded in its capture, times its
     replays), every flash launch through the wgmma body;
  7. tokens: Gemma-2-2B at full width (``phase_tokens``): its kernel
     path against its plain path (an 8 x 512 prefill and 4 steps, float32
     and bf16), a 1 x 512 prefill replayed in a CUDA graph as the token
     engine's measured prefill, ``serve.decode_executor_for``'s slot
     buckets 1-16 (one decode step each, over a cache prefilled through
     K1, captured in a CUDA graph; their graph pool's size; the LM head
     (bf16 operands, float32 output) against the widened product within
     the summation-order bound, timed beside it; per bucket the step's
     host-clock ms, one traced replay's busy ms, idle share, K2's and the
     head product's ms), then ``token_engine.run_continuous`` over them
     on a 64-request ragged trace: requests conserved, no bucket miss and
     no stale hit after the warm-up, every decode launch a replay's;
  8. train (``phase_train``): the blockwise attention's backward (float32,
     SmolLM's and Gemma-2's shapes) against float64 autograd of a dense
     softmax at 2e-5; ``api.train_loss`` and its gradients on the card
     against the CPU in float32 (SmolLM-360M at full width cut to 2
     layers, and the ten TINY configs) at 1e-4, and one bf16 step of each
     TINY config as the reference's smoke test asks; then ``loop.train``,
     SmolLM-360M at full width, 30 bf16 AdamW steps at 8 x 256 on the
     synthetic corpus, its loss falling by at least 0.15: step ms,
     tokens/s, peak memory over 2 steps with and without remat, one step
     traced (busy, idle share, top kernels).  Every model runs with
     ``kernel_impl="pallas"`` and the four launch counts stay 0: the
     train path reaches no kernel (none has a backward); a JSON line;
  9. dist (``phase_dist``): the sharded steps (``launch/steps.py``) on a
     process group of their own (NCCL, world size 1, a FileStore in a
     temporary directory) over a (1, 1) mesh, SmolLM-360M at full width,
     bf16, parameters laid out by the reference's ``param_specs(...,
     "infer")``: ``make_prefill_step`` at 8 x 512 and 32 greedy
     ``make_decode_step`` steps with the sharded cache append, tokens
     equal to ``api.generate``'s, logits within the model phase's bf16
     bound (bit for bit or not printed), K1 32 per prefill and K2 32 per
     step on the local shards (``launches_by_path["dist"]``), no
     collective over a step (``CommDebugMode``); ``make_train_step`` at 8 x
     256 (4 microbatches) in float32 at 2 layers against the composed
     microbatch step at 1e-4, then 5 bf16 steps at full width timed (2
     also through the composed step), each run's peak memory; eager
     host-clock ms of the sharded prefill and step beside the unsharded
     ones; a JSON line;
  10. examples (``phase_examples``): ``repro_torch.examples.quickstart``
     as shipped (TINY) and its ``run`` at full width (SmolLM-360M, bf16,
     the kernel path, the example's ``(n, 32)`` token batches served by a
     prefill at capacity 48 under DNNScaler at 8 x the bs=1 latency): every
     bucket captured before the run, no miss and no stale hit over it, K1
     32 a replay, all through the wgmma body
     (``launches_by_path["examples"]``), the largest bucket's logits
     against the plain path within the model phase's bf16 bound; then,
     after a throwaway executor captured each bucket once,
     ``warm_start.serve_once`` cold and warm against one store (a bucket
     miss a CUDA-graph capture), in ``WARM_PAIRS`` pairs: the warm run
     strictly fewer probes and captures in each, and its median stall
     seconds strictly below the cold runs'; a JSON line;
  11. autotune: ``serve --autotune``'s tuning of the serving shape classes
     (SmolLM-360M prefill, decode and paged decode; Mamba2-1.3B's SSD
     scan), every candidate timed through its kernel on the device alone
     (calls captured in a CUDA graph): the flash kernel at its four wgmma
     tiles, the paged kernel at each page size, each first held against
     its plain version on the tuning's own inputs; a second tuning times
     nothing and the generation bumps once per class; a view off the
     16-byte rule of the tuned flash class takes the CUDA-core body at its
     own tile; then a short SmolLM serving run on the tuned cache with
     zero misses and zero stale hits after warm-up;
  12. fleet (``phase_fleet``, on the host): the paper's 30-job Table-4
     fleet as ``serve --cluster`` prices it (``run_paper_cluster`` in
     ``auto`` mode, 12 simulated Tesla P40s, 90 s, seed 0), its aggregate
     printed, run again through ``VectorClusterEngine`` and held equal;
     ``serve --job 5`` under DNNScaler; and the cost model's live features
     (``features_for_served_module``: the served decode step and prefill
     traced on meta tensors at full width) of the seven models the script
     serves, none missing.  These price the reference's simulated devices:
     no number of this phase is a measurement of the card.

Phases 4-6 run Qwen3-MoE last, its 61 GB of weights made after the
model before it is freed, and print the card's free memory before its
init (phase 7 prints it before Gemma-2-2B's); running out of memory fails
the script.  Prints the kernels' JSON line (each kernel's launches on the
first served path that reaches it, and by path in ``launches_by_path``,
the token path's under ``tokens``, the sharded steps' under ``dist``,
the full-width quickstart's under ``examples``),
the card's name and power limit, and
last the device JSON line.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.distributed.tensor.debug import CommDebugMode
from torch.profiler import ProfilerActivity, profile

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device available")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.base import (ARCH_IDS, InputShape,  # noqa: E402
                                       get_config, torch_dtype)
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import \
    decode_attention as k2  # noqa: E402
from repro_torch.kernels.decode_attention import \
    ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention import \
    paged_decode_attention as k3  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, paged_decode_attention_ref)
from repro_torch.kernels.flash_attention import \
    flash_attention as k1  # noqa: E402
from repro_torch.kernels.flash_attention import \
    ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as k4  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.examples import quickstart, warm_start  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.serve import (decode_executor_for,  # noqa: E402
                                      make_controller, real_executor_for)
from repro_torch.models import api, head, layers, moe, transformer  # noqa: E402
from repro_torch.models.mamba import ssd_chunked  # noqa: E402
from repro_torch.perf import autotune  # noqa: E402
from repro_torch.perf.roofline import (BF16_FLOPS, F32_FLOPS,  # noqa: E402
                                       HBM_BPS, TF32_FLOPS)
from repro_torch.perf import cost_model  # noqa: E402
from repro_torch.serving import device_model as dm  # noqa: E402
from repro_torch.serving.cluster import run_paper_cluster  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.executor import CudaGraphs, tensor_leaves  # noqa: E402
from repro_torch.serving.token_engine import (  # noqa: E402
    ragged_decode_trace, run_continuous)
from repro_torch.training import adamw  # noqa: E402
from repro_torch.training.data import DataConfig, TokenStream  # noqa: E402
from repro_torch.training.loop import (loss_and_grads, train,  # noqa: E402
                                       train_step)

DEV = torch.device("cuda")
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

# (B, Tq, Tk, H, KV, hd, causal, window, cap): the reference's FLASH_CASES,
# plus one at head_dim 256 (float32: the CUDA-core body; bf16: wgmma)
FLASH_CASES = [
    (2, 256, 256, 8, 2, 64, True, None, None),
    (1, 128, 128, 4, 4, 32, True, 64, None),
    (2, 200, 200, 6, 2, 64, True, None, 50.0),
    (1, 256, 256, 8, 1, 128, True, 100, 30.0),
    (1, 96, 96, 8, 8, 32, False, None, None),
    (3, 384, 384, 15, 5, 64, True, None, None),
    (2, 200, 200, 6, 2, 64, False, None, None),
    (1, 64, 64, 8, 4, 256, True, 32, 50.0),     # gemma2's head_dim
]
# cases of the flash kernel's wgmma body (bf16, head_dim 64, 128 and 256):
# ((B, Tq, Tk, H, KV, hd, causal, window, cap), q_offset, (block_q,
# block_k)): each tile, at hd 64 and, with window and cap, at hd 128 (G 8);
# Tq not a multiple of the tile (200, 384); Tk > Tq with q_offset; G 1, 3
# and 8; bidirectional; the default tile; at hd 256 each of its two tiles
# at Gemma-2-2B's G 2 and cap 50 (a window of 32 that cuts the tiles, Tq
# 100, q_offset with Tk > Tq), G 1 and G 8
WGMMA_CASES = (
    [((2, 256, 256, 8, 2, 64, True, None, None), 0, (bq, bk))
     for bq in (64, 128) for bk in (64, 128)]
    + [((1, 256, 256, 8, 1, 128, True, 100, 30.0), 0, (bq, bk))
       for bq in (64, 128) for bk in (64, 128)]
    + [((2, 200, 200, 6, 6, 64, True, None, None), 0, (128, 64)),
       ((3, 384, 384, 15, 5, 128, True, None, None), 0, (128, 128)),
       ((2, 100, 300, 8, 8, 64, True, None, None), 200, (64, 128)),
       ((2, 130, 400, 16, 2, 128, True, None, 50.0), 270, (128, 64)),
       ((2, 200, 200, 6, 2, 64, False, None, None), 0, (64, 64)),
       ((2, 200, 200, 6, 2, 128, True, 64, None), 0, (None, None))]
    + [(case, q_offset, tile) for tile in ((64, 64), (128, 64))
       for case, q_offset in (
           ((1, 192, 192, 4, 2, 256, True, 32, 50.0), 0),
           ((2, 100, 100, 4, 2, 256, True, None, 50.0), 0),
           ((1, 70, 200, 4, 2, 256, True, 128, 50.0), 130),
           ((2, 200, 200, 4, 4, 256, True, None, 50.0), 0),
           ((1, 256, 256, 8, 1, 256, True, 100, None), 0))])

# (B, S, H, KV, hd, pos, window, cap): the reference's DECODE_CASES
DECODE_CASES = [
    (2, 512, 8, 2, 64, 300, None, None),
    (1, 512, 4, 1, 128, 511, 128, None),
    (3, 300, 6, 6, 32, 150, None, 50.0),
    (2, 1024, 48, 1, 64, 700, None, None),
    (1, 256, 32, 4, 128, 0, None, None),
]
# every split length the autotuner offers, on a 1,024-key cache: 64 gives 16
# splits, a full cluster of the split-K kernel
SPLIT_CASE = (2, 1024, 8, 2, 64, 1023, None, None)
SPLIT_LENS = (64, 128, 192, 256, 320, 512, 1024)
# the reference's kv-major cases (tests/test_paged_attention.py)
KVMAJOR_CASES = [
    (2, 300, 8, 2, 64, 299, None, None),
    (3, 300, 6, 3, 64, 150, None, None),
    (1, 512, 4, 1, 128, 37, None, None),
    (1, 640, 12, 3, 64, 633, 128, None),
    (2, 384, 10, 5, 32, 65, None, 40.0),
    (1, 256, 8, 2, 64, 0, None, None),
]

# (B, T, H, P, N, chunk): the reference's SSD_CASES (tests/test_kernels.py),
# then the chunks 300- and 700-token prompts give (not multiples of the
# kernel's 64-row tile); phase_ssd adds the Mamba2-1.3B and Zamba2-1.2B
# serving shapes
SSD_CASES = [
    (2, 256, 4, 64, 32, 64),
    (1, 128, 8, 32, 16, 128),
    (2, 512, 2, 64, 64, 128),
    (1, 256, 64, 64, 128, 64),
    (2, 300, 8, 64, 128, 300),
    (1, 700, 4, 32, 64, 350),
]
SSD_TOL = 2e-3             # the reference's bound for the chunked scan

# (B, S, H, KV, hd, page_size, lens, window, cap): the reference's
# PAGED_CASES (tests/test_paged_attention.py), then each page size the
# autotuner offers, then the two timing shapes: SmolLM-360M's decode
# geometry with every slot full, and the ragged shape of
# benchmarks/token_benches.py
PAGED_CASES = [
    (4, 512, 8, 2, 64, 64, (512, 300, 37, 1), None, None),
    (1, 256, 4, 1, 128, 64, (200,), None, None),
    (3, 384, 6, 3, 64, 128, (384, 129, 64), None, None),
    (2, 512, 8, 2, 64, 64, (500, 90), 128, None),
    (2, 256, 4, 4, 32, 32, (250, 31), None, 50.0),
    (3, 256, 8, 2, 64, 64, (256, 0, 10), None, None),
]
PAGE_SIZE_CASES = [(2, 512, 8, 2, 64, psz, (512, 301), None, None)
                   for psz in (32, 64, 128, 256)]
PAGED_SMOLLM = (8, 544, 15, 5, 64, 32, (544,) * 8, None, None)
PAGED_RAGGED = (8, 1024, 8, 2, 64, 64, (1024, 700, 512, 301, 128, 37, 1, 0),
                None, None)
# the new body's own cases: more splits than a cluster holds (a 163,840-key
# context in 32-key pages: 20 splits of a block's 256-page table), G 48 (six
# query-row chunks), and a pool view off the 16-byte rule (the element-wise
# copy)
PAGED_WALK = (2, 163840, 8, 2, 64, 32, (163840, 70000), None, None)
PAGED_G48 = (2, 1024, 48, 1, 64, 64, (1024, 333), 300, None)
PAGED_VIEW = (3, 512, 6, 2, 64, 32, (512, 200, 0), None, 30.0)

# the serving paths' shapes: 8 prompts of 512 tokens, 32 decode steps
ARCH, BATCH, PROMPT, STEPS = "smollm_360m", 8, 512, 32
# the examples phase: quickstart's buckets (bs up to 32 x mtl up to 4)
QUICK_MAX_ITEMS = 32 * 4
# the warm start's cold / warm pairs, each on a store of its own: a
# run's stall seconds are 8-10 captures of about 1 ms of host time,
# in which one capture on a shared host can take 10-150 ms, so the
# pairs' medians are compared
WARM_PAIRS = 5
SSM_ARCH, HYBRID_ARCH = "mamba2_1p3b", "zamba2_1p2b"
# the vision stub (256 of a prompt's 512 positions are patches) and the
# encoder-decoder (1500 encoder frames and a 512-token decoder prompt)
VLM_ARCH, ENCDEC_ARCH = "internvl2_2b", "whisper_medium"
# the MoE model, run last in every phase (its 61 GB of bf16 weights leave
# about 19 GB of the card), and its float32 check cut to 8 of its 48
# layers (all 48 are 122 GB in float32)
MOE_ARCH, MOE_F32_LAYERS = "qwen3_moe_30b_a3b", 8
# the token path: the model the reference's token engine serves by default,
# its KV budget, the slot ladder (the token engine's buckets up to 16
# slots) and the decode steps of its model check
TOKEN_ARCH, KV_BUDGET, TOKEN_STEPS = "gemma2_2b", 1024, 4
SLOT_LADDER = (1, 2, 4, 8, 12, 16)
# the train path: SmolLM-360M at full width, AdamW steps at batch x
# sequence and lr; its card-against-CPU float32 check cut to TRAIN_CUT of
# its 32 layers; the TINY configs' smoke shape (tests/test_models.py's);
# the blockwise attention's gradients at SmolLM's and Gemma-2's shapes
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = (
    "smollm_360m", 8, 256, 30, 3e-4)
TRAIN_CUT = 2
# the dist path: bf16 train steps timed through the sharded train step,
# and the first of them timed again through the composed unsharded step
DIST_TRAIN_STEPS, DIST_COMPOSED_STEPS = 5, 2
TRAIN_TINY_SHAPE = InputShape("smoke", 64, 2, "train")
TRAIN_ATTN_CASES = (
    ("smollm", (8, 256, 15, 5, 64), dict(causal=True)),
    ("gemma2", (8, 512, 8, 4, 256), dict(causal=True, window=128,
                                        logit_cap=50.0)),
)
# a logits row past its bound passes as a routing near-tie only if, at the
# first layer where its routing differs between the two paths, no router
# logit of its routing group has drifted by more than this (the JAX
# 2-layer prefill bound) and every top-k flip there lies within twice that
# drift (``_routing_diff``)
ROUTE_DRIFT = 3e-2


def _rand(gen, shape, dtype, scale=0.5):
    return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)


def _qkv(gen, q_shape, kv_shape, dtype):
    """q and k at scale 2, so the scaled logits have a std of about 4 at any
    head_dim and the softmax is peaked: outputs are O(|v|), not the near-
    uniform average a tolerance of 2e-2 could hide a masking error in."""
    return (_rand(gen, q_shape, dtype, 2.0), _rand(gen, kv_shape, dtype, 2.0),
            _rand(gen, kv_shape, dtype))


def _time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _graph_ms(fn, iters: int = 20) -> float:
    """Device time per call: ``iters`` calls captured once in a CUDA graph,
    replayed between two CUDA events (the median of 3 replays), so no host
    work is timed.  A call that cannot be captured raises."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    del graph
    return sorted(times)[1]


def _ms(fn) -> tuple:
    """(eager ms, device ms) per call of ``fn``."""
    return _time_ms(fn), _graph_ms(fn)


def _wall_ms(fn, iters: int = 3) -> float:
    """Host clock around ``iters`` runs ended by a synchronise, after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _profile_in(fn, kernels: tuple, moe_split: bool = False) -> tuple:
    """From torch.profiler's trace of the card over one run of ``fn``: the
    ms and count of the device's kernels whose names contain each string of
    ``kernels``, the ms of all its activity, the ms from the first
    activity's start to the last one's end, and with ``moe_split`` the MoE
    blocks' split (``_moe_split``, the run under ``_moe_ranges``; else
    None).  A trace with no device time fails."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with _moe_ranges() if moe_split else contextlib.nullcontext():
            fn()
        torch.cuda.synchronize()
    # a record_function range also leaves its span on the device's
    # timeline (a GPU user annotation), which is no device activity
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and e.name not in MOE_RANGES]
    assert dev, "torch.profiler's trace holds no device time"
    ms = lambda es: sum(e.time_range.elapsed_us() for e in es) / 1e3  # noqa
    found = [[e for e in dev if name in e.name] for name in kernels]
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev)) / 1e3
    return ([(ms(es), len(es)) for es in found], ms(dev), span,
            _moe_split(prof) if moe_split else None)


def _bound(nbytes: float, *work) -> tuple:
    """Least time in ms for moving ``nbytes`` and doing ``work``, pairs of
    (FLOP, peak FLOP/s) whose times add up; and which of the two bounds
    it."""
    t_bytes = nbytes / HBM_BPS
    t_ops = sum(flops / peak for flops, peak in work)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _maxerr(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _reset_launches() -> None:
    k1.reset_counts()
    k2.LAUNCHES = k3.LAUNCHES = k4.LAUNCHES = 0


def _relerr(out, ref) -> float:
    """max |out - ref| over mean |ref|: the error against a typical output."""
    return _maxerr(out, ref) / ref.float().abs().mean().item()


# ---------------------------------------------------------------------------
def phase_toolchain() -> str:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[toolchain] python {sys.version.split()[0]}  torch "
          f"{torch.__version__}  cuda {torch.version.cuda}  nvcc "
          f"{nvcc[-1]}")
    print(f"[toolchain] device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}  nvidia-smi: {smi}")
    print(f"[toolchain] allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    build.build("flash_attention", "decode_attention",
                "paged_decode_attention", "ssd_scan", force=True)
    print(f"[build] nvcc sm_90a, four sources in parallel: "
          f"{time.perf_counter() - t0:.1f}s")
    for name, log in build.PTXAS_REPORT.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln
                  and not re.search(r"0 bytes spill stores, 0 bytes spill "
                                    r"loads", ln)]
        print(f"[build] {name}: {len(regs)} kernels, registers "
              f"{min(regs)}-{max(regs)} a thread; "
              + ("; ".join(spills) if spills else "no spills"))
    inst = _wgmma_instances(build.PTXAS_REPORT["flash_attention"])
    assert len(inst) == sum(map(len, k1.TILES.values())), inst
    print("[build] flash wgmma instances (head_dim, block_q, block_k): "
          "registers a thread, spill stores / loads (bytes), dynamic shared "
          "memory a block: " + "; ".join(
              f"{key} {r} regs, {st} / {ld}, {k1.wgmma_smem(*key)} B"
              for key, (r, st, ld) in sorted(inst.items())))
    for ln in build.PTXAS_REPORT["flash_attention"].splitlines():
        if "serialized" in ln or "Performance" in ln:
            print(f"[build] flash_attention ptxas: {ln.strip()}")
    spilled = {key: v for key, v in inst.items() if v[1] or v[2]}
    assert not spilled, ("wgmma instances spill registers", spilled)


def _wgmma_instances(log: str) -> dict:
    """ptxas's report of each ``flash_fwd_wgmma_kernel<HD, BM, BN>``:
    (HD, BM, BN) -> (registers, spill store bytes, spill load bytes)."""
    out = {}
    for entry in log.split("Compiling entry function")[1:]:
        name = re.search(r"flash_fwd_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                         entry)
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        out[tuple(map(int, name.groups()))] = (
            int(regs.group(1)), int(spill.group(1)), int(spill.group(2)))
    return out


# each flash body's CUDA kernel, as its name shows in a trace
FLASH_KERNEL = {"wgmma": "flash_fwd_wgmma_kernel",
                "mma_sync": "flash_fwd_mma_kernel",
                "cuda_cores": "::flash_fwd_kernel<"}


def _flash_body(dtype, hd: int) -> str:
    """The body of the flash kernel that aligned inputs of ``dtype`` and
    ``hd`` take."""
    if dtype == torch.float32:
        return "cuda_cores"
    return "wgmma" if k1.wgmma_class(dtype, hd) else "mma_sync"


def _check_flash(gen, case, dtype, q_offset=0, tile=(None, None),
                 body=None, view=False) -> tuple:
    """The flash kernel against ``attention_ref`` at ``case``, asserting
    through ``LAUNCHES_BY_BODY`` which body ran (``_flash_body``'s unless
    given).  ``view``: q, k and v are views 4 elements into rows of hd + 4,
    so no pointer or stride keeps the 16-byte rule."""
    B, Tq, Tk, H, KV, hd, causal, window, cap = case
    q, k, v = _qkv(gen, (B, Tq, H, hd + 4 * view),
                   (B, Tk, KV, hd + 4 * view), dtype)
    if view:
        q, k, v = q[..., 4:], k[..., 4:], v[..., 4:]
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=q_offset)
    before = dict(k1.LAUNCHES_BY_BODY)
    out = flash_ops.flash_attention(q, k, v, block_q=tile[0],
                                    block_k=tile[1], **kw)
    ref = attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    ran = [n for n, c in k1.LAUNCHES_BY_BODY.items() if c != before[n]]
    assert ran == [body or _flash_body(dtype, hd)], ("flash body", case, ran)
    err = _maxerr(out, ref)
    tol = TOL[dtype]
    assert torch.isfinite(out.float()).all(), ("flash", case, dtype)
    assert torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol), \
        ("flash kernel disagrees", case, dtype, tile, err)
    return err, _relerr(out, ref)


def _check_tile(q, k, v, tile, what: str) -> float:
    """The flash kernel's wgmma body at ``tile`` against ``attention_ref``
    (causal) on ``q``, ``k``, ``v``, at the bf16 tolerance."""
    before = k1.LAUNCHES_BY_BODY["wgmma"]
    out = flash_ops.flash_attention(q, k, v, causal=True, block_q=tile[0],
                                    block_k=tile[1])
    ref = attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert k1.LAUNCHES_BY_BODY["wgmma"] == before + 1, \
        ("flash tile not through the wgmma body", what, tile)
    assert torch.isfinite(out.float()).all(), ("flash", what, tile)
    tol = TOL[torch.bfloat16]
    assert torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol), \
        ("flash kernel disagrees", what, tile, _maxerr(out, ref))
    return _maxerr(out, ref)


def _check_decode(gen, case, dtype, kvmajor: bool,
                  split_len=None, view: bool = False) -> tuple:
    """``view``: the kv-major wrapper reads a (B, S, KV, hd) cache through
    its transposed view, no copy, as a decode step's cross-attention reads
    the encoder's K/V."""
    B, S, H, KV, hd, pos, window, cap = case
    q, k, v = _qkv(gen, (B, H, hd), (B, S, KV, hd), dtype)
    p = torch.tensor([pos], dtype=torch.int32, device=DEV)
    kw = dict(window=window, logit_cap=cap, split_len=split_len)
    if view:
        out = decode_ops.decode_attention_kvmajor(
            q, k.transpose(1, 2), v.transpose(1, 2), p, **kw)
    elif kvmajor:   # the model's (B, KV, S, hd) layout, contiguous
        out = decode_ops.decode_attention_kvmajor(
            q, k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
            p, **kw)
    else:
        out = decode_ops.decode_attention(q, k, v, p, **kw)
    ref = decode_attention_ref(q, k, v, pos, window=window, logit_cap=cap)
    torch.cuda.synchronize()
    err = _maxerr(out, ref)
    tol = TOL[dtype]
    assert torch.isfinite(out.float()).all(), ("decode", case, dtype)
    assert torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol), \
        ("decode kernel disagrees", case, dtype, split_len, err)
    return err, _relerr(out, ref)


def phase_kernels() -> dict:
    cfg = get_config(ARCH)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S = PROMPT + STEPS
    slice_flash = (BATCH, PROMPT, PROMPT, H, KV, hd, True, None, None)
    slice_decode = (BATCH, S, H, KV, hd, S - 1, None, None)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    worst = {"flash": {}, "decode": {}}
    k1.reset_counts()
    for dtype in (torch.float32, torch.bfloat16):
        fl = [_check_flash(gen, c, dtype) for c in FLASH_CASES + [slice_flash]]
        if dtype == torch.bfloat16:
            fl += [_check_flash(gen, c, dtype, q_offset, tile)
                   for c, q_offset, tile in WGMMA_CASES]
            fl += [_check_flash(gen, c, dtype, body="cuda_cores", view=True)
                   for c in (slice_flash, FLASH_CASES[-1])]
        dc = ([_check_decode(gen, c, dtype, False) for c in DECODE_CASES]
              + [_check_decode(gen, c, dtype, True)
                 for c in KVMAJOR_CASES + [slice_decode]]
              + [_check_decode(gen, SPLIT_CASE, dtype, True, sl)
                 for sl in SPLIT_LENS])
        for name, res in (("flash", fl), ("decode", dc)):
            worst[name][dtype] = (max(e for e, _ in res),
                                  max(r for _, r in res), len(res))
    for name, w in worst.items():
        (f_abs, f_rel, n), (b_abs, b_rel, nb) = (w[torch.float32],
                                                 w[torch.bfloat16])
        print(f"[kernels] {name}: max |kernel - plain|: float32 over {n} "
              f"cases {f_abs:.3e} (tol 2e-5; {f_rel:.3e} of mean |plain|), "
              f"bfloat16 over {nb} cases {b_abs:.3e} (tol 2e-2; {b_rel:.3e} "
              f"of mean |plain|)")
    print(f"[kernels] flash launches by body over the checks (the expected "
          f"body asserted for each): {k1.LAUNCHES_BY_BODY}")

    # timing at the serving path's shapes, in the path's dtype (bf16)
    dt = torch.bfloat16
    q, k, v = _qkv(gen, (BATCH, PROMPT, H, hd), (BATCH, PROMPT, KV, hd), dt)
    f_err = _maxerr(flash_ops.flash_attention(q, k, v, causal=True),
                    attention_ref(q, k, v, causal=True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    # the kernel (wgmma body, default tile) and SDPA in turns: K1, SDPA,
    # SDPA, K1, each eager and on the device alone
    turns = {"k1": [], "sdpa": []}
    for name in ("k1", "sdpa", "sdpa", "k1"):
        turns[name].append(_ms(
            (lambda: flash_ops.flash_attention(q, k, v, causal=True))
            if name == "k1" else
            (lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))))
    (f_ms, f_dev), (f_lib, f_lib_dev) = (
        tuple(sum(x) / 2 for x in zip(*turns[n])) for n in ("k1", "sdpa"))
    f_plain = _time_ms(lambda: attention_ref(q, k, v, causal=True))
    tiles = {}
    for bq, bk in k1.TILES[hd]:
        _check_tile(q, k, v, (bq, bk), "serving shape")
        tiles[bq, bk] = _graph_ms(lambda: flash_ops.flash_attention(
            q, k, v, causal=True, block_q=bq, block_k=bk))
    # the CUDA-core body, which float32 takes, beside its plain version
    q32, k32, v32 = q.float(), k.float(), v.float()
    f32_ms = _time_ms(lambda: flash_ops.flash_attention(q32, k32, v32,
                                                        causal=True))
    f32_plain = _time_ms(lambda: attention_ref(q32, k32, v32, causal=True))
    pairs = BATCH * H * PROMPT * (PROMPT + 1) // 2      # unmasked (q, k) pairs
    f_bound, f_by = _bound(2 * (2 * q.numel() + 2 * k.numel()),
                           (4 * pairs * hd, BF16_FLOPS))

    pos = S - 1
    qd, kc, vc = _qkv(gen, (BATCH, H, hd), (BATCH, KV, S, hd), dt)
    pd = torch.tensor([pos], dtype=torch.int32, device=DEV)
    d_err = _maxerr(decode_ops.decode_attention_kvmajor(qd, kc, vc, pd),
                    decode_attention_ref(qd, kc.transpose(1, 2),
                                         vc.transpose(1, 2), pos))
    d_ms, d_dev = _ms(lambda: decode_ops.decode_attention_kvmajor(qd, kc, vc,
                                                                  pd))
    d_plain = _time_ms(lambda: decode_attention_ref(
        qd, kc.transpose(1, 2), vc.transpose(1, 2), pos))
    live = pos + 1
    d_lib, d_lib_dev = _ms(lambda: F.scaled_dot_product_attention(
        qd[:, :, None], kc[:, :, :live], vc[:, :, :live], enable_gqa=True))
    d_bound, d_by = _bound(2 * (2 * qd.numel() + 2 * BATCH * KV * live * hd),
                           (4 * BATCH * H * live * hd, BF16_FLOPS))
    shown = "; ".join(
        f"{n} " + ", ".join(f"eager {e:.4f} ms, device {d:.4f} ms"
                            for e, d in turns[n]) for n in ("k1", "sdpa"))
    print(f"[kernels] flash at {slice_flash[:6]} bf16 (wgmma body, default "
          f"tile), in turns K1, SDPA, SDPA, K1: {shown}")
    print(f"[kernels] flash at {slice_flash[:6]} bf16: kernel eager "
          f"{f_ms:.4f} ms, device {f_dev:.4f} ms; plain {f_plain:.4f} ms; "
          f"sdpa eager {f_lib:.4f} ms, device {f_lib_dev:.4f} ms; bound "
          f"{f_bound:.4f} ms ({f_by}); float32 (CUDA-core body) kernel "
          f"{f32_ms:.4f} ms, plain {f32_plain:.4f} ms")
    print(f"[kernels] flash at {slice_flash[:6]} bf16, device ms of each "
          f"wgmma tile (block_q x block_k), each first held against the "
          f"plain version at 2e-2 and its body asserted: " + ", ".join(
              f"{bq}x{bk} {ms:.4f}" for (bq, bk), ms in tiles.items())
          + f" (default {k1.DEFAULT_TILE[0]}x{k1.DEFAULT_TILE[1]})")
    print(f"[kernels] decode at {slice_decode[:6]} bf16: kernel eager "
          f"{d_ms:.4f} ms, device {d_dev:.4f} ms; plain {d_plain:.4f} ms; "
          f"sdpa eager {d_lib:.4f} ms, device {d_lib_dev:.4f} ms; bound "
          f"{d_bound:.4f} ms ({d_by})")
    return {
        "flash": dict(name="flash_attention_fwd", route="cuda",
                      source="src/repro_torch/kernels/csrc/flash_attention.cu",
                      replaces="src/repro/kernels/flash_attention/"
                               "flash_attention.py:111",
                      max_abs_err=f_err, ms=f_ms, device_ms=f_dev,
                      plain_ms=f_plain, bound_ms=f_bound, bound_by=f_by,
                      library_ms=f_lib, library_device_ms=f_lib_dev),
        "decode": dict(name="decode_attention_fwd", route="cuda",
                       source="src/repro_torch/kernels/csrc/"
                              "decode_attention.cu",
                       replaces="src/repro/kernels/decode_attention/"
                                "decode_attention.py:90",
                       max_abs_err=d_err, ms=d_ms, device_ms=d_dev,
                       plain_ms=d_plain, bound_ms=d_bound, bound_by=d_by,
                       library_ms=d_lib, library_device_ms=d_lib_dev),
    }


def _family_shapes() -> tuple:
    """The call shapes InternVL2-2B's, Whisper-medium's and
    Qwen3-MoE-30B-A3B's paths give K1 and K2 at 8 x 512 positions and 32
    steps, Gemma-2-2B's token path (hd 256, cap 50) at 8 prompts of 512
    tokens in a cache of ``KV_BUDGET`` positions, and the examples phase's
    quickstart (SmolLM-360M) at its largest bucket of ``(n, 32)`` tokens
    (one partial q tile), by name: K1 cases (B, Tq, Tk, H, KV, hd, causal,
    window, cap), K2 cases ((B, S, H, KV, hd, pos, window, cap), whether
    the cache is read through a transposed view)."""
    vlm, enc, mo, gem, sm = (get_config(a) for a in (
        VLM_ARCH, ENCDEC_ARCH, MOE_ARCH, TOKEN_ARCH, ARCH))
    S, Se = PROMPT + STEPS, enc.encoder_seq_len
    gv = (vlm.num_heads, vlm.num_kv_heads, vlm.head_dim)
    ge = (enc.num_heads, enc.num_kv_heads, enc.head_dim)
    gm = (mo.num_heads, mo.num_kv_heads, mo.head_dim)
    gg = (gem.num_heads, gem.num_kv_heads, gem.head_dim)
    gs = (sm.num_heads, sm.num_kv_heads, sm.head_dim)
    cap = gem.attn_logit_softcap
    flash = {
        "internvl2 prefill": (BATCH, PROMPT, PROMPT, *gv, True, None, None),
        "whisper encoder": (BATCH, Se, Se, *ge, False, None, None),
        "whisper self prefill": (BATCH, PROMPT, PROMPT, *ge, True, None,
                                 None),
        "whisper cross prefill": (BATCH, PROMPT, Se, *ge, False, None, None),
        "qwen3-moe prefill": (BATCH, PROMPT, PROMPT, *gm, True, None, None),
        "gemma2 prefill": (BATCH, PROMPT, PROMPT, *gg, True, None, cap),
        "quickstart prefill": (QUICK_MAX_ITEMS, quickstart.SEQ,
                               quickstart.SEQ, *gs, True, None, None),
    }
    decode = {
        "internvl2 decode": ((BATCH, S, *gv, S - 1, None, None), False),
        "whisper self decode": ((BATCH, S, *ge, S - 1, None, None), False),
        "whisper cross decode": ((BATCH, Se, *ge, Se - 1, None, None), True),
        "qwen3-moe decode": ((BATCH, S, *gm, S - 1, None, None), False),
        "gemma2 decode": ((BATCH, KV_BUDGET, *gg, PROMPT, None, cap), False),
    }
    return flash, decode


def phase_family_shapes() -> dict:
    """K1 and K2 at the call shapes of InternVL2-2B (hd 128, G 2),
    Qwen3-MoE-30B-A3B (hd 128, G 8), Whisper-medium (hd 64, G 1; 1500
    encoder frames, not a multiple of either wgmma tile; non-causal
    encoder and cross-attention; the decode step's cross-attention through
    a transposed view of the (B, S_enc, KV, hd) cache), Gemma-2-2B (hd
    256, G 2, cap 50: K1's wgmma body, also at each of its tiles, timed
    with and without the cap) and the full-width quickstart
    (hd 64, G 3, 128 x 32 positions: a partial q tile), each held against
    its plain version in float32 and bfloat16 with the body asserted, then
    timed in bf16 on the device alone, with its window and cap, beside SDPA
    at the same shape (which has no cap), with its bound."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(19)
    flash, decode = _family_shapes()
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, case in flash.items():
            rows.setdefault(name, {})[dtype] = _check_flash(gen, case,
                                                            dtype)[0]
        for name, (case, view) in decode.items():
            rows.setdefault(name, {})[dtype] = _check_decode(
                gen, case, dtype, True, view=view)[0]
    dt = torch.bfloat16
    # Gemma-2-2B's prefill call at each wgmma tile of head_dim 256: held
    # against the plain version, then timed on the device alone with its
    # cap, without it (the cap's share of the kernel's time) and at one
    # sequence (the token path's prefill call); and the CUDA-core body at
    # the same call, on a view off the 16-byte rule
    case = flash["gemma2 prefill"]
    B, Tq, Tk, H, KV, hd, causal, window, cap = case
    q, k, v = _qkv(gen, (B, Tq, H, hd + 4), (B, Tk, KV, hd + 4), dt)
    views = tuple(x[..., 4:] for x in (q, k, v))
    q, k, v = (x[..., :hd].contiguous() for x in (q, k, v))

    def gemma_ms(q, k, v, c=cap, tile=(None, None)):
        return _graph_ms(lambda: flash_ops.flash_attention(
            q, k, v, causal=causal, window=window, logit_cap=c,
            block_q=tile[0], block_k=tile[1]))

    for tile in k1.TILES[hd]:
        err = _check_flash(gen, case, dt, tile=tile)[0]
        print(f"[kernels] K1 at the gemma2 prefill shape {case}, wgmma tile "
              f"{tile[0]}x{tile[1]}: max |kernel - plain| bfloat16 "
              f"{err:.3e} (tol 2e-2); bf16 device "
              f"{gemma_ms(q, k, v, tile=tile):.4f} ms with the cap, "
              f"{gemma_ms(q, k, v, None, tile):.4f} ms without it, "
              f"{gemma_ms(q[:1], k[:1], v[:1], tile=tile):.4f} ms at B 1")
    print(f"[kernels] K1 at the gemma2 prefill shape {case}, CUDA-core body "
          f"(a view off the 16-byte rule): bf16 device "
          f"{gemma_ms(*views):.4f} ms")
    timed = {}
    for name, case in flash.items():
        B, Tq, Tk, H, KV, hd, causal, window, cap = case
        q, k, v = _qkv(gen, (B, Tq, H, hd), (B, Tk, KV, hd), dt)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        dev = _graph_ms(lambda: flash_ops.flash_attention(
            q, k, v, causal=causal, window=window, logit_cap=cap))
        lib = _graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
        plain = _time_ms(lambda: attention_ref(
            q, k, v, causal=causal, window=window, logit_cap=cap))
        pairs = B * H * (Tq * (Tq + 1) // 2 if causal else Tq * Tk)
        bound, by = _bound(2 * (2 * q.numel() + 2 * k.numel()),
                           (4 * pairs * hd, BF16_FLOPS))
        timed[name] = ("K1", case, dev, lib, plain, bound, by)
    for name, (case, view) in decode.items():
        B, S, H, KV, hd, pos, window, cap = case
        qd = _rand(gen, (B, H, hd), dt, 2.0)
        if view:
            kc, vc = (_rand(gen, (B, S, KV, hd), dt, s).transpose(1, 2)
                      for s in (2.0, 0.5))
        else:
            kc, vc = (_rand(gen, (B, KV, S, hd), dt, s) for s in (2.0, 0.5))
        pd = torch.tensor([pos], dtype=torch.int32, device=DEV)
        dev = _graph_ms(lambda: decode_ops.decode_attention_kvmajor(
            qd, kc, vc, pd, window=window, logit_cap=cap))
        live = pos + 1
        lib = _graph_ms(lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kc[:, :, :live], vc[:, :, :live],
            enable_gqa=True))
        plain = _time_ms(lambda: decode_attention_ref(
            qd, kc.transpose(1, 2), vc.transpose(1, 2), pos, window=window,
            logit_cap=cap))
        bound, by = _bound(2 * (2 * qd.numel() + 2 * B * KV * live * hd),
                           (4 * B * H * live * hd, BF16_FLOPS))
        timed[name] = ("K2", case, dev, lib, plain, bound, by)
    for name, (kern, case, dev, lib, plain, bound, by) in timed.items():
        err = rows[name]
        print(f"[kernels] {kern} at the {name} shape {case}: max |kernel "
              f"- plain| float32 {err[torch.float32]:.3e} (tol 2e-5), "
              f"bfloat16 {err[torch.bfloat16]:.3e} (tol 2e-2); bf16 device "
              f"{dev:.4f} ms, sdpa device {lib:.4f} ms, plain {plain:.4f} "
              f"ms, bound {bound:.4f} ms ({by})")
    return timed


def _ssd_inputs(gen, case, bc_dtype, x_dtype=torch.float32,
                view: int = 0) -> tuple:
    """The reference test's distributions: x, dt (softplus'd), A
    (negative), Bm, Cm; x in ``x_dtype``, B and C in ``bc_dtype``.
    ``view``: x is a slice ``view`` elements into rows of (B, T, H * P +
    16), as the model's x is a slice of the convolution's output (8 keeps
    the 16-byte rule, 1 breaks it)."""
    B, T, H, P, N, _ = case
    x = _rand(gen, (B, T, H, P), x_dtype)
    if view:
        wide = torch.zeros((B, T, H * P + 16), dtype=x_dtype, device=DEV)
        wide[..., view:view + H * P] = x.reshape(B, T, H * P)
        x = wide[..., view:view + H * P].unflatten(-1, (H, P))
    dt = F.softplus(_rand(gen, (B, T, H), torch.float32, 1.0))
    A = -torch.exp(_rand(gen, (H,), torch.float32))
    return (x, dt, A, _rand(gen, (B, T, N), bc_dtype),
            _rand(gen, (B, T, N), bc_dtype))


def _ssd_work_f32_cores(case, bc_dtype) -> tuple:
    """(bytes, work) as the first body counted them, for the history:
    the wrapper's float32 xdt and dA read and y written heads-first, C Bᵀ
    once per (batch, chunk) at the peak for B and C's dtype, the other
    products at the float32 CUDA-core peak (67 TFLOP/s)."""
    B, T, H, P, N, c = case
    nc = T // c
    nbytes = 4 * (2 * B * H * T * P + B * H * T + B * H * P * N) \
        + 2 * bc_dtype.itemsize * B * T * N
    pairs = nc * c * (c + 1) // 2         # causal (t, s) pairs per sequence
    bc_peak = BF16_FLOPS if bc_dtype == torch.bfloat16 else F32_FLOPS
    scores = (2 * B * pairs * N, bc_peak)
    f32 = (2 * B * H * (pairs * P + (2 * nc - 1) * c * P * N), F32_FLOPS)
    return nbytes, (scores, f32)


def _check_ssd(gen, case, bc, xd, view=0) -> tuple:
    x, dt, A, Bm, Cm = _ssd_inputs(gen, case, bc, xd, view)
    y, st = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=case[-1])
    yr, sr = ssd_chunked(x.float(), dt, A, Bm, Cm, case[-1])
    torch.cuda.synchronize()
    for got, want in ((y, yr), (st, sr)):
        assert torch.isfinite(got).all(), ("ssd", case, bc, xd, view)
        assert torch.allclose(got, want, atol=SSD_TOL, rtol=SSD_TOL), \
            ("ssd kernel disagrees", case, bc, xd, view, _maxerr(got, want))
    return max(_maxerr(y, yr), _maxerr(st, sr)), _relerr(y, yr)


def phase_ssd() -> dict:
    """K4 against its plain version over the reference's cases and the two
    serving shapes, with float32 and bfloat16 x and B/C, and x as a
    strided slice (16-byte aligned as the model's, and not), at 2e-3;
    timed at the Mamba2 serving shape in bf16, as the bf16 model gives
    its inputs."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(4)
    shapes = {}
    for arch in (SSM_ARCH, HYBRID_ARCH):
        cfg = get_config(arch)
        H, P = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
        shapes[arch] = (BATCH, PROMPT, H, P, cfg.ssm_state_size,
                        min(cfg.ssm_chunk_size, PROMPT))
    worst = {}
    for xd in (torch.float32, torch.bfloat16):
        for bc in (torch.float32, torch.bfloat16):
            errs = [_check_ssd(gen, case, bc, xd)
                    for case in SSD_CASES + list(shapes.values())]
            errs += [_check_ssd(gen, SSD_CASES[2], bc, xd, view)
                     for view in (8, 1)]
            worst[xd, bc] = (max(e for e, _ in errs),
                             max(r for _, r in errs), len(errs))
    shown = "; ".join(
        f"x {str(xd)[6:]} B/C {str(bc)[6:]} {a:.3e} ({r:.3e} of mean "
        f"|plain y|)" for (xd, bc), (a, r, _) in worst.items())
    n = next(iter(worst.values()))[2]
    print(f"[kernels] ssd_scan: max |kernel - plain| (y and state) over {n} "
          f"cases each (two with x a strided slice): {shown}; tol "
          f"{SSD_TOL:g}")

    case = shapes[SSM_ARCH]
    chunk = case[-1]
    bf = torch.bfloat16
    x, dt, A, Bm, Cm = _ssd_inputs(gen, case, bf, bf)
    y, st = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    yr, sr = ssd_chunked(x.float(), dt, A, Bm, Cm, chunk)
    err = max(_maxerr(y, yr), _maxerr(st, sr))
    ms, dev = _ms(lambda: ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk))
    plain = _time_ms(lambda: ssd_chunked(x.float(), dt, A, Bm, Cm, chunk))
    nbytes, work = k4.work(*case, 2, 2)
    bound, by = _bound(nbytes, *work)
    (cb, _), (tf32, _) = work
    old_bytes, old_work = _ssd_work_f32_cores(case, bf)
    old_bound, old_by = _bound(old_bytes, *old_work)
    print(f"[kernels] ssd_scan at (B, T, H, P, N, chunk) {case} bf16 x and "
          f"B/C, through ops.ssd_scan ({k4.KERNELS_PER_CALL} kernels, xdt "
          f"and dA formed inside): kernel eager {ms:.4f} ms, device "
          f"{dev:.4f} ms; plain {plain:.4f} ms (ssd_chunked); bound "
          f"{bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, C B^T "
          f"{cb / 1e9:.3f} GFLOP at the bf16 {BF16_FLOPS / 1e12:.0f} "
          f"TFLOP/s, {tf32 / 1e9:.3f} GFLOP of TF32 products, split ones "
          f"counted thrice, at {TF32_FLOPS / 1e12:.0f} TFLOP/s); the first "
          f"body's float32-CUDA-core bound {old_bound:.4f} ms ({old_by}); "
          f"no single PyTorch call computes the scan")
    return dict(name="ssd_scan_fwd", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan/ssd_scan.py:80",
                max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None,
                library_device_ms=None, bound_ms_f32_cores=old_bound)


def _paged_inputs(gen, case, dtype, shuffle: bool) -> tuple:
    """q and a dense cache chopped into a (P, psz, KV, hd) pool, with the
    block table (pages scattered through the pool when ``shuffle``) and
    the lengths on the card."""
    B, S, H, KV, hd, psz, lens, _, _ = case
    q, k, v = _qkv(gen, (B, H, hd), (B, S, KV, hd), dtype)
    ns = S // psz
    P = B * ns
    kp, vp = k.reshape(P, psz, KV, hd), v.reshape(P, psz, KV, hd)
    tbl = torch.arange(P, dtype=torch.int32, device=DEV).reshape(B, ns)
    if shuffle:
        perm = torch.randperm(P, generator=gen, device=DEV)
        kp, vp = kp[perm], vp[perm]
        tbl = torch.argsort(perm).to(torch.int32).reshape(B, ns)
    return q, kp, vp, torch.tensor(lens, dtype=torch.int32, device=DEV), tbl


def _check_paged(gen, case, dtype, shuffle: bool = True,
                 garbage: bool = False, view: bool = False) -> float:
    """K3 against its plain version at ``case``.  ``garbage``: pages past
    each length hold 1e4 and their table entries 10,000; ``view``: the
    pool is a view 2 elements into rows of hd + 2, off the 16-byte rule."""
    window, cap = case[-2:]
    q, kp, vp, lens, tbl = _paged_inputs(gen, case, dtype, shuffle)
    ref = paged_decode_attention_ref(q, kp, vp, lens, tbl, window=window,
                                     logit_cap=cap)
    if garbage:   # the reference's test: poison what lies past each length
        psz = kp.shape[1]
        used = (torch.arange(tbl.shape[1], device=DEV)[None, :]
                < ((lens + psz - 1) // psz)[:, None])
        bad = torch.ones(kp.shape[0], dtype=torch.bool, device=DEV)
        bad[tbl[used].long()] = False
        kp = torch.where(bad[:, None, None, None], 1e4, kp).to(dtype)
        vp = torch.where(bad[:, None, None, None], 1e4, vp).to(dtype)
        tbl = torch.where(used, tbl, 10_000)
    if view:
        hd = kp.shape[-1]
        kp, vp = (torch.cat([torch.zeros_like(x[..., :2]), x], -1)[..., 2:]
                  for x in (kp, vp))
        assert kp.data_ptr() % 16 and kp.stride(2) == hd + 2
    out = decode_ops.paged_decode_attention(q, kp, vp, lens, tbl,
                                            window=window, logit_cap=cap)
    torch.cuda.synchronize()      # a read out of range would fault here
    tol = TOL[dtype]
    assert torch.isfinite(out.float()).all(), ("paged", case, dtype)
    assert torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol), \
        ("paged kernel disagrees", case, dtype, _maxerr(out, ref))
    assert (out[lens == 0] == 0).all(), ("freed slot not zero", case)
    return _maxerr(out, ref)


def _kernels_per_call(fn) -> list:
    """The names of the CUDA kernels one call of ``fn`` runs, from
    torch.profiler's trace of the card."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def _paged_timing(gen, case, dtype) -> tuple:
    """(kernel eager ms, kernel device ms, plain ms, bound ms, bound_by,
    max |err|, live keys, bytes, the CUDA kernels of one traced call) at
    ``case``.
    The bound counts the live keys' K and V, q and o, and the table
    entries of the live pages, each moved once."""
    B, S, H, KV, hd, psz, lens, _, _ = case
    q, kp, vp, lens_t, tbl = _paged_inputs(gen, case, dtype, True)
    err = _maxerr(decode_ops.paged_decode_attention(q, kp, vp, lens_t, tbl),
                  paged_decode_attention_ref(q, kp, vp, lens_t, tbl))
    call = lambda: decode_ops.paged_decode_attention(  # noqa: E731
        q, kp, vp, lens_t, tbl)
    ms, dev = _ms(call)
    names = _kernels_per_call(call)
    plain = _time_ms(lambda: paged_decode_attention_ref(q, kp, vp, lens_t,
                                                        tbl))
    live = sum(lens)
    pages = sum(math.ceil(n / psz) for n in lens)
    size = q.element_size()
    nbytes = size * (2 * live * KV * hd + 2 * B * H * hd) + 4 * (pages + B)
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    bound, by = _bound(nbytes, (4 * live * H * hd, peak))
    return ms, dev, plain, bound, by, err, live, nbytes, names


def phase_paged() -> dict:
    """K3 against its plain version: the reference's PAGED_CASES (pages
    shuffled through the pool), each page size (pages in order), the
    garbage-page/garbage-table case, the two timing shapes, and the new
    body's own cases (splits past a cluster, G 48, a pool off the 16-byte
    rule), in both dtypes; then timed at SmolLM's decode geometry (bf16)
    beside K2 at the same geometry, in turns, and at the ragged shape
    (float32), with the split plan and the CUDA kernels of one call."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(13)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs = ([_check_paged(gen, c, dtype) for c in PAGED_CASES]
                + [_check_paged(gen, c, dtype, shuffle=False)
                   for c in PAGE_SIZE_CASES]
                + [_check_paged(gen, (2, 256, 4, 2, 64, 64, (70, 128), None,
                                      None), dtype, False, garbage=True)]
                + [_check_paged(gen, c, dtype)
                   for c in (PAGED_SMOLLM, PAGED_RAGGED)]
                + [_check_paged(gen, PAGED_WALK, dtype),
                   _check_paged(gen, PAGED_G48, dtype),
                   _check_paged(gen, PAGED_VIEW, dtype, view=True)])
        worst[dtype] = (max(errs), len(errs))
    (f_abs, n), (b_abs, _) = worst[torch.float32], worst[torch.bfloat16]
    print(f"[kernels] paged_decode_attention: max |kernel - plain| over {n} "
          f"cases (garbage pages and a 10,000-entry table included, no "
          f"fault at the synchronise; 20 splits walked by clusters of 16; "
          f"G 48; a pool view off the 16-byte rule): float32 {f_abs:.3e} "
          f"(tol 2e-5), bfloat16 {b_abs:.3e} (tol 2e-2); freed slots "
          f"exactly 0")
    rows = {}
    for name, case, dtype in (("smollm", PAGED_SMOLLM, torch.bfloat16),
                              ("ragged", PAGED_RAGGED, torch.float32)):
        B, S, H, KV, hd, psz = case[:6]
        split_len, n_split = k3.split_plan(B * KV, S // psz, psz)
        smem = k3.smem_bytes(dtype.itemsize, hd, H // KV)
        ms, dev, plain, bound, by, err, live, nbytes, names = _paged_timing(
            gen, case, dtype)
        rows[name] = (ms, dev, plain, bound, by, err)
        print(f"[kernels] paged_decode_attention at (B, S, H, KV, hd, psz) "
              f"{case[:6]} lens {case[6]} {str(dtype)[6:]}: kernel eager "
              f"{ms:.4f} ms, device {dev:.4f} ms; plain {plain:.4f} ms, "
              f"bound {bound:.4f} ms ({by}: "
              f"{live} live keys, {nbytes / 1e6:.3f} MB); no single "
              f"PyTorch call reads a block table")
        print(f"[kernels] paged_decode_attention at {case[:6]}: split plan "
              f"{n_split} splits of {split_len} keys, clusters of "
              f"{min(n_split, k3.MAX_CLUSTER)}, "
              f"{k3.blocks(B * KV, H // KV, n_split)} blocks of "
              f"{smem} B of shared memory; CUDA kernels in one traced "
              f"call: {len(names)} {names}")
        assert len(names) == 1 and "paged_kernel" in names[0], names
    # K2 at the same geometry, the yardstick, on the same keys gathered into
    # its dense (B, KV, S, hd) cache, in turns with K3: K3, K2, K2, K3, each
    # on the device alone
    B, S, H, KV, hd = PAGED_SMOLLM[:5]
    q, kp, vp, lens, tbl = _paged_inputs(gen, PAGED_SMOLLM, torch.bfloat16,
                                         True)
    k, v = (x[tbl.long()].reshape(B, S, KV, hd).transpose(1, 2).contiguous()
            for x in (kp, vp))
    pos = torch.tensor([S - 1], dtype=torch.int32, device=DEV)
    turns = {"k3": [], "k2": []}
    for name in ("k3", "k2", "k2", "k3"):
        turns[name].append(_graph_ms(
            (lambda: decode_ops.paged_decode_attention(q, kp, vp, lens, tbl))
            if name == "k3" else
            (lambda: decode_ops.decode_attention_kvmajor(q, k, v, pos))))
    print(f"[kernels] at SmolLM's decode geometry (B 8, S 544, H 15, KV 5, "
          f"hd 64) bf16, device ms in turns K3, K2, K2, K3: K3 "
          + " / ".join(f"{x:.4f}" for x in turns["k3"]) + "; K2 "
          + " / ".join(f"{x:.4f}" for x in turns["k2"])
          + f"; K3 / K2 {sum(turns['k3']) / sum(turns['k2']):.2f}x")
    ms, dev, plain, bound, by, err = rows["smollm"]
    return dict(name="paged_decode_attention_fwd", route="cuda",
                source="src/repro_torch/kernels/csrc/"
                       "paged_decode_attention.cu",
                replaces="src/repro/kernels/decode_attention/"
                         "paged_decode_attention.py:103",
                max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None,
                library_device_ms=None,
                k2_device_ms_same_geometry=sum(turns["k2"]) / 2)


def _bound_used(got, want, atol, rtol) -> float:
    """Share of the bound |got - want| <= atol + rtol |want| used (<= 1
    passes)."""
    return (((got - want).abs() - rtol * want.abs()).max() / atol).item()


def _check_logits(got, want, atol, rtol, what, routing=None) -> tuple:
    """Logits agree within atol + rtol |want|; an argmax that differs must
    be a near-tie of the plain path (its logit at the kernel path's choice
    within atol of its max).  ``routing`` (an MoE model's, from
    ``_routing_diff``): a row past the bound, or whose argmax differs off
    a near-tie, passes only as a routing near-tie (``ROUTE_DRIFT``), which
    is printed with its top-k margin.  Returns the numbers of rows whose
    argmax differs and of rows passed as routing near-ties."""
    assert got.shape == want.shape and torch.isfinite(got).all(), what
    used = (((got - want).abs() - rtol * want.abs()).amax(-1) / atol)
    a_got, a_want = got.argmax(-1), want.argmax(-1)
    diff = a_got != a_want
    top = want.max(-1).values
    at_got = want.gather(-1, a_got[:, None])[:, 0]
    off = (used > 1.0) | (diff & (top - at_got > atol))
    ties = 0
    for row in off.nonzero()[:, 0].tolist():
        first = (routing or {}).get(row)
        assert first is not None, (what, "row", row, _maxerr(got[row],
                                                               want[row]),
                                   float(used[row]), "argmax", bool(diff[row]))
        layer, margin, drift = first
        assert drift <= ROUTE_DRIFT and margin <= 2 * drift, \
            (what, "row", row, "routing differs first at layer", layer,
             "top-k margin", margin, "router-logit drift", drift)
        ties += 1
        print(f"[model] {what}: row {row} past the bound "
              f"({float(used[row]):.2f} of it, max |dlogit| "
              f"{_maxerr(got[row], want[row]):.3e}, "
              f"argmax {'differs' if diff[row] else 'equal'}) passes as a "
              f"routing near-tie: its routing first differs at MoE layer "
              f"{layer}, where the largest top-k margin of a flipped token is "
              f"{margin:.3e} (the least gap between neighbours among the "
              f"plain path's k + 1 largest router logits) and the largest "
              f"router-logit drift between the paths {drift:.3e} (rule: "
              f"drift <= {ROUTE_DRIFT:g} and margin <= 2 drift)")
    return int(diff.sum()), ties


@contextlib.contextmanager
def _routing_recorded():
    """While open, each MoE routing call appends to the yielded list its
    router logits (tokens, E) float32 and its kept (token, expert) slots
    (tokens, E) bool, tokens in (sequence, position) order, one entry per
    MoE layer in order."""
    calls = []
    route = moe._route

    def recorded(hg, p, cfg, C):
        out = route(hg, p, cfg, C)
        calls.append((moe.router_logits(hg, p).flatten(0, 1),
                      (out[0].sum(-1) > 0).flatten(0, 1)))
        return out

    moe._route = recorded
    try:
        yield calls
    finally:
        moe._route = route


def _routing_diff(plain, kern, B: int, K: int) -> tuple:
    """Two recorded runs (``_routing_recorded``) of one batch of B
    sequences.  Per MoE layer: the tokens whose top-K experts differ, as a
    set or in slot order (flips), and those whose kept slots differ (a
    flip, or a capacity drop a flip moved).  Per sequence whose routing
    differs, at the first layer where it does: (layer, the largest top-K
    margin of a flipped token of its routing group, and the largest drift
    of a router logit between the runs over the group).  A token's top-K
    margin is the least gap between neighbours among the plain run's K + 1
    largest router logits: no flip is possible while it exceeds twice the
    drift.  A sequence's routing group is the sequence itself at prefill
    (a 256-token group never spans two) and the batch at decode."""
    per_layer, first = [], {}
    for layer, ((lx, kx), (lk, kk)) in enumerate(zip(plain, kern)):
        vals, idx = lx.topk(K + 1, dim=-1)
        flip = (idx[:, :K] != lk.topk(K, dim=-1).indices).any(-1)
        moved = (kx != kk).any(-1)
        per_layer.append((int(flip.sum()), int(moved.sum())))
        margin = (vals[:, :K] - vals[:, 1:]).amin(-1)
        drift = (lk - lx).abs().amax(-1)
        T = flip.numel() // B
        for b in range(B):
            own = slice(b * T, (b + 1) * T)
            if b in first or not (flip[own] | moved[own]).any():
                continue
            grp = own if T > 1 else slice(None)
            m = margin[grp][flip[grp]]
            first[b] = (layer, m.max().item() if m.numel() else math.inf,
                        drift[grp].max().item())
    return per_layer, first


MOE_RANGES = ("moe_block", "moe_route")


@contextlib.contextmanager
def _moe_ranges():
    """While open, each MoE block and its routing run inside a
    ``record_function`` range (``MOE_RANGES``) that ``_moe_split`` reads
    from a trace."""
    block, route = moe.moe_block_apply, moe._route

    def ranged(fn, name):
        def call(*args):
            with torch.profiler.record_function(name):
                return fn(*args)
        return call

    moe.moe_block_apply = ranged(block, "moe_block")
    moe._route = ranged(route, "moe_route")
    try:
        yield
    finally:
        moe.moe_block_apply, moe._route = block, route


def _kernel_us(ev) -> float:
    """Device us of the kernels launched by the op ``ev`` and the ops under
    it (the ranges' own GPU annotations left out)."""
    return (sum(k.duration for k in ev.kernels if k.name not in MOE_RANGES)
            + sum(_kernel_us(ch) for ch in ev.cpu_children))


def _moe_split(prof) -> dict:
    """Device ms, from a trace taken under ``_moe_ranges``, of the MoE
    blocks' kernels, of their routing's, and of the einsums' of their
    dispatch, experts and combine (the einsums outside the routing)."""
    out = {"blocks": 0.0, "routing": 0.0, "einsums": 0.0}

    def walk(ev, in_route):
        for ch in ev.cpu_children:
            if ch.name == "moe_route":
                out["routing"] += _kernel_us(ch)
                walk(ch, True)
            elif ch.name == "aten::einsum" and not in_route:
                out["einsums"] += _kernel_us(ch)
            else:
                walk(ch, in_route)

    for ev in prof.events():
        if ev.name == "moe_block" and ev.device_type == DeviceType.CPU:
            out["blocks"] += _kernel_us(ev)
            walk(ev, False)
    return {k: v / 1e3 for k, v in out.items()}


def _clone(tree):
    """A copy of a cache: nested dicts and lists of tensors."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


# launches of each full-width model: K1 per prefill, K2 per decode step, K4
# per prefill
PATH_COUNTS = {ARCH: (32, 32, 0), SSM_ARCH: (0, 0, 48),
               HYBRID_ARCH: (6, 6, 32), VLM_ARCH: (24, 24, 0),
               ENCDEC_ARCH: (72, 48, 0), MOE_ARCH: (48, 48, 0),
               TOKEN_ARCH: (26, 26, 0)}


def _path_counts(cfg) -> tuple:
    """(K1 per prefill, K2 per decode step, K4 per prefill) from the
    config: an encoder-decoder's prefill runs its encoder layers and its
    decoder's self- and cross-attention through K1, its decode step the
    decoder's self- and cross-attention through K2."""
    if cfg.is_encoder_decoder:
        return (cfg.encoder_layers + 2 * cfg.num_layers,
                2 * cfg.num_layers, 0)
    attn = mamba = 0
    for kind, count in cfg.layer_groups:
        if kind == "mamba":
            mamba += count
        elif kind == "hybrid_super":
            mamba += count * cfg.hybrid_attn_every
            attn += count
        elif kind == "local_global":
            attn += 2 * count
        else:
            attn += count
    return attn, attn, mamba


def _lookup_cost(cfg, n_dec: int, step) -> None:
    """What the wrappers' autotune lookups (one per attention layer and
    decode step, memoised) cost: one lookup on the host clock, and the
    decode step with lookups on and off, in turns (on, off, off, on, ...),
    each the median of its runs."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    q = torch.zeros((BATCH, H, cfg.head_dim), dtype=torch.bfloat16,
                    device=DEV)
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        decode_ops._resolve_split_len(None, q, BATCH * KV, H // KV,
                                      PROMPT + STEPS)
    per_us = (time.perf_counter() - t0) / n * 1e6
    times = {True: [], False: []}
    for on in (True, False, False, True, True, False, False, True):
        autotune.configure(enabled=on)
        times[on].append(_wall_ms(step))
    autotune.configure(enabled=True)
    on_ms, off_ms = (sorted(times[k])[len(times[k]) // 2]
                     for k in (True, False))
    print(f"[model] {cfg.name} bf16 decode step, median of 4 runs each in "
          f"turns: with the memoised autotune lookups {on_ms:.2f} ms, "
          f"without {off_ms:.2f} ms; one lookup {per_us:.2f} us on the "
          f"host, {n_dec} per step = {n_dec * per_us / 1e3:.3f} ms")


def _free_gib() -> float:
    return torch.cuda.mem_get_info()[0] / 2 ** 30


def _moe_bounds(cfg, param_bytes: float) -> tuple:
    """An MoE model's least device times at BATCH x PROMPT: (the prefill's
    FLOP, its bound in ms, a decode step's bytes, its floor in ms).  The
    prefill counts each expert over the capacity slots of every routing
    group, the dispatch and combine products, the router, the attention
    projections, attention over its unmasked pairs and the head, at the
    bf16 peak; it also reads every weight once.  A step reads every weight
    but the embedding table (B rows of it) and the KV cache at its last
    position, over the memory rate."""
    d, E, K = cfg.d_model, cfg.num_experts, cfg.num_experts_per_tok
    f = cfg.moe_d_ff or cfg.d_ff
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tokens = BATCH * PROMPT
    g, n, _ = moe.route_groups(torch.empty((BATCH, PROMPT, 1),
                                           device="meta")).shape
    C = moe.capacity(n, E, K)
    per_layer = (g * E * C * 3 * 2 * d * f
                 + 2 * 2 * g * n * E * C * d
                 + 2 * tokens * d * E
                 + 2 * tokens * d * (2 * H + 2 * KV) * hd
                 + 4 * BATCH * H * PROMPT * (PROMPT + 1) // 2 * hd)
    flops = cfg.num_layers * per_layer + 2 * BATCH * d * cfg.vocab_size
    prefill, _ = _bound(param_bytes, (flops, BF16_FLOPS))
    esize = torch_dtype(cfg).itemsize
    kv = cfg.num_layers * 2 * BATCH * KV * (PROMPT + STEPS) * hd * esize
    step_bytes = param_bytes - cfg.vocab_size * d * esize + kv
    return flops, prefill, step_bytes, step_bytes / HBM_BPS * 1e3


def _routing_summary(per_layer: list, K: int) -> str:
    flips = {i: f for i, (f, _) in enumerate(per_layer) if f}
    return (f"{sum(f for f, _ in per_layer)} top-{K} flips (set or slot "
            f"order) and "
            f"{sum(m for _, m in per_layer)} tokens with other kept slots "
            f"over {len(per_layer)} MoE layers (flips by layer: "
            f"{flips or 'none'})")


def _model_run(arch: str, dtype: str, steps: int, layers_cut=None) -> None:
    """Full-width model: the kernel path against the plain path on the same
    inputs.  Each decode step starts both paths from the kernel path's
    cache, so a step compares the step alone.  ``layers_cut``: the model
    cut to that many layers, its widths kept.

    float32: atol = rtol = 1e-4; the two paths differ only in summation
    order, and a bf16 computation anywhere would miss this by far.
    bfloat16: over tens of layers any change of rounding grows chaotically,
    so the bound is the larger of the JAX bound for 2-layer models (3e-2
    prefill, 5e-2 decode, absolute) and twice the gap, measured in this
    run, between the plain path and itself with 64-key instead of 512-key
    attention blocks and 128-token instead of 256-token SSD chunks (same
    math, other rounding).

    An MoE model also has its init's peak memory held under its
    parameters' bytes + 2 GB, the routing decisions that differ between
    the two paths counted at each MoE layer (``_routing_diff``), a logits
    row past its bound passed only as a routing near-tie
    (``_check_logits``), and in bf16 the MoE blocks' share of the traced
    prefill and decode step, each beside its bound (``_moe_bounds``)."""
    cfg = get_config(arch).replace(dtype=dtype)
    full = cfg.num_layers
    if layers_cut:
        cfg = cfg.replace(num_layers=layers_cut)
    n_pre, n_dec, n_mamba = _path_counts(cfg)
    assert (n_pre, n_dec, n_mamba) == tuple(
        n * cfg.num_layers // full for n in PATH_COUNTS[arch]), \
        (arch, n_pre, n_dec, n_mamba)
    cfg_k, cfg_x = cfg.replace(kernel_impl="pallas"), cfg.replace(kernel_impl="xla")
    is_moe, K = bool(cfg.num_experts), cfg.num_experts_per_tok
    if is_moe:
        print(f"[model] {cfg.name} {dtype}, {cfg.num_layers} of its {full} "
              f"layers: {_free_gib():.2f} GiB free on the card before the "
              f"init")
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    params = api.init_params(cfg_k, seed=0)
    nparam = sum(x.numel() for x in tensor_leaves(params))
    pbytes = sum(x.numel() * x.element_size() for x in tensor_leaves(params))
    if is_moe:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        print(f"[model] {cfg.name} {dtype} api.init_params: peak "
              f"{peak / 1e9:.3f} GB allocated (torch.cuda.max_memory_"
              f"allocated) for {pbytes / 1e9:.3f} GB of parameters, "
              f"{(peak - pbytes) / 1e9:+.3f} GB (bound +2 GB)")
        assert peak < pbytes + 2e9, ("init peak memory", peak, pbytes)

    def run(fn):
        """``fn``'s result, and for an MoE model its routing calls."""
        if not is_moe:
            return fn(), None
        with _routing_recorded() as calls:
            out = fn()
        return out, calls

    def diff(plain, kern):
        return _routing_diff(plain, kern, BATCH, K) if is_moe else ([], None)

    batch = api.make_batch(cfg, InputShape("smoke", PROMPT, BATCH, "prefill"),
                           seed=1)
    cap = PROMPT + steps
    (lx, _), rx = run(lambda: api.prefill(params, batch, cfg_x, capacity=cap))
    floor_flips = None
    if dtype == "float32":
        floor, rtol = None, 1e-4
        atol = {"prefill": 1e-4, "decode": 1e-4}
    else:
        saved, layers.DEFAULT_BLOCK_K = layers.DEFAULT_BLOCK_K, 64
        try:
            (l64, _), r64 = run(lambda: api.prefill(
                params, batch, cfg_x.replace(ssm_chunk_size=128),
                capacity=cap))
        finally:
            layers.DEFAULT_BLOCK_K = saved
        floor, rtol = _maxerr(l64, lx), 0.0
        floor_flips = diff(rx, r64)[0]
        atol = {"prefill": max(3e-2, 2 * floor),
                "decode": max(5e-2, 2 * floor)}
    _reset_launches()
    (lk, ck), rk = run(lambda: api.prefill(params, batch, cfg_k,
                                           capacity=cap))
    torch.cuda.synchronize()
    assert (k1.LAUNCHES, k2.LAUNCHES, k4.LAUNCHES) == (n_pre, 0, n_mamba), \
        ("prefill launches", k1.LAUNCHES, k2.LAUNCHES, k4.LAUNCHES)
    body = _flash_body(torch_dtype(cfg), cfg.head_dim) if n_pre else None
    assert k1.LAUNCHES_BY_BODY.get(body, 0) == k1.LAUNCHES, \
        ("flash launches not all through the", body, "body",
         k1.LAUNCHES_BY_BODY)
    pre_flips, first = diff(rx, rk)
    flips, ties = _check_logits(lk, lx, atol["prefill"], rtol,
                                "prefill logits", first)
    p_err, p_jax = _maxerr(lk, lx), _bound_used(lk, lx, 3e-2, 3e-2)
    d_err = d_jax = 0.0
    dec_flips = [(0, 0)] * len(pre_flips)
    tok = lk.argmax(-1).to(torch.int32)
    assert api.prefill_len(batch) == PROMPT, api.prefill_len(batch)
    pos = torch.tensor(PROMPT, dtype=torch.int32, device=DEV)
    for step in range(steps):
        (dx, _), rdx = run(lambda: api.decode_step(params, _clone(ck), tok,
                                                   pos, cfg_x))
        before = k2.LAUNCHES
        (dk, ck), rdk = run(lambda: api.decode_step(params, ck, tok, pos,
                                                    cfg_k))
        torch.cuda.synchronize()
        assert k2.LAUNCHES - before == n_dec, ("decode launches", step)
        assert (k1.LAUNCHES, k4.LAUNCHES) == (n_pre, n_mamba), \
            "decode reached a prefill kernel"
        step_flips, first = diff(rdx, rdk)
        dec_flips = [(a + c, b + e) for (a, b), (c, e)
                     in zip(dec_flips, step_flips)]
        n_arg, n_tie = _check_logits(dk, dx, atol["decode"], rtol,
                                     f"decode step {step}", first)
        flips, ties = flips + n_arg, ties + n_tie
        d_err = max(d_err, _maxerr(dk, dx))
        d_jax = max(d_jax, _bound_used(dk, dx, 5e-2, 5e-2))
        tok = dk.argmax(-1).to(torch.int32)
        pos = pos + 1
    counts = (k1.LAUNCHES, k2.LAUNCHES, k4.LAUNCHES)
    if is_moe:
        floor_part = ("" if floor_flips is None else
                      f"; plain path against itself with 64-key attention "
                      f"blocks (its rounding floor): "
                      f"{_routing_summary(floor_flips, K)}")
        print(f"[model] {cfg.name} {dtype} routing, kernel path against "
              f"plain path: prefill ({BATCH * PROMPT} tokens) "
              f"{_routing_summary(pre_flips, K)}; the {steps} decode steps "
              f"({BATCH} tokens each) {_routing_summary(dec_flips, K)}"
              f"{floor_part}; logits rows passed as routing near-ties: "
              f"{ties} of {BATCH * (steps + 1)}")
    if dtype == "bfloat16":    # the served dtype: time the kernel path
        def run_prefill():
            api.prefill(params, batch, cfg_k, capacity=cap)

        pre_ms = _wall_ms(run_prefill)
        step_ms = _wall_ms(lambda: api.decode_step(params, ck, tok, pos - 1,
                                                   cfg_k))
        if n_dec:
            _lookup_cost(cfg, n_dec, lambda: api.decode_step(
                params, ck, tok, pos - 1, cfg_k))
        print(f"[model] {cfg.name} bf16 kernel path, host clock around "
              f"synchronised runs: prefill {BATCH}x{PROMPT} {pre_ms:.2f} ms, "
              f"decode step {step_ms:.2f} ms")
        names = (("flash", FLASH_KERNEL.get(body, "flash_fwd"), n_pre),
                 ("ssd_scan", "ssd_", k4.KERNELS_PER_CALL * n_mamba),
                 ("of which its chunk states", "ssd_chunk_state_kernel",
                  n_mamba),
                 ("and its output", "ssd_chunk_scan_kernel", n_mamba))
        # a trace loses a record now and then (Mamba2's prefill once
        # counted 94 of its 96 SSD-scan kernels), which only ever lowers a
        # count: up to three prefills are traced until one counts every
        # kernel; a kernel the model missed or added shows in every trace
        for attempt in range(3):
            kern, busy, _, split = _profile_in(
                run_prefill, tuple(k for _, k, _ in names), moe_split=is_moe)
            counted = [n for _, n in kern]
            if counted == [want for _, _, want in names]:
                break
            assert attempt < 2, ("kernels in a traced prefill", names,
                                 counted)
        parts = []
        for (label, _, want), (ms, n) in zip(names, kern):
            if want:
                parts.append(f"{label} {ms:.3f} ms over {n} kernels, "
                             f"{ms / pre_ms:.1%} of the prefill")
        print(f"[model] {cfg.name} bf16 prefill under torch.profiler "
              f"(kernel time on the card alone): {'; '.join(parts)}; all "
              f"device activity {busy:.2f} ms, against the {pre_ms:.2f} ms "
              f"of an unprofiled prefill on the host clock (device idle "
              f"share {1 - busy / pre_ms:.1%})")
        if is_moe:
            flops, pre_bound, step_bytes, step_floor = _moe_bounds(cfg,
                                                                   pbytes)
            print(f"[model] {cfg.name} bf16 prefill, "
                  f"{_moe_share(split, busy)}; bound {pre_bound:.2f} ms "
                  f"({flops / 1e12:.2f} TFLOP at {BF16_FLOPS / 1e12:.0f} "
                  f"TFLOP/s), device activity {busy / pre_bound:.2f}x it")

        def run_step():
            api.decode_step(params, ck, tok, pos - 1, cfg_k)

        for attempt in range(3):       # as the prefill's trace above
            (dec, ssd), busy, _, split = _profile_in(
                run_step, ("::decode_kernel<", "ssd_"), moe_split=is_moe)
            if dec[1] == n_dec and ssd[1] == 0:
                break
            assert attempt < 2, ("decode step kernels", dec, ssd)
        k2_part = (f"decode attention {dec[0]:.3f} ms over {dec[1]} kernels "
                   f"(one per attention call), {dec[0] / step_ms:.1%} of "
                   f"the step; " if n_dec else "")
        print(f"[model] {cfg.name} bf16 decode step under torch.profiler: "
              f"{k2_part}all device activity {busy:.2f} ms, against the "
              f"{step_ms:.2f} ms of an unprofiled step on the host clock "
              f"(device idle share {1 - busy / step_ms:.1%})")
        if is_moe:
            print(f"[model] {cfg.name} bf16 decode step, "
                  f"{_moe_share(split, busy)}; weight-read floor "
                  f"{step_floor:.2f} ms ({step_bytes / 1e9:.2f} GB: every "
                  f"weight but the embedding table, and the KV cache, at "
                  f"{HBM_BPS / 1e12:.2f} TB/s), device activity "
                  f"{busy / step_floor:.2f}x it")
    bound = ("atol = rtol = 1e-4" if floor is None else
             f"atol {atol['prefill']:.3e} / {atol['decode']:.3e}, plain-path "
             f"rounding floor {floor:.3e}")
    cut = (f" (cut to {cfg.num_layers} of its {full} layers)"
           if layers_cut else "")
    print(f"[model] {cfg.name} full width ({nparam / 1e6:.1f}M params, "
          f"{cfg.num_layers} layers{cut}, {dtype}): prefill "
          f"{BATCH}x{PROMPT} + "
          f"{steps} decode steps, kernel path vs plain path: max |dlogit| "
          f"prefill {p_err:.3e}, decode {d_err:.3e} ({bound}); share of the "
          f"JAX 2-layer bounds used: prefill {p_jax:.2f} (3e-2), decode "
          f"{d_jax:.2f} (5e-2); argmax differs on {flips} of "
          f"{BATCH * (steps + 1)} rows (near-ties only); launches flash "
          f"{counts[0]}{f' (all {body})' if body else ''} decode {counts[1]} "
          f"ssd_scan {counts[2]} (= "
          f"{n_pre} flash and {n_mamba} ssd_scan per prefill, {n_dec} "
          f"decode per decode step)")
    del params, ck, lk, lx
    torch.cuda.empty_cache()


def _moe_share(split: dict, busy: float) -> str:
    return (f"MoE blocks {split['blocks']:.2f} ms of its {busy:.2f} ms of "
            f"device activity ({split['blocks'] / busy:.1%}; of them routing "
            f"{split['routing']:.2f} ms, the dispatch, expert and combine "
            f"einsums {split['einsums']:.2f} ms)")


def phase_model() -> None:
    """The float32 check and the bf16 run of each model, Qwen3-MoE last
    with its float32 check cut to MOE_F32_LAYERS layers."""
    for arch in (ARCH, SSM_ARCH, HYBRID_ARCH, VLM_ARCH, ENCDEC_ARCH,
                 MOE_ARCH):
        _model_run(arch, "float32", 4,
                   MOE_F32_LAYERS if arch == MOE_ARCH else None)
        torch.cuda.empty_cache()
        _model_run(arch, "bfloat16", STEPS)
        torch.cuda.empty_cache()


def _host_ms(fn) -> float:
    """Host clock around one run of ``fn`` between two synchronises."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _graph_run(arch: str) -> None:
    """``serve``'s executor at bucket BATCH: the request captured in a CUDA
    graph, replayed, and held against the eager path; both timed in turns
    (replay, eager, replay: the eager request is the one the tokens are
    held against); one replay traced."""
    free = _free_gib()
    ex, cfg = real_executor_for(arch, prompt_len=PROMPT, new_tokens=STEPS)
    n_pre, n_dec, n_mamba = _path_counts(cfg)
    t0 = time.perf_counter()
    ex.warmup(BATCH, 1)
    warm_s = time.perf_counter() - t0
    entry = ex._exec[BATCH]
    want = {"flash": n_pre, "flash/wgmma": n_pre,
            "decode": n_dec * STEPS, "ssd_scan": n_mamba}
    assert entry.launches == {k: v for k, v in want.items() if v}, \
        ("launches recorded in the capture", entry.launches, want)
    ex.run_step(BATCH, 1)
    replayed = entry.out.clone()

    def replay():
        entry.graph.replay()

    eager = []
    times = {"replay": [_host_ms(replay)],
             "eager": [_host_ms(lambda: eager.append(api.generate(
                 ex.params, entry.batch, cfg, STEPS)))]}
    times["replay"].append(_host_ms(replay))
    eager = eager[0]
    assert replayed.shape == (BATCH, STEPS + 1), replayed.shape
    assert int(replayed.min()) >= 0 and int(replayed.max()) < cfg.vocab_size
    assert torch.equal(replayed, eager), \
        ("replayed tokens differ from eager",
         int((replayed != eager).sum()))
    names = (("flash", "flash_fwd_wgmma_kernel", n_pre),
             ("decode", "::decode_kernel<", n_dec * STEPS),
             ("ssd_scan", "ssd_", k4.KERNELS_PER_CALL * n_mamba))
    # A trace this long (Qwen3-MoE's replay: 178,330 device events) loses
    # a few records at random, which only ever lowers a count.  Every
    # replay launches the same kernels, so up to three replays are traced
    # until one counts exactly the launches the capture recorded; a kernel
    # the graph missed or added shows in every trace.
    want = {label: n for label, _, n in names}
    totals = []
    while True:
        kern, busy, span, _ = _profile_in(
            replay, tuple(k for _, k, _ in names) + ("",))
        totals.append(kern.pop()[1])       # "" matches every event
        counted = {label: n for (label, _, _), (_, n) in zip(names, kern)}
        if counted == want:
            break
        assert len(totals) < 3, ("CUDA kernels in one replay", counted,
                                 "device events in each trace", totals)
    rep = sorted(times["replay"])[0]
    ours = ", ".join(f"{label} {ms:.2f} ms" for (label, _, n), (ms, _)
                     in zip(names, kern) if n)
    print(f"[graphs] {cfg.name} bf16, {BATCH}x{PROMPT} + {STEPS} steps "
          f"({free:.2f} GiB free on the card before the init; "
          f"{_free_gib():.2f} after the capture): "
          f"warm-up and capture {warm_s:.2f}s (capture "
          f"{ex.capture_time_s:.2f}s); replayed tokens equal the eager "
          f"path's ({replayed.numel()} tokens); host clock per request, in "
          f"turns: replay {', '.join(f'{t:.2f}' for t in times['replay'])} "
          f"ms, eager {', '.join(f'{t:.2f}' for t in times['eager'])} ms")
    print(f"[graphs] {cfg.name} one replay under torch.profiler (device "
          f"events in each trace taken: {totals}): CUDA "
          f"kernels {counted} (recorded in the capture: {entry.launches}), "
          f"{ours}; all device activity {busy:.2f} ms over a {span:.2f} ms "
          f"span (device idle share {1 - busy / span:.1%}); an unprofiled "
          f"replay {rep:.2f} ms on the host clock")
    del ex, entry, replayed, eager
    torch.cuda.empty_cache()


def phase_graphs() -> None:
    for arch in (ARCH, SSM_ARCH, HYBRID_ARCH, VLM_ARCH, ENCDEC_ARCH,
                 MOE_ARCH):
        _graph_run(arch)
        torch.cuda.empty_cache()


def _serve(arch: str, max_bs: int, max_mtl: int, steps: int) -> dict:
    """A user's serving run, under ``serve``'s default controller
    (DNNScaler), every bucket captured in a CUDA graph at warm-up.  Kernel
    launches are read over exactly the engine's run, after the buckets'
    warm-up, the SLO's calibration and the profiler's probes: the
    wrappers' own counts (launches outside a graph: none, with no miss)
    plus the executor's count of the graphs' replays."""
    free = _free_gib()
    t0 = time.perf_counter()
    ex, cfg = real_executor_for(arch, prompt_len=PROMPT, new_tokens=STEPS)
    n_pre, n_dec, n_mamba = _path_counts(cfg)
    # DNNScaler's Profiler probes (1, 1), (m, 1) and (1, n), then scales bs
    # at mtl 1 or mtl at bs 1, so no step needs more than max(max_bs,
    # max_mtl) items.  Largest first: each smaller bucket's graph then
    # reuses the shared pool's blocks, where in rising order every new
    # largest bucket adds blocks of its own (no block spans two segments).
    for n in sorted({ex.bucket(i) for i in range(1, max(max_bs, max_mtl)
                                                 + 1)}, reverse=True):
        ex.warmup(n, 1)
    warm_s = time.perf_counter() - t0
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    free_warm = _free_gib()
    warm_misses = ex.cache_stats.misses
    assert ex.captures == warm_misses, (ex.captures, warm_misses)
    ex.cache_stats.reset_counters()
    base = ex.mean_latency(1, 1)
    slo = 4 * base
    ctrl = make_controller("dnnscaler", ex, slo, m=8, n=4, max_bs=max_bs,
                           max_mtl=max_mtl)
    eng = ServingEngine(ex, slo, instance_launch_s=0.2)
    torch.cuda.synchronize()
    _reset_launches()
    ex.replayed_launches.clear()
    acc = eng.run(ctrl, max_steps=steps)
    torch.cuda.synchronize()
    eager = kernels.launch_counts()
    assert not any(eager.values()), ("launches outside the graphs", eager)
    replayed = ex.replayed_launches
    launches = {k: replayed[k] for k in ("flash", "decode", "ssd_scan")}
    assert replayed["flash/wgmma"] == replayed["flash"], \
        ("served flash launches not all through the wgmma body", replayed)
    s, batches = acc.summary(), len(acc.trace)
    act = ctrl.action()
    cs = ex.cache_stats
    replays = {n: e.replays for n, e in sorted(ex._exec.items())
               if e.replays}
    print(f"[serving] {cfg.name} full width, {PROMPT}-token prompts + "
          f"{STEPS} decode steps per request, buckets up to "
          f"{max(max_bs, max_mtl)} (max_bs {max_bs}, max_mtl {max_mtl}): "
          f"warmed {warm_misses} buckets in {warm_s:.1f}s, of which "
          f"{ex.capture_time_s:.1f}s capturing {ex.captures} CUDA graphs "
          f"(memory reserved after the warm-up {reserved:.2f} GiB, of "
          f"which parameters {ex.param_bytes / 2 ** 30:.2f}; free on the "
          f"card {free:.2f} GiB before the init, {free_warm:.2f} after the "
          f"warm-up); base "
          f"{base * 1e3:.1f} ms -> SLO "
          f"{slo * 1e3:.1f} ms; replays per bucket over the whole run "
          f"{replays}")
    print(f"[serving] controller dnnscaler: approach={ctrl.approach} "
          f"profiler picked "
          f"{ctrl.profile.approach}; steady(bs={act.bs}, mtl={act.mtl}); "
          f"throughput {s['throughput']:.2f} req/s; p95 "
          f"{s['p95_s'] * 1e3:.1f} ms; attainment {s['slo_attainment']:.3f}; "
          f"exec-cache hits {cs.hits} misses {cs.misses} stale hits "
          f"{cs.stale_hits} after warm-up")
    assert s["throughput"] > 0 and math.isfinite(s["p95_s"]), s
    assert cs.misses == 0, ("bucket-cache misses after warm-up", cs.misses)
    assert cs.stale_hits == 0, ("stale buckets served", cs.stale_hits)
    want = {"flash": n_pre * batches, "decode": n_dec * STEPS * batches,
            "ssd_scan": n_mamba * batches}
    assert launches == want and any(launches.values()), (launches, want)
    per = ", ".join(f"{k} {v} ({v / s['items']:.3f} per served request)"
                    for k, v in launches.items())
    print(f"[serving] kernel launches over the engine's run ({batches} "
          f"served batches = graph replays, {s['items']} served requests; "
          f"none outside a graph): {per}; per batch "
          f"{n_pre} flash{' (all wgmma)' if n_pre else ''}, "
          f"{n_dec * STEPS} decode, {n_mamba} ssd_scan")
    del ex, ctrl, eng
    torch.cuda.empty_cache()
    return launches


def phase_serving() -> tuple:
    """The main paths, each with its own counts: SmolLM-360M (K1, K2) and
    Mamba2-1.3B (K4) at buckets up to 64 and 40 steps, then InternVL2-2B,
    Whisper-medium and Qwen3-MoE-30B-A3B (K1, K2) at buckets up to 16 and
    10 steps.
    Returns the kernels' launches on the first paths that reach them
    (SmolLM, Mamba2), and every path's launches by model."""
    by_path = {get_config(arch).name: _serve(arch, *knobs)
               for arch, knobs in ((ARCH, (64, 4, 40)),
                                   (SSM_ARCH, (64, 4, 40)),
                                   (VLM_ARCH, (16, 4, 10)),
                                   (ENCDEC_ARCH, (16, 4, 10)),
                                   (MOE_ARCH, (16, 4, 10)))}
    smollm, mamba = (by_path[get_config(a).name] for a in (ARCH, SSM_ARCH))
    return ({"flash": smollm["flash"], "decode": smollm["decode"],
             "ssd_scan": mamba["ssd_scan"]}, by_path)


def _device_events(fn, complete=bool) -> list:
    """(name, start us, end us) of each device activity in torch.profiler's
    trace of one run of ``fn``, in start order.  A trace loses records now
    and then (a whole short trace once, past 170,000 events a few), which
    only ever lowers a count, so up to three runs are traced until
    ``complete`` accepts one's events; else this fails."""
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = sorted(((e.name, e.time_range.start, e.time_range.end)
                      for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e[1])
        if dev and complete(dev):
            return dev
    raise AssertionError(("no complete trace in three", len(dev)))


def _span_ms(events) -> tuple:
    """(device busy ms, span ms from the first start to the last end)."""
    busy = sum(end - start for _, start, end in events) / 1e3
    return busy, (max(e for *_, e in events) - events[0][1]) / 1e3


def _captured(run):
    """(graph, output): ``run`` warmed up and captured once in a CUDA
    graph of its own pool."""
    graphs = CudaGraphs(DEV)
    graphs.warm_up(run)
    return graphs.capture(run)


def _head_kernels(params, cfg, n: int, step: list) -> int:
    """How many of the last device activities of the decode step whose
    traced names are ``step`` are the head product's: those of
    ``head.logits_last`` on ``n`` rows (the bf16 product with float32
    output, ``mm.dtype``, then the final softcap), captured in a graph of
    their own and one replay traced.  A trace whose names are not the
    step's last fails."""
    x = torch.zeros((n, 1, cfg.d_model), dtype=torch_dtype(cfg), device=DEV)
    graph, _ = _captured(lambda: head.logits_last(params, x[:, 0], cfg))
    events = _device_events(graph.replay, lambda ev: [
        name for name, *_ in ev] == step[-len(ev):])
    del graph
    torch.cuda.empty_cache()
    return len(events)


def _head_check(params, cfg, n: int = 16) -> dict:
    """``head.head_logits`` (bf16 operands, float32 output and
    accumulation, no float32 copy of the head) on ``n`` rows drawn from
    seed 0, against the plain widened product on the same operands.  Both
    sum exact float32 products, in orders of their own, so each element
    lies within 2 d 2^-24 sum_k |h_k w_k| of the other (twice the bound of
    one float32 sum of d terms in any order).  Also each path's time per
    call, eager and on the device alone (``_ms``; the plain one over 5
    calls, each making a float32 copy of the head), beside the bound: the
    bf16 head and rows read once, the float32 logits written once."""
    w = head.head_matrix(params, cfg)
    g = torch.Generator(device=DEV).manual_seed(0)
    x = torch.randn((n, cfg.d_model), generator=g, device=DEV).to(w.dtype)
    got = head.head_logits(x, w)
    plain = x.float() @ w.float()
    bound = 2 * cfg.d_model * 2.0 ** -24 * (x.float().abs()
                                            @ w.float().abs())
    err = (got - plain).abs()
    ratio = (err / bound.clamp_min(1e-30)).max().item()
    assert got.dtype == torch.float32 and ratio <= 1.0, \
        ("head logits against the widened product", ratio)
    out = dict(err=_maxerr(got, plain), ratio=ratio)
    del got, plain, bound, err
    out["head"] = _ms(lambda: head.head_logits(x, w))
    plain = lambda: x.float() @ w.float()             # noqa: E731
    out["plain"] = (_time_ms(plain, 5), _graph_ms(plain, 5))
    V = w.shape[1]
    out["bound"] = _bound((cfg.d_model * V + n * cfg.d_model) * 2
                          + n * V * 4, (2 * n * cfg.d_model * V,
                                        BF16_FLOPS))
    return out


def _pool_gib(pool) -> float:
    """GiB of the allocator's segments in the graph pool ``pool``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool)) / 2 ** 30


def _ladder_rung(ex, cfg, n: int, n_attn: int) -> dict:
    """Bucket ``n``'s decode step: 20 replays on the host clock, one replay
    traced (device busy and span, K2's kernels, the head product: the
    step's last kernels, named as ``_head_kernels`` names them), and the
    launches its capture recorded."""
    entry = ex._exec[n]
    assert entry.launches == {"decode": n_attn}, \
        ("launches recorded in the capture", n, entry.launches)
    host = sorted(_host_ms(entry.graph.replay) for _ in range(20))

    def k2_of(events):
        return [e for e in events if "::decode_kernel<" in e[0]]

    events = _device_events(entry.graph.replay,
                            lambda ev: len(k2_of(ev)) == n_attn)
    busy, span = _span_ms(events)
    k2_ev = k2_of(events)
    n_head = _head_kernels(ex.params, cfg, n,
                           [name for name, *_ in events])
    tail = events[-n_head:]
    return dict(host=host, busy=busy, span=span,
                k2=sum(e - s for _, s, e in k2_ev) / 1e3,
                head=sum(e - s for _, s, e in tail) / 1e3,
                n_head=n_head, n_events=len(events),
                launches=dict(entry.launches))


def phase_tokens() -> dict:
    """The token path at full width: Gemma-2-2B (26 layers, hd 256, caps
    50 / 30; bf16, weights from seed 0), the model the reference's token
    engine serves by default.
      1. the model, kernel path against plain path: one 8 x 512 prefill
         and ``TOKEN_STEPS`` decode steps in float32 (1e-4) and in bf16
         (twice the plain path's floor), 26 K1 per prefill, 26 K2 a step;
      2. a 1 x 512 prefill captured in a CUDA graph, the median of 5
         replays on the host clock: the profile's measured ``prefill_ms``;
      3. ``serve.decode_executor_for``: one decode step per slot bucket,
         each bucket's cache filled by a prefill through K1 and its step
         captured in a CUDA graph, warmed largest first; the graph
         pool's size and the head against the widened product
         (``_head_check``); for each rung of
         ``SLOT_LADDER`` the step's host-clock ms (20 replays), one traced
         replay's device busy ms and idle share, K2's and the head
         product's ms within it, the launches recorded at capture;
      4. ``token_engine.run_continuous`` over it (the reference's ``serve
         --token-engine`` defaults but a 64-request trace): requests
         conserved, no bucket miss and no stale hit after the warm-up,
         every decode launch a replay's.
    Returns the path's launches: K1 over the warm-up (the prefills that
    fill the buckets' caches), K2 over the engine's run (replays)."""
    for dtype in ("float32", "bfloat16"):
        _model_run(TOKEN_ARCH, dtype, TOKEN_STEPS)
        torch.cuda.empty_cache()
    free = _free_gib()
    ex, cfg, prof = decode_executor_for(TOKEN_ARCH, prompt_len=PROMPT,
                                        kv_budget=KV_BUDGET)
    n_pre, n_attn, _ = _path_counts(cfg)

    one = api.make_batch(cfg, InputShape("tokens", PROMPT, 1, "prefill"),
                         seed=1)
    graph, _ = _captured(lambda: api.prefill(ex.params, one, cfg,
                                             capacity=KV_BUDGET))
    pre = sorted(_host_ms(graph.replay) for _ in range(5))
    del graph
    torch.cuda.empty_cache()
    ex.profile = dataclasses.replace(prof, prefill_ms=pre[2])
    print(f"[tokens] {cfg.name} bf16, 1 x {PROMPT} prefill into a "
          f"{KV_BUDGET}-position cache, one CUDA graph, 5 replays on the "
          f"host clock: {', '.join(f'{t:.3f}' for t in pre)} ms; median "
          f"{pre[2]:.3f} ms replaces the priced profile's prefill_ms "
          f"{prof.prefill_ms:.3f} (a TPU figure)")

    # the path: counts set to 0 before the buckets' warm-up, read after
    # the engine's run
    _reset_launches()
    t0 = time.perf_counter()
    for n in sorted(SLOT_LADDER, reverse=True):
        ex.warmup(n, 1)
    warm_s = time.perf_counter() - t0
    k1_warm = k1.LAUNCHES
    assert k1_warm == n_pre * len(SLOT_LADDER), ("prefills' K1", k1_warm)
    assert k1.LAUNCHES_BY_BODY["wgmma"] == k1_warm, k1.LAUNCHES_BY_BODY
    assert ex.captures == len(SLOT_LADDER) == ex.cache_stats.misses
    print(f"[tokens] {cfg.name} decode executor: {len(SLOT_LADDER)} slot "
          f"buckets {sorted(SLOT_LADDER)} warmed largest first in "
          f"{warm_s:.1f}s ({ex.cache_stats.compile_time_s:.1f}s charged as "
          f"compile time: each bucket's prefill through K1, {k1_warm} K1 "
          f"launches in all, and {ex.capture_time_s:.1f}s capturing "
          f"{ex.captures} CUDA graphs); caches {sum(SLOT_LADDER)} slots x "
          f"{ex.kv_bytes_per_item / 1e6:.1f} MB; {free:.2f} GiB free on "
          f"the card before the init, {_free_gib():.2f} after the warm-up; "
          f"memory reserved {torch.cuda.memory_reserved() / 2 ** 30:.2f} "
          f"GiB, of which parameters {ex.param_bytes / 2 ** 30:.2f}")
    pool = _pool_gib(ex._graphs.pool)
    hc = _head_check(ex.params, cfg)
    print(f"[tokens] {cfg.name} head (bf16 (16, {cfg.d_model}) x "
          f"({cfg.d_model}, {cfg.vocab_size}), float32 output): "
          f"max |err| {hc['err']:.3e} against the widened plain product, "
          f"{hc['ratio']:.3f} of the summation-order bound 2 d 2^-24 "
          f"sum|h w|; eager {hc['head'][0]:.4f} ms, device "
          f"{hc['head'][1]:.4f} ms (widened plain {hc['plain'][0]:.4f} / "
          f"{hc['plain'][1]:.4f} ms; bound {hc['bound'][0]:.4f} ms, "
          f"{hc['bound'][1]}); the decode steps' graph pool "
          f"{pool:.3f} GiB after the warm-up")
    for n in SLOT_LADDER:
        r = _ladder_rung(ex, cfg, n, n_attn)
        h = r["host"]
        print(f"[tokens] slot bucket {n:>2}: decode step host clock median "
              f"{h[len(h) // 2]:.3f} ms (20 replays, {h[0]:.3f}-{h[-1]:.3f}); "
              f"one traced replay: device busy {r['busy']:.3f} ms over a "
              f"{r['span']:.3f} ms span (idle share "
              f"{1 - r['busy'] / r['span']:.1%}, {r['n_events']} device "
              f"activities), K2 {r['k2']:.3f} ms over {n_attn} kernels, "
              f"head product {r['head']:.3f} ms over its {r['n_head']} "
              f"kernels ({r['head'] / r['busy']:.1%} of busy); launches "
              f"recorded at capture {r['launches']}")

    trace = ragged_decode_trace(64, seed=0, rate_rps=12.0, prefill_mean=512,
                                decode_mean=96, decode_sigma=0.8)
    ex.cache_stats.reset_counters()
    ex.replayed_launches.clear()
    _reset_launches()
    t0 = time.perf_counter()
    rep = run_continuous(trace, ex, max_slots=16, prefill_mode="cotenant",
                         ttft_slo_s=1.0, tpot_slo_s=0.050)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    eager = kernels.launch_counts()
    assert not any(eager.values()), ("launches outside the graphs", eager)
    cs = ex.cache_stats
    decode = ex.replayed_launches["decode"]
    replays = {n: e.replays for n, e in sorted(ex._exec.items())}
    print(f"[tokens] run_continuous ({len(trace)} requests at 12 req/s, "
          f"prompts about {PROMPT}, decode lengths lognormal mean 96; 16 "
          f"slots, cotenant prefill at the measured {pre[2]:.3f} ms; TTFT "
          f"SLO 1 s, TPOT SLO 50 ms; the engine's clock advanced by each "
          f"measured step) in {run_s:.1f}s: goodput "
          f"{rep['goodput_tokens_s']:.1f} tok/s, throughput "
          f"{rep['throughput_tokens_s']:.1f} tok/s, TTFT p95 "
          f"{rep['ttft_p95_s'] * 1e3:.2f} ms (attainment "
          f"{rep['ttft_attainment']:.3f}), TPOT p95 "
          f"{rep['tpot_p95_s'] * 1e3:.3f} ms (attainment "
          f"{rep['tpot_attainment']:.3f}), mean live slots "
          f"{rep['mean_live_slots']:.2f}, {rep['steps']} steps, "
          f"{rep['tokens_out']} tokens; submitted {rep['submitted']} = "
          f"completed {rep['completed']} + rejected {rep['rejected']} + "
          f"backlog {rep['backlog']}; bucket misses {cs.misses} and stale "
          f"hits {cs.stale_hits} after the warm-up, replays per bucket "
          f"{replays}")
    assert rep["conserved"] and rep["completed"] == len(trace), rep
    assert not rep["truncated"]
    assert cs.misses == 0, ("bucket-cache misses after warm-up", cs.misses)
    assert cs.stale_hits == 0, ("stale buckets served", cs.stale_hits)
    assert decode == n_attn * rep["steps"] > 0, (decode, rep["steps"])
    del ex
    torch.cuda.empty_cache()
    return {"flash": k1_warm, "decode": decode}


def _dense_attention(q, k, v, causal, window, cap):
    """Attention through a dense masked softmax in float64: the oracle of
    the blockwise attention's gradients.  q (B, T, H, hd), k/v (B, T, KV,
    hd), head h reading KV head h // G, as the port groups them."""
    G = q.shape[2] // k.shape[2]
    kk, vv = (x.double().repeat_interleave(G, dim=2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.double() * q.shape[-1] ** -0.5, kk)
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    pos = torch.arange(q.shape[1], device=q.device)
    mask = torch.ones_like(s[0, 0], dtype=torch.bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv)


def _grad_err(got, want) -> float:
    """max |got - want| over max |want|, leaf by leaf: the largest (a leaf
    the loss does not reach has zero gradients on both sides)."""
    return max(_maxerr(g, w) / max(w.float().abs().max().item(), 1e-30)
               for g, w in zip(got, want))


def _train_grads(params, batch, cfg, device):
    """(loss, aux, gradient leaves copied to the host) of
    ``api.train_loss`` on ``device``, from copies of ``params`` and
    ``batch`` there."""
    to = lambda x: x.to(device)  # noqa: E731
    loss, m, grads = loss_and_grads(adamw.tree_map(to, params),
                                    {k: to(v) for k, v in batch.items()}, cfg)
    return (loss.item(), m["aux"].item(),
            [g.cpu() for g in adamw.tree_leaves(grads)])


def _train_step_trace(params, cfg, kw) -> dict:
    """One ``loop.train_step`` (a fresh AdamW state, a batch of the
    corpus) under torch.profiler: the device's activities, their busy ms,
    the span from the first's start to the last's end, and the six names
    with the most device time (ms, count)."""
    tokens = torch.from_numpy(next(iter(TokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=kw["seq_len"],
        batch_size=kw["batch_size"], seed=1))))).to(DEV)
    opt = adamw.init(params)
    train_step(params, opt, tokens, cfg, lr=kw["lr"], remat=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_step(params, opt, tokens, cfg, lr=kw["lr"], remat=False)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert dev, "torch.profiler's trace holds no device time"
    by_name = {}
    for e in dev:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {"kernels": len(dev),
            "busy_ms": sum(ms for ms, _ in by_name.values()),
            "span_ms": (max(e.time_range.end for e in dev)
                        - min(e.time_range.start for e in dev)) / 1e3,
            "top": [(name, ms, n) for name, (ms, n) in top]}


def phase_train() -> dict:
    """Training on the card (``training/loop.py``, ``api.train_loss``,
    ``adamw.update``), every model with ``kernel_impl="pallas"``: the train
    path must reach no kernel (none has a backward), so the four launch
    counts, set to 0 before the phase, must still be 0 after it.
      1. the blockwise attention's gradients (``layers._Flash``'s
         recomputing backward), float32, against autograd through a
         dense masked softmax in float64, within 2e-5 of each largest
         gradient, at SmolLM's and Gemma-2's shapes; the forward and
         backward timed (20 calls between two CUDA events);
      2. SmolLM-360M at full width but ``TRAIN_CUT`` layers, float32: one
         ``train_loss`` and backward on the card against the same on the
         CPU, each leaf within 1e-4 of its largest gradient;
      3. every TINY config: one bf16 step (loss finite in (0, 20), its
         gradient norm finite and > 0, as the reference's smoke test asks),
         and in float32 the loss and gradients equal to the CPU's within
         1e-4;
      4. SmolLM-360M at full width, bf16: ``loop.train`` for
         ``TRAIN_STEPS`` AdamW steps at ``TRAIN_BATCH`` x ``TRAIN_SEQ``, lr
         ``TRAIN_LR``, on the synthetic corpus, its loss falling by at
         least 0.15 (the reference's bar); step ms (median after the
         first 3, host clock ended by reading the loss) and tokens/s; peak
         memory (``max_memory_allocated``) over 2 steps with and without
         ``remat``; one more step under torch.profiler (its device busy
         time, idle share and the kernels with the most device time).
    Prints the phase's figures as a JSON line; returns the launch
    counts (all 0)."""
    t_phase = time.perf_counter()
    _reset_launches()
    out = {"attention": {}}
    gen = torch.Generator(device=DEV)
    gen.manual_seed(23)
    for name, (B, T, H, KV, hd), kw in TRAIN_ATTN_CASES:
        q, k, v, do = (_rand(gen, shp, torch.float32, 1.0) for shp in
                       ((B, T, H, hd), (B, T, KV, hd), (B, T, KV, hd),
                        (B, T, H, hd)))
        leaves = [x.requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(layers.flash_attention(q, k, v, **kw),
                                  leaves, do)
        want = torch.autograd.grad(
            _dense_attention(q, k, v, kw["causal"], kw.get("window"),
                             kw.get("logit_cap")), leaves, do.double())
        errs = [_maxerr(g, w) / w.abs().max().item()
                for g, w in zip(got, want)]
        ms = _time_ms(lambda: torch.autograd.grad(
            layers.flash_attention(q, k, v, **kw), leaves, do))
        print(f"[train] blockwise attention {name} {(B, T, H, KV, hd)} "
              f"{kw}, float32: dq / dk / dv against float64 autograd of a "
              f"dense softmax, max err over max |grad| "
              f"{', '.join(f'{e:.2e}' for e in errs)} (bound 2e-5); "
              f"forward + backward {ms:.3f} ms")
        assert max(errs) <= 2e-5, (name, errs)
        out["attention"][name] = {"rel_err": errs, "fwd_bwd_ms": ms}

    cfg = get_config(TRAIN_ARCH).replace(dtype="float32",
                                         num_layers=TRAIN_CUT,
                                         kernel_impl="pallas")
    params = api.init_params(cfg, seed=0)
    tokens = torch.from_numpy(next(iter(TokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH, seed=0)))))
    t0 = time.perf_counter()
    card = _train_grads(params, {"tokens": tokens}, cfg, DEV)
    host = _train_grads(params, {"tokens": tokens}, cfg, "cpu")
    err = _grad_err(card[2], host[2])
    print(f"[train] {cfg.name} float32 at full width, {TRAIN_CUT} of its "
          f"{get_config(TRAIN_ARCH).num_layers} layers, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: loss card "
          f"{card[0]:.6f} / CPU {host[0]:.6f}; {len(card[2])} gradient "
          f"leaves, max err over each leaf's max |grad| {err:.2e} (bound "
          f"1e-4) ({time.perf_counter() - t0:.1f}s)")
    assert abs(card[0] - host[0]) <= 1e-4 and err <= 1e-4, (card[0],
                                                            host[0], err)
    out["card_vs_cpu"] = {"loss": [card[0], host[0]], "rel_err": err}
    del params, card, host

    out["tiny"] = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch, tiny=True).replace(kernel_impl="pallas")
        batch = api.make_batch(cfg, TRAIN_TINY_SHAPE, seed=0)
        params = api.init_params(cfg, seed=0)
        loss, aux, grads = _train_grads(params, batch, cfg, DEV)
        gnorm = math.sqrt(sum(g.float().square().sum().item()
                              for g in grads))
        assert math.isfinite(loss) and 0.0 < loss < 20.0, (arch, loss)
        assert math.isfinite(gnorm) and gnorm > 0.0, (arch, gnorm)
        f32 = cfg.replace(dtype="float32")
        params = api.init_params(f32, seed=0)
        batch = {k: v.float() if v.is_floating_point() else v
                 for k, v in batch.items()}
        card = _train_grads(params, batch, f32, DEV)
        host = _train_grads(params, batch, f32, "cpu")
        err = _grad_err(card[2], host[2])
        print(f"[train] {cfg.name}: bf16 loss {loss:.4f}, aux {aux:.4f}, "
              f"gradient norm {gnorm:.4f}; float32 loss card {card[0]:.6f} "
              f"/ CPU {host[0]:.6f}, max leaf err {err:.2e} (bound 1e-4)")
        assert abs(card[0] - host[0]) <= 1e-4 and err <= 1e-4, (arch, err)
        out["tiny"][arch] = {"loss_bf16": loss, "gnorm_bf16": gnorm,
                             "rel_err_f32": err}

    cfg = get_config(TRAIN_ARCH).replace(kernel_impl="pallas")
    kw = dict(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, lr=TRAIN_LR, seed=0)
    peaks = {}
    for remat in (True, False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        run = train(cfg, steps=2, log_every=0, remat=remat, **kw)
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 1e9
        del run
    torch.cuda.empty_cache()
    run = train(cfg, steps=TRAIN_STEPS, log_every=10, **kw)
    losses, step_s = run["losses"], sorted(run["step_s"][3:])
    step_ms = step_s[len(step_s) // 2] * 1e3
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3
    print(f"[train] {cfg.name} bf16 at full width ({run['n_params']:,} "
          f"params): loop.train, {TRAIN_STEPS} AdamW steps at {TRAIN_BATCH} "
          f"x {TRAIN_SEQ}, lr {TRAIN_LR}: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (must fall by 0.15); step {step_ms:.2f} ms "
          f"(median of steps 4-{TRAIN_STEPS}, {step_s[0] * 1e3:.2f}-"
          f"{step_s[-1] * 1e3:.2f}), {tokens_s:.0f} tokens/s; peak memory "
          f"over 2 steps {peaks[True]:.3f} GB with remat, "
          f"{peaks[False]:.3f} GB without")
    assert losses[-1] <= losses[0] - 0.15, losses
    n_params = run["n_params"]
    trace = _train_step_trace(run["params"], cfg, kw)
    print(f"[train] one traced step ({TRAIN_BATCH} x {TRAIN_SEQ}, from the "
          f"run's parameters): {trace['kernels']} device activities, busy "
          f"{trace['busy_ms']:.2f} ms over a {trace['span_ms']:.2f} ms span "
          f"(idle share {1 - trace['busy_ms'] / trace['span_ms']:.1%}); by "
          f"device time: " + "; ".join(
              f"{ms:.2f} ms x{n} {name[:70]}" for name, ms, n in trace["top"]))
    del run
    torch.cuda.empty_cache()
    counts = kernels.launch_counts()
    assert not any(counts.values()), ("the train path launched", counts)
    out.update(full_width={
        "arch": cfg.name, "n_params": n_params, "steps": TRAIN_STEPS,
        "loss_first": losses[0], "loss_last": losses[-1],
        "step_ms": step_ms, "tokens_s": tokens_s,
        "peak_gb_remat": peaks[True], "peak_gb_no_remat": peaks[False],
        "traced_step": trace},
        launches={n: counts[n] for n in ("flash", "decode", "paged",
                                         "ssd_scan")},
        seconds=time.perf_counter() - t_phase)
    print(json.dumps({"train": out}))
    return out["launches"]


# ---------------------------------------------------------------------------
def _composed_train_step(params, opt, tokens, cfg, nm: int):
    """The sharded train step's arithmetic composed by hand on plain
    tensors: ``loop.loss_and_grads`` over ``nm`` microbatches (the
    reference's grouping: consecutive rows), each gradient cast to float32
    and divided by ``nm``, summed, then ``adamw.update``."""
    grads, loss = None, 0.0
    for mb in tokens.chunk(nm):
        mb_loss, _, g = loss_and_grads(params, {"tokens": mb}, cfg)
        g = adamw.tree_map(lambda t: t.float() / nm, g)
        grads = g if grads is None else adamw.tree_map(torch.add, grads, g)
        loss = loss + mb_loss / nm
    new, opt, gnorm = adamw.update(grads, opt, params, lr=TRAIN_LR)
    return new, opt, loss, gnorm


def _full(tree):
    return adamw.tree_map(lambda t: t.full_tensor(), tree)


def _dist_serve(minfo, cfg) -> dict:
    """The sharded prefill and ``STEPS`` greedy sharded decode steps
    (``sharded_append``) against ``api.generate`` and the unsharded
    prefill / step on the same parameters; the kernels' launches over the
    sharded run; the collectives of its first step."""
    shape = InputShape("dist", PROMPT, BATCH, "prefill")
    cap = PROMPT + STEPS
    pfn, _, p_in, _ = steps.make_prefill_step(cfg, minfo, shape, capacity=cap)
    dfn, _, d_in, _ = steps.make_decode_step(
        cfg, minfo, InputShape("dist", cap, BATCH, "decode"))
    params = api.init_params(cfg, seed=0)
    batch = api.make_batch(cfg, shape, seed=1)
    P = shd.distribute_tree(params, p_in[0], minfo)
    Bt = shd.distribute_tree(batch, p_in[1], minfo)
    pos0 = torch.full((), PROMPT, dtype=torch.int32, device=DEV)

    def sharded():
        logits, cache = pfn(P, Bt)
        first = logits.full_tensor()
        tok = logits.argmax(-1).to(torch.int32)
        pos = shd.distribute(pos0, d_in[3], minfo)
        toks, step_logits, comm = [tok.full_tensor()], None, None
        for i in range(STEPS):
            with CommDebugMode() if i == 0 else contextlib.nullcontext() \
                    as mode:
                logits, cache = dfn(P, cache, tok, pos)
            if i == 0:
                comm, step_logits = mode, logits.full_tensor()
            tok = logits.argmax(-1).to(torch.int32)
            toks.append(tok.full_tensor())
            pos = pos + 1
        return first, step_logits, torch.stack(toks, dim=1), comm

    _reset_launches()
    first, step1, toks, comm = sharded()
    torch.cuda.synchronize()
    launches = {n: c for n, c in kernels.launch_counts().items()
                if "/" not in n}
    want_toks = api.generate(params, batch, cfg, STEPS)
    want_first, cache = api.prefill(params, batch, cfg, capacity=cap)
    tok0 = want_first.argmax(-1).to(torch.int32)
    want_step1, _ = api.decode_step(params, cache, tok0, pos0, cfg)
    # the plain path's own rounding floor, as the model phase measures it
    plain = cfg.replace(kernel_impl="xla")
    lx, _ = api.prefill(params, batch, plain, capacity=cap)
    saved, layers.DEFAULT_BLOCK_K = layers.DEFAULT_BLOCK_K, 64
    try:
        l64, _ = api.prefill(params, batch, plain, capacity=cap)
    finally:
        layers.DEFAULT_BLOCK_K = saved
    floor = _maxerr(l64, lx)
    atol = {"prefill": max(3e-2, 2 * floor), "decode": max(5e-2, 2 * floor)}
    errs = {"prefill": _maxerr(first, want_first),
            "decode": _maxerr(step1, want_step1)}
    exact = {"prefill": torch.equal(first, want_first),
             "decode": torch.equal(step1, want_step1),
             "tokens": torch.equal(toks, want_toks)}
    n_coll = comm.get_total_counts()
    assert toks.shape == want_toks.shape and exact["tokens"], \
        ("sharded tokens differ from api.generate's",
         (toks != want_toks).sum().item())
    for k in ("prefill", "decode"):
        assert errs[k] <= atol[k], (k, errs[k], atol[k])
    assert n_coll == 0, ("collectives in a sharded decode step",
                         comm.get_comm_counts())
    n_attn = cfg.num_layers
    assert launches["flash"] == n_attn and \
        launches["decode"] == n_attn * STEPS, launches

    # eager host-clock ms, sharded beside unsharded
    c_sh = pfn(P, Bt)[1]
    tok_sh = shd.distribute(tok0, d_in[2], minfo)
    pos_sh = shd.distribute(pos0, d_in[3], minfo)
    ms = {"prefill_sharded": _wall_ms(lambda: pfn(P, Bt)),
          "prefill": _wall_ms(
              lambda: api.prefill(params, batch, cfg, capacity=cap)),
          "step_sharded": _wall_ms(lambda: dfn(P, c_sh, tok_sh, pos_sh)),
          "step": _wall_ms(
              lambda: api.decode_step(params, cache, tok0, pos0, cfg))}
    return {"launches": launches, "logits_err": errs, "bound": atol,
            "floor": floor, "bit_for_bit": exact, "collectives": n_coll,
            "ms": ms}


def _dist_train(minfo) -> dict:
    """``make_train_step`` at ``TRAIN_BATCH`` x ``TRAIN_SEQ`` with its
    default microbatches: float32 at ``TRAIN_CUT`` layers against
    ``_composed_train_step``; then bf16 at full width, timed beside the
    composed step, each with the peak memory its timed steps allocate.
    The step donates its parameters and optimizer state (it writes the
    new values into them), so it is given copies."""
    shape = InputShape("dist", TRAIN_SEQ, TRAIN_BATCH, "train")
    tokens = torch.from_numpy(next(iter(TokenStream(DataConfig(
        vocab_size=get_config(ARCH).vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH, seed=0))))).to(DEV)
    out = {}
    for dtype, cut in (("float32", TRAIN_CUT), ("bfloat16", None)):
        cfg = get_config(ARCH).replace(dtype=dtype, kernel_impl="pallas")
        if cut:
            cfg = cfg.replace(num_layers=cut)
        nm = steps.default_microbatches(cfg, shape, minfo)
        tfn, _, t_in, _ = steps.make_train_step(cfg, minfo, shape,
                                                lr=TRAIN_LR)
        params = api.init_params(cfg, seed=0)
        opt = adamw.init(params)
        args = [shd.distribute_tree(_clone(params), t_in[0], minfo),
                shd.distribute_tree(adamw.init(params), t_in[1], minfo),
                shd.distribute_tree({"tokens": tokens}, t_in[2], minfo)]
        if cut:
            new, _, m = tfn(*args)
            want, _, want_loss, _ = _composed_train_step(params, opt, tokens,
                                                         cfg, nm)
            err = max(_maxerr(a, b) for a, b in zip(
                adamw.tree_leaves(_full(new)), adamw.tree_leaves(want)))
            loss = m["loss"].full_tensor().item()
            assert err <= 1e-4 and abs(loss - want_loss.item()) <= 1e-4, \
                (err, loss, want_loss.item())
            out["float32"] = {"layers": cut, "microbatches": nm,
                              "param_err": err, "loss": loss,
                              "loss_composed": want_loss.item()}
            continue
        ms, ms_plain, losses = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for _ in range(DIST_TRAIN_STEPS):
            t0 = time.perf_counter()
            args[0], args[1], m = tfn(*args)
            losses.append(m["loss"].full_tensor().item())
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        base_plain = torch.cuda.memory_allocated()
        for _ in range(DIST_COMPOSED_STEPS):
            t0 = time.perf_counter()
            params, opt, loss, _ = _composed_train_step(params, opt, tokens,
                                                        cfg, nm)
            loss.item()
            ms_plain.append((time.perf_counter() - t0) * 1e3)
        peak_plain = torch.cuda.max_memory_allocated()
        assert all(math.isfinite(x) for x in losses), losses
        out["bfloat16"] = {"microbatches": nm, "losses": losses,
                           "step_ms": sorted(ms)[len(ms) // 2],
                           "step_ms_composed": sorted(ms_plain)[
                               len(ms_plain) // 2],
                           "peak_gb": peak / 1e9,
                           "peak_gb_composed": peak_plain / 1e9,
                           "held_before_gb": base / 1e9,
                           "held_before_gb_composed": base_plain / 1e9}
    return out


def phase_dist() -> dict:
    """Distribution (``launch/steps.py``, ``distributed/``) on the card: a
    process group of its own (NCCL, world size 1, on a FileStore in a
    temporary directory, destroyed at the end) and a (1, 1) ``(data,
    model)`` mesh; parameters laid out by ``param_specs(..., "infer")``.
      1. serving: SmolLM-360M at full width, bf16, weights from seed 0,
         ``make_prefill_step`` at ``BATCH`` x ``PROMPT``, then
         ``STEPS`` greedy ``make_decode_step`` steps with
         ``sharded_append``: the tokens equal ``api.generate``'s; the
         prefill's and the first step's logits within the model phase's
         bf16 bound (the larger of the JAX bound and twice the plain
         path's rounding floor), bit for bit or not said; K1 launched once
         per layer in the prefill and K2 once per layer a step (counts set
         to 0 just before, read just after: ``launches_by_path["dist"]``);
         ``CommDebugMode`` counts no collective over the first step, its
         cache append included; eager host-clock ms of the sharded prefill
         and step beside the unsharded ones;
      2. training: ``make_train_step`` at ``TRAIN_BATCH`` x ``TRAIN_SEQ``
         with its default microbatches, float32 at ``TRAIN_CUT`` layers:
         one step's new parameters within 1e-4 of ``loss_and_grads`` over
         the same microbatches and ``adamw.update``
         (``_composed_train_step``); bf16 at full width:
         ``DIST_TRAIN_STEPS`` steps, each timed on the host clock (ended
         by reading the loss), then ``DIST_COMPOSED_STEPS`` through the
         composed step; each run's peak allocated memory
         (``max_memory_allocated`` after a reset), printed with no bound.
    Prints a JSON line; returns the serving run's launch counts."""
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dist_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        f"{tmp.name}/store", 1), rank=0, world_size=1)
    try:
        minfo = mesh_lib.make_host_mesh(1, 1)
        cfg = get_config(ARCH).replace(kernel_impl="pallas")
        out = {"mesh": dict(minfo.axis_sizes),
               "serve": _dist_serve(minfo, cfg),
               "train": _dist_train(minfo)}
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    s, t = out["serve"], out["train"]
    print(f"[dist] {cfg.name} bf16 on a (1, 1) mesh (NCCL): sharded "
          f"prefill {BATCH} x {PROMPT} + {STEPS} greedy sharded decode "
          f"steps: tokens equal api.generate's; logits max |diff| prefill "
          f"{s['logits_err']['prefill']:.3e} / first step "
          f"{s['logits_err']['decode']:.3e} (bounds "
          f"{s['bound']['prefill']:.3e} / {s['bound']['decode']:.3e}, plain "
          f"floor {s['floor']:.3e}; bit for bit: prefill "
          f"{s['bit_for_bit']['prefill']}, step {s['bit_for_bit']['decode']}"
          f"); launches {s['launches']}; collectives in a step "
          f"{s['collectives']}; eager ms: prefill "
          f"{s['ms']['prefill_sharded']:.2f} sharded / "
          f"{s['ms']['prefill']:.2f} unsharded, step "
          f"{s['ms']['step_sharded']:.2f} / {s['ms']['step']:.2f}")
    print(f"[dist] make_train_step {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"{t['float32']['microbatches']} microbatches: float32 at "
          f"{TRAIN_CUT} layers, new params max |diff| "
          f"{t['float32']['param_err']:.3e} against the composed step "
          f"(bound 1e-4), loss {t['float32']['loss']:.6f} / "
          f"{t['float32']['loss_composed']:.6f}; bf16 at full width, "
          f"{DIST_TRAIN_STEPS} steps, losses "
          f"{', '.join(f'{x:.4f}' for x in t['bfloat16']['losses'])}: step "
          f"{t['bfloat16']['step_ms']:.1f} ms sharded / "
          f"{t['bfloat16']['step_ms_composed']:.1f} ms composed (median); "
          f"peak allocated over the timed steps "
          f"{t['bfloat16']['peak_gb']:.2f} GB sharded / "
          f"{t['bfloat16']['peak_gb_composed']:.2f} GB composed (held "
          f"before them {t['bfloat16']['held_before_gb']:.2f} / "
          f"{t['bfloat16']['held_before_gb_composed']:.2f} GB)")
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"dist": out}))
    return s["launches"]


@contextlib.contextmanager
def _warmed_quickstart():
    """While open, ``quickstart.run``'s executor warms (captures) every
    bucket its run can reach, largest first as phase 6 does, before the
    run measures anything, then sets the launch counts to 0 and the bucket
    cache's counters too; the yielded list holds each executor made and
    the seconds each bucket's warm-up and capture took."""
    made = []

    class Warmed(quickstart.RealExecutor):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seconds = {n: self.warmup(n, 1) for n in sorted(
                {self.bucket(i) for i in range(1, QUICK_MAX_ITEMS + 1)},
                reverse=True)}
            torch.cuda.synchronize()
            made.append((self, seconds))
            self.cache_stats.reset_counters()
            _reset_launches()
            self.replayed_launches.clear()

    saved, quickstart.RealExecutor = quickstart.RealExecutor, Warmed
    try:
        yield made
    finally:
        quickstart.RealExecutor = saved


def phase_examples() -> dict:
    """The examples (``repro_torch.examples``) on the card:
      1. ``quickstart.main(["--device", "cuda"])`` as shipped (TINY
         SmolLM, its config's plain path), its five lines printed;
      2. ``quickstart.run`` at full width: SmolLM-360M, bf16, the kernel
         path, weights from seed 0, the example's own ``(n, 32)`` token
         batches served by a prefill at capacity 48, DNNScaler at 8 x the
         bs=1 latency (m 8, n 4, bs up to 32, mtl up to 4), 40 engine
         steps; every bucket the run can reach captured before it
         (``_warmed_quickstart``): no miss and no stale hit over the run,
         no launch outside a graph, K1 32 a replay, all through the wgmma
         body (each bucket's capture records its launches; counts set to
         0 just before the run, read just after:
         ``launches_by_path["examples"]``); the largest bucket's logits,
         replayed, against the plain path on the card within the model
         phase's bf16 prefill bound (the larger of 3e-2 and twice the
         plain path's own floor, here between its default key block,
         which holds all 32 positions, and 8 blocks of 4, as the model
         phase takes 8 blocks of 64 of its 512);
      3. ``warm_start.serve_once`` cold, then warm, against one temporary
         store on the card (a bucket miss is a CUDA-graph capture), after
         a throwaway executor captured every bucket once, ``WARM_PAIRS``
         times, each pair on a store of its own: in every pair the warm
         run loads the cold run's row and takes strictly fewer probes and
         captures, and over the pairs its median stall seconds are
         strictly below the cold runs' median.
    Prints a JSON line; returns the full-width run's launches."""
    t_phase = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        quickstart.main(["--device", "cuda"])
    lines = out.getvalue().splitlines()
    assert len(lines) == 5 and lines[0].startswith("model: "), lines
    for line in lines:
        print(f"[examples] quickstart (TINY, as shipped): {line}")
    t_tiny = time.perf_counter() - t_phase

    cfg = get_config(ARCH).replace(kernel_impl="pallas")
    t0 = time.perf_counter()
    with _warmed_quickstart() as made, contextlib.redirect_stdout(out):
        res = quickstart.run(cfg, DEV)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    (ex, bucket_s), = made
    eager = kernels.launch_counts()
    assert not any(eager.values()), ("launches outside the graphs", eager)
    replayed = ex.replayed_launches
    per_bucket = {n: e.launches for n, e in sorted(ex._exec.items())}
    n_attn = cfg.num_layers
    for n, got in per_bucket.items():
        assert got == {"flash": n_attn, "flash/wgmma": n_attn}, (n, got)
    replays = sum(e.replays for e in ex._exec.values())
    assert replayed["flash"] == replayed["flash/wgmma"] == n_attn * replays \
        and replays > 0, (dict(replayed), replays)
    cs = ex.cache_stats
    assert cs.misses == 0 and cs.stale_hits == 0, \
        ("bucket misses or stale hits after warm-up", cs.misses,
         cs.stale_hits)
    s = res["summary"]
    assert s["throughput"] > 0 and math.isfinite(s["p95_s"]), s

    big = max(ex._exec)
    entry = ex._exec[big]
    entry.graph.replay()
    torch.cuda.synchronize()
    got = entry.out.float().clone()
    plain = cfg.replace(kernel_impl="xla")
    want = quickstart.serve_fn_for(plain)(ex.params, entry.batch).float()
    # the plain path's own rounding floor at 8 key blocks, as the model
    # phase takes it at 8 x 512 (blocks of 64): one block holds all 32
    saved = layers.DEFAULT_BLOCK_K
    layers.DEFAULT_BLOCK_K = quickstart.SEQ // 8
    try:
        l8 = quickstart.serve_fn_for(plain)(ex.params, entry.batch).float()
    finally:
        layers.DEFAULT_BLOCK_K = saved
    floor = _maxerr(l8, want)
    bound = max(3e-2, 2 * floor)
    err = _maxerr(got, want)
    peak = want.abs().max().item()
    assert got.shape == want.shape and torch.isfinite(got).all() \
        and err <= bound, (got.shape, err, bound, peak)
    print(f"[examples] quickstart.run {cfg.name} full width bf16, (n, "
          f"{quickstart.SEQ}) batches at capacity {quickstart.CAPACITY}: "
          f"{ex.captures} buckets captured before the run, seconds each "
          f"(warm-up and capture) "
          f"{ {n: round(x, 3) for n, x in sorted(bucket_s.items())} } "
          f"({ex.capture_time_s:.1f}s of them capturing); base "
          f"{res['base_s'] * 1e3:.2f} ms -> SLO "
          f"{res['slo_s'] * 1e3:.2f} ms; approach {res['approach']}, steady "
          f"(bs={res['steady'][0]}, mtl={res['steady'][1]}); "
          f"{s['throughput']:.1f} req/s, p95 {s['p95_s'] * 1e3:.2f} ms, "
          f"attainment {s['slo_attainment']:.3f}; misses {cs.misses}, stale "
          f"hits {cs.stale_hits} after warm-up; K1 {replayed['flash']} over "
          f"{replays} replays ({n_attn} a replay, all wgmma); bucket {big}'s "
          f"logits max |diff| {err:.3e} against the plain path (bound "
          f"{bound:.3e}, plain floor {floor:.3e}; largest |logit| "
          f"{peak:.3f}); run {t_run:.1f}s")

    # one-time capture warm-up: every bucket either run may reach captured
    # once in a throwaway executor, so that the first capture at a shape
    # (the allocator's new segments, the GEMM's first call at that shape)
    # is billed to neither run, and each run's stalls are its captures
    lab = warm_start.WarmLabExecutor(warm_start.JOB.profile(),
                                     torch_device=DEV)
    for n in lab.buckets:
        lab.warmup(n, 1)
    del lab
    pairs = []
    for i in range(WARM_PAIRS):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_warm_") as store:
            cold = warm_start.serve_once(store, device=DEV)
            warm = warm_start.serve_once(store, device=DEV)
        pairs.append((cold, warm))
        for label, r in (("cold", cold), ("warm", warm)):
            with contextlib.redirect_stdout(out):
                warm_start.show(label, r)
            print(f"[examples] warm_start on the card, pair {i}: "
                  f"{out.getvalue().splitlines()[-1].strip()}; "
                  f"{r['compile_stall_s'] / r['compiles'] * 1e3:.2f} ms a "
                  f"capture")
        assert cold["loaded_rows"] == 0 and warm["loaded_rows"] >= 1 \
            and warm["probes"] < cold["probes"] \
            and warm["compiles"] < cold["compiles"], (i, cold, warm)
    stall = {label: statistics.median(p[j]["compile_stall_s"] for p in pairs)
             for j, label in enumerate(("cold", "warm"))}
    print(f"[examples] warm_start stall seconds warm / cold, median of "
          f"{WARM_PAIRS} pairs: {stall['warm'] * 1e3:.3f} / "
          f"{stall['cold'] * 1e3:.3f} ms = "
          f"{stall['warm'] / stall['cold']:.3f}; by pair "
          f"{[round(w['compile_stall_s'] / c['compile_stall_s'], 3)
              for c, w in pairs]}")
    assert stall["warm"] < stall["cold"], (stall, pairs)
    launches = {"flash": replayed["flash"]}
    rep = {"quickstart_tiny_s": t_tiny,
           "quickstart": {"bucket_s": bucket_s,
                          "capture_s": ex.capture_time_s,
                          "base_ms": res["base_s"] * 1e3,
                          "slo_ms": res["slo_s"] * 1e3,
                          "approach": res["approach"],
                          "steady": list(res["steady"]),
                          "req_s": s["throughput"], "p95_ms": s["p95_s"] * 1e3,
                          "attainment": s["slo_attainment"],
                          "misses": cs.misses, "stale_hits": cs.stale_hits,
                          "replays": replays, "launches": dict(replayed),
                          "logits_err": err, "bound": bound, "floor": floor,
                          "max_abs_logit": peak,
                          "run_s": t_run},
           "warm_start": {"pairs": [
               {k: {kk: (list(v) if isinstance(v, tuple) else v)
                    for kk, v in r.items()}
                for k, r in (("cold", cold), ("warm", warm))}
               for cold, warm in pairs],
               "median_stall_s": stall}}
    rep["seconds"] = time.perf_counter() - t_phase
    print(f"[examples] phase {rep['seconds']:.1f}s")
    print(json.dumps({"examples": rep}))
    return launches


def _tune_classes() -> list:
    """(kernel, dtype, dims) of the serving shape classes at batch 8:
    SmolLM-360M's flash prefill and split-K decode, the paged decode
    kernel at SmolLM's decode geometry (the page size a paged KV cache of
    it would take), and Mamba2-1.3B's SSD scan."""
    smollm, mamba = get_config(ARCH), get_config(SSM_ARCH)
    KV = smollm.num_kv_heads
    geo = dict(BKV=BATCH * KV, G=smollm.num_heads // KV, hd=smollm.head_dim)
    dt = torch_dtype(smollm)
    return [
        ("flash_attention", dt, dict(geo, Tq=PROMPT, Tk=PROMPT, causal=True)),
        ("decode_attention", dt, dict(geo, S=PROMPT + STEPS)),
        ("paged_decode_attention", dt, dict(geo, S=PROMPT + STEPS)),
        ("ssd_scan", torch_dtype(mamba), dict(
            H=mamba.ssm_expand * mamba.d_model // mamba.ssm_head_dim,
            P=mamba.ssm_head_dim, N=mamba.ssm_state_size, T=PROMPT)),
    ]


def _tune_all(classes) -> list:
    return [autotune.tune(kernel, dtype, device=DEV, **dims)
            for kernel, dtype, dims in classes]


def _check_paged_class(dtype, dims) -> float:
    """K3 against its plain version on the inputs the tuning times it on
    (``autotune.paged_inputs``), at every page size it may time."""
    cls = autotune.shape_class("paged_decode_attention", **dims)
    errs = []
    for psz in (32, 64, 128, 256):
        q, kp, vp, lens, tbl = autotune.paged_inputs(cls, dtype, psz, DEV)
        out = decode_ops.paged_decode_attention(q, kp, vp, lens, tbl)
        ref = paged_decode_attention_ref(q, kp, vp, lens, tbl)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), ("paged", cls, psz)
        assert torch.allclose(out.float(), ref.float(), atol=TOL[dtype],
                              rtol=TOL[dtype]), \
            ("paged kernel disagrees", cls, psz, _maxerr(out, ref))
        errs.append(_maxerr(out, ref))
    print(f"[autotune] paged_decode_attention at the tuned class {cls} "
          f"{str(dtype)[6:]}, page sizes 32, 64, 128, 256: max |kernel - "
          f"plain| {max(errs):.3e} (tol {TOL[dtype]:g})")
    return max(errs)


def _check_flash_class(dtype, dims) -> float:
    """K1 against its plain version on the inputs the tuning times it on
    (``autotune.flash_inputs``), at every wgmma tile it may time."""
    cls = autotune.shape_class("flash_attention", **dims)
    q, k, v = autotune.flash_inputs(cls, dtype, DEV)
    tiles = k1.TILES[cls["hd"]]
    err = max(_check_tile(q, k, v, tile, str(cls)) for tile in tiles)
    print(f"[autotune] flash_attention at the tuned class {cls} "
          f"{str(dtype)[6:]}, wgmma tiles {tiles}: max "
          f"|kernel - plain| {err:.3e} (tol {TOL[dtype]:g})")
    return err


def phase_autotune() -> int:
    """``autotune.tune`` of the serving shape classes (``_tune_classes``),
    after K1 and K3 are held against their plain versions on the flash and
    paged classes' own inputs at every tile and page size.  Every candidate
    runs its kernel, timed on the device alone.  A second tuning times
    nothing, the generation bumps once per new class, and
    ``resolve_page_size`` returns the tuned page size; a view of the tuned
    flash class that breaks the 16-byte rule takes the CUDA-core body at
    its own tile.  Returns the paged kernel's launches over the tuning;
    then serves SmolLM briefly on the tuned cache."""
    classes = _tune_classes()
    _check_flash_class(*classes[0][1:])
    _check_paged_class(*classes[2][1:])
    gen0 = autotune.generation()
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    entries = _tune_all(classes)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    launches = {"flash": k1.LAUNCHES, "decode": k2.LAUNCHES,
                "paged": k3.LAUNCHES, "ssd_scan": k4.LAUNCHES}
    stats = autotune.cache_stats()
    assert all(launches.values()), ("a kernel was not timed", launches)
    assert stats["generation"] == gen0 + len(classes), stats
    for (kernel, _, _), e in zip(classes, entries):
        timed = ", ".join(f"{json.loads(c)} {us:.2f}"
                          for c, us in e["candidates_timed"].items())
        print(f"[autotune] {kernel} {str(e['shape_class'])} "
              f"{e['backend']}: chose {e['config']} at "
              f"{e['us_per_call']:.2f} us (default {e['default_us']} us); "
              f"candidates (us, median of 3 after a warm-up): {timed}")
    flash, paged = entries[0], entries[2]
    per = 1 + autotune.GRAPH_CALLS     # a warm-up and the captured calls
    tiles = [json.loads(c) for c in flash["candidates_timed"]]
    assert len(tiles) == 4 and launches["flash"] == per * len(tiles), \
        ("the flash class's four wgmma tiles", tiles, launches)
    assert k1.LAUNCHES_BY_BODY["wgmma"] == k1.LAUNCHES, k1.LAUNCHES_BY_BODY
    sizes = [json.loads(c)["page_size"] for c in paged["candidates_timed"]]
    assert launches["paged"] == per * len(sizes), (launches, sizes)
    print(f"[autotune] {len(classes)} classes in {tune_s * 1e3:.1f} ms, "
          f"{stats['timings']} candidates timed; generation {gen0} -> "
          f"{stats['generation']}; launches over the tuning: {launches} "
          f"(per candidate a warm-up and {autotune.GRAPH_CALLS} calls "
          f"captured in the graph it replays)")

    assert _tune_all(classes) == entries
    assert autotune.cache_stats()["timings"] == stats["timings"]
    assert autotune.generation() == stats["generation"]
    smollm = get_config(ARCH)
    psz = decode_ops.resolve_page_size(
        classes[2][1], B=BATCH, H=smollm.num_heads, KV=smollm.num_kv_heads,
        hd=smollm.head_dim, seq_budget=PROMPT + STEPS, device=DEV)
    assert psz == paged["config"]["page_size"], (psz, paged["config"])
    print(f"[autotune] a second tuning timed nothing and kept generation "
          f"{autotune.generation()}; resolve_page_size -> {psz}")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(14)
    view = (BATCH, PROMPT, PROMPT, smollm.num_heads, smollm.num_kv_heads,
            smollm.head_dim, True, None, None)
    err, _ = _check_flash(gen, view, classes[0][1], body="cuda_cores",
                          view=True)
    print(f"[autotune] a view off the 16-byte rule of the tuned flash class "
          f"(tuned tile {flash['config']}): CUDA-core body at its own tile, "
          f"max |kernel - plain| {err:.3e}")

    hits = autotune.cache_stats()["hits"]
    _serve(ARCH, 8, 1, 10)
    print(f"[autotune] served SmolLM on the tuned cache: "
          f"{autotune.cache_stats()['hits'] - hits} lookups answered by it")
    return launches["paged"]


# phase 12: the seven models this script serves, traced for the cost
# model's live features at full width
FLEET_ARCHS = (ARCH, SSM_ARCH, HYBRID_ARCH, VLM_ARCH, ENCDEC_ARCH, MOE_ARCH,
               TOKEN_ARCH)


def _report_json(rep: dict) -> str:
    """A report as one canonical string: equal strings, equal reports
    (NaN included, which ``==`` on the dicts would call unequal)."""
    return json.dumps(rep, sort_keys=True, default=repr)


def phase_fleet() -> None:
    """The paper's fleet and the analysis layers, priced on the host as
    the reference prices them (module docstring, phase 12)."""
    t = time.perf_counter()
    reps = {}
    for vectorized in (False, True):
        t1 = time.perf_counter()
        reps[vectorized] = run_paper_cluster(
            "auto", n_devices=12, sim_time_limit=90.0, seed=0,
            vectorized=vectorized)
        agg = reps[vectorized]["aggregate"]
        engine = "VectorClusterEngine" if vectorized else "ClusterEngine"
        print(f"[fleet] {engine}: {agg['jobs']} Table-4 jobs on "
              f"{agg['devices']} simulated P40s, 90 s: aggregate "
              f"{agg['aggregate_throughput']} items/s, "
              f"{agg['jobs_meeting_slo']}/{agg['feasible_jobs']} feasible "
              f"jobs meet the SLO, stalls {agg['total_stall_s']} s "
              f"({time.perf_counter() - t1:.1f}s)")
    if _report_json(reps[False]) != _report_json(reps[True]):
        raise SystemExit("[fleet] FAIL: VectorClusterEngine's report "
                         "differs from ClusterEngine's")
    argv, out = sys.argv, io.StringIO()
    sys.argv = ["serve", "--job", "5", "--controller", "dnnscaler"]
    try:
        with contextlib.redirect_stdout(out):
            serve_launcher.main()
    finally:
        sys.argv = argv
    lines = out.getvalue().splitlines()
    if not lines or not lines[0].startswith("job5 ") \
            or "controller=dnnscaler" not in lines[0]:
        raise SystemExit(f"[fleet] FAIL: serve --job 5 printed {lines}")
    for line in lines:
        print(f"[fleet] serve --job 5: {line.strip()}")
    for arch in FLEET_ARCHS:
        cfg = get_config(arch)
        for phase in ("decode", "prefill"):
            t1 = time.perf_counter()
            feat = cost_model.features_for_served_module(
                cfg, phase, dm.llm_profile(cfg, phase))
            if feat is None:
                raise SystemExit(f"[fleet] FAIL: no live features for "
                                 f"{cfg.name} {phase}")
            hist = ", ".join(f"{c} {x:.3f}" for c, x in
                             zip(cost_model.OP_CLASSES, feat.op_hist))
            print(f"[fleet] live features {cfg.name} {phase}: n_ops "
                  f"{feat.n_ops:.0f}, FLOPs {feat.flops:.4e}, histogram "
                  f"({hist}) ({time.perf_counter() - t1:.1f}s)")
    print(f"[fleet] phase {time.perf_counter() - t:.1f}s")


def main() -> None:
    t0 = time.perf_counter()
    store = tempfile.TemporaryDirectory(prefix="chip_smoke_autotune_")
    autotune.configure(cache_dir=store.name, tune_on_miss=False,
                       enabled=True)
    smi = phase_toolchain()
    marks = [("toolchain", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    phase_build()
    mark("build")
    rows = phase_kernels()
    family = phase_family_shapes()
    rows["ssd_scan"] = phase_ssd()
    rows["paged"] = phase_paged()
    mark("kernels")
    phase_model()
    mark("model")
    phase_graphs()
    mark("graphs")
    launches, by_path = phase_serving()
    mark("serving")
    by_path["tokens"] = phase_tokens()
    mark("tokens")
    by_path["train"] = phase_train()
    mark("train")
    by_path["dist"] = phase_dist()
    mark("dist")
    by_path["examples"] = phase_examples()
    mark("examples")
    launches["paged"] = phase_autotune()
    mark("autotune")
    phase_fleet()
    mark("fleet")
    print("[done] seconds by phase: " + ", ".join(
        f"{name} {t - prev:.1f}" for (_, prev), (name, t)
        in zip(marks, marks[1:])))
    by_path["tuning"] = {"paged": launches["paged"]}
    for n, kern in (("flash", "K1"), ("decode", "K2")):
        rows[n]["family_device_ms"] = {
            name: t[2] for name, t in family.items() if t[0] == kern}
    kernels = [dict(rows[n], launches=launches[n], launches_by_path={
        path: counts[n] for path, counts in by_path.items()
        if counts.get(n)}) for n in ("flash", "decode", "paged", "ssd_scan")]
    store.cleanup()
    print(f"[done] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
