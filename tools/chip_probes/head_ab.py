"""Gemma-2-2B's decode steps and LM head of one tree (argv[1]: its root),
as the token phase of ``chip_smoke.py`` builds them: the flash and decode
kernels built, ``serve.decode_executor_for``'s slot buckets 1-16 each
captured in a CUDA graph (largest first), then the graph pool's size and,
for each bucket, the step's host-clock ms (20 replays), one traced
replay's device busy ms, and the tree's ``logits_last`` alone on that
many rows: its device ms a call (``chip_smoke._graph_ms``, 5 calls in a
CUDA graph).  To compare two trees on one card, unpack the other (``git
archive``) into a gitignored directory and run the two in one command, in
the order A B B A:

    python3 tools/chip_probes/head_ab.py PATH_TO_TREE
"""
import importlib
import json
import os
import sys
import time

ROOT = os.path.abspath(sys.argv[1])
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.base import torch_dtype  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.serve import decode_executor_for  # noqa: E402

assert cs.__file__.startswith(ROOT), cs.__file__
try:                                # the head's own module, where it has one
    logits_last = importlib.import_module(
        "repro_torch.models.head").logits_last
except ImportError:
    logits_last = importlib.import_module(
        "repro_torch.models.transformer").logits_last
t0 = time.perf_counter()
cs.phase_toolchain()
build.build("flash_attention", "decode_attention")
built = time.perf_counter() - t0
ex, cfg, _ = decode_executor_for(cs.TOKEN_ARCH, prompt_len=cs.PROMPT,
                                 kv_budget=cs.KV_BUDGET)
_, n_attn, _ = cs._path_counts(cfg)
for n in sorted(cs.SLOT_LADDER, reverse=True):
    ex.warmup(n, 1)
pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
           if tuple(seg["segment_pool_id"]) == tuple(ex._graphs.pool))
rungs = {}
for n in cs.SLOT_LADDER:
    entry = ex._exec[n]
    host = sorted(cs._host_ms(entry.graph.replay) for _ in range(20))
    events = cs._device_events(entry.graph.replay, lambda ev: sum(
        "::decode_kernel<" in e[0] for e in ev) == n_attn)
    busy, span = cs._span_ms(events)
    x = torch.zeros((n, cfg.d_model), dtype=torch_dtype(cfg), device=cs.DEV)
    head_ms = cs._graph_ms(lambda: logits_last(ex.params, x, cfg), 5)
    rungs[n] = {"host_median_ms": host[len(host) // 2], "busy_ms": busy,
                "span_ms": span, "head_ms": head_ms}
print(json.dumps({"tree": sys.argv[1], "build_s": built,
                  "pool_gib": pool / 2 ** 30,
                  "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30,
                  "rungs": rungs, "seconds": time.perf_counter() - t0}))
