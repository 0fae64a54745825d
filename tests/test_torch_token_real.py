"""The token engine on the port's ``RealExecutor``: ``run_token_step`` has
the reference's semantics (tokens = live slots x mtl, the bucket of the
live slots plus the chunked-prefill rows), and ``launch.serve.
decode_executor_for`` builds an executor over one decode step whose bucket
batch holds a prefilled cache, whose ``fits`` charges each slot its KV
cache without building a batch, whose step equals ``api.decode_step`` on
that cache, and over which ``run_continuous`` conserves requests.  On the
CPU, at TINY widths."""

import math

import numpy as np
import pytest
import torch

from repro_torch.configs.base import InputShape, torch_dtype
from repro_torch.launch.serve import decode_act_bytes, decode_executor_for
from repro_torch.models import api
from repro_torch.serving import device_model as dm
from repro_torch.serving import token_engine as te
from repro_torch.serving.executor import PARAM_OVERHEAD, RealExecutor

ARCHS = ["gemma2-2b", "smollm-360m"]
PROMPT, BUDGET = 16, 48


def _executor(arch):
    return decode_executor_for(arch, tiny=True, device="cpu",
                               prompt_len=PROMPT, kv_budget=BUDGET)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_executor_builds_on_the_cpu(arch):
    ex, cfg, prof = _executor(arch)
    assert ex.device.type == "cpu" and cfg.kernel_impl == "pallas"
    assert ex.profile is prof and ex.mem_bytes is None
    assert prof == dm.llm_profile(cfg, mode="decode", kv_seq_budget=BUDGET)
    assert ex.kv_bytes_per_item == dm.kv_cache_bytes(
        cfg, BUDGET, dtype_bytes=torch_dtype(cfg).itemsize)
    assert ex.act_bytes_per_item == decode_act_bytes(cfg)
    with pytest.raises(ValueError):
        decode_executor_for(arch, tiny=True, device="cpu", prompt_len=BUDGET,
                            kv_budget=BUDGET)


@pytest.mark.parametrize("live,mtl,extra,bucket", [
    (1, 1, 0.0, 1), (3, 1, 0.0, 4), (3, 1, 0.5, 4), (3, 1, 1.5, 8),
    (5, 1, 0.0, 8), (2, 2, 0.0, 4)])
def test_run_token_step_counts_live_slots(live, mtl, extra, bucket):
    ex, _, _ = _executor("gemma2-2b")
    r = ex.run_token_step(live, mtl, prefill_tenants=2, extra_slots=extra)
    assert r["tokens"] == r["items"] == live * mtl
    assert r["bucket_items"] == bucket == ex.bucket(
        (live + math.ceil(extra)) * mtl)
    assert r["step_time"] > 0 and r["compile_time"] > 0
    assert list(ex._exec) == [bucket]


@pytest.mark.parametrize("arch", ARCHS)
def test_fits_charges_kv_bytes_per_slot(arch):
    """``fits`` reads the per-slot activations it was given (no batch is
    built) and charges every live slot its KV cache at the budget."""
    ex, _, _ = _executor(arch)
    need = (ex.param_bytes * PARAM_OVERHEAD + ex.bucket(4)
            * ex.act_bytes_per_item + 4 * ex.kv_bytes_per_item)
    ex.mem_bytes = need
    assert ex.fits(4, 1) and not ex.fits(5, 1)
    assert te.memory_slot_cap(ex, 16) == 4
    ex.mem_bytes = need - ex.kv_bytes_per_item    # one slot's KV short
    assert te.memory_slot_cap(ex, 16) == 3
    ex.kv_bytes_per_item = 0.0
    assert te.memory_slot_cap(ex, 16) == 4
    assert ex.cache_stats.misses == 0 and not ex._exec


@pytest.mark.parametrize("arch", ARCHS)
def test_step_equals_decode_step_on_the_prefilled_cache(arch):
    """A bucket's batch is the prefill of its seeded prompts into a
    ``BUDGET``-position cache; the executor's step is ``api.decode_step``
    at ``PROMPT`` on it, and replaying it leaves the depth fixed."""
    ex, cfg, _ = _executor(arch)
    n = 3
    ex.warmup(n, 1)
    batch = ex._exec[ex.bucket(n)].batch
    nb = ex.bucket(n)
    prompt = api.make_batch(cfg, InputShape("decode", PROMPT, nb, "prefill"),
                            seed=1, device="cpu")
    logits, cache = api.prefill(ex.params, prompt, cfg, capacity=BUDGET)
    tok = logits.argmax(-1).to(torch.int32)
    assert torch.equal(batch["tokens"], tok)
    assert batch["pos"].dtype == torch.int32 and int(batch["pos"]) == PROMPT
    want = api.decode_step(ex.params, cache, tok,
                           torch.full((), PROMPT, dtype=torch.int32), cfg)[0]
    got = ex.fn(ex.params, batch)
    assert got.shape == (nb, cfg.vocab_size) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for _ in range(2):
        ex.run_token_step(n)
    torch.testing.assert_close(ex.fn(ex.params, batch), want, rtol=0, atol=0)
    assert ex.cache_stats.misses == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_run_continuous_conserves_over_the_decode_step(arch):
    ex, _, _ = _executor(arch)
    trace = te.ragged_decode_trace(12, 0, rate_rps=12.0, prefill_mean=PROMPT,
                                   decode_mean=8)
    rep = te.run_continuous(trace, ex, max_slots=4, ttft_slo_s=1.0,
                            tpot_slo_s=0.05)
    assert rep["conserved"] and rep["completed"] == 12
    assert rep["tokens_out"] == sum(r.decode_tokens for r in trace)
    assert rep["mean_live_slots"] <= 4 and not rep["truncated"]
    assert set(ex._exec) <= {1, 2, 4}


CASES = [(1, 1, 0.0), (3, 1, 0.0), (3, 1, 0.25), (7, 2, 0.0), (12, 1, 3.5)]


def test_run_token_step_matches_the_reference():
    """Given the same trivial callable, the reference's and the port's
    ``run_token_step`` count the same tokens and items in the same
    bucket."""
    pytest.importorskip("jax")
    from repro.serving.executor import RealExecutor as RefExecutor
    ref = RefExecutor(fn=lambda p, b: b, params=np.zeros(16, np.float32),
                      make_batch=lambda n: np.zeros((n, 4), np.float32))
    port = RealExecutor(fn=lambda p, b: b, params=torch.zeros(16),
                        make_batch=lambda n: torch.zeros((n, 4)))
    for live, mtl, extra in CASES:
        r, p = (ex.run_token_step(live, mtl, prefill_tenants=1,
                                  extra_slots=extra) for ex in (ref, port))
        assert (p["tokens"], p["items"], p["bucket_items"]) == \
            (r["tokens"], r["items"], r["bucket_items"])
