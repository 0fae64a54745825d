"""The benchmark's counts against hand counts, two shapes each, and the
device-timeline arithmetic on made-up intervals."""

import pytest

from bench import counts, spec
from bench.context import Context, Trace
from bench.reference import llama, mamba2
from bench.serve import Step


@pytest.mark.parametrize("shape,flops,nbytes", [
    # (B, T, H, KV, hd): pairs T(T+1)/2; 4 B H hd pairs; 2 B T hd (2H+2KV)
    ((1, 4, 2, 1, 8), 4 * 2 * 8 * 10, 2 * 4 * 8 * 6),
    # SmolLM at 8 x 512: pairs 131,328
    ((8, 512, 15, 5, 64), 4 * 8 * 15 * 64 * 131328,
     2 * 8 * 512 * 64 * 40),
])
def test_flash_prefill(shape, flops, nbytes):
    assert counts.flash_prefill(*shape) == (flops, nbytes)


@pytest.mark.parametrize("shape,flops,nbytes", [
    # (B, H, KV, hd, pos): 4 B H hd (pos+1); 2 (2 B KV (pos+1) hd + 2 B H hd)
    ((1, 2, 1, 8, 3), 4 * 2 * 8 * 4, 2 * (2 * 4 * 8 + 2 * 2 * 8)),
    ((8, 15, 5, 64, 543), 4 * 8 * 15 * 64 * 544,
     2 * (2 * 8 * 5 * 544 * 64 + 2 * 8 * 15 * 64)),
])
def test_decode_attention(shape, flops, nbytes):
    assert counts.decode_attention(*shape) == (flops, nbytes)


@pytest.mark.parametrize("shape,flops,nbytes", [
    # B 1, T 4, H 1, P 2, N 2, chunk 2: 2 chunks, 6 causal pairs.
    # C Bᵀ 2*6*2 = 24; masked product 2*6*2 = 24; states 2*4*2*2 = 32;
    # state outputs 2*(4-2)*2*2 = 16.  Bytes: x 2*8, dt 4*4, A 4, B and C
    # 2*2*8, y 4*8, state 4*4.
    ((1, 4, 1, 2, 2, 2), 24 + 24 + 32 + 16,
     16 + 16 + 4 + 32 + 32 + 16),
    # Mamba2 at 8 x 512, chunk 256: 2 chunks, 65,792 pairs.
    ((8, 512, 64, 64, 128, 256),
     2 * 8 * 65792 * 128 + 2 * 8 * 64 * 65792 * 64
     + 2 * 8 * 64 * 512 * 64 * 128 + 2 * 8 * 64 * 256 * 64 * 128,
     2 * 8 * 512 * 64 * 64 + 4 * 8 * 512 * 64 + 4 * 64
     + 2 * 2 * 8 * 512 * 128 + 4 * 8 * 512 * 64 * 64 + 4 * 8 * 64 * 64 * 128),
])
def test_ssd_scan(shape, flops, nbytes):
    assert counts.ssd_scan(*shape) == (flops, nbytes)


def test_least_time_takes_the_larger_bound():
    assert counts.least_s(989e12, 0) == pytest.approx(1.0)
    assert counts.least_s(0, 3.35e12) == pytest.approx(1.0)


LLAMA = {"family": "llama", "config": {
    "hidden_size": 4, "num_attention_heads": 2, "num_key_value_heads": 1,
    "intermediate_size": 8, "num_hidden_layers": 1, "vocab_size": 10}}
MAMBA = {"family": "mamba2", "config": {
    "d_model": 2, "expand": 2, "d_state": 2, "headdim": 2, "d_conv": 2,
    "n_layer": 1, "chunk_size": 2, "vocab_size": 9,
    "pad_vocab_size_multiple": 2}}


def test_request_flops_llama_by_hand():
    # d 4, H 2, KV 1, hd 2: attn 4*4*2 + 2*2*4 = 48 weights; mlp 3*4*8 = 96;
    # trunk 2 * 144 = 288 a token.  T 2, steps 1: 3 tokens 864; head
    # 2*4*10 over 2 positions 160; prefill attention 4*2*2*3 = 48; the
    # decode step at pos 2 4*2*2*3 = 48.
    assert counts.request_flops(LLAMA, 2, 1) == 864 + 160 + 48 + 48


def test_request_flops_mamba_by_hand():
    # d 2, d_in 4, N 2, P 2, H 2, vocab 9 padded to 10: in_proj
    # 2*(8+4+2) = 28, out_proj 8, conv 2*(4+4) = 16; 2*52 = 104 a token.
    # T 2, steps 0: 208; head 2*2*10 = 40; the scan at B 1, T 2, H 2, P 2,
    # N 2, chunk 2: pairs 3, 2*3*2 + 2*2*3*2 + 2*2*2*2*2 + 0 = 12+24+32.
    assert counts.vocab(MAMBA) == 10
    assert counts.request_flops(MAMBA, 2, 0) == 208 + 40 + 68
    # one decode step more: 3 tokens, 2 positions on the head, 4 H P N
    assert counts.request_flops(MAMBA, 2, 1) == 312 + 80 + 68 + 4 * 8


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (9, 12)]
    assert counts.union_s(iv, 0, 10) == 3 + 1 + 1
    assert counts.gaps(iv, 0, 10) == [(3, 5), (6, 9)]


def test_trace_breakdown_labels_gaps_by_host_range():
    tr = Trace(events=[("k1", 0, 4), ("k2", 10, 12), ("k1", 12, 14)],
               lo=0, hi=20, steps=[Step(0, 0, 1, 2, 2, 0)],
               host=[("bench.step", 0, 14), ("bench.controller", 14, 20)])
    assert tr.busy_us == 8
    b = tr.breakdown()
    assert b["device_ops"] == [["k1", 6e-6], ["k2", 2e-6]]
    assert b["idle_gaps"] == [["bench.step", 6e-6],
                              ["bench.controller", 6e-6]]


def test_each_familys_request_count_lies_beside_its_reference():
    assert counts.request_flops(LLAMA, 2, 1) == llama.request_flops(
        LLAMA, 2, 1)
    assert counts.request_flops(MAMBA, 2, 1) == mamba2.request_flops(
        MAMBA, 2, 1)
    assert mamba2.scan_chunk({"chunk_size": 256}, 2048) == 256
    assert mamba2.scan_chunk({"chunk_size": 256}, 100) == 100


def _ctx(events, steps):
    conf = {"family": "llama", "config": {
        "hidden_size": 8, "num_attention_heads": 2,
        "num_key_value_heads": 1, "num_hidden_layers": 2}}
    ctx = Context(conf, {"prompt_len": 4, "new_tokens": 0}, {}, 1.0,
                  steps, 1.0, 0.0)
    ctx.trace = Trace(events, 0, 100, steps, [])
    return ctx


def test_a_roofline_with_no_kernel_is_silent_and_a_miscount_fails():
    read = spec.metric_reader("kernels.flash_attn_roofline.score")
    steps = [Step(1, 0, 1, 2, 2, 0)]
    other = [("gemm", 0, 10)]
    assert read(_ctx(other, steps)) is None
    one = [("flash_fwd_wgmma_kernel", 0, 10)]
    with pytest.raises(RuntimeError, match="1 kernels"):
        read(_ctx(one, steps))          # 2 layers make 2 calls
    assert 0 < read(_ctx(one * 2, steps)) < 100
