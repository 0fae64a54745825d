"""kernels.flash_attn_roofline: the least time of causal prefill attention
at the traced calls' shapes (``counts.flash_prefill``: each prefill's
layers at (bucket rows, T, H, KV, hd)) over the device time of K1's
kernels (``kernels/flash_attention``), in %.  None where the trace holds
none of them; another count than one kernel a call fails the run."""

from bench import counts
from bench.reference import llama

KERNELS = r"\bflash_fwd_\w*kernel\b"


def read(ctx):
    tr = ctx.trace
    c, T = ctx.conf["config"], ctx.traffic["prompt_len"]
    L = c["num_hidden_layers"]
    H, KV, hd = llama.dims(c)
    found = tr.kernels(KERNELS)
    if not found:
        return None
    counts.expect_kernels(found, L * len(tr.steps), KERNELS)
    least = sum(L * counts.least_s(*counts.flash_prefill(
        s.bucket, T, H, KV, hd)) for s in tr.steps)
    return 100.0 * least / (sum(e - s for _, s, e in found) / 1e6)
