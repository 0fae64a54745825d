"""kernels.decode_attn_roofline: the least time of one query against the
cache at the traced calls' shapes (``counts.decode_attention``: each
layer's decode step i of a request reads the keys and values of positions
0..T + i) over the device time of K2's kernels
(``kernels/decode_attention``), in %.  None where the trace holds none of
them; another count than one kernel a call fails the run."""

from bench import counts
from bench.reference import llama

KERNELS = r"\bdecode_kernel\b"


def read(ctx):
    tr = ctx.trace
    steps = ctx.traffic["new_tokens"]
    c, T = ctx.conf["config"], ctx.traffic["prompt_len"]
    L = c["num_hidden_layers"]
    H, KV, hd = llama.dims(c)
    found = tr.kernels(KERNELS)
    if not found:
        return None
    counts.expect_kernels(found, L * steps * len(tr.steps), KERNELS)
    least = sum(L * counts.least_s(*counts.decode_attention(
        s.bucket, H, KV, hd, T + i)) for s in tr.steps for i in range(steps))
    return 100.0 * least / (sum(e - s for _, s, e in found) / 1e6)
