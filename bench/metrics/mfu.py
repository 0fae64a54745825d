"""mfu: the model FLOPs of the requests completed in the window (from the
configuration's shapes, ``counts.request_flops``) over the window's
seconds times the bf16 peak, in %."""

from bench import counts


def read(ctx):
    per = counts.request_flops(ctx.conf, ctx.traffic["prompt_len"],
                               ctx.traffic["new_tokens"])
    return 100.0 * per * ctx.requests / (ctx.window_s * counts.BF16_FLOPS)
