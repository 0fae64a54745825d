"""Faults planted in the program's timed path, to show that the check
catches them: by the CPU tests at a tiny size, and at a cell's own size on
the card (``python3 -m bench.control --fault <name>``).  The benchmark's
own runs never plant one.

Each fault takes ``patch(obj, name, value)`` (pytest's
``monkeypatch.setattr``, or ``setattr``) and is planted before the
buckets are captured, so the graphs replay it.
"""

from __future__ import annotations


def altered_token(patch) -> None:
    """The last served token of every request is another one."""
    from repro_torch.models import api
    generate = api.generate

    def altered(params, batch, cfg, steps):
        out = generate(params, batch, cfg, steps).clone()
        out[:, -1] = (out[:, -1] + 1) % cfg.vocab_size
        return out
    patch(api, "generate", altered)


def state_unchanged(patch) -> None:
    """A Mamba block's decode step returns its recurrent state (the SSM
    and convolution state) as it found it."""
    from repro_torch.models import mamba
    block = mamba.mamba_block_apply

    def unchanged(p, x, cfg, *, state=None, mode="prefill"):
        out, new = block(p, x, cfg, state=state, mode=mode)
        return out, (state if mode == "decode" else new)
    patch(mamba, "mamba_block_apply", unchanged)


def cache_unwritten(patch) -> None:
    """An attention layer's decode step leaves the KV cache as it found it:
    the new token's key and value go to a copy that only this step reads,
    so every later step attends over the prompt alone."""
    from repro_torch.models import layers
    block = layers.attn_block_apply

    def unwritten(p, x, cfg, *, cache=None, mode="prefill", **kw):
        if mode == "decode":
            cache = {k: v.clone() for k, v in cache.items()}
        return block(p, x, cfg, cache=cache, mode=mode, **kw)
    patch(layers, "attn_block_apply", unwritten)


FAULTS = {f.__name__: f for f in (altered_token, state_unchanged,
                                  cache_unwritten)}
