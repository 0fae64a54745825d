"""Encoder-decoder transformer (Whisper-style speech backbone).

Counterpart of ``repro.models.encdec``.  The mel-spectrogram + conv
feature extractor is stubbed as in the reference: the batch supplies
precomputed frame embeddings (B, encoder_seq_len, d_model).  The encoder
is bidirectional; the decoder has causal self-attention (RoPE, cached at
decode) plus cross-attention over per-layer encoder K/V computed once at
prefill and kept in the cache.  Parameters keep the reference's layout:
``enc_layers`` and ``dec_layers`` stacked on a leading layer axis.  Three
modes, as the decoder-only models: train (``train_loss``), prefill and
decode.

The cache is the reference's: {'k','v': (L, B, KV, cap, hd), 'ck','cv':
(L, B, S_enc, KV, hd)}.  Both modes write it in place.  On the kernel path
(``kernel_impl="pallas"``) the encoder's self-attention and the prefill's
cross-attention take the flash kernel with ``causal=False``, and the decode
step's cross-attention the decode kernel over a transposed view of
``ck``/``cv`` (``layers.cross_attn_apply``), where the reference runs its
pure-JAX blockwise attention for all three.  Training takes that plain
attention everywhere, on either path.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import torch_dtype
from repro_torch.distributed import fsdp, is_dtensor
from repro_torch.distributed.cache_update import (deltas_like, write_slice,
                                                  write_whole)
from repro_torch.models import head, transformer
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_params, unstack


def init_params(gen: torch.Generator, cfg, device) -> dict:
    dt = torch_dtype(cfg)
    enc, dec = (cfg.encoder_layers,), (cfg.num_layers,)
    params = {
        "embed": L.normal(gen, (cfg.vocab_size, cfg.d_model), dt, device),
        "enc_layers": {"attn": L.init_attn_block(gen, cfg, enc, dt, device),
                       "mlp": L.init_mlp(gen, cfg, enc, dt, device)},
        "dec_layers": {"attn": L.init_attn_block(gen, cfg, dec, dt, device),
                       "cross": L.init_attn_block(gen, cfg, dec, dt, device,
                                                  cross=True),
                       "mlp": L.init_mlp(gen, cfg, dec, dt, device)},
        "enc_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal(gen, (cfg.d_model, cfg.vocab_size), dt,
                                     device)
    return params


def _top_gathered(params, gather, mark=None):
    return transformer.top_gathered(params, gather, mark,
                                    stacks=("enc_layers", "dec_layers"))


def encode(params, audio_embeds: torch.Tensor, cfg, *,
           mode: str = "prefill", bspec=None, gather=None) -> torch.Tensor:
    """audio_embeds: (B, S_enc, d), the stubbed frontend's output -> the
    encoder's states.  ``mode="train"`` takes the plain attention, never
    the kernel.  ``gather``: the sharded steps' per-layer gather, applied
    to each layer's parameters as the loop reaches it."""
    fetch = gather or fsdp.resolved
    x = L.constrain_batch(audio_embeds.to(torch_dtype(cfg)), bspec)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in unstack(params["enc_layers"]):
        lp = fetch(lp)
        x, _ = L.attn_block_apply(lp["attn"], L.constrain_batch(x, bspec), cfg,
                                  causal=False,
                                  positions=positions, mode=mode)
        x = L.mlp_apply(lp["mlp"], x, cfg)
    return L.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _decoder_trunk(params, x, cfg, cache, *, mode, enc_out=None,
                   positions=None, pos=None, remat=False, bspec=None,
                   return_deltas=False, gather=None):
    """Runs the decoder layers, writing ``cache`` in place.

    prefill: self-attention K/V of the T prompt positions at [0, T), and
    each layer's cross-attention K/V of ``enc_out`` into ``ck``/``cv``.
    decode: one token at slot ``pos`` (0-d int tensor on the device);
    cross-attention reads ``ck``/``cv``; ``return_deltas`` leaves the
    cache unwritten and returns (x, the reference's deltas).
    train: no cache; ``remat`` checkpoints each layer's body (see
    ``transformer.run_group_train``).  ``gather``: the sharded steps'
    per-layer gather, applied to each layer's parameters as the loop
    reaches it (in train, inside the checkpointed body)."""
    n = cfg.num_layers
    if mode == "train":
        fetch = gather or fsdp.resolved

        def body(y, lp):
            lp = fetch(lp)
            y = L.constrain_batch(y, bspec)
            y, _ = L.attn_block_apply(lp["attn"], y, cfg, mode="train",
                                      positions=positions)
            enc_kv = L.encode_kv(lp["cross"], enc_out, cfg)
            y = L.cross_attn_apply(lp["cross"], y, enc_kv, cfg, mode="train")
            return L.mlp_apply(lp["mlp"], y, cfg)
        for lp in unstack(params["dec_layers"]):
            x = (checkpoint(body, x, lp, use_reentrant=False) if remat
                 else body(x, lp))
        return x
    fetch = gather or transformer._as_is
    if mode == "prefill":
        T = x.shape[1]
        for i in range(n):
            lp = fetch(layer_params(params["dec_layers"], i))
            x, kv = L.attn_block_apply(lp["attn"], L.constrain_batch(x, bspec),
                                       cfg, mode="prefill",
                                       positions=positions)
            enc_kv = L.encode_kv(lp["cross"], enc_out, cfg)
            if is_dtensor(cache["k"]):
                for name in ("k", "v"):
                    write_slice(cache[name][i], kv[name].transpose(1, 2), 2,
                                0)
                    write_whole(cache["c" + name][i], enc_kv[name])
            else:
                cache["k"][i, :, :, :T] = kv["k"].transpose(1, 2)
                cache["v"][i, :, :, :T] = kv["v"].transpose(1, 2)
                cache["ck"][i] = enc_kv["k"]
                cache["cv"][i] = enc_kv["v"]
            x = L.cross_attn_apply(lp["cross"], x, enc_kv, cfg)
            x = L.mlp_apply(lp["mlp"], x, cfg)
        return x

    positions = pos.reshape(1)
    enc_last = torch.full((1,), cache["ck"].shape[2] - 1, dtype=torch.int32,
                          device=x.device)
    kvs = []
    for i in range(n):
        lp = fetch(layer_params(params["dec_layers"], i))
        x, kv = L.attn_block_apply(lp["attn"], L.constrain_batch(x, bspec),
                                   cfg, mode="decode",
                                   cache={"k": cache["k"][i],
                                          "v": cache["v"][i]},
                                   cache_pos=pos, positions=positions,
                                   write=not return_deltas)
        kvs.append(kv)
        x = L.cross_attn_apply(lp["cross"], x,
                               {"k": cache["ck"][i], "v": cache["cv"][i]},
                               cfg, enc_last=enc_last)
        x = L.mlp_apply(lp["mlp"], x, cfg)
    if return_deltas:
        deltas = {name: torch.stack([kv[name] for kv in kvs])
                  for name in ("k", "v")}
        return x, deltas_like({**deltas, "ck": cache["ck"],
                               "cv": cache["cv"]}, cache)
    return x


def init_cache(cfg, batch: int, capacity: int, device=None) -> dict:
    dt = torch_dtype(cfg)
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    Ld, Se = cfg.num_layers, cfg.encoder_seq_len

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    return {"k": zeros(Ld, batch, KV, capacity, hd),
            "v": zeros(Ld, batch, KV, capacity, hd),
            "ck": zeros(Ld, batch, Se, KV, hd),
            "cv": zeros(Ld, batch, Se, KV, hd)}


def train_loss(params, batch, cfg, *, remat=True, bspec=None, gather=None,
               mark=None):
    """batch: {'tokens': (B, T) int, 'audio_embeds': (B, S_enc, d)}.
    Next-token cross-entropy of the decoder; aux is zero (no MoE).
    Returns (loss, {'ce', 'aux'}).  ``gather`` as
    ``transformer.train_loss``'s; ``mark``: entered around the encoder
    ("group0") and the decoder ("group1"), forward and backward, as
    ``transformer.forward_full`` does around its groups."""
    tokens = batch["tokens"]
    params = _top_gathered(params, gather, mark)
    with L.marked(mark, "group0"):
        enc_out = encode(params, batch["audio_embeds"], cfg, mode="train",
                         bspec=bspec, gather=gather)
    # the encoder's input needs no gradient: its backward phase runs on to
    # the end of the backward
    enc_out = L.backward_marked(mark, "backward_group0")[1](enc_out)
    x = L.constrain_batch(head.embed_lookup(params["embed"], tokens).to(
        torch_dtype(cfg)), bspec)
    positions = torch.arange(tokens.shape[1], device=x.device)
    inward, outward = L.backward_marked(mark, "backward_group1")
    with L.marked(mark, "group1"):
        h = _decoder_trunk(params, inward(x), cfg, None, mode="train",
                           enc_out=enc_out, positions=positions, remat=remat,
                           bspec=bspec, gather=gather)
    h = outward(h)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    ce = head.chunked_ce_loss(
        params, h, *transformer.next_token_targets(tokens), cfg)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=x.device)}


def prefill(params, batch, cfg, capacity: int, bspec=None, cache=None,
            gather=None):
    """batch: {'tokens': (B, T) int, 'audio_embeds': (B, S_enc, d)}.
    Returns (last_logits (B,V) f32, cache) with cache capacity
    ``capacity``; ``cache``, ``bspec``, ``gather`` as
    ``transformer.prefill``'s."""
    tokens = batch["tokens"]
    params = _top_gathered(params, gather)
    enc_out = encode(params, batch["audio_embeds"], cfg, bspec=bspec,
                     gather=gather)
    x = L.constrain_batch(head.embed_lookup(params["embed"], tokens).to(
        torch_dtype(cfg)), bspec)
    B, T = tokens.shape
    positions = torch.arange(T, device=x.device)
    if cache is None:
        cache = init_cache(cfg, B, capacity, device=x.device)
    h = _decoder_trunk(params, x, cfg, cache, mode="prefill", enc_out=enc_out,
                       positions=positions, bspec=bspec, gather=gather)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return head.logits_last(params, h[:, -1], cfg), cache


def decode_step(params, cache, tokens, pos, cfg, bspec=None,
                return_deltas: bool = False, gather=None):
    """tokens: (B,) int new token ids; pos: 0-d int tensor slot index.
    Returns (logits (B,V) f32, cache), the cache updated in place; with
    ``return_deltas`` the cache is unwritten and the second result is the
    reference's deltas: {'k','v': (L, B, KV, 1, hd), 'ck','cv': the cache's
    own}; ``gather`` as ``transformer.prefill``'s."""
    params = _top_gathered(params, gather)
    x = L.constrain_batch(head.embed_lookup(
        params["embed"], tokens[:, None]).to(torch_dtype(cfg)), bspec)
    h = _decoder_trunk(params, x, cfg, cache, mode="decode", pos=pos,
                       return_deltas=return_deltas, bspec=bspec,
                       gather=gather)
    if return_deltas:
        h, cache = h
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return head.logits_last(params, h[:, 0], cfg), cache
