"""Decoder-only transformer assembly for the dense, MoE, SSM, hybrid and
VLM models.

Counterpart of ``repro.models.transformer`` for the ``attn``, ``swa``,
``local_global``, ``mamba`` and ``hybrid_super`` groups (a dense layer's
FFN is an MLP, or with ``cfg.num_experts`` a mixture of experts,
``models/moe.py``), with the vision stub's patch embeddings prepended
(``embed_tokens``).  Each group's parameters keep the reference's layout,
stacked on a leading layer axis (Zamba2's Mamba stack on two:
super-block, then block; its shared block unstacked); a Python loop over
that axis takes the place of ``lax.scan``.
Three modes:

  train   — full-sequence forward, chunked cross-entropy loss
  prefill — full-sequence forward, returns last-position logits + cache
  decode  — one token against the cache (the serving hot path)

Prefill and decode write the cache in place (on a mesh, each rank its
own shard) and discard the MoE layers' load-balance loss, as the
reference's do; train adds it to the loss.  Decode with
``return_deltas`` leaves the cache unwritten and returns the reference's
deltas instead.
Train never takes a kernel: the attention's backward is the reference's
blockwise recomputation (``layers._Flash``), the Mamba blocks run
``ssd_chunked``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, MAMBA, SWA, torch_dtype
from repro_torch.distributed import fsdp, is_dtensor
from repro_torch.distributed.cache_update import (deltas_like, write_slice,
                                                  write_whole)
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models.head import (chunked_ce_loss, embed_lookup,
                                     logits_last)

KINDS = (ATTN, SWA, "local_global", MAMBA, "hybrid_super")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"layer group {kind!r} is not ported to repro_torch yet")


# ---------------------------------------------------------------------------
# Parameter init (random, from an explicit torch.Generator)
# ---------------------------------------------------------------------------
def _init_dense_stack(gen, cfg, prefix, dt, device) -> dict:
    p = {"attn": L.init_attn_block(gen, cfg, prefix, dt, device)}
    if cfg.num_experts:
        p["moe"] = MOE.init_moe(gen, cfg, prefix, dt, device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, prefix, dt, device)
    return p


def init_params(gen: torch.Generator, cfg, device) -> dict:
    dt = torch_dtype(cfg)
    groups = []
    for kind, count in cfg.layer_groups:
        _check_kind(kind)
        if kind == "local_global":
            groups.append({"local": _init_dense_stack(gen, cfg, (count,), dt, device),
                           "global": _init_dense_stack(gen, cfg, (count,), dt, device)})
        elif kind == MAMBA:
            groups.append(M.init_mamba_block(gen, cfg, (count,), device))
        elif kind == "hybrid_super":
            inner = cfg.hybrid_attn_every
            groups.append({
                "mamba": M.init_mamba_block(gen, cfg, (count, inner), device),
                "shared": _init_dense_stack(gen, cfg, (), dt, device)})
        else:
            groups.append(_init_dense_stack(gen, cfg, (count,), dt, device))
    params = {
        "embed": L.normal(gen, (cfg.vocab_size, cfg.d_model), dt, device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "groups": groups,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal(gen, (cfg.d_model, cfg.vocab_size), dt,
                                     device)
    if cfg.frontend == "vision_stub":
        params["vis_proj"] = L.normal(gen, (cfg.d_model, cfg.d_model), dt,
                                      device)
    return params


def layer_params(gp: dict, i: int) -> dict:
    """Layer ``i`` of a stacked group: every leaf indexed on its layer axis
    (``fsdp.layer``: a DTensor sharded on that axis gives the one layer,
    from the rank that holds it)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else fsdp.layer(v, i)
            for k, v in gp.items()}


def unstack(gp: dict) -> list:
    """Every layer of a stacked group, each leaf split on its layer axis by
    ``torch.unbind``: the backward stacks the layers' gradients into the
    leaf once, where indexing each layer (``layer_params``) would add a
    full-size gradient per layer.  A DTensor sharded on its layer axis
    gives a ``fsdp.LayerRef`` per layer, taken where the layer body
    applies ``fsdp.resolved`` or the steps' gather."""
    parts = {k: unstack(v) if isinstance(v, dict) else fsdp.layers(v)
             for k, v in gp.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------
def dense_layer_apply(lp, x, cfg, *, window, mode, kv=None, cache_pos=None,
                      positions=None, ring=False, write=True, seq_axis=None):
    """Returns (x, new_kv, aux): aux is the MoE load-balance loss, 0.0 (a
    float, so no kernel is launched for it) after an MLP."""
    x0 = x
    x, new_kv = L.attn_block_apply(lp["attn"], x, cfg, window=window,
                                   mode=mode, cache=kv, cache_pos=cache_pos,
                                   positions=positions, ring=ring,
                                   write=write, seq_axis=seq_axis)
    x = L.keep_layout(x, x0)
    if "moe" in lp:
        x, aux = MOE.moe_block_apply(lp["moe"], x, cfg)
    else:
        x = L.mlp_apply(lp["mlp"], x, cfg)
        aux = 0.0
    return L.keep_layout(x, x0), new_kv, aux


def _window(cfg, kind):
    return cfg.sliding_window if kind == SWA else None


# ---------------------------------------------------------------------------
# Cache allocation
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, capacity: int, windowed: bool = False,
               device=None) -> list:
    """windowed=True: sliding-window layers allocate only ``window`` slots
    (ring buffer) instead of the full context."""
    dt = torch_dtype(cfg)
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    wcap = capacity
    if windowed and cfg.sliding_window:
        wcap = min(capacity, cfg.sliding_window)

    def kv(count, cap):
        return {"k": torch.zeros((count, batch, KV, cap, hd), dtype=dt,
                                 device=device),
                "v": torch.zeros((count, batch, KV, cap, hd), dtype=dt,
                                 device=device)}

    caches = []
    for kind, count in cfg.layer_groups:
        _check_kind(kind)
        if kind == "local_global":
            caches.append({"local": kv(count, wcap),
                           "global": kv(count, capacity)})
        elif kind == MAMBA:
            caches.append(M.init_mamba_state(cfg, batch, dt, device, (count,)))
        elif kind == "hybrid_super":
            inner = cfg.hybrid_attn_every
            caches.append({"mamba": M.init_mamba_state(cfg, batch, dt, device,
                                                       (count, inner)),
                           **kv(count, wcap)})
        else:
            caches.append(kv(count, wcap if kind == SWA else capacity))
    return caches


# ---------------------------------------------------------------------------
# Group execution
# ---------------------------------------------------------------------------
def _as_is(tree):
    return tree


def run_group_train(gp, x, cfg, kind, *, positions, remat=False, bspec=None,
                    gather=None):
    """Full-sequence forward of one group; returns (x, the group's MoE aux
    loss).  ``remat`` wraps each layer body (a Zamba2 super-block: its
    Mamba stack and the shared block) in a non-reentrant
    ``torch.utils.checkpoint``, as the reference's ``jax.checkpoint(body)``:
    only the body's input is kept, its activations are recomputed in the
    backward.  ``bspec``: each body's input is constrained to the batch
    axes first (``layers.constrain_batch``), as the reference's are.
    ``gather``: the sharded steps' per-layer gather, applied inside the
    body to its layer's parameters (a Zamba2 super-block's: each Mamba
    block's and, once, the shared block's), so that under ``remat`` the
    backward gathers the layer again and one gathered layer is held at a
    time."""
    _check_kind(kind)
    window = cfg.sliding_window
    fetch = gather or fsdp.resolved
    if kind == "local_global":
        def body(y, lp):
            y, _, a1 = dense_layer_apply(lp["local"], y, cfg, window=window,
                                         mode="train", positions=positions)
            y, _, a2 = dense_layer_apply(lp["global"], y, cfg, window=None,
                                         mode="train", positions=positions)
            return y, a1 + a2
        layers = unstack(gp)
    elif kind == MAMBA:
        def body(y, lp):
            return M.mamba_block_apply(lp, y, cfg, mode="train")[0], 0.0
        layers = unstack(gp)
    elif kind == "hybrid_super":
        def body(y, mp_stack):
            for mp in unstack(fsdp.resolved(mp_stack)):
                y, _ = M.mamba_block_apply(fetch(mp), y, cfg, mode="train")
            y, _, _ = dense_layer_apply(fetch(gp["shared"]), y, cfg,
                                        window=window, mode="train",
                                        positions=positions)
            return y, 0.0
        layers = unstack(gp["mamba"])
    else:
        def body(y, lp):
            y, _, aux = dense_layer_apply(lp, y, cfg,
                                          window=_window(cfg, kind),
                                          mode="train", positions=positions)
            return y, aux
        layers = unstack(gp)
    inner = body
    take = _as_is if kind == "hybrid_super" else fetch

    def body(y, lp):
        return inner(L.constrain_batch(y, bspec), take(lp))
    aux_total = 0.0
    for lp in layers:
        if remat:
            x, aux = checkpoint(body, x, lp, use_reentrant=False)
        else:
            x, aux = body(x, lp)
        aux_total = aux_total + aux
    return x, aux_total


def _put(buf: dict, i: int, kv: dict, cache_pos: int) -> None:
    """Write layer i's prefill K/V (B, T, KV, hd) at [cache_pos, cache_pos+T)."""
    T = kv["k"].shape[1]
    for name in ("k", "v"):
        if is_dtensor(buf[name]):
            write_slice(buf[name][i], kv[name].transpose(1, 2), 2, cache_pos)
        else:
            buf[name][i, :, :, cache_pos:cache_pos + T] = \
                kv[name].transpose(1, 2)


def _mamba_layer(lp, x, cfg, buf: dict, idx: tuple, mode: str,
                 fresh: bool = False, write: bool = True):
    """One Mamba block on the state at ``buf[...][idx]``, which it then
    overwrites in place with the block's new state (``write=False``: left
    as it is).  ``fresh``: no token came before, so the block starts from
    ``state=None``, the zero state.  Returns (x, the new state)."""
    st = None if fresh else {"ssm": buf["ssm"][idx], "conv": buf["conv"][idx]}
    x, new = M.mamba_block_apply(lp, x, cfg, state=st, mode=mode)
    if write:
        for name in ("ssm", "conv"):
            if is_dtensor(buf[name]):
                write_whole(buf[name][idx], new[name])
            else:
                buf[name][idx].copy_(new[name])
    return x, new


def run_group_prefill(gp, x, cfg, kind, cache, *, positions, cache_pos=0,
                      seq_axis=None, bspec=None, gather=None):
    """Forward with the cache written in place at [cache_pos, cache_pos+T).

    At ``cache_pos == 0`` no token came before, so the Mamba blocks start
    from ``state=None``, the zero state, which lets a kernel prefill take
    the SSD-scan kernel (``mamba.mamba_block_apply``).  Past it they read
    their state from the cache, as the reference's always do.
    ``seq_axis``: the attention groups' sequence-parallel prefill (not the
    hybrid's shared block, as in the reference).  ``bspec``: each layer's
    input constrained to the batch axes (``layers.constrain_batch``), the
    one layout the reference's scan carries through its layers.
    ``gather``: the sharded steps' per-layer gather, applied to each
    layer's parameters as the loop reaches the layer (Zamba2's shared
    block: once a super-block)."""
    fresh = cache_pos == 0
    carry = lambda y: L.constrain_batch(y, bspec)  # noqa: E731
    fetch = gather or _as_is
    take = lambda g, i: fetch(layer_params(g, i))  # noqa: E731
    _check_kind(kind)
    if kind == "local_global":
        for i in range(gp["local"]["attn"]["wq"].shape[0]):
            x, kv_l, _ = dense_layer_apply(take(gp["local"], i),
                                           carry(x), cfg,
                                           window=cfg.sliding_window,
                                           mode="prefill",
                                           positions=positions,
                                           seq_axis=seq_axis)
            _put(cache["local"], i, kv_l, cache_pos)
            x, kv_g, _ = dense_layer_apply(take(gp["global"], i), x,
                                           cfg, window=None, mode="prefill",
                                           positions=positions,
                                           seq_axis=seq_axis)
            _put(cache["global"], i, kv_g, cache_pos)
        return x, cache
    if kind == MAMBA:
        for i in range(gp["in_proj"].shape[0]):
            x, _ = _mamba_layer(take(gp, i), carry(x), cfg, cache,
                                (i,), "prefill", fresh)
        return x, cache
    if kind == "hybrid_super":
        count, inner = gp["mamba"]["in_proj"].shape[:2]
        for i in range(count):
            stack = layer_params(gp["mamba"], i)
            for j in range(inner):
                x, _ = _mamba_layer(take(stack, j), carry(x), cfg,
                                    cache["mamba"], (i, j), "prefill", fresh)
            x, kv, _ = dense_layer_apply(fetch(gp["shared"]), x, cfg,
                                         window=cfg.sliding_window,
                                         mode="prefill", positions=positions)
            _put(cache, i, kv, cache_pos)
        return x, cache
    for i in range(gp["attn"]["wq"].shape[0]):
        x, kv, _ = dense_layer_apply(take(gp, i), carry(x), cfg,
                                     window=_window(cfg, kind), mode="prefill",
                                     positions=positions, seq_axis=seq_axis)
        _put(cache, i, kv, cache_pos)
    return x, cache


def _layer_cache(buf: dict, i: int) -> dict:
    return {"k": buf["k"][i], "v": buf["v"][i]}


def _stacked(per_layer: list) -> dict:
    """Per-layer dicts of tensors as one dict, each leaf stacked on a new
    leading layer axis (a list of lists of dicts: two axes)."""
    if isinstance(per_layer[0], list):
        per_layer = [_stacked(inner) for inner in per_layer]
    return {k: torch.stack([d[k] for d in per_layer])
            for k in per_layer[0]}


def run_group_decode(gp, x, cfg, kind, cache, *, pos, windowed=False,
                     return_deltas=False, bspec=None, gather=None):
    """One-token step.  pos: 0-d int tensor — the slot the new token lands in.
    windowed=True: sliding-window layers (and Zamba2's shared block) use
    ring-buffer caches.  The cache is updated in place: K/V as in
    ``layers.attn_block_apply``, the SSM and conv state by ``_mamba_layer``.
    Returns (x, cache).

    ``return_deltas``: the cache is left unwritten and the second result
    is the group's deltas, the reference's: each K/V leaf's new token
    stacked over the layers, (count, B, KV, 1, hd), and each state leaf's
    new state; on DTensors laid out as the cache leaves with the sequence
    axis whole (``cache_update.deltas_like``), ready for
    ``cache_update.apply_cache_deltas``.  ``bspec`` and ``gather`` as
    ``run_group_prefill``'s."""
    _check_kind(kind)
    carry = lambda y: L.constrain_batch(y, bspec)  # noqa: E731
    fetch = gather or _as_is
    take = lambda g, i: fetch(layer_params(g, i))  # noqa: E731
    positions = pos.reshape(1)
    write = not return_deltas
    if kind == "local_global":
        dl, dg = [], []
        for i in range(gp["local"]["attn"]["wq"].shape[0]):
            x, kv_l, _ = dense_layer_apply(
                take(gp["local"], i), carry(x), cfg,
                window=cfg.sliding_window, mode="decode",
                kv=_layer_cache(cache["local"], i), cache_pos=pos,
                positions=positions, ring=windowed, write=write)
            x, kv_g, _ = dense_layer_apply(
                take(gp["global"], i), x, cfg, window=None,
                mode="decode", kv=_layer_cache(cache["global"], i),
                cache_pos=pos, positions=positions, write=write)
            dl.append(kv_l)
            dg.append(kv_g)

        def deltas():
            return {"local": _stacked(dl), "global": _stacked(dg)}
    elif kind == MAMBA:
        states = []
        for i in range(gp["in_proj"].shape[0]):
            x, st = _mamba_layer(take(gp, i), carry(x), cfg, cache,
                                 (i,), "decode", write=write)
            states.append(st)

        def deltas():
            return _stacked(states)
    elif kind == "hybrid_super":
        count, inner = gp["mamba"]["in_proj"].shape[:2]
        states, kvs = [], []
        for i in range(count):
            stack = layer_params(gp["mamba"], i)
            states.append([])
            for j in range(inner):
                x, st = _mamba_layer(take(stack, j), carry(x), cfg,
                                     cache["mamba"], (i, j), "decode",
                                     write=write)
                states[-1].append(st)
            x, kv, _ = dense_layer_apply(fetch(gp["shared"]), x, cfg,
                                         window=cfg.sliding_window,
                                         mode="decode",
                                         kv=_layer_cache(cache, i),
                                         cache_pos=pos, positions=positions,
                                         ring=windowed, write=write)
            kvs.append(kv)

        def deltas():
            return {"mamba": _stacked(states), **_stacked(kvs)}
    else:
        ring = windowed and kind == SWA
        kvs = []
        for i in range(gp["attn"]["wq"].shape[0]):
            x, kv, _ = dense_layer_apply(take(gp, i), carry(x), cfg,
                                         window=_window(cfg, kind),
                                         mode="decode",
                                         kv=_layer_cache(cache, i),
                                         cache_pos=pos, positions=positions,
                                         ring=ring, write=write)
            kvs.append(kv)

        def deltas():
            return _stacked(kvs)
    if not return_deltas:
        return x, cache
    return x, deltas_like(deltas(), cache)


# ---------------------------------------------------------------------------
# Embedding (the head and its loss: models/head.py)
# ---------------------------------------------------------------------------
def embed_tokens(params, tokens, cfg, patch_embeds=None):
    """Token embeddings (B, T, d); ``patch_embeds`` (B, P, d), the stubbed
    vision frontend's output, are projected by ``vis_proj`` and prepended,
    so the sequence is P + T positions long."""
    x = embed_lookup(params["embed"], tokens).to(torch_dtype(cfg))
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if patch_embeds is not None:
        pe = patch_embeds.to(x.dtype)
        if "vis_proj" in params:
            pe = pe @ params["vis_proj"]
        x = torch.cat([pe, x], dim=1)
    return x


def _roll_left(tokens):
    """``torch.roll(tokens, -1, dims=1)``; a DTensor's on each rank's own
    rows, its sequence made whole first (not every DTensor release has a
    rule for ``roll``)."""
    if not is_dtensor(tokens):
        return torch.roll(tokens, -1, dims=1)
    from torch.distributed.tensor import Replicate
    want = tuple(Replicate() if p.is_shard(1) or p.is_partial() else p
                 for p in tokens.placements)
    if want != tuple(tokens.placements):
        tokens = tokens.redistribute(tokens.device_mesh, want)
    return L.from_local(torch.roll(tokens.to_local(), -1, dims=1),
                        tokens.device_mesh, want)


def next_token_targets(tokens):
    """(labels, mask) of next-token prediction: tokens rolled left by one,
    the last position masked out."""
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    return _roll_left(tokens), mask


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------
def top_gathered(params, gather, mark=None, stacks=("groups",)):
    """``params`` with the leaves outside the layer stacks ``stacks``
    (embedding, norms, head, vision projection) gathered once (``gather``;
    None: as they are); the stacks as they are, for each layer's own
    gather.  ``mark``: entered around it, "gather"."""
    if gather is None:
        return params
    with L.marked(mark, "gather"):
        top = gather({k: v for k, v in params.items() if k not in stacks})
    return {**top, **{k: params[k] for k in stacks}}


def forward_full(params, x, cfg, *, positions, remat=False, bspec=None,
                 gather=None, mark=None):
    """Train-mode trunk: groups -> final norm.  Returns (h, the MoE aux
    loss summed over layers, a float32 scalar).  ``gather``: each layer's
    (``run_group_train``); ``mark``: entered around each group
    (``layers.marked``), and its backward (``layers.backward_marked``)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (gp, (kind, _)) in enumerate(zip(params["groups"],
                                            cfg.layer_groups)):
        inward, outward = L.backward_marked(mark, f"backward_group{i}")
        with L.marked(mark, f"group{i}"):
            x, aux = run_group_train(gp, inward(x), cfg, kind,
                                     positions=positions, remat=remat,
                                     bspec=bspec, gather=gather)
        x = outward(x)
        aux_total = aux_total + aux
    return L.rmsnorm(x, params["final_norm"], cfg.norm_eps), aux_total


def train_loss(params, batch, cfg, *, remat=True, bspec=None, gather=None,
               mark=None):
    """batch: {'tokens': (B, T) int, optional 'patch_embeds': (B, P, d)}.
    Next-token cross-entropy over the text positions (the last one
    masked), plus ``router_aux_loss_coef`` x the MoE aux loss.  Returns
    (loss, {'ce', 'aux'}).  ``bspec``: the mesh axes the activations'
    batch is constrained to (``layers.constrain_batch``); ``gather``: the
    sharded steps' per-layer gather, applied once to the leaves outside
    the layer groups (a tied embedding, the head too, gathered once and
    its gradient reduced once) and to each layer in its body; ``mark`` as
    ``forward_full``'s (and around the first gather, "gather")."""
    tokens = batch["tokens"]
    params = top_gathered(params, gather, mark)
    x = L.constrain_batch(embed_tokens(params, tokens, cfg,
                                       patch_embeds=batch.get("patch_embeds")),
                          bspec)
    T = x.shape[1]
    positions = torch.arange(T, device=x.device)
    h, aux = forward_full(params, x, cfg, positions=positions, remat=remat,
                          bspec=bspec, gather=gather, mark=mark)
    h_text = L.constrain_batch(h[:, T - tokens.shape[1]:], bspec)
    ce = chunked_ce_loss(params, h_text, *next_token_targets(tokens), cfg)
    loss = ce + cfg.router_aux_loss_coef * aux
    return loss, {"ce": ce, "aux": aux}


def prefill(params, batch, cfg, capacity: int, bspec=None, seq_axis=None,
            cache=None, gather=None, mark=None):
    """Returns (last_logits (B,V) f32, cache) with cache capacity ``capacity``.
    batch: {'tokens': (B, T) int, optional 'patch_embeds': (B, P, d)}; the
    cache then holds P + T positions.  ``cache``: a zero cache to fill in
    place (under a mesh, DTensors laid out by the steps' cache specs);
    None allocates a plain one.  ``bspec`` and ``seq_axis`` as the
    reference's; ``gather`` and ``mark`` as ``train_loss``'s."""
    params = top_gathered(params, gather, mark)
    x = L.constrain_batch(embed_tokens(params, batch["tokens"], cfg,
                                       patch_embeds=batch.get("patch_embeds")),
                          bspec)
    B, T = x.shape[0], x.shape[1]
    positions = torch.arange(T, device=x.device)
    if cache is None:
        cache = init_cache(cfg, B, capacity, device=x.device)
    for i, (gp, c, (kind, _)) in enumerate(zip(params["groups"], cache,
                                               cfg.layer_groups)):
        with L.marked(mark, f"group{i}"):
            x, _ = run_group_prefill(gp, x, cfg, kind, c,
                                     positions=positions, seq_axis=seq_axis,
                                     bspec=bspec, gather=gather)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return logits_last(params, x[:, -1], cfg), cache


def decode_step(params, cache, tokens, pos, cfg, windowed: bool = False,
                bspec=None, return_deltas: bool = False, gather=None,
                mark=None):
    """tokens: (B,) int new token ids; pos: 0-d int tensor slot index.

    Returns (logits (B,V) f32, cache).  The cache is updated in place and
    the same list is returned; with ``return_deltas`` it is left
    unwritten and the second result is each group's deltas
    (``run_group_decode``).  ``gather`` and ``mark`` as ``train_loss``'s."""
    params = top_gathered(params, gather, mark)
    x = L.constrain_batch(embed_tokens(params, tokens[:, None], cfg), bspec)
    out = []
    for i, (gp, c, (kind, _)) in enumerate(zip(params["groups"], cache,
                                               cfg.layer_groups)):
        with L.marked(mark, f"group{i}"):
            x, nc = run_group_decode(gp, x, cfg, kind, c, pos=pos,
                                     windowed=windowed,
                                     return_deltas=return_deltas,
                                     bspec=bspec, gather=gather)
        out.append(nc)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return logits_last(params, x[:, 0], cfg), (out if return_deltas
                                                else cache)
