"""Sharded step functions (train / prefill / decode) used by the dry-run,
the counterpart of ``repro.launch.steps``.

Every builder returns ``(fn, arg_specs, in_shardings, out_shardings)``:
``arg_specs`` are meta tensors (shapes and dtypes, no storage: the
reference's ShapeDtypeStructs) and the shardings are trees of DTensor
placements (the reference's NamedShardings), from the reference's spec
rules (``distributed.sharding``).  ``fn`` is one rank's program, the
same on every rank: it takes its arguments as DTensors laid out by
``in_shardings`` (``sharding.distribute_tree``) and returns its results
laid out by ``out_shardings``.  Its body runs under DTensor's
``implicit_replication``, so a plain tensor a model makes (positions,
masks, a zero accumulator) counts as replicated on every rank.  The
reference jits each function; here each runs eagerly, op by op.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.distributed import cache_update, fsdp, is_dtensor
from repro_torch.distributed import sharding as shd
from repro_torch.models import api
from repro_torch.models.layers import marked
from repro_torch.training import adamw
from repro_torch.training.loop import loss_and_grads


def default_microbatches(cfg: ModelConfig, shape: InputShape,
                         minfo: shd.MeshInfo) -> int:
    """Pick gradient-accumulation so each microbatch has ~<=2 seqs/device."""
    dp = minfo.batch_size
    per_dev = shape.global_batch / dp
    # scale down further for very large models (activation pressure); hybrid
    # archs carry both attention KV and d_in=2*d SSM streams per layer, so
    # they also get 1 seq/device
    target = 1 if (cfg.param_count() >= 30e9
                   or cfg.arch_type == "hybrid") else 2
    micro = max(1, int(per_dev / target))
    while shape.global_batch % (micro * dp) and micro > 1:
        micro -= 1
    return micro


def _replicated(minfo: shd.MeshInfo) -> tuple:
    return shd.to_placements((), minfo.mesh)


def layer_gather(minfo: shd.MeshInfo):
    """The per-layer FSDP gather the sharded steps hand the model
    (``gather=``): a layer's parameters (or the leaves outside the layer
    groups) made whole on the batch axes ('pod', 'data'), the 'model'
    axis's TP kept (``fsdp.gathered``).  A partitioner all-gathers an
    FSDP-sharded weight where it is used, so each rank computes on its
    own batch rows; DTensor, left to itself, may instead keep the weight
    sharded and gather the activations (a weight-stationary product),
    which computes on the whole batch.  The model applies it inside each
    layer body, so a rank holds one gathered layer at a time, and its
    backward takes each layer's gradient onto the params' shards."""
    return functools.partial(fsdp.gathered, batch_axes=minfo.batch_axes)


def _device(t) -> torch.device:
    return t.to_local().device if is_dtensor(t) else t.device


def microbatches(batch: dict, nm: int, minfo: shd.MeshInfo, bspec):
    """``nm`` microbatches of ``batch``, the reference's: microbatch i is
    the global rows ``[i*B/nm, (i+1)*B/nm)`` (its reshape to (nm, B/nm,
    ...)), laid out over ``bspec``.  A sharded batch is gathered first
    (token ids: a few bytes a position) and each microbatch taken from
    it as the step reaches it, each rank keeping its own slice."""
    for t in batch.values():
        if t.shape[0] % nm:
            raise ValueError(f"a batch of {t.shape[0]} does not split into "
                             f"{nm} microbatches")
    whole = {k: t.full_tensor() if is_dtensor(t) else t
             for k, t in batch.items()}
    for i in range(nm):
        mb = {}
        for k, t in whole.items():
            part = t.chunk(nm)[i]
            if is_dtensor(batch[k]):
                part = shd.distribute(part, shd.to_placements(
                    (bspec,) + (None,) * (t.ndim - 1), minfo.mesh), minfo)
            mb[k] = part
        yield mb


# ---------------------------------------------------------------------------
# Train step (grad-accumulation microbatching + AdamW)
# ---------------------------------------------------------------------------
def make_train_step(cfg: ModelConfig, minfo: shd.MeshInfo, shape: InputShape,
                    *, num_microbatches: Optional[int] = None,
                    lr: float = 3e-4, remat: bool = True,
                    param_mode: str = "train", mark=None):
    """``fn(params, opt_state, batch) -> (params, opt_state, {'loss',
    'grad_norm'})``: the gradients of ``nm`` microbatches summed in
    float32, each divided by ``nm``, then AdamW.  The model gathers each
    layer's FSDP shards as it reaches the layer (``layer_gather``), so
    the gradients come out of the backward laid out as the params and
    are summed into one sharded float32 tree, in place.  The step
    donates ``params`` and ``opt_state``, as the reference's jit does:
    ``adamw.update_`` writes the new values into them, a stacked leaf one
    layer at a time, and they are returned.  ``mark``: entered around
    each phase of the step (the forward, the backward, the accumulation,
    the update; each layer group and its backward: ``layers.marked``,
    ``layers.backward_marked``; in the forward, the gathering of the
    leaves outside the layer groups), as the dry-run takes them apart;
    each layer's gathering is counted in its group's phase in the forward
    and in its group's backward phase, where the remat gathers it
    again."""
    if num_microbatches is None:
        num_microbatches = default_microbatches(cfg, shape, minfo)
    nm = num_microbatches

    abstract_params = api.param_specs(cfg)
    p_specs = shd.param_specs(abstract_params, cfg, minfo, param_mode)
    batch_abs = api.batch_specs(cfg, shape)
    b_specs = shd.batch_input_specs(batch_abs, minfo)
    bspec = shd.batch_spec_axes(minfo, shape.global_batch // nm)
    p_sh = shd.to_shardings(p_specs, minfo)
    rep = _replicated(minfo)
    gather = layer_gather(minfo)
    stacked = api.stacked(abstract_params)

    def add(p, g, acc=None):
        """The running sum ``acc`` plus ``g / nm`` in float32, in place;
        ``g`` must be laid out as its parameter ``p``."""
        if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
            raise ValueError(f"a gradient laid out as {g.placements}, its "
                             f"parameter as {p.placements}")
        g = g.float() / nm
        return g if acc is None else acc.add_(g)

    def train_step(params, opt_state, batch):
        with implicit_replication(), torch.enable_grad():
            grads, loss = None, 0.0
            for mb in microbatches(batch, nm, minfo, bspec):
                mb_loss, _, g = loss_and_grads(params, mb, cfg, remat=remat,
                                               bspec=bspec, gather=gather,
                                               mark=mark)
                with marked(mark, "accumulate"):
                    grads = adamw.tree_map(add, params, g, *(
                        () if grads is None else (grads,)))
                    loss = loss + mb_loss / nm
                del g       # not held through the next microbatch
            with marked(mark, "update"):
                new_params, new_opt, gnorm = adamw.update_(
                    grads, opt_state, params, stacked=stacked, lr=lr)
            metrics = {"loss": shd.distribute(loss, rep, minfo),
                       "grad_norm": shd.distribute(gnorm, rep, minfo)}
        return new_params, new_opt, metrics

    opt_abs = adamw.init(abstract_params)
    opt_sh = adamw.AdamWState(step=rep, mu=p_sh, nu=p_sh)
    in_shardings = (p_sh, opt_sh, shd.to_shardings(b_specs, minfo))
    out_shardings = (p_sh, opt_sh, {"loss": rep, "grad_norm": rep})
    arg_specs = (abstract_params, opt_abs, batch_abs)
    return train_step, arg_specs, in_shardings, out_shardings


# ---------------------------------------------------------------------------
# Prefill step
# ---------------------------------------------------------------------------
def prefill_seq_axis(cfg: ModelConfig, minfo: shd.MeshInfo,
                     shape: InputShape) -> Optional[str]:
    """Sequence-parallel attention: when neither KV-head TP nor q-TP
    applies, shard the prefill's q blocks over 'model' instead of
    replicating the attention compute."""
    if (not cfg.is_encoder_decoder and cfg.num_heads
            and not shd.attn_head_tp(cfg, minfo.model)
            and cfg.num_heads % minfo.model != 0
            and (shape.seq_len // 256) % minfo.model == 0):
        return "model"
    return None


def make_prefill_step(cfg: ModelConfig, minfo: shd.MeshInfo,
                      shape: InputShape, *, capacity: Optional[int] = None,
                      param_mode: str = "infer", mark=None):
    """``fn(params, batch) -> (last logits, cache)``: the cache made as
    zeros laid out by the reference's cache specs, each rank allocating
    its own shard, and filled in place; the params' FSDP shards (where
    ``param_mode`` gives them) gathered layer by layer
    (``layer_gather``).  ``mark`` as the train step's."""
    capacity = capacity or shape.seq_len
    B = shape.global_batch
    abstract_params = api.param_specs(cfg)
    p_specs = shd.param_specs(abstract_params, cfg, minfo, param_mode)
    batch_abs = api.batch_specs(cfg, shape)
    b_specs = shd.batch_input_specs(batch_abs, minfo)
    cache_abs = api.init_cache(cfg, B, capacity, device="meta")
    c_sh = shd.to_shardings(
        shd.cache_specs_tree(cache_abs, cfg, minfo, B, capacity), minfo)
    bspec = shd.batch_spec_axes(minfo, B)
    logits_sh = shd.to_placements((bspec, None), minfo.mesh)
    seq_axis = prefill_seq_axis(cfg, minfo, shape)
    gather = layer_gather(minfo)

    def prefill_step(params, batch):
        with implicit_replication():
            cache = shd.zeros(cache_abs, c_sh, minfo,
                              _device(batch["tokens"]))
            logits, cache = api.prefill(params, batch, cfg, capacity,
                                        bspec=bspec, seq_axis=seq_axis,
                                        cache=cache, gather=gather,
                                        mark=mark)
            return shd.distribute(logits, logits_sh, minfo), cache

    in_shardings = (shd.to_shardings(p_specs, minfo),
                    shd.to_shardings(b_specs, minfo))
    return (prefill_step, (abstract_params, batch_abs), in_shardings,
            (logits_sh, c_sh))


# ---------------------------------------------------------------------------
# Decode step (serve_step for decode shapes)
# ---------------------------------------------------------------------------
def make_decode_step(cfg: ModelConfig, minfo: shd.MeshInfo,
                     shape: InputShape, *, windowed_cache: bool = False,
                     param_mode: str = "infer", sharded_append: bool = True,
                     mark=None):
    """``fn(params, cache, tokens, pos) -> (logits, cache)``, the cache
    written in place.  windowed_cache / param_mode='tp' are the
    reference's beyond-baseline variants: ring-buffer caches for
    sliding-window layers, and TP-only inference params.
    ``sharded_append``: the decode step leaves the cache unwritten and
    returns the new tokens' deltas, which ``cache_update`` appends into
    each rank's own shard (zero collectives).  The params' FSDP shards
    are gathered layer by layer, as the prefill's.  ``mark`` as the train
    step's (each layer group, the append)."""
    B, S = shape.global_batch, shape.seq_len
    abstract_params = api.param_specs(cfg)
    p_specs = shd.param_specs(abstract_params, cfg, minfo, param_mode)
    cache_abs = api.init_cache(cfg, B, S, windowed=windowed_cache,
                               device="meta")
    c_sh = shd.to_shardings(shd.cache_specs_tree(cache_abs, cfg, minfo, B, S),
                            minfo)
    tok_abs = torch.empty((B,), dtype=torch.int32, device="meta")
    pos_abs = torch.empty((), dtype=torch.int32, device="meta")
    bspec = shd.batch_spec_axes(minfo, B)
    tok_sh = shd.to_placements((bspec,), minfo.mesh)
    logits_sh = shd.to_placements((bspec, None), minfo.mesh)
    gather = layer_gather(minfo)

    def decode(params, cache, tokens, pos):
        with implicit_replication():
            if not sharded_append:
                logits, cache = api.decode_step(params, cache, tokens, pos,
                                                cfg, windowed=windowed_cache,
                                                bspec=bspec, gather=gather,
                                                mark=mark)
            else:
                logits, deltas = api.decode_step(params, cache, tokens, pos,
                                                 cfg, windowed=windowed_cache,
                                                 bspec=bspec,
                                                 return_deltas=True,
                                                 gather=gather, mark=mark)
                with marked(mark, "append"):
                    cache_update.apply_cache_deltas(cache, deltas, pos)
            return shd.distribute(logits, logits_sh, minfo), cache

    in_shardings = (shd.to_shardings(p_specs, minfo), c_sh, tok_sh,
                    _replicated(minfo))
    arg_specs = (abstract_params, cache_abs, tok_abs, pos_abs)
    return decode, arg_specs, in_shardings, (logits_sh, c_sh)


def make_step(cfg: ModelConfig, minfo: shd.MeshInfo, shape: InputShape,
              **kw):
    if shape.kind == "train":
        return make_train_step(cfg, minfo, shape, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, minfo, shape, **kw)
    return make_decode_step(cfg, minfo, shape, **kw)
