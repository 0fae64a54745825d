"""Single-device training loop, the counterpart of
``repro.training.loop``: the model's next-token loss, its gradients by
``torch.autograd`` and an AdamW update per step, on the card unless the
caller passes ``device="cpu"``."""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models.layers import marked
from repro_torch.training import adamw, checkpoint
from repro_torch.training.data import DataConfig, TokenStream


def loss_and_grads(params, batch: dict, cfg: ModelConfig, *,
                   remat: bool = True, bspec=None, gather=None, mark=None):
    """``jax.value_and_grad`` of ``api.train_loss`` with its metrics:
    returns (loss, {'ce', 'aux'}, grads), the gradients in the parameters'
    tree (zero for a leaf the loss does not reach, such as a cross-
    attention block's unused ``norm``).  The autograd leaves are
    ``params`` as given: on a mesh, their FSDP shards, which ``gather``
    (``train_loss``'s per-layer gather) makes whole layer by layer, its
    backward taking each gradient back onto the shard, so the gradients
    come out laid out as the params.  ``bspec``: ``train_loss``'s batch
    constraint (a mesh's DTensors); ``mark``: entered around the forward,
    the backward and each layer group (``layers.marked``)."""
    p = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = adamw.tree_leaves(p)
    with marked(mark, "forward"):
        loss, metrics = api.train_loss(p, batch, cfg, remat=remat,
                                       bspec=bspec, gather=gather, mark=mark)
    with marked(mark, "backward"):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    by_leaf = {id(t): g for t, g in zip(leaves, grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            adamw.tree_map(lambda t: by_leaf[id(t)], p))


def train_step(params, opt: adamw.AdamWState, tokens: torch.Tensor,
               cfg: ModelConfig, *, lr: float, remat: bool):
    """One step, the reference's jitted ``step_fn``: the loss of
    ``api.train_loss`` on ``{'tokens': tokens}`` and its gradients
    (``loss_and_grads``), then ``adamw.update``.  Returns (params, opt,
    loss, gnorm), the last two 0-d tensors on the device."""
    loss, _, grads = loss_and_grads(params, {"tokens": tokens}, cfg,
                                    remat=remat)
    params, opt, gnorm = adamw.update(grads, opt, params, lr=lr)
    return params, opt, loss, gnorm


def train(cfg: ModelConfig, *, steps: int = 100, batch_size: int = 8,
          seq_len: int = 256, lr: float = 3e-4, seed: int = 0,
          log_every: int = 10, ckpt_path: Optional[str] = None,
          ckpt_every: int = 0, data_path: Optional[str] = None,
          remat: bool = False, device=None) -> dict:
    """Single-device training; returns the loss trace.  The batches equal
    the reference's for the same seed (``TokenStream`` is numpy only); the
    initial weights do not (``api.init_params`` draws from a
    ``torch.Generator``).  ``step_s``: each step's seconds on the host
    clock, ended by reading its loss (which waits for the device)."""
    dev = resolve_device(device)
    params = api.init_params(cfg, seed=seed, device=dev)
    opt = adamw.init(params)
    n_params = sum(x.numel() for x in adamw.tree_leaves(params))

    stream = iter(TokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, batch_size=batch_size,
        seed=seed, path=data_path)))

    losses, times = [], []
    t_start = time.perf_counter()
    for i in range(steps):
        tokens = torch.from_numpy(next(stream)).to(dev)
        t0 = time.perf_counter()
        params, opt, loss, gnorm = train_step(params, opt, tokens, cfg,
                                              lr=lr, remat=remat)
        loss = float(loss)
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        if log_every and (i % log_every == 0 or i == steps - 1):
            tok_s = batch_size * seq_len / np.mean(times[-log_every:])
            print(f"step {i:>5d}  loss {loss:7.4f}  gnorm {float(gnorm):6.2f} "
                  f" tok/s {tok_s:9.0f}")
        if ckpt_path and ckpt_every and (i + 1) % ckpt_every == 0:
            checkpoint.save(ckpt_path, i + 1, params, opt)
    wall = time.perf_counter() - t_start
    if ckpt_path:
        checkpoint.save(ckpt_path, steps, params, opt)
    return {"losses": losses, "wall_s": wall, "n_params": n_params,
            "final_loss": losses[-1], "params": params, "step_s": times}
