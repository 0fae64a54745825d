"""Model API — counterpart of ``repro.models.api`` for the decoder-only models
(dense, SSM and hybrid; MoE layers raise in ``transformer``).

  init_params(cfg, seed=0, device=None)             -> params dict
  params_from_jax(tree, device=None)                -> params dict
  prefill(params, batch, cfg, capacity)             -> (last_logits, cache)
  decode_step(params, cache, tokens, pos, cfg)      -> (logits, cache)
  init_cache(cfg, batch, capacity, device=None)     -> cache list
  make_batch(cfg, shape, seed=0, device=None)       -> {'tokens': ...}
  generate(params, batch, cfg, steps)               -> (B, steps + 1) tokens

``device=None`` means the GPU; pass ``device="cpu"`` for the plain path on
the CPU.  Parameters keep the reference's layout (one stacked leading layer
axis per group), so a reference parameter tree converts leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer


def _decoder_only(cfg: ModelConfig) -> None:
    """Encoder-decoder and frontend (audio, vision) models are not ported."""
    if cfg.is_encoder_decoder or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: only decoder-only text models are ported so far")


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on the target device."""
    _decoder_only(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return transformer.init_params(gen, cfg, dev)


def params_from_jax(tree, device=None):
    """The reference's parameter pytree (leaves as numpy arrays, or anything
    ``np.asarray`` accepts) as this package's parameters, leaf by leaf.
    bfloat16 leaves go through float32, which is exact."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, dev) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dev)


def prefill(params, batch, cfg: ModelConfig, capacity: int):
    _decoder_only(cfg)
    return transformer.prefill(params, batch, cfg, capacity)


def decode_step(params, cache, tokens, pos, cfg: ModelConfig,
                windowed: bool = False):
    _decoder_only(cfg)
    return transformer.decode_step(params, cache, tokens, pos, cfg,
                                   windowed=windowed)


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               windowed: bool = False, device=None):
    _decoder_only(cfg)
    return transformer.init_cache(cfg, batch, capacity, windowed=windowed,
                                  device=resolve_device(device))


def make_batch(cfg: ModelConfig, shape: InputShape, seed: int = 0,
               device=None) -> dict:
    """Random prompt tokens (global_batch, seq_len) from a seeded generator."""
    _decoder_only(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size,
                           (shape.global_batch, shape.seq_len),
                           generator=gen, device=dev, dtype=torch.int32)
    return {"tokens": tokens}


def generate(params, batch, cfg: ModelConfig, steps: int) -> torch.Tensor:
    """One served request batch: prefill the prompts, then ``steps`` greedy
    decode steps.  Returns the (B, steps + 1) generated token ids.  The
    position is made and advanced on the device (no copy from the host),
    so no step waits on the host and the whole request can be captured in
    a CUDA graph."""
    tokens = batch["tokens"]
    T = tokens.shape[1]
    logits, cache = prefill(params, batch, cfg, capacity=T + steps)
    tok = logits.argmax(-1).to(torch.int32)
    out = [tok]
    pos = torch.full((), T, dtype=torch.int32, device=tokens.device)
    for _ in range(steps):
        logits, cache = decode_step(params, cache, tok, pos, cfg)
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
        pos = pos + 1
    return torch.stack(out, dim=1)
