"""Model API — counterpart of ``repro.models.api``: dispatches on
``cfg.is_encoder_decoder`` between the decoder-only models (dense, MoE,
SSM, hybrid and the vision stub: ``transformer``) and the encoder-decoder
(``encdec``).

  init_params(cfg, seed=0, device=None)             -> params dict
  params_from_jax(tree, device=None)                -> params dict
  train_loss(params, batch, cfg, remat=True)        -> (loss, {'ce', 'aux'})
  prefill(params, batch, cfg, capacity)             -> (last_logits, cache)
  decode_step(params, cache, tokens, pos, cfg)      -> (logits, cache)

Each also takes the reference's mesh arguments (``bspec``; ``seq_axis``
for prefill, ``return_deltas`` for decode) and works on DTensors laid out
on a ``DeviceMesh`` (``launch/steps.py``); ``gather`` is the sharded
steps' per-layer FSDP gather (``distributed.fsdp``), which the models
apply to each layer's parameters as they reach the layer and to the
leaves outside the layer groups once a call.
  init_cache(cfg, batch, capacity, device=None)     -> cache
  make_batch(cfg, shape, seed=0, device=None)       -> {'tokens': ..., ...}
  generate(params, batch, cfg, steps)               -> (B, steps + 1) tokens

``device=None`` means the GPU; pass ``device="cpu"`` for the plain path on
the CPU.  Parameters keep the reference's layout (one stacked leading layer
axis per group), so a reference parameter tree converts leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import InputShape, ModelConfig, torch_dtype
from repro_torch.models import encdec, transformer


def _model(cfg: ModelConfig):
    return encdec if cfg.is_encoder_decoder else transformer


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on the target device.  On the meta device there is no
    generator: the leaves get their shapes and dtypes and nothing is
    drawn (``param_specs``)."""
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    return _model(cfg).init_params(gen, cfg, dev)


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


def _given(**kw) -> dict:
    """The keyword arguments given a value: a call without the mesh's
    arguments reaches the model functions as it did before they had
    them."""
    return {k: v for k, v in kw.items() if v is not None and v is not False}


def _marks(cfg: ModelConfig, mark) -> dict:
    """``mark`` for the decoder-only models, which enter it around each
    layer group (``layers.marked``); the encoder-decoder marks its
    prefill and decode none (its train loss marks its two stacks)."""
    return {} if cfg.is_encoder_decoder else _given(mark=mark)


def train_loss(params, batch, cfg: ModelConfig, *, remat: bool = True,
               bspec=None, gather=None, mark=None):
    """Next-token loss of ``batch`` (the reference's ``train_loss``),
    differentiable by ``torch.autograd``; takes no kernel.  ``bspec``:
    the mesh axes the activations' batch is constrained to."""
    return _model(cfg).train_loss(params, batch, cfg, remat=remat,
                                  **_given(bspec=bspec, gather=gather,
                                           mark=mark))


def prefill(params, batch, cfg: ModelConfig, capacity: int, bspec=None,
            seq_axis=None, cache=None, gather=None, mark=None):
    """``cache``: a zero cache to fill in place (a mesh's DTensors); the
    encoder-decoder takes no ``seq_axis``, as the reference's."""
    if cfg.is_encoder_decoder:
        return encdec.prefill(params, batch, cfg, capacity,
                              **_given(bspec=bspec, cache=cache,
                                       gather=gather))
    return transformer.prefill(params, batch, cfg, capacity,
                               **_given(bspec=bspec, seq_axis=seq_axis,
                                        cache=cache, gather=gather,
                                        mark=mark))


def decode_step(params, cache, tokens, pos, cfg: ModelConfig,
                windowed: bool = False, bspec=None,
                return_deltas: bool = False, gather=None, mark=None):
    """``return_deltas``: the cache is left unwritten and the second
    result is the reference's deltas (``transformer.run_group_decode``)."""
    kw = _given(bspec=bspec, return_deltas=return_deltas, gather=gather)
    if cfg.is_encoder_decoder:
        return encdec.decode_step(params, cache, tokens, pos, cfg, **kw)
    return transformer.decode_step(params, cache, tokens, pos, cfg,
                                   windowed=windowed, **kw,
                                   **_marks(cfg, mark))


def stacked(params) -> dict:
    """A tree of bools like ``params``: True where a leaf has a leading
    layer axis (every leaf of a layer group or of the encoder-decoder's
    two stacks, but Zamba2's shared block, which is one block)."""
    def mark(tree, inside):
        if isinstance(tree, dict):
            return {k: mark(v, inside and k != "shared")
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [mark(v, inside) for v in tree]
        return inside
    return {k: mark(v, k in ("groups", "enc_layers", "dec_layers"))
            for k, v in params.items()}


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               windowed: bool = False, device=None):
    dev = resolve_device(device)
    if cfg.is_encoder_decoder:
        return encdec.init_cache(cfg, batch, capacity, device=dev)
    return transformer.init_cache(cfg, batch, capacity, windowed=windowed,
                                  device=dev)


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text-token length once stub frontend tokens are accounted for."""
    if cfg.frontend == "vision_stub":
        return max(seq_len - cfg.num_frontend_tokens, 1)
    return seq_len


def make_batch(cfg: ModelConfig, shape: InputShape, seed: int = 0,
               device=None) -> dict:
    """A prefill batch of ``shape.seq_len`` input positions, as the
    reference's ``make_batch``: prompt tokens (global_batch, text length),
    and the stubbed frontend's embeddings at 0.02 scale in the config's
    dtype: ``patch_embeds`` (global_batch, num_frontend_tokens, d), which
    take that many of the positions, or ``audio_embeds`` (global_batch,
    encoder_seq_len, d), the encoder's input.  Drawn from one generator
    seeded with ``seed``, tokens first."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    B = shape.global_batch
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (B, _text_len(cfg, shape.seq_len)),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    frontend = {"vision_stub": ("patch_embeds", cfg.num_frontend_tokens),
                "audio_stub": ("audio_embeds", cfg.encoder_seq_len)}
    if cfg.frontend in frontend:
        name, n = frontend[cfg.frontend]
        batch[name] = (torch.randn((B, n, cfg.d_model), generator=gen,
                                   device=dev) * 0.02).to(torch_dtype(cfg))
    return batch


def batch_shapes(cfg: ModelConfig, shape: InputShape) -> dict:
    """{name: (shape, dtype)} for each model input of this (arch,
    input-shape), as the reference's ``batch_shapes``."""
    B, S = shape.global_batch, shape.seq_len
    out = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = ((B, _text_len(cfg, S)), torch.int32)
        if cfg.frontend == "vision_stub":
            out["patch_embeds"] = ((B, cfg.num_frontend_tokens, cfg.d_model),
                                   torch_dtype(cfg))
        if cfg.frontend == "audio_stub":
            out["audio_embeds"] = ((B, cfg.encoder_seq_len, cfg.d_model),
                                   torch_dtype(cfg))
    else:  # decode: one token against a cache of S
        out["tokens"] = ((B,), torch.int32)
    return out


# Abstract inputs: meta tensors (shapes and dtypes, no storage), the
# counterpart of the reference's ShapeDtypeStructs.
def batch_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    return {name: torch.empty(shp, dtype=dt, device="meta")
            for name, (shp, dt) in batch_shapes(cfg, shape).items()}


def cache_specs(cfg: ModelConfig, shape: InputShape):
    """Abstract KV/state cache for decode shapes (capacity = seq_len)."""
    return init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")


def param_specs(cfg: ModelConfig) -> dict:
    return init_params(cfg, device="meta")


def prefill_len(batch) -> int:
    """Positions a prefill of ``batch`` writes to the decoder's cache: the
    prompt tokens plus any prepended patch embeddings (an encoder's frames
    are not among them)."""
    n = batch["tokens"].shape[1]
    if "patch_embeds" in batch:
        n += batch["patch_embeds"].shape[1]
    return n


def generate(params, batch, cfg: ModelConfig, steps: int) -> torch.Tensor:
    """One served request batch: prefill the prompts, then ``steps`` greedy
    decode steps.  Returns the (B, steps + 1) generated token ids.  The
    cache and the first decode position come from the prefilled length
    (``prefill_len``: for a vision model the patches count).  The
    position is made and advanced on the device (no copy from the host),
    so no step waits on the host and the whole request can be captured in
    a CUDA graph."""
    T = prefill_len(batch)
    logits, cache = prefill(params, batch, cfg, capacity=T + steps)
    tok = logits.argmax(-1).to(torch.int32)
    out = [tok]
    pos = torch.full((), T, dtype=torch.int32, device=tok.device)
    for _ in range(steps):
        logits, cache = decode_step(params, cache, tok, pos, cfg)
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
        pos = pos + 1
    return torch.stack(out, dim=1)
