"""A Llama-style decoder (the layout of SmolLM, hf:HuggingFaceTB/
SmolLM-360M, ``LlamaForCausalLM``), float32.

A token embedding; per layer RMSNorm, q, k, v projections with grouped
key/value heads, rotary embeddings on q and k (rotate-half layout, the
frequencies theta^(-2i/hd)), causal softmax attention at 1/sqrt(hd), the
output projection and the residual; RMSNorm, the SwiGLU MLP down(SiLU(gate
x) * up x) and the residual; a final RMSNorm and the tied head.

Weights as the served model lays them out, one stack per leaf:
``attn``: ``wq`` (L, d, H, hd), ``wk`` and ``wv`` (L, d, KV, hd), ``wo``
(L, H, hd, d), ``norm`` (L, d); ``mlp``: ``wg`` (gate) and ``wi`` (up)
(L, d, ff), ``wo`` (L, ff, d), ``norm`` (L, d).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench import counts
from bench.reference.common import head, layer, matmul, rmsnorm

QUERY_BLOCK = 512       # query rows whose scores exist at once


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (b, T, h, hd) at positions 0..T-1."""
    T, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, device=x.device,
                                  dtype=torch.float32) / hd)
    ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], -1)[None, :, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], -1) * sin


def attention(q, k, v, prec=None) -> torch.Tensor:
    """Causal attention, q (b, T, H, hd), k and v (b, T, KV, hd), in
    blocks of query rows; both products at ``prec``."""
    b, T, H, hd = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)      # (b, H, T, hd)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    q = q.transpose(1, 2) * hd ** -0.5
    out = []
    for t0 in range(0, T, QUERY_BLOCK):
        t1 = min(t0 + QUERY_BLOCK, T)
        s = matmul(q[:, :, t0:t1], k[:, :, :t1].transpose(-1, -2), prec)
        mask = (torch.arange(t1, device=q.device)[None, :]
                > torch.arange(t0, t1, device=q.device)[:, None])
        s = s.masked_fill(mask, float("-inf"))
        out.append(matmul(torch.softmax(s, dim=-1), v[:, :, :t1], prec))
    return torch.cat(out, dim=2).transpose(1, 2)             # (b, T, H, hd)


def block(p: dict, x: torch.Tensor, c: dict, prec=None) -> torch.Tensor:
    b, T, d = x.shape
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    a = p["attn"]
    H, hd = a["wq"].shape[1], a["wq"].shape[2]
    KV = a["wk"].shape[1]
    h = rmsnorm(x, a["norm"], eps)
    q = matmul(h, a["wq"].reshape(d, H * hd), prec).reshape(b, T, H, hd)
    k = matmul(h, a["wk"].reshape(d, KV * hd), prec).reshape(b, T, KV, hd)
    v = matmul(h, a["wv"].reshape(d, KV * hd), prec).reshape(b, T, KV, hd)
    o = attention(rotary(q, theta), rotary(k, theta), v, prec)
    x = x + matmul(o.reshape(b, T, H * hd), a["wo"].reshape(H * hd, d), prec)
    m = p["mlp"]
    h = rmsnorm(x, m["norm"], eps)
    gate = F.silu(matmul(h, m["wg"], prec)) * matmul(h, m["wi"], prec)
    return x + matmul(gate, m["wo"], prec)


def forward(conf: dict, params: dict, tokens: torch.Tensor,
            positions: torch.Tensor, prec=None) -> torch.Tensor:
    """Float32 logits (b, len(positions), V) of ``tokens`` (b, T) at
    ``positions``, layer by layer."""
    c = conf["config"]
    x = params["embed"][tokens].float()
    stack = params["groups"][0]
    for i in range(c["num_hidden_layers"]):
        x = block(layer(stack, i), x, c, prec)
    h = rmsnorm(x[:, positions], params["final_norm"].float(),
                c["rms_norm_eps"])
    return head(h, params["embed"], prec)


# ---------------------------------------------------------------------------
# The work of a request, from the published shapes (``mfu``, the rooflines)
# ---------------------------------------------------------------------------
def dims(c: dict) -> tuple:
    """(heads, kv heads, head dim) of an attention layer."""
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    return H, KV, c["hidden_size"] // H


def request_flops(conf: dict, T: int, steps: int) -> int:
    """Model FLOPs of one request: the products' weights over T + steps
    tokens, the tied head over the steps + 1 positions that yield a
    token, causal attention over the prompt (``counts.flash_prefill``) and
    each decode step's reads of the cache (``counts.decode_attention``)."""
    c = conf["config"]
    d = c["hidden_size"]
    H, KV, hd = dims(c)
    weights = d * (H + 2 * KV) * hd + H * hd * d + 3 * d * c[
        "intermediate_size"]
    per_layer = (2 * weights * (T + steps)
                 + counts.flash_prefill(1, T, H, KV, hd)[0]
                 + sum(counts.decode_attention(1, H, KV, hd, T + i)[0]
                       for i in range(steps)))
    return (per_layer * c["num_hidden_layers"]
            + 2 * d * counts.vocab(conf) * (steps + 1))
