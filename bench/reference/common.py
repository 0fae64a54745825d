"""What the references share: float32 RMSNorm, products (matrix products
and einsums) at float32 or in the control's float8, the tied head, and
the layer-by-layer weights."""

from __future__ import annotations

import torch

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Root-mean-square norm over the last axis, scaled by ``w``."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def fp8_round(x: torch.Tensor, dim) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (an axis or a tuple of axes; its absolute maximum mapped to 448), back
    in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(FP8).float() * scale


def matmul(a: torch.Tensor, b: torch.Tensor, prec=None) -> torch.Tensor:
    """``a @ b`` in float32, contracting a's last axis with b's next to
    last.  ``prec="fp8"``: each slice of a and of b along that axis
    rounded to float8 first (per-token and per-channel scales, the usual
    float8 serving recipe)."""
    if prec == "fp8":
        a, b = fp8_round(a, -1), fp8_round(b, -2)
    elif prec is not None:
        raise ValueError(f"unknown precision {prec!r}")
    return a @ b


def einsum(eq: str, *ops: torch.Tensor, prec=None) -> torch.Tensor:
    """``torch.einsum`` in float32.  ``prec="fp8"``: each operand rounded
    to float8 first, one scale per operand."""
    if prec == "fp8":
        ops = tuple(fp8_round(x, tuple(range(x.dim()))) for x in ops)
    elif prec is not None:
        raise ValueError(f"unknown precision {prec!r}")
    return torch.einsum(eq, *ops)


def layer(tree, i: int):
    """Layer ``i`` of a stack of layers, every leaf in float32."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i].float()


def head(h: torch.Tensor, embed: torch.Tensor, prec=None) -> torch.Tensor:
    """Logits of the tied head: h (..., d) against the embedding (V, d)."""
    return matmul(h, embed.float().t(), prec)
