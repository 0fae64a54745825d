"""Mamba2 (arXiv:2405.21060, "Transformers are SSMs"), float32.

The published language model: a token embedding, ``n_layer`` residual
Mamba2 blocks each behind an RMSNorm, a final RMSNorm and the tied head.
A block (the paper's Figure 6, one group of B and C): one input
projection to [z, x, B, C, dt]; a depthwise causal convolution of width
``d_conv`` with bias over [x, B, C], then SiLU; dt = softplus(dt +
dt_bias); A = -exp(A_log); the SSD of §6 (its Listing 1,
``ssd_minimal_discrete``) over heads of ``headdim`` channels with the
skip D x; the gated RMSNorm norm(y * SiLU(z)) over all d_inner channels;
the output projection.

Weights as the served model lays them out, one stack per leaf:
``in_proj`` (L, d, 2 d_in + 2 N + H) with columns z, xBC, dt;
``conv_w`` (L, d_conv, d_in + 2 N) whose last row multiplies the current
position; ``conv_b``; ``A_log``, ``D``, ``dt_bias`` (L, H); ``norm``
(L, d); ``gate_norm`` (L, d_in); ``out_proj`` (L, d_in, d).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench import counts
from bench.reference.common import einsum, head, layer, matmul, rmsnorm

BLOCK = 64      # the SSD's chunk here; any chunk gives the same sums


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): sum of x over (s, t] below the diagonal,
    -inf above it (Listing 1)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, float("-inf"))


def ssd(X, A, B, C, block: int = BLOCK, prec=None):
    """Listing 1 of the paper from a zero state.  X (b, T, h, p) = x dt,
    A (b, T, h) = A dt, B and C (b, T, n) shared by the heads; T a
    multiple of ``block``; every product at ``prec``.  Returns Y (b, T, h,
    p)."""
    b, T, h, p = X.shape
    c = T // block
    X = X.reshape(b, c, block, h, p)
    B = B.reshape(b, c, block, -1)
    C = C.reshape(b, c, block, -1)
    A = A.reshape(b, c, block, h).permute(0, 3, 1, 2)        # (b, h, c, l)
    A_cum = torch.cumsum(A, dim=-1)
    # 1. within each chunk
    L = torch.exp(segsum(A))                                 # (b, h, c, l, s)
    CB = einsum("bcln,bcsn->bcls", C, B, prec=prec)
    Y_diag = einsum("bcls,bhcls,bcshp->bclhp", CB, L, X, prec=prec)
    # 2. each chunk's state
    decay = torch.exp(A_cum[..., -1:] - A_cum)               # (b, h, c, l)
    states = einsum("bcln,bhcl,bclhp->bchpn", B, decay, X, prec=prec)
    # 3. the states passed from chunk to chunk
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))
    states = einsum("bhzc,bchpn->bzhpn", chunk_decay, states,
                    prec=prec)[:, :-1]
    # 4. each state's output
    Y_off = einsum("bcln,bchpn,bhcl->bclhp", C, states, torch.exp(A_cum),
                   prec=prec)
    return (Y_diag + Y_off).reshape(b, T, h, p)


def block(p: dict, x: torch.Tensor, c: dict, prec=None) -> torch.Tensor:
    """One residual Mamba2 block on x (b, T, d), float32."""
    b, T, d = x.shape
    d_in = c["expand"] * d
    N, P, W = c["d_state"], c["headdim"], c["d_conv"]
    H = d_in // P
    eps = c["norm_epsilon"]
    proj = matmul(rmsnorm(x, p["norm"], eps), p["in_proj"], prec)
    z, xBC, dt = proj.split([d_in, d_in + 2 * N, H], dim=-1)
    conv = F.conv1d(xBC.transpose(1, 2), p["conv_w"].t()[:, None, :],
                    p["conv_b"], padding=W - 1, groups=xBC.shape[-1])
    xBC = F.silu(conv[..., :T].transpose(1, 2))
    xs, B, C = xBC.split([d_in, N, N], dim=-1)
    xs = xs.reshape(b, T, H, P)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    pad = (-T) % BLOCK            # zeros after the end change no earlier
    y = ssd(F.pad(xs * dt[..., None], (0, 0, 0, 0, 0, pad)),
            F.pad(A * dt, (0, 0, 0, pad)), F.pad(B, (0, 0, 0, pad)),
            F.pad(C, (0, 0, 0, pad)), prec=prec)[:, :T]
    y = (y + xs * p["D"][:, None]).reshape(b, T, d_in)
    y = rmsnorm(y * F.silu(z), p["gate_norm"], eps)
    return x + matmul(y, p["out_proj"], prec)


def forward(conf: dict, params: dict, tokens: torch.Tensor,
            positions: torch.Tensor, prec=None) -> torch.Tensor:
    """Float32 logits (b, len(positions), V) of ``tokens`` (b, T) at
    ``positions``, layer by layer."""
    c = conf["config"]
    x = params["embed"][tokens].float()
    stack = params["groups"][0]
    for i in range(c["n_layer"]):
        x = block(layer(stack, i), x, c, prec)
    h = rmsnorm(x[:, positions], params["final_norm"].float(),
                c["norm_epsilon"])
    return head(h, params["embed"], prec)


# ---------------------------------------------------------------------------
# The work of a request, from the published shapes (``mfu``, the rooflines)
# ---------------------------------------------------------------------------
def dims(c: dict) -> tuple:
    """(d_inner, heads, head dim, state) of a Mamba2 layer."""
    d_in = c["expand"] * c["d_model"]
    return d_in, d_in // c["headdim"], c["headdim"], c["d_state"]


def scan_chunk(c: dict, T: int) -> int:
    """The chunk a T-token prefill scans at: ``chunk_size`` cut to divide T
    into whole chunks (T // max(T // chunk_size, 1))."""
    return T // max(T // c["chunk_size"], 1)


def request_flops(conf: dict, T: int, steps: int) -> int:
    """Model FLOPs of one request: the products' weights over T + steps
    tokens (projections and the convolution), the tied head over the
    steps + 1 positions that yield a token, the SSD scan of the prompt
    (``counts.ssd_scan``) and each recurrent step's 4 H P N a layer."""
    c = conf["config"]
    d = c["d_model"]
    d_in, H, P, N = dims(c)
    proj = d * (2 * d_in + 2 * N + H) + d_in * d
    conv = c["d_conv"] * (d_in + 2 * N)
    per_layer = (2 * (proj + conv) * (T + steps)
                 + counts.ssd_scan(1, T, H, P, N, scan_chunk(c, T))[0]
                 + steps * 4 * H * P * N)
    return (per_layer * c["n_layer"]
            + 2 * d * counts.vocab(conf) * (steps + 1))
