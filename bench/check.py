"""How ``correct`` is decided: the tokens the timed replays produced, held
against the plain float32 reference.

Once the window has closed, a sample drawn from the seed of every request
the window served (each step's own prompts, its tokens taken as the step
returned them) goes to the reference: one pass
over each prompt with its served tokens, and at every position that
yielded a served token the gap by which that token's logit lies below the
reference's best.  The widest gap over the sample is compared with the
cell's limit.  The control (``control=True``) reads, at the same positions,
the gap of the token that the reference in float8 puts first.
"""

from __future__ import annotations

import numpy as np
import torch

from bench import reference

TOKENS_PER_BLOCK = 16384    # reference rows x positions at once


def sample(steps, seed: int, k: int) -> list:
    """``k`` requests, (step id, row), drawn from the seed out of every
    request the steps served; the first row of a step of the largest
    bucket always among them."""
    pool = [(s.id, r, s.bucket) for s in steps for r in range(s.items)]
    big = max(s.bucket for s in steps)
    first = next(p for p in pool if p[2] == big)
    rest = [p for p in pool if p != first]
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(rest), size=min(k, len(pool)) - 1, replace=False)
    return [first] + [rest[i] for i in sorted(pick)]


def served(timed, picks) -> tuple:
    """(prompts (k, T), tokens (k, steps + 1)) of the picked requests: the
    prompts drawn again from the seed (``Requests.batch``), the tokens as
    their step returned them (``TimedExecutor.outputs``)."""
    prompts = [timed.requests.batch(sid, bucket)[row]
               for sid, row, bucket in picks]
    tokens = [timed.outputs[sid][row].cpu() for sid, row, _ in picks]
    return torch.stack(prompts), torch.stack(tokens)


def gaps(conf: dict, params: dict, prompt: torch.Tensor,
         tokens: torch.Tensor, device, control: bool = False) -> np.ndarray:
    """Per request, the widest gap (reference's best logit minus that of
    the token judged) over the positions that yielded a served token.
    ``control``: the token judged is the float8 reference's first."""
    ref = reference.module(conf)
    vocab = params["embed"].shape[0]
    T, n_out = prompt.shape[1], tokens.shape[1]
    outside = ((tokens < 0) | (tokens >= vocab)).any(-1).numpy()
    tokens = tokens.clamp(0, vocab - 1)
    seq = torch.cat([prompt, tokens[:, :n_out - 1]], dim=1).long()
    pos = torch.arange(T - 1, T - 1 + n_out, device=device)
    rows = max(1, TOKENS_PER_BLOCK // seq.shape[1])
    out = []
    with torch.no_grad():
        for r0 in range(0, len(seq), rows):
            s = seq[r0:r0 + rows].to(device)
            logits = ref.forward(conf, params, s, pos)
            if control:
                tok = ref.forward(conf, params, s, pos, prec="fp8").argmax(-1)
            else:
                tok = tokens[r0:r0 + rows].to(device).long()
            gap = logits.max(-1).values - logits.gather(
                -1, tok[..., None])[..., 0]
            out.append(gap.max(-1).values.cpu())
    widest = torch.cat(out).numpy()
    if not control:     # a token id outside the vocabulary is no token
        widest[outside] = np.inf
    return widest
