"""The benchmark's weights: drawn on the device from the seed, in the type
they are served in, laid out as the served model takes them.

The layout (each leaf's name, shape and dtype) is read from the program's
parameter specs on the meta device; the values are the benchmark's own.
Every bf16 leaf is a view of one flat buffer filled by one draw of a
normal at 0.02 (a norm's weights at 1 + that draw); the float32 leaves are
Mamba2's published initialisation of A_log, dt_bias and D.  The program
and the reference are handed the same tensors.
"""

from __future__ import annotations

import math

import torch


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def _a_log(gen, shape, device):
    """A ~ U(1, 16), stored as log A (the Mamba2 code's A_init_range)."""
    return torch.log(_uniform(gen, shape, 1.0, 16.0, device))


def _dt_bias(gen, shape, device):
    """dt log-uniform in [1e-3, 1e-1]; the bias is softplus's inverse at
    dt (dt_min, dt_max of the Mamba2 code)."""
    dt = torch.exp(_uniform(gen, shape, math.log(1e-3), math.log(1e-1),
                            device))
    return dt + torch.log(-torch.expm1(-dt))


def _ones(gen, shape, device):
    return torch.ones(shape, device=device)


FLOAT32_INIT = {"A_log": _a_log, "dt_bias": _dt_bias, "D": _ones}


class SeededWeights:
    """``params``: the tree the program and the reference read.  ``fill``
    draws new values from a seed into the same tensors."""

    def __init__(self, specs, dtype: torch.dtype, device, seed: int):
        self.device = torch.device(device)
        leaves = list(_leaves(specs))
        self.total = sum(s.numel() for p, s in leaves if s.dtype == dtype
                         and not (s.dtype == torch.float32
                                  and p[-1] in FLOAT32_INIT))
        self.flat = torch.empty(self.total, dtype=dtype, device=self.device)
        self._bf, self._f32 = [], []
        made = {}
        off = 0
        for path, spec in leaves:
            if spec.dtype == torch.float32 and path[-1] in FLOAT32_INIT:
                t = torch.empty(spec.shape, dtype=torch.float32,
                                device=self.device)
                self._f32.append((path, t))
            elif spec.dtype == dtype:
                t = self.flat[off:off + spec.numel()].view(spec.shape)
                off += spec.numel()
                self._bf.append((path, t))
            else:
                raise ValueError(f"no initialisation for leaf {path} "
                                 f"({spec.dtype})")
            made[path] = t
        self.params = _rebuild(specs, made)
        self.fill(seed)

    def fill(self, seed: int) -> None:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        torch.randn(self.total, generator=gen, out=self.flat)
        self.flat.mul_(0.02)
        for path, t in self._bf:
            if str(path[-1]).endswith("norm"):
                t.add_(1.0)
        for path, t in self._f32:
            t.copy_(FLOAT32_INIT[path[-1]](gen, t.shape, self.device))


def _rebuild(tree, made, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, made, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, made, path + (i,))
                          for i, v in enumerate(tree))
    return made[path]
