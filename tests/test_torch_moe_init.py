"""The MoE init's memory: a stacked expert leaf is drawn one layer at a time
(``moe._normal_stack``), so a 48-layer model's (48, E, d, f) leaf never
exists in float32.  On the CPU, the draws' shapes; marked ``cuda``, the
init's peak device memory at Qwen3-MoE's full widths (eight layers).

This file imports no JAX, so the ``cuda`` test runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_init.py
"""

import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.models import api
from repro_torch.serving.executor import tensor_leaves


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "mixtral_8x22b"])
def test_expert_leaves_are_drawn_one_layer_at_a_time(arch, monkeypatch):
    cfg = get_config(arch, tiny=True)
    E, d, L = cfg.num_experts, cfg.d_model, cfg.num_layers
    f = cfg.moe_d_ff or cfg.d_ff
    drawn = []
    randn = torch.randn

    def spy(*shape, **kw):
        drawn.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return randn(*shape, **kw)

    monkeypatch.setattr(torch, "randn", spy)
    params = api.init_params(cfg, seed=0, device="cpu")
    assert drawn.count((E, d, f)) == 2 * L and drawn.count((E, f, d)) == L
    assert (L, E, d, f) not in drawn and (L, E, f, d) not in drawn
    moe = params["groups"][0]["moe"]
    assert moe["wi"].shape == (L, E, d, f) and moe["wo"].shape == (L, E, f, d)
    assert moe["wi"].dtype == torch.bfloat16


@pytest.mark.cuda
def test_init_peak_memory_on_the_card():
    """Qwen3-MoE's full widths at eight layers, bf16: the init's peak stays
    under the parameters' bytes plus its largest float32 temporary, which
    is one layer's expert leaf or the head, drawn whole and last.  A
    stack drawn whole in float32 (6.4 GB beside its 3.2 GB result) would
    pass that bound by about 4 GB."""
    if not torch.cuda.is_available():
        pytest.skip("device memory needs an NVIDIA GPU")
    cfg = get_config("qwen3_moe_30b_a3b").replace(num_layers=8)
    E, d, f, V = (cfg.num_experts, cfg.d_model, cfg.moe_d_ff,
                  cfg.vocab_size)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    nbytes = sum(x.numel() * x.element_size() for x in tensor_leaves(params))
    slack = 2 ** 24                     # the allocator's rounding
    assert peak <= nbytes + 4 * max(E * d * f, V * d) + slack, \
        (peak - nbytes, E * d * f * 4, V * d * 4)
