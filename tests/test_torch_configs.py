"""The port's configs are copies of the reference's: every architecture,
full and tiny, has the same fields, layer groups and parameter counts."""

import dataclasses

import pytest
import torch

pytest.importorskip("jax")

from repro.configs import base as jbase  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_config_matches_reference(arch, tiny):
    cj = jbase.get_config(arch, tiny=tiny)
    ct = tbase.get_config(arch, tiny=tiny)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert tuple(ct.layer_groups) == tuple(cj.layer_groups)
    assert ct.param_count() == cj.param_count()
    assert ct.active_param_count() == cj.active_param_count()
    assert ct.supports_long_context == cj.supports_long_context


def test_aliases_and_dtype_map():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert tbase.get_config("smollm-360m").name == "smollm-360m"
    assert tbase.get_config("zamba2-1.2b").name == \
        jbase.get_config("zamba2-1.2b").name
    cfg = tbase.get_config("smollm_360m")
    assert tbase.torch_dtype(cfg) == torch.bfloat16
    assert tbase.torch_dtype(cfg.replace(dtype="float32")) == torch.float32
