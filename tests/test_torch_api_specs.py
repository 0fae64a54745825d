"""The port's abstract shape functions (``api.batch_shapes``,
``batch_specs``, ``cache_specs``, ``param_specs``): meta tensors with the
shapes and dtypes of ``jax.eval_shape`` of the reference's, leaf by leaf,
for every architecture at full width and at TINY size; and the meta path
of ``init_params`` leaves the real-device draws as they were."""

import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.configs.base import ARCH_IDS  # noqa: E402
from repro.configs.base import InputShape as RefShape  # noqa: E402
from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro_torch.configs.base import InputShape, get_config  # noqa: E402
from repro_torch.models import api, encdec, transformer  # noqa: E402


def _jax_leaves(tree) -> dict:
    """{path: (shape, dtype name)} of a tree of ShapeDtypeStructs."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _torch_leaves(tree, prefix=()) -> dict:
    """The same for the port's nested dicts and lists of meta tensors."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        assert tree.device.type == "meta", prefix
        return {prefix: (tuple(tree.shape),
                         str(tree.dtype).replace("torch.", ""))}
    out = {}
    for k, v in items:
        out.update(_torch_leaves(v, prefix + (k,)))
    return out


@pytest.mark.parametrize("tiny", [False, True], ids=["full", "tiny"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_the_references_eval_shape(arch, tiny):
    rcfg, cfg = ref_config(arch, tiny=tiny), get_config(arch, tiny=tiny)
    assert _torch_leaves(api.param_specs(cfg)) == \
        _jax_leaves(ref_api.param_specs(rcfg))
    for kind in ("prefill", "decode"):
        shp = InputShape("spec", 96, 2, kind)
        rshp = RefShape("spec", 96, 2, kind)
        assert _torch_leaves(api.batch_specs(cfg, shp)) == \
            _jax_leaves(ref_api.batch_specs(rcfg, rshp))
        assert {k: (v[0], str(v[1]).replace("torch.", ""))
                for k, v in api.batch_shapes(cfg, shp).items()} == \
            {k: (v[0], str(jax.numpy.dtype(v[1])))
             for k, v in ref_api.batch_shapes(rcfg, rshp).items()}
    shp = InputShape("spec", 96, 2, "decode")
    assert _torch_leaves(api.cache_specs(cfg, shp)) == \
        _jax_leaves(ref_api.cache_specs(rcfg, RefShape("spec", 96, 2,
                                                       "decode")))


def test_param_specs_draw_nothing():
    cfg = get_config("qwen3_moe_30b_a3b")
    state = torch.get_rng_state()
    specs = api.param_specs(cfg)
    assert torch.equal(torch.get_rng_state(), state)
    n = sum(t.numel() for t in _flat(specs))
    assert n == cfg.param_count()


def _flat(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat(v)]
    return [tree]


@pytest.mark.parametrize("arch", ["smollm_360m", "qwen3_moe_30b_a3b",
                                  "zamba2_1p2b", "whisper_medium"])
def test_init_params_on_a_real_device_draws_as_before(arch):
    """``init_params`` on the CPU draws from one generator seeded with
    ``seed``, exactly what the model modules draw from it."""
    cfg = get_config(arch, tiny=True)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    model = encdec if cfg.is_encoder_decoder else transformer
    want = _flat(model.init_params(gen, cfg, torch.device("cpu")))
    got = _flat(api.init_params(cfg, seed=3, device="cpu"))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.device.type == "cpu" and torch.equal(a, b)
