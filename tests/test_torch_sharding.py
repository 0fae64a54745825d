"""The port's sharding rules (``repro_torch.distributed.sharding``) and
``launch.steps.default_microbatches`` against the reference's, entry for
entry, for every architecture, mode, mesh and input shape.  No devices:
the reference side runs ``jax.eval_shape`` only, the port side builds its
trees on the meta device, and both take a stand-in for the mesh info."""

import functools
import math

import pytest

jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.base import ARCH_IDS, INPUT_SHAPES  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import api as japi  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import api  # noqa: E402


class _FakeMeshInfo:
    """MeshInfo stand-in with given axis sizes (no devices needed); the
    rule functions of both packages read only these properties."""

    def __init__(self, sizes):
        self._sizes = sizes

    @property
    def axis_sizes(self):
        return dict(self._sizes)

    @property
    def model(self):
        return self._sizes.get("model", 1)

    @property
    def data(self):
        return self._sizes.get("data", 1)

    @property
    def has_pod(self):
        return "pod" in self._sizes

    @property
    def batch_axes(self):
        return ("pod", "data") if self.has_pod else ("data",)

    @property
    def batch_size(self):
        return int(math.prod(self._sizes[a] for a in self.batch_axes))


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2}}
MINFO = _FakeMeshInfo(MESHES["16x16"])


def _entry(e):
    """A PartitionSpec entry in the port's form: a 1-tuple of axes and the
    bare axis name are one sharding to JAX."""
    if isinstance(e, (tuple, list)):
        return e[0] if len(e) == 1 else tuple(e)
    return e


def _ref_flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(jshd._path_names(path)): tuple(_entry(e) for e in spec)
            for path, spec in leaves}


def _port_flat(tree) -> dict:
    out = {}
    shd.tree_map_with_path(
        lambda path, spec: out.__setitem__(
            tuple(shd._path_names(path)), tuple(_entry(e) for e in spec)),
        tree)
    return out


@functools.lru_cache(maxsize=None)
def _abstract_params(arch):
    return (japi.param_specs(jget_config(arch)),
            api.param_specs(get_config(arch)))


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mode", ["train", "infer", "tp", "infer_noqtp"])
def test_param_specs_equal_reference(arch, mode):
    ref_abs, port_abs = _abstract_params(arch)
    for name, sizes in MESHES.items():
        minfo = _FakeMeshInfo(sizes)
        want = _ref_flat(jshd.param_specs(ref_abs, jget_config(arch), minfo,
                                          mode))
        got = _port_flat(shd.param_specs(port_abs, get_config(arch), minfo,
                                         mode))
        assert got == want, (arch, mode, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_cache_specs_equal_reference(arch, shape):
    s = INPUT_SHAPES[shape]
    jcfg, cfg = jget_config(arch), get_config(arch)
    ref_abs = jax.eval_shape(
        lambda: japi.init_cache(jcfg, s.global_batch, s.seq_len))
    port_abs = api.init_cache(cfg, s.global_batch, s.seq_len, device="meta")
    for name, sizes in MESHES.items():
        minfo = _FakeMeshInfo(sizes)
        want = _ref_flat(jshd.cache_specs_tree(ref_abs, jcfg, minfo,
                                               s.global_batch, s.seq_len))
        got = _port_flat(shd.cache_specs_tree(port_abs, cfg, minfo,
                                              s.global_batch, s.seq_len))
        assert got == want, (arch, shape, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_rules_and_microbatches_equal_reference(arch):
    """``batch_input_specs``, ``batch_spec_axes``, ``attn_head_tp`` and
    ``default_microbatches`` for every input shape and mesh."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    for s in INPUT_SHAPES.values():
        want_abs = japi.batch_specs(jcfg, s)
        got_abs = api.batch_specs(cfg, s)
        for name, sizes in MESHES.items():
            minfo = _FakeMeshInfo(sizes)
            want = {k: tuple(_entry(e) for e in v) for k, v in
                    jshd.batch_input_specs(want_abs, minfo).items()}
            got = {k: tuple(_entry(e) for e in v) for k, v in
                   shd.batch_input_specs(got_abs, minfo).items()}
            assert got == want, (arch, s.name, name)
            for b in (1, 2, 8, 32, s.global_batch, s.global_batch // 4 or 1):
                assert (shd.batch_spec_axes(minfo, b)
                        == jshd.batch_spec_axes(minfo, b)), (b, name)
            assert (shd.attn_head_tp(cfg, minfo.model)
                    == jshd.attn_head_tp(jcfg, minfo.model))
            assert (steps.default_microbatches(cfg, s, minfo)
                    == jsteps.default_microbatches(jcfg, s, minfo)), \
                (arch, s.name, name)


# ---------------------------------------------------------------------------
# The reference test file's rule tests, on the port
# ---------------------------------------------------------------------------
def _uses(spec, axis: str) -> bool:
    return any(axis in shd.axes_of(e) for e in spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mode", ["train", "infer"])
def test_param_specs_divisible(arch, mode):
    """Every sharded dim is divisible by its mesh axes' product."""
    cfg = get_config(arch)
    abstract = api.param_specs(cfg)
    specs = shd.param_specs(abstract, cfg, MINFO, mode)

    def check(leaf, spec):
        for dim, entry in zip(leaf.shape, spec):
            prod = math.prod(MINFO.axis_sizes[a] for a in shd.axes_of(entry))
            assert dim % prod == 0, (arch, mode, tuple(leaf.shape), spec)
    shd.tree_map2(check, abstract, specs)


def _flat_specs(specs) -> list:
    return list(_port_flat(specs).values())


def test_train_mode_has_fsdp():
    cfg = get_config("qwen2_72b")
    flat = _flat_specs(shd.param_specs(api.param_specs(cfg), cfg, MINFO,
                                       "train"))
    n_data = sum(1 for s in flat if _uses(s, "data"))
    assert n_data > len(flat) * 0.5  # most params data-sharded (FSDP)


def test_infer_mode_fsdp_only_when_needed():
    big = get_config("mixtral_8x22b")      # 280 GB bf16 -> needs data shard
    small = get_config("gemma2_2b")        # fits TP-only
    for cfg, expect_fsdp in ((big, True), (small, False)):
        flat = _flat_specs(shd.param_specs(api.param_specs(cfg), cfg, MINFO,
                                           "infer"))
        assert any(_uses(s, "data") for s in flat) == expect_fsdp, cfg.name


def test_cache_specs_long_context_seq_sharded():
    cfg = get_config("mixtral_8x22b")
    shape = INPUT_SHAPES["long_500k"]
    cache = api.init_cache(cfg, 1, shape.seq_len, device="meta")
    specs = shd.cache_specs_tree(cache, cfg, MINFO, 1, shape.seq_len)
    k_spec = specs[0]["k"]
    # (count, B, KV, S, hd): sequence axis at index 3, over every axis
    assert k_spec[3] == ("data", "model")
