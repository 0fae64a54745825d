"""The port's training modules against the reference's
(``repro.training.*``, ``repro.launch.train``): the token stream bit for
bit, AdamW and whole train steps over three steps on the same state,
checkpoints crossing between the packages both ways, the loop, the
launcher and the 100M example on the CPU.

Tolerances: AdamW float32 leaves within 1e-6 (bfloat16 leaves within one
bfloat16 ulp of the reference's, the same float32 update rounded once);
train steps: loss and gradient norm within 1e-4 relative; each leaf's
change over the three steps within 1e-4 of its largest at the 99.9th
percentile, and within 1e-2 everywhere (AdamW divides each gradient by its
own running size, so an element whose gradient lies near the float32
noise of its leaf moves by a step of up to ``lr`` either way)."""

import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.training import adamw as jadamw  # noqa: E402
from repro.training import checkpoint as jcheckpoint  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.training import adamw, checkpoint, data, loop  # noqa: E402
from test_torch_train_models import one_torch_thread  # noqa: E402,F401


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# TokenStream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_token_stream_synthetic_bit_identical(seed):
    kw = dict(vocab_size=512, seq_len=64, batch_size=4, seed=seed)
    a = iter(data.TokenStream(data.DataConfig(**kw)))
    b = iter(jdata.TokenStream(jdata.DataConfig(**kw)))
    for _ in range(3):
        x, y = next(a), next(b)
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


def test_token_stream_from_file_bit_identical(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_text("the quick brown fox jumps over the lazy dog. " * 40)
    kw = dict(vocab_size=100, seq_len=32, batch_size=3, seed=5,
              path=str(path))
    a = iter(data.TokenStream(data.DataConfig(**kw)))
    b = iter(jdata.TokenStream(jdata.DataConfig(**kw)))
    for _ in range(3):
        np.testing.assert_array_equal(next(a), next(b))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
SHAPES = {"a": ((6, 8), "float32"), "b": [((16,), "float32"),
                                          ((3, 4, 5), "bfloat16")],
          "c": ((7,), "bfloat16")}


def _tree(fn, spec=SHAPES):
    if isinstance(spec, dict):
        return {k: _tree(fn, v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_tree(fn, v) for v in spec]
    return fn(*spec)


def test_adamw_matches_reference_over_three_steps():
    """Steps 1 and 3 under the clip norm, step 2 clipped (its gradient
    norm is about 50); bfloat16 leaves cast back; decay on the matrices."""
    rng = np.random.default_rng(0)
    p0 = _tree(lambda s, dt: rng.standard_normal(s).astype(np.float32))

    def as_jax(tree):
        return jax.tree.map(lambda x, sp: jnp.asarray(x).astype(sp[1]), tree,
                            _tree(lambda s, dt: (s, dt)),
                            is_leaf=lambda x: isinstance(x, np.ndarray))

    def as_torch(tree):
        dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
        return adamw.tree_map(lambda x, sp: torch.from_numpy(x).to(dts[sp[1]]),
                              tree, _tree(lambda s, dt: (s, dt)))

    jp, tp = as_jax(p0), as_torch(p0)
    jo, to = jadamw.init(jp), adamw.init(tp)
    for step, gscale in enumerate((0.01, 5.0, 0.02), start=1):
        g = _tree(lambda s, dt: (rng.standard_normal(s) * gscale)
                  .astype(np.float32))
        jp, jo, jn = jadamw.update(as_jax(g), jo, jp, lr=1e-2)
        tp, to, tn = adamw.update(as_torch(g), to, tp, lr=1e-2)
        assert int(to.step) == int(jo.step) == step
        assert to.step.dtype == torch.int32
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        assert (float(jn) > 1.0) == (gscale == 5.0)
        for name, t, j in (("p", tp, jp), ("mu", to.mu, jo.mu),
                           ("nu", to.nu, jo.nu)):
            for a, b in zip(adamw.tree_leaves(t), jax.tree.leaves(j)):
                assert a.dtype == (torch.bfloat16 if b.dtype == jnp.bfloat16
                                   else torch.float32), name
                b = np.asarray(b, np.float32)
                if a.dtype == torch.bfloat16:
                    ulp = np.abs(b) * 2.0 ** -7
                    assert (np.abs(_np(a) - b) <= ulp).all(), name
                else:
                    np.testing.assert_allclose(_np(a), b, rtol=1e-6,
                                               atol=1e-7)


@pytest.mark.parametrize("rows", [False, True], ids=["whole", "by_layer"])
def test_adamw_in_place_equals_update(rows):
    """``update_`` (the sharded train step's, which writes into the
    parameters and moments it is given, as the reference's donated step)
    gives ``update``'s new parameters and moments bit for bit over the
    same three steps, each leaf updated whole or, where ``stacked`` says
    so, one slice of its leading axis at a time; it returns the very
    tensors it was given."""
    rng = np.random.default_rng(1)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    p0 = _tree(lambda s, dt: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dts[dt]))
    stacked = _tree(lambda s, dt: rows and len(s) >= 2)
    want_p, want_o = p0, adamw.init(p0)
    got_p = adamw.tree_map(torch.clone, p0)
    got_o = adamw.init(got_p)
    for gscale in (0.01, 5.0, 0.02):
        g = _tree(lambda s, dt: torch.from_numpy(
            (rng.standard_normal(s) * gscale).astype(np.float32)).to(dts[dt]))
        want_p, want_o, wn = adamw.update(g, want_o, want_p, lr=1e-2)
        ids = [id(t) for t in adamw.tree_leaves([got_p, got_o.mu, got_o.nu])]
        got_p, got_o, gn = adamw.update_(g, got_o, got_p, stacked=stacked,
                                         lr=1e-2)
        assert ids == [id(t) for t in adamw.tree_leaves(
            [got_p, got_o.mu, got_o.nu])]
        assert int(got_o.step) == int(want_o.step) and torch.equal(gn, wn)
        for t, w in ((got_p, want_p), (got_o.mu, want_o.mu),
                     (got_o.nu, want_o.nu)):
            for a, b in zip(adamw.tree_leaves(t), adamw.tree_leaves(w)):
                assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------
def _models():
    cj = jax_config("smollm_360m", tiny=True)
    params = jax.jit(japi.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cj)
    tp = api.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return params, tp


def _bump(opt):
    """An optimizer state with distinct non-zero moments and step 3."""
    return opt._replace(step=opt.step + 3,
                        mu=adamw.tree_map(lambda x: x + 0.5, opt.mu),
                        nu=adamw.tree_map(lambda x: x + 0.25, opt.nu))


def test_checkpoint_port_to_reference(tmp_path):
    jparams, tp = _models()
    to = _bump(adamw.init(tp))
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, 11, tp, to)
    jpath = str(tmp_path / "ref.npz")
    jcheckpoint.save(jpath, 11, jparams, jadamw.init(jparams))
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "params/groups/0/attn/wq" in a.files and "opt/step" in a.files
    step, jp, jo = jcheckpoint.load(path, jparams, jadamw.init(jparams))
    assert step == 11 and int(jo.step) == 3
    for t, j in zip(adamw.tree_leaves(tp) + adamw.tree_leaves(to.mu),
                    jax.tree.leaves(jp) + jax.tree.leaves(jo.mu)):
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32))


def test_checkpoint_reference_to_port(tmp_path):
    jparams, tp = _models()
    jo = jadamw.init(jparams)
    jo = jo._replace(step=jo.step + 4,
                     nu=jax.tree.map(lambda x: x + 0.125, jo.nu))
    path = str(tmp_path / "ref.npz")
    jcheckpoint.save(path, 9, jparams, jo)
    template = adamw.tree_map(torch.zeros_like, tp)
    step, p, o = checkpoint.load(path, template, adamw.init(template))
    assert step == 9 and int(o.step) == 4 and o.step.dtype == torch.int32
    for t, j in zip(adamw.tree_leaves(p) + adamw.tree_leaves(o.nu),
                    jax.tree.leaves(jparams) + jax.tree.leaves(jo.nu)):
        assert t.dtype == (torch.bfloat16 if j.dtype == jnp.bfloat16
                           else torch.float32)
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32))


# ---------------------------------------------------------------------------
# The train step and the loop
# ---------------------------------------------------------------------------
def test_train_step_matches_reference_over_three_steps():
    cj = jax_config("smollm_360m", tiny=True).replace(dtype="float32")
    cfg = get_config("smollm_360m", tiny=True).replace(dtype="float32")
    jp = jax.jit(japi.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cj)
    tp = api.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    p0 = [np.asarray(x) for x in jax.tree.leaves(jp)]

    @jax.jit
    def jstep(params, opt, tokens):        # the reference's inner step_fn
        (loss, _), grads = jax.value_and_grad(
            lambda p: japi.train_loss(p, {"tokens": tokens}, cj, remat=False),
            has_aux=True)(params)
        params, opt, gnorm = jadamw.update(grads, opt, params, lr=3e-3)
        return params, opt, loss, gnorm

    jo, to = jadamw.init(jp), adamw.init(tp)
    stream = iter(data.TokenStream(data.DataConfig(
        vocab_size=cj.vocab_size, seq_len=48, batch_size=2, seed=0)))
    for _ in range(3):
        tokens = next(stream)
        jp, jo, jl, jn = jstep(jp, jo, jnp.asarray(tokens))
        tp, to, tl, tn = loop.train_step(tp, to, torch.from_numpy(tokens),
                                         cfg, lr=3e-3, remat=True)
        assert abs(float(tl) - float(jl)) <= 1e-4 * float(jl)
        assert abs(float(tn) - float(jn)) <= 1e-4 * float(jn)
    for t, j, x0 in zip(adamw.tree_leaves(tp), jax.tree.leaves(jp), p0):
        dj, dt = np.asarray(j) - x0, _np(t) - x0
        err = np.abs(dt - dj) / np.abs(dj).max()
        assert np.quantile(err, 0.999) <= 1e-4
        assert err.max() <= 1e-2


def test_loop_train_reduces_loss():
    """The reference's own bar (tests/test_models.py)."""
    cfg = get_config("smollm_360m", tiny=True)
    out = loop.train(cfg, steps=30, batch_size=4, seq_len=128, log_every=0,
                     device="cpu")
    assert out["losses"][-1] < out["losses"][0] - 0.15
    assert len(out["step_s"]) == 30
    assert out["n_params"] == sum(
        x.numel() for x in adamw.tree_leaves(out["params"]))


def test_loop_train_needs_a_device_choice_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None trains on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.train(get_config("smollm_360m", tiny=True), steps=1)


def test_launch_train_prints_the_references_lines(capsys, monkeypatch):
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    args = ["--arch", "smollm-360m", "--tiny", "--steps", "2", "--batch",
            "2", "--seq", "16"]
    monkeypatch.setattr("sys.argv", ["train"] + args)
    jtrain.main()
    want = capsys.readouterr().out.splitlines()
    ttrain.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0]
    assert got[0].startswith("training smollm-360m-tiny: 0.3M params")
    assert len(got) == len(want) == 4
    for g, w in zip(got[1:3], want[1:3]):
        assert g.split()[:2] == w.split()[:2] and "tok/s" in g
    assert got[3].startswith("done: 323,160 params, final loss")


def test_example_train_100m_writes_its_checkpoint(tmp_path, capsys):
    from repro_torch.examples import train_100m
    path = str(tmp_path / "ck" / "train100m.npz")
    train_100m.main(["--quick", "--steps", "5", "--device", "cpu",
                     "--ckpt", path])
    assert "final: 323,160 params" in capsys.readouterr().out
    assert os.path.exists(path)
    cfg = get_config("smollm_360m", tiny=True)
    template = api.init_params(cfg, device="cpu")
    step, params, opt = checkpoint.load(path, template,
                                        adamw.init(template))
    assert step == 5 and int(opt.step) == 5
    assert all(torch.isfinite(x.float()).all()
               for x in adamw.tree_leaves(params))
