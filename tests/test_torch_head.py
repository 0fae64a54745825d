"""The LM head (``repro_torch.models.head``) against the reference's
``logits_last`` and ``chunked_ce_loss`` (``repro.models.transformer``),
with ``jax.vjp`` of the reference's for the gradients with respect to the
rows and the head, on the same numpy-seeded inputs: TINY Gemma-2 (a tied
head, final softcap 30) and TINY Qwen3-MoE (an untied head), in float32
and bf16.

On the CPU the head's product is the plain widened one: exact products
summed in float32, as XLA computes the reference's bf16 einsum with
float32 output, so only the order of the sums differs.  Tolerances: the
logits and the loss within 1e-5 of their largest (float32 sums of at most
a few hundred terms); float32 gradients within 1e-4 of each one's largest
(the rule of tests/test_torch_train_models.py); bf16 gradients, rounded to
bf16 from float32 sums taken in another order, within one bf16 spacing of
each one's largest (2^-8 of it).

The card's path (``mm.dtype``: 16-bit operands, float32 output; its
backward on a split cotangent) runs here on meta tensors: it makes no
float32 copy of the head, and the split holds the cotangent to 2^-16.
The vocab-parallel path runs on a (4, 2) ``gloo`` mesh of 8 processes
(this file as a script, as tests/test_torch_distributed.py runs its
ranks), float32: the loss, its gradients, the served logits and the
embedding lookup with its gradient against the unsharded path within
1e-5, each rank's logits no wider than its vocabulary shard.  About 20 s
in all here.
"""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
HEADS = ["gemma2_2b", "qwen3_moe_30b_a3b"]        # tied, untied
DTYPES = ["float32", "bfloat16"]
B, T, CHUNK = 2, 40, 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg, seed=0, batch=B, length=T):
    """(head leaf name, head (V, d) tied or (d, V), rows (batch, length, d),
    labels, mask, logits cotangent (batch, V)) as float32 numpy."""
    rng = np.random.default_rng(seed)
    V, d = cfg.vocab_size, cfg.d_model
    name = "embed" if cfg.tie_embeddings else "lm_head"
    w = (rng.standard_normal((V, d) if cfg.tie_embeddings else (d, V))
         * 0.3).astype(np.float32)
    h = rng.standard_normal((batch, length, d)).astype(np.float32)
    tokens = rng.integers(0, V, (batch, length)).astype(np.int32)
    mask = np.ones((batch, length), np.float32)
    mask[:, -1] = 0.0
    ct = rng.standard_normal((batch, V)).astype(np.float32)
    return name, w, h, np.roll(tokens, -1, axis=1), mask, ct


def _configs(arch, dtype):
    from repro.configs.base import get_config as jax_config
    from repro_torch.configs.base import get_config
    return (jax_config(arch, tiny=True).replace(dtype=dtype),
            get_config(arch, tiny=True).replace(dtype=dtype))


def _rounded(x, dtype):
    """``x`` in the reference's ``dtype`` (jnp) and in the port's (torch),
    the same values."""
    import jax.numpy as jnp
    from repro_torch.models import api
    j = jnp.asarray(x).astype(dtype)
    return j, api.params_from_jax(np.asarray(j), device="cpu")


def _close(got, want, rel, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * top, (what, err, top, err / top)


def _grad_rel(dtype):
    return 1e-4 if dtype == "float32" else 2.0 ** -8


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", HEADS)
def test_logits_last_and_grads_match_reference(arch, dtype):
    jax = pytest.importorskip("jax")
    from repro.models import transformer as jtr
    from repro_torch.models import head
    cj, cfg = _configs(arch, dtype)
    name, w, h, _, _, ct = _inputs(cfg)
    jw, tw = _rounded(w, dtype)
    jh, th = _rounded(h[:, -1], dtype)
    want, vjp = jax.vjp(lambda hh, ww: jtr.logits_last({name: ww}, hh, cj),
                        jh, jw)
    gh, gw = vjp(jax.numpy.asarray(ct))
    tw.requires_grad_()
    th.requires_grad_()
    got = head.logits_last({name: tw}, th, cfg)
    assert got.dtype == torch.float32
    got.backward(torch.from_numpy(ct))
    _close(got, want, 1e-5, "logits")
    for g, r, what in ((th.grad, gh, "rows"), (tw.grad, gw, "head")):
        assert g.dtype == th.dtype, what
        _close(g, r, _grad_rel(dtype), what)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", HEADS)
def test_chunked_ce_loss_and_grads_match_reference(arch, dtype):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import transformer as jtr
    from repro_torch.models import head
    cj, cfg = _configs(arch, dtype)
    name, w, h, labels, mask, _ = _inputs(cfg, seed=1)
    jw, tw = _rounded(w, dtype)
    jh, th = _rounded(h, dtype)
    want, (gh, gw) = jax.value_and_grad(
        lambda hh, ww: jtr.chunked_ce_loss(
            {name: ww}, hh, jnp.asarray(labels), jnp.asarray(mask), cj,
            chunk=CHUNK), argnums=(0, 1))(jh, jw)
    tw.requires_grad_()
    th.requires_grad_()
    got = head.chunked_ce_loss({name: tw}, th, torch.from_numpy(labels),
                               torch.from_numpy(mask), cfg, chunk=CHUNK)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    for g, r, what in ((th.grad, gh, "rows"), (tw.grad, gw, "head")):
        assert g.dtype == th.dtype, what
        _close(g, r, _grad_rel(dtype), what)


class _Outputs(torch.utils._python_dispatch.TorchDispatchMode):
    """Every op's name, and (name, dtype, numel) of each float32 tensor
    it returns."""

    def __init__(self):
        super().__init__()
        self.ops, self.f32 = set(), []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.add(str(func))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                self.f32.append((str(func), t.numel()))
        return out


@pytest.mark.parametrize("arch", HEADS)
def test_card_path_makes_no_float32_copy_of_the_head(arch):
    """bf16 on meta tensors takes the card's path: the served logits and the
    loss's forward run ``mm.dtype``, the loss's backward ``mixed_mm``
    (float32 cotangent x bf16 operand), and no operand is widened: the
    served path makes no float32 tensor as large as the head, the loss
    only each chunk's float32 head gradient."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import head
    cfg = get_config(arch, tiny=True).replace(dtype="bfloat16")
    V, d = cfg.vocab_size, cfg.d_model
    shape = (V, d) if cfg.tie_embeddings else (d, V)
    name = "embed" if cfg.tie_embeddings else "lm_head"
    meta = dict(dtype=torch.bfloat16, device="meta")
    w = torch.empty(shape, **meta).requires_grad_()
    h = torch.empty((1, 16, d), **meta).requires_grad_()
    labels = torch.zeros((1, 16), dtype=torch.int32, device="meta")
    mask = torch.ones((1, 16), device="meta")
    with _Outputs() as served:
        head.logits_last({name: w}, h[:, -1], cfg)
    with _Outputs() as trained:
        head.chunked_ce_loss({name: w}, h, labels, mask, cfg,
                             chunk=8).backward()
    assert "aten.mm.dtype" in served.ops
    assert {"aten.mm.dtype", "repro_torch.mixed_mm.default"} <= trained.ops
    assert max(n for _, n in served.f32) < V * d
    # the head's gradient, a float32 product then rounded (the reference's
    # dot_general with float32 output, then its convert), once a chunk
    big = [op for op, n in trained.f32 if n >= V * d]
    assert big == ["repro_torch.mixed_mm.default"] * 2, big
    assert w.grad.dtype == h.grad.dtype == torch.bfloat16


def test_split_cotangent_holds_float32():
    """The backward's two bf16 parts of a float32 cotangent sum to it
    within 2^-16 of each element (16 bits of mantissa)."""
    from repro_torch.models import head
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64, 300)).astype(np.float32)) * torch.logspace(-6, 3, 300)
    hi, lo = head._split(g, torch.bfloat16)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (hi.float() + lo.float() - g).abs()
    assert (err <= 2.0 ** -16 * g.abs()).all()


# ---------------------------------------------------------------------------
# The vocab-parallel path on a (4, 2) mesh of gloo processes
# ---------------------------------------------------------------------------
MESH = (4, 2)


def _mesh_case(rank, out):
    """Each of HEADS in float32 on the (4, 2) mesh: the rows batch-sharded
    over 'data', the head vocab-sharded over 'model' (the reference's
    rule), against the unsharded path on rank 0."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import head
    minfo = meshlib.make_host_mesh(*MESH)
    flat = {}
    for arch in HEADS:
        cfg = get_config(arch, tiny=True).replace(dtype="float32")
        name, w, h, labels, mask, ct = _inputs(cfg, seed=3, batch=8)
        wpl = (Replicate(), Shard(0 if cfg.tie_embeddings else 1))
        rows = (Shard(0), Replicate())
        got, want = {}, {}
        for sharded, res in ((True, got), (False, want)):
            if not sharded and rank:
                continue
            lay = (lambda t, pl: shd.distribute(t, pl, minfo)) if sharded \
                else (lambda t, pl: t)
            tw = lay(torch.from_numpy(w), wpl).requires_grad_()
            th = lay(torch.from_numpy(h), rows).requires_grad_()
            tl = lay(torch.from_numpy(labels), rows)
            loss = head.chunked_ce_loss({name: tw}, th, tl,
                                        torch.from_numpy(mask), cfg,
                                        chunk=CHUNK)
            loss.backward()
            logits = head.logits_last({name: tw}, th[:, -1].detach(), cfg)
            if sharded:
                assert logits.placements[1] == Shard(1), logits.placements
                assert logits.to_local().shape[1] == cfg.vocab_size // 2
            full = (lambda t: t.detach().full_tensor()) if sharded \
                else (lambda t: t.detach())
            res.update(loss=full(loss), gh=full(th.grad),
                       gw=full(tw.grad), logits=full(logits))
            if cfg.tie_embeddings:
                tw.grad = None
                emb = head.embed_lookup(tw, tl)
                ctr = lay(torch.from_numpy(np.tile(ct[:, None, :cfg.d_model],
                                                   (1, T, 1))), rows)
                (emb * ctr).sum().backward()
                res.update(emb=full(emb), gemb=full(tw.grad))
        if rank == 0:
            for k in got:
                flat[f"{arch}/{k}"] = np.stack([got[k].numpy(),
                                                want[k].numpy()])
    if rank == 0:
        np.savez(f"{out}/mesh.npz", **flat)


def _worker(rank, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=MESH[0] * MESH[1])
    try:
        _mesh_case(rank, out)
    finally:
        dist.destroy_process_group()


def test_vocab_parallel_loss_on_a_mesh_equals_unsharded():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    with tempfile.TemporaryDirectory() as out:
        procs = [subprocess.Popen([sys.executable, __file__, str(rank), out],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env=env)
                 for rank in range(MESH[0] * MESH[1])]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert all(p.returncode == 0 for p in procs), logs[0][-4000:]
        got = dict(np.load(f"{out}/mesh.npz"))
    assert {k.split("/")[1] for k in got} == {"loss", "gh", "gw", "logits",
                                              "emb", "gemb"}
    for k, (sharded, plain) in got.items():
        top = np.abs(plain).max()
        assert np.abs(sharded - plain).max() <= 1e-5 * top, (
            k, np.abs(sharded - plain).max(), top)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2])
