"""The port's sharded steps (``repro_torch.launch.steps``) on real
multi-process meshes on the CPU, against the reference's own sharded
steps and the port's unsharded entry points.

Each port run is 4 or 8 ``gloo`` processes (this file run as a script, one
intra-op thread per rank, ``init_method="file://"``); rank 0 writes what
it gathered to an ``.npz``.  The reference runs in a subprocess with 8
host devices on an Auto-axis mesh (``jax.make_mesh`` defaults to
Explicit axes since jax 0.9, on which its own multi-device tests fail)
and hands its arrays back through its own ``training.checkpoint``, which
the port's reads.  Every run has a timeout of its own, so a hang fails
the test instead of stalling the suite.

Tolerances: the train step's losses within 1e-4 relative, each parameter
leaf's change over the two steps within 1e-4 of its largest at the 99.9th
percentile and within 1e-2 everywhere (the rule of
tests/test_torch_training.py: AdamW divides each gradient by its own
running size, so an element whose gradient lies at the float32 noise of
its leaf moves by up to ``lr`` either way), the first bound no finer
than two float32 spacings of the parameter (the resolution of a change
the two steps round into it), the second no finer than the reference's
own difference between its (4, 2) and (8, 1) runs of the same steps (its
float32 partitioning noise: 1.8e-2 of the largest change of one MLP
leaf); the bf16 decode against the reference's sharded decode at the
reference's own 5e-2; the float32 sharded steps against the port's
unsharded ones at 1e-5 (the sharded products sum in another order).
TINY Zamba2's train step: the losses within 1e-4 relative and AdamW's
first moment (linear in the summed gradients) within 1e-4 of each leaf's
largest, the rule tests/test_torch_train_models.py holds gradients to.
Its parameter changes are not held to the SmolLM rule: AdamW moves each
element whose gradient lies at its leaf's float32 noise by up to ``lr``
either way, and on Zamba2 the reference's own steps on a (1, 1) and a
(2, 4) mesh put up to 0.31% of a leaf's elements past the 1e-4 bound
(the rule allows 0.1%)."""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300            # seconds, per multi-process run


# ---------------------------------------------------------------------------
# The reference's sharded steps (8 host devices, Auto-axis mesh)
# ---------------------------------------------------------------------------
REF_PRELUDE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs.base import get_config, InputShape
from repro.distributed.sharding import MeshInfo
from repro.launch import steps as steps_lib
from repro.models import api
from repro.training import adamw, checkpoint
out = sys.argv[1]
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
minfo = MeshInfo(mesh)
"""

REF_TRAIN = REF_PRELUDE + r"""
cfg = get_config("smollm_360m", tiny=True).replace(
    num_heads=4, num_kv_heads=2, head_dim=32, d_model=128, d_ff=256,
    vocab_size=512, dtype="float32")
shape = InputShape("t", 64, 8, "train")
rng = jax.random.PRNGKey(0)
params = api.init_params(rng, cfg)
batch = api.make_batch(rng, cfg, shape)
checkpoint.save(f"{out}/ref_train0.npz", 0, jax.device_get(params))
# the (4, 2) mesh, and the same steps on (8, 1): the reference's own
# partitioning noise
for name, m in (("", mesh), ("_8x1", jax.make_mesh(
        (8, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2))):
    with m:
        fn, _, in_sh, _ = steps_lib.make_train_step(cfg, MeshInfo(m), shape,
                                                    num_microbatches=2)
        p = jax.device_put(params, in_sh[0])
        o = jax.device_put(adamw.init(params), in_sh[1])
        b = jax.device_put(batch, in_sh[2])
        p, o, m1 = fn(p, o, b)
        p, o, m2 = fn(p, o, b)
    checkpoint.save(f"{out}/ref_train2{name}.npz", 2, jax.device_get(p))
    if not name:
        losses = [float(m1["loss"]), float(m2["loss"])]
np.savez(f"{out}/ref_train.npz", tokens=np.asarray(batch["tokens"]),
         losses=np.array(losses))
print("REF_OK")
"""

# TINY Zamba2 (a hybrid super-block: five Mamba blocks and the shared
# attention block) at batch 4, so that each of the 2 microbatches holds 2
# rows: one a rank on the (2, 4) mesh, fewer than the 'data' ranks on (4, 2)
REF_TRAIN_ZAMBA2 = REF_PRELUDE + r"""
cfg = get_config("zamba2_1p2b", tiny=True).replace(dtype="float32")
shape = InputShape("t", 64, 4, "train")
rng = jax.random.PRNGKey(0)
params = api.init_params(rng, cfg)
batch = api.make_batch(rng, cfg, shape)
checkpoint.save(f"{out}/ref_zamba2_0.npz", 0, jax.device_get(params))
losses = {}
for data, model in ((2, 4), (4, 2)):
    m = jax.make_mesh((data, model), ("data", "model"),
                      axis_types=(AxisType.Auto,) * 2)
    with m:
        fn, _, in_sh, _ = steps_lib.make_train_step(cfg, MeshInfo(m), shape,
                                                    num_microbatches=2)
        p = jax.device_put(params, in_sh[0])
        o = jax.device_put(adamw.init(params), in_sh[1])
        b = jax.device_put(batch, in_sh[2])
        p, o, m1 = fn(p, o, b)
        p, o, m2 = fn(p, o, b)
    checkpoint.save(f"{out}/ref_zamba2_2_{data}x{model}.npz", 2,
                    jax.device_get(p), jax.device_get(o.mu))
    losses[f"losses_{data}x{model}"] = np.array([float(m1["loss"]),
                                                 float(m2["loss"])])
np.savez(f"{out}/ref_zamba2.npz", tokens=np.asarray(batch["tokens"]),
         **losses)
print("REF_OK")
"""

# Two steps on the data-only (8, 1) mesh, 2 microbatches of 8 rows (one a
# rank), TINY SmolLM as REF_TRAIN's; the same steps on (4, 2) give the
# reference's own partitioning noise
REF_TRAIN_DP = REF_PRELUDE + r"""
cfg = get_config("smollm_360m", tiny=True).replace(
    num_heads=4, num_kv_heads=2, head_dim=32, d_model=128, d_ff=256,
    vocab_size=512, dtype="float32")
shape = InputShape("t", 64, 16, "train")
rng = jax.random.PRNGKey(0)
params = api.init_params(rng, cfg)
batch = api.make_batch(rng, cfg, shape)
checkpoint.save(f"{out}/ref_dp0.npz", 0, jax.device_get(params))
for data, model in ((8, 1), (4, 2)):
    m = jax.make_mesh((data, model), ("data", "model"),
                      axis_types=(AxisType.Auto,) * 2)
    with m:
        fn, _, in_sh, _ = steps_lib.make_train_step(cfg, MeshInfo(m), shape,
                                                    num_microbatches=2)
        p = jax.device_put(params, in_sh[0])
        o = jax.device_put(adamw.init(params), in_sh[1])
        b = jax.device_put(batch, in_sh[2])
        p, o, m1 = fn(p, o, b)
        p, o, m2 = fn(p, o, b)
    checkpoint.save(f"{out}/ref_dp2_{data}x{model}.npz", 2, jax.device_get(p),
                    jax.device_get({"mu": o.mu, "nu": o.nu}))
    if data == 8:
        losses = [float(m1["loss"]), float(m2["loss"])]
np.savez(f"{out}/ref_dp.npz", tokens=np.asarray(batch["tokens"]),
         losses=np.array(losses))
print("REF_OK")
"""

REF_DECODE = REF_PRELUDE + r"""
cfg = get_config("mixtral_8x22b", tiny=True)
B, S = 8, 128
shape = InputShape("d", S, B, "decode")
rng = jax.random.PRNGKey(0)
params = api.init_params(rng, cfg)
prefix = jax.random.randint(rng, (B, S - 1), 0, cfg.vocab_size, jnp.int32)
_, cache = api.prefill(params, {"tokens": prefix}, cfg, capacity=S)
tok = jax.random.randint(jax.random.PRNGKey(1), (B,), 0, cfg.vocab_size,
                         jnp.int32)
pos = jnp.asarray(S - 1, jnp.int32)
checkpoint.save(f"{out}/ref_decode_in.npz", 0, jax.device_get(params),
                jax.device_get(cache))
with mesh:
    fn, _, _, _ = steps_lib.make_decode_step(cfg, minfo, shape)
    logits, new_cache = fn(params, cache, tok, pos)
checkpoint.save(f"{out}/ref_decode_out.npz", 1, jax.device_get(new_cache))
np.savez(f"{out}/ref_decode.npz", tok=np.asarray(tok),
         logits=np.asarray(logits, np.float32))
print("REF_OK")
"""


def _run_reference(prog: str, out: str) -> None:
    pytest.importorskip("jax")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", prog, out], capture_output=True,
                       text=True, timeout=TIMEOUT, env=env)
    assert "REF_OK" in r.stdout, r.stdout + r.stderr[-4000:]


# ---------------------------------------------------------------------------
# The port's runs: this file as a script, one process per rank
# ---------------------------------------------------------------------------
def _run_port(case: str, data: int, model: int, out: str) -> None:
    world = data * model
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(rank), str(data), str(model),
         out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for rank in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs[0][-4000:] + "".join(
        log[-2000:] for log in logs[1:] if "Error" in log)


def _worker(case, rank, data, model, out):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store_{case}",
                            rank=rank, world_size=data * model)
    try:
        CASES[case](rank, data, model, out)
    finally:
        dist.destroy_process_group()


def _full(tree):
    """Every DTensor of a tree gathered whole (a collective: all ranks)."""
    from repro_torch.distributed import sharding as shd
    return shd.tree_map_with_path(
        lambda _, t: t.full_tensor() if hasattr(t, "full_tensor") else t,
        tree)


def _train_two_steps(cfg, batch_size, rank, data, model, ref0, ref_tokens,
                     port_out, moments=False):
    """Two sharded train steps (2 microbatches) from the reference's
    parameters and tokens; rank 0 saves the new parameters and AdamW's
    first moment (``moments``: both, as ``{"mu", "nu"}``), and the
    losses, to ``port_out`` + ``2.npz`` / ``.npz``."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.training import adamw, checkpoint
    minfo = meshlib.make_host_mesh(data, model)
    shape = InputShape("t", 64, batch_size, "train")
    _, params, _ = checkpoint.load(ref0, api.init_params(cfg, device="cpu"))
    tokens = torch.from_numpy(np.load(ref_tokens)["tokens"])
    fn, _, in_sh, _ = steps.make_train_step(cfg, minfo, shape,
                                            num_microbatches=2)
    p = shd.distribute_tree(params, in_sh[0], minfo)
    o = shd.distribute_tree(adamw.init(params), in_sh[1], minfo)
    b = shd.distribute_tree({"tokens": tokens}, in_sh[2], minfo)
    p, o, m1 = fn(p, o, b)
    p, o, m2 = fn(p, o, b)
    losses = [m["loss"].full_tensor().item() for m in (m1, m2)]
    full = _full(p)
    opt = _full({"mu": o.mu, "nu": o.nu} if moments else o.mu)
    if rank == 0:
        checkpoint.save(f"{port_out}2.npz", 2, full, opt)
        np.savez(f"{port_out}.npz", losses=np.array(losses))


def _case_train(rank, data, model, out):
    from repro_torch.configs.base import get_config
    cfg = get_config("smollm_360m", tiny=True).replace(
        num_heads=4, num_kv_heads=2, head_dim=32, d_model=128, d_ff=256,
        vocab_size=512, dtype="float32")
    _train_two_steps(cfg, 8, rank, data, model, f"{out}/ref_train0.npz",
                     f"{out}/ref_train.npz", f"{out}/port_train")


def _case_train_dp(rank, data, model, out):
    from repro_torch.configs.base import get_config
    cfg = get_config("smollm_360m", tiny=True).replace(
        num_heads=4, num_kv_heads=2, head_dim=32, d_model=128, d_ff=256,
        vocab_size=512, dtype="float32")
    _train_two_steps(cfg, 16, rank, data, model, f"{out}/ref_dp0.npz",
                     f"{out}/ref_dp.npz", f"{out}/port_dp", moments=True)


def _case_train_zamba2(rank, data, model, out):
    from repro_torch.configs.base import get_config
    cfg = get_config("zamba2_1p2b", tiny=True).replace(dtype="float32")
    _train_two_steps(cfg, 4, rank, data, model, f"{out}/ref_zamba2_0.npz",
                     f"{out}/ref_zamba2.npz",
                     f"{out}/port_zamba2_{data}x{model}_")


def _case_decode(rank, data, model, out):
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.distributed import cache_update
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.training import checkpoint
    minfo = meshlib.make_host_mesh(data, model)
    B, S = 8, 128
    shape = InputShape("d", S, B, "decode")
    ref = np.load(f"{out}/ref_decode.npz")
    tok = torch.from_numpy(ref["tok"])
    pos = torch.tensor(S - 1, dtype=torch.int32)
    results = {}
    for dtype in ("bfloat16", "float32"):
        cfg = get_config("mixtral_8x22b", tiny=True).replace(dtype=dtype)
        _, params, cache = checkpoint.load(
            f"{out}/ref_decode_in.npz", api.init_params(cfg, device="cpu"),
            api.init_cache(cfg, B, S, device="cpu"))
        fn, _, in_sh, _ = steps.make_decode_step(cfg, minfo, shape)
        p = shd.distribute_tree(params, in_sh[0], minfo)
        c = shd.distribute_tree(cache, in_sh[1], minfo)
        t = shd.distribute(tok, in_sh[2], minfo)
        q = shd.distribute(pos, in_sh[3], minfo)
        logits, c = fn(p, c, t, q)
        results[dtype] = (logits.full_tensor(), _full(c))
        # the append alone: the step's deltas, then apply_cache_deltas
        with steps.implicit_replication():
            _, deltas = api.decode_step(p, c, t, q, cfg,
                                        bspec=shd.batch_spec_axes(minfo, B),
                                        return_deltas=True)
            with CommDebugMode() as comm:
                cache_update.apply_cache_deltas(c, deltas, q)
        if rank == 0 and dtype == "float32":
            want_logits, want_cache = api.decode_step(params, cache, tok, pos,
                                                      cfg)
            results["unsharded"] = (want_logits, want_cache)
    if rank == 0:
        flat = {"collectives": np.asarray(comm.get_total_counts())}
        for name, (lg, cc) in results.items():
            flat[f"{name}/logits"] = lg.float().numpy()
            for g, grp in enumerate(cc):
                for k, v in grp.items():
                    flat[f"{name}/cache/{g}/{k}"] = v.float().numpy()
        np.savez(f"{out}/port_decode.npz", **flat)


def _case_prefill(rank, data, model, out):
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import steps
    from repro_torch.models import api
    minfo = meshlib.make_host_mesh(data, model)
    B, S = 4, 512
    shape = InputShape("p", S, B, "prefill")
    flat = {}
    for impl in ("xla", "pallas"):
        cfg = get_config("smollm_360m", tiny=True).replace(
            dtype="float32", kernel_impl=impl)
        params = api.init_params(cfg, seed=0, device="cpu")
        batch = api.make_batch(cfg, shape, seed=1, device="cpu")
        fn, _, in_sh, out_sh = steps.make_prefill_step(cfg, minfo, shape)
        logits, cache = fn(shd.distribute_tree(params, in_sh[0], minfo),
                           shd.distribute_tree(batch, in_sh[1], minfo))
        got = (logits.full_tensor(), _full(cache))
        if rank == 0:
            want = api.prefill(params, batch, cfg, capacity=S)
            flat[f"{impl}/seq_axis"] = np.asarray(
                steps.prefill_seq_axis(cfg, minfo, shape) or "")
            for name, (lg, cc) in (("sharded", got), ("unsharded", want)):
                flat[f"{impl}/{name}/logits"] = lg.numpy()
                for k in ("k", "v"):
                    flat[f"{impl}/{name}/{k}"] = cc[0][k].numpy()
    if rank == 0:
        np.savez(f"{out}/port_prefill.npz", **flat)


def _case_kernel_guard(rank, data, model, out):
    """The kernel path on a sequence-sharded decode cache raises, and on a
    data-only mesh it runs the kernels' CPU versions on local shards."""
    import torch
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import steps
    from repro_torch.models import api
    minfo = meshlib.make_host_mesh(data, model)
    B, S = 4, 64
    shape = InputShape("d", S, B, "decode")
    cfg = get_config("smollm_360m", tiny=True).replace(
        dtype="float32", kernel_impl="pallas")
    params = api.init_params(cfg, seed=0, device="cpu")
    cache = api.init_cache(cfg, B, S, device="cpu")
    tok = torch.arange(B, dtype=torch.int32)
    pos = torch.tensor(5, dtype=torch.int32)
    fn, _, in_sh, _ = steps.make_decode_step(cfg, minfo, shape)
    args = (shd.distribute_tree(params, in_sh[0], minfo),
            shd.distribute_tree(cache, in_sh[1], minfo),
            shd.distribute(tok, in_sh[2], minfo),
            shd.distribute(pos, in_sh[3], minfo))
    try:
        logits, _ = fn(*args)
        raised = ""
        err = (logits.full_tensor() - api.decode_step(
            params, cache, tok, pos, cfg)[0]).abs().max().item()
    except NotImplementedError as e:
        raised, err = str(e), -1.0
    if rank == 0:
        np.savez(f"{out}/port_guard_{data}x{model}.npz",
                 raised=np.asarray(raised), err=np.asarray(err))


def _collective_operands(watched: dict):
    """A dispatch mode that records, for every functional collective, each
    operand that lies on the storage of a tensor in ``watched``
    ({storage: name}): (name, the operand's element count)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Operands(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t is DTensor for t in types):
                return NotImplemented
            if func.namespace == "_c10d_functional":
                for a in args:
                    if isinstance(a, torch.Tensor) \
                            and a.untyped_storage() in watched:
                        self.seen.append((watched[a.untyped_storage()],
                                          a.numel()))
            return func(*args, **(kwargs or {}))
    return Operands()


def _case_layer_axis(rank, data, model, out):
    """TINY Mamba2 at 8 layers, float32: the FSDP rule shards the layer
    axis of its (8, 8) leaves (``A_log``, ``D``, ``dt_bias``).  One train
    step of 2 microbatches, then a prefill and a decode step with the
    params laid out as in training, every collective's operands that lie
    on those leaves recorded; then a DTensor ``leaf[3]``, which gathers
    the whole leaf, recorded the same way.  Rank 0 runs the unsharded
    step and entry points on the same inputs."""
    import torch
    from torch.utils.weak import WeakIdKeyDictionary
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.training import adamw
    from repro_torch.training.loop import loss_and_grads
    minfo = meshlib.make_host_mesh(data, model)
    cfg = get_config("mamba2_1p3b", tiny=True).replace(num_layers=8,
                                                       dtype="float32")
    B, T = 8, 64
    shape = InputShape("t", T, B, "train")
    params = api.init_params(cfg, seed=0, device="cpu")
    tokens = api.make_batch(cfg, shape, seed=1, device="cpu")["tokens"]
    fn, _, in_sh, _ = steps.make_train_step(cfg, minfo, shape,
                                            num_microbatches=2)
    p = shd.distribute_tree(adamw.tree_map(torch.clone, params), in_sh[0],
                            minfo)
    o = shd.distribute_tree(adamw.init(params), in_sh[1], minfo)
    b = shd.distribute_tree({"tokens": tokens}, in_sh[2], minfo)
    watched, layer_numel = WeakIdKeyDictionary(), {}
    for name, leaf in p["groups"][0].items():
        if leaf.placements[0].is_shard(0):
            watched[leaf.to_local().untyped_storage()] = name
            layer_numel[name] = leaf.to_local()[0].numel()
    rec = {}
    with _collective_operands(watched) as mode:
        p, o, m = fn(p, o, b)
    rec["train"] = mode.seen
    loss, mu = m["loss"].full_tensor().item(), _full(o.mu)

    pshape = InputShape("p", T, B, "prefill")
    pfn, _, p_in, _ = steps.make_prefill_step(cfg, minfo, pshape,
                                              param_mode="train")
    dfn, _, d_in, _ = steps.make_decode_step(
        cfg, minfo, InputShape("d", T, B, "decode"), param_mode="train")
    batch = {"tokens": tokens}
    P = shd.distribute_tree(params, p_in[0], minfo)
    watched.clear()
    for name, leaf in P["groups"][0].items():
        if leaf.placements[0].is_shard(0):
            watched[leaf.to_local().untyped_storage()] = name
    tok = torch.arange(B, dtype=torch.int32)
    pos = torch.tensor(T, dtype=torch.int32)
    with _collective_operands(watched) as mode:
        logits, cache = pfn(P, shd.distribute_tree(batch, p_in[1], minfo))
        step_logits, _ = dfn(P, cache, shd.distribute(tok, d_in[2], minfo),
                             shd.distribute(pos, d_in[3], minfo))
    rec["serve"] = mode.seen
    got = (logits.full_tensor(), step_logits.full_tensor())
    with _collective_operands(watched) as mode:
        P["groups"][0]["A_log"][3]
    rec["control"] = mode.seen

    if rank == 0:
        grads, want_loss = None, 0.0
        for mb in tokens.chunk(2):
            mb_loss, _, g = loss_and_grads(params, {"tokens": mb}, cfg)
            g = adamw.tree_map(lambda t: t / 2, g)
            grads = g if grads is None else adamw.tree_map(torch.add, grads,
                                                           g)
            want_loss += mb_loss.item() / 2
        _, want_opt, _ = adamw.update(grads, adamw.init(params), params)
        want_logits, want_cache = api.prefill(params, batch, cfg, capacity=T)
        want_step, _ = api.decode_step(params, want_cache, tok, pos, cfg)
        flat = {"loss": np.array([loss, want_loss]),
                "logits": got[0].numpy(), "want_logits": want_logits.numpy(),
                "step": got[1].numpy(), "want_step": want_step.numpy(),
                "layer_numel": np.array([layer_numel[k]
                                         for k in sorted(layer_numel)]),
                "layer_leaves": np.array(sorted(layer_numel))}
        for k, seen in rec.items():
            flat[f"{k}/names"] = np.array([n for n, _ in seen], dtype=str)
            flat[f"{k}/numel"] = np.array([c for _, c in seen], dtype=np.int64)
        for path_mu, (got_mu, want_mu) in enumerate(zip(
                adamw.tree_leaves(mu), adamw.tree_leaves(want_opt.mu))):
            flat[f"mu/{path_mu}"] = np.stack([got_mu.numpy(),
                                              want_mu.numpy()])
        np.savez(f"{out}/port_layer_axis.npz", **flat)


CASES = {"train": _case_train, "train_zamba2": _case_train_zamba2,
         "train_dp": _case_train_dp, "layer_axis": _case_layer_axis,
         "decode": _case_decode,
         "prefill": _case_prefill, "guard": _case_kernel_guard}


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------
def _leaves(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k.startswith("params/")}


def test_sharded_train_step_matches_reference():
    """(4, 2) mesh, 8 ranks: TINY SmolLM, 2 microbatches, 2 steps."""
    with tempfile.TemporaryDirectory() as out:
        _run_reference(REF_TRAIN, out)
        _run_port("train", 4, 2, out)
        want = np.load(f"{out}/ref_train.npz")["losses"]
        got = np.load(f"{out}/port_train.npz")["losses"]
        np.testing.assert_allclose(got, want, rtol=1e-4)
        p0 = _leaves(f"{out}/ref_train0.npz")
        pr, pp = _leaves(f"{out}/ref_train2.npz"), _leaves(
            f"{out}/port_train2.npz")
        p8 = _leaves(f"{out}/ref_train2_8x1.npz")
        assert pr.keys() == pp.keys() == p0.keys() == p8.keys()
        for k, x0 in p0.items():
            dj, dt = pr[k] - x0, pp[k] - x0
            err = np.abs(dt - dj)
            largest = np.abs(dj).max()
            # a change is a difference of float32 parameters, each step
            # rounding the parameter once: two spacings of the parameter
            # are its resolution (a norm weight near 1.0: 2 x 6e-8, 2e-4 of
            # a two-step change at lr 3e-4)
            bound = np.maximum(1e-4 * largest, 2 * np.spacing(np.abs(pr[k])))
            assert np.quantile(err / bound, 0.999) <= 1.0, k
            # ... and the reference's own steps on another mesh move an
            # element at its leaf's gradient noise by more than 1e-2
            own = np.abs((p8[k] - x0) - dj).max()
            assert err.max() <= max(1e-2 * largest, own), (k, err.max(), own)


def test_sharded_train_step_on_a_data_mesh_matches_reference():
    """(8, 1) mesh, 8 ranks: TINY SmolLM, batch 16 in 2 microbatches (each
    row on its own rank, every leaf FSDP-sharded over 'data' and gathered
    layer by layer), two steps: the losses, the parameters' change (the
    rule of ``test_sharded_train_step_matches_reference``, the
    reference's own noise here its steps on (4, 2)) and AdamW's two
    moments after the steps within 1e-4 of each leaf's largest (the rule
    of ``test_sharded_zamba2_train_step_matches_reference``)."""
    with tempfile.TemporaryDirectory() as out:
        _run_reference(REF_TRAIN_DP, out)
        _run_port("train_dp", 8, 1, out)
        want = np.load(f"{out}/ref_dp.npz")["losses"]
        got = np.load(f"{out}/port_dp.npz")["losses"]
        np.testing.assert_allclose(got, want, rtol=1e-4)
        p0 = _leaves(f"{out}/ref_dp0.npz")
        pr = _leaves(f"{out}/ref_dp2_8x1.npz")
        pp = _leaves(f"{out}/port_dp2.npz")
        p42 = _leaves(f"{out}/ref_dp2_4x2.npz")
        assert pr.keys() == pp.keys() == p0.keys() == p42.keys()
        for k, x0 in p0.items():
            dj, dt = pr[k] - x0, pp[k] - x0
            err = np.abs(dt - dj)
            largest = np.abs(dj).max()
            bound = np.maximum(1e-4 * largest, 2 * np.spacing(np.abs(pr[k])))
            assert np.quantile(err / bound, 0.999) <= 1.0, k
            own = np.abs((p42[k] - x0) - dj).max()
            assert err.max() <= max(1e-2 * largest, own), (k, err.max(), own)
        with np.load(f"{out}/ref_dp2_8x1.npz") as z, \
                np.load(f"{out}/port_dp2.npz") as g:
            opt = [k for k in z.files if k.startswith("opt/")]
            assert sorted(opt) == sorted(k for k in g.files
                                         if k.startswith("opt/"))
            assert {k.split("/")[1] for k in opt} == {"mu", "nu"}
            for k in opt:
                np.testing.assert_allclose(
                    g[k], z[k], rtol=0, atol=1e-4 * np.abs(z[k]).max(),
                    err_msg=k)


def test_layer_axis_shards_are_gathered_one_layer_at_a_time():
    """(4, 2) mesh, 8 ranks: TINY Mamba2 at 8 layers, whose (8, 8) leaves
    the FSDP rule shards on their layer axis.  Over a train step (2
    microbatches), a prefill and a decode step with the params laid out
    as in training, no collective takes such a leaf's local shard whole:
    each collective that touches one holds one layer of it, and some do
    (the layers are gathered from the rank that holds them); a DTensor
    ``leaf[3]``, which does gather the whole leaf, is caught by the same
    record.  The results against the unsharded step and entry points in
    float32: the loss, the logits within 1e-5 (the sharded products sum
    in another order), AdamW's first moment within 1e-4 of each leaf's
    largest."""
    with tempfile.TemporaryDirectory() as out:
        _run_port("layer_axis", 4, 2, out)
        got = np.load(f"{out}/port_layer_axis.npz")
        names = [str(n) for n in got["layer_leaves"]]
        assert set(names) == {"A_log", "D", "dt_bias"}
        one = dict(zip(names, got["layer_numel"]))
        for phase in ("train", "serve"):
            seen = list(zip(got[f"{phase}/names"], got[f"{phase}/numel"]))
            assert seen, phase
            assert all(n <= one[str(name)] for name, n in seen), (phase, seen)
        control = list(zip(got["control/names"], got["control/numel"]))
        assert any(n > one[str(name)] for name, n in control), control
        loss, want_loss = got["loss"]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        for k in ("logits", "step"):
            np.testing.assert_allclose(got[k], got[f"want_{k}"], atol=1e-5,
                                       rtol=1e-5)
        for k in (k for k in got.files if k.startswith("mu/")):
            g, w = got[k]
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=k)


@pytest.fixture(scope="module")
def zamba2_reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("zamba2_ref")
    _run_reference(REF_TRAIN_ZAMBA2, str(out))
    return out


@pytest.mark.parametrize("mesh", [(2, 4), (4, 2)], ids=["2x4", "4x2"])
def test_sharded_zamba2_train_step_matches_reference(zamba2_reference, mesh):
    """8 ranks: TINY Zamba2 (a hybrid super-block over a 'model' axis), 2
    microbatches of 2 rows, 2 steps, against the reference's own sharded
    step on the same mesh: the losses, and AdamW's first moment after
    the two steps (0.09 g1 + 0.1 g2: the summed microbatch gradients,
    which the parameters' change divides by their own running size)."""
    ref = zamba2_reference
    data, model = mesh
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("ref_zamba2_0.npz", "ref_zamba2.npz"):
            os.symlink(ref / name, f"{tmp}/{name}")
        _run_port("train_zamba2", data, model, tmp)
        port = f"{tmp}/port_zamba2_{data}x{model}_"
        want = np.load(ref / "ref_zamba2.npz")[f"losses_{data}x{model}"]
        np.testing.assert_allclose(np.load(f"{port}.npz")["losses"], want,
                                   rtol=1e-4)
        with np.load(ref / f"ref_zamba2_2_{data}x{model}.npz") as z, \
                np.load(f"{port}2.npz") as g:
            mus = [k for k in z.files if k.startswith("opt/")]
            assert sorted(mus) == sorted(k for k in g.files
                                         if k.startswith("opt/"))
            for k in mus:
                np.testing.assert_allclose(
                    g[k], z[k], rtol=0, atol=1e-4 * np.abs(z[k]).max(),
                    err_msg=k)


def test_sharded_decode_matches_reference_and_appends_without_collectives():
    """(4, 2) mesh, 8 ranks: TINY Mixtral, B 8, S 128, sharded append (the
    cache's sequence over 'model')."""
    with tempfile.TemporaryDirectory() as out:
        _run_reference(REF_DECODE, out)
        _run_port("decode", 4, 2, out)
        got = np.load(f"{out}/port_decode.npz")
        assert int(got["collectives"]) == 0
        ref = np.load(f"{out}/ref_decode.npz")
        np.testing.assert_allclose(got["bfloat16/logits"], ref["logits"],
                                   atol=5e-2, rtol=5e-2)
        with np.load(f"{out}/ref_decode_out.npz") as z:
            for k in z.files:
                if not k.startswith("opt/"):
                    continue
                g, leaf = k.split("/")[1:]
                np.testing.assert_allclose(
                    got[f"bfloat16/cache/{g}/{leaf}"], z[k], atol=5e-2,
                    rtol=5e-2)
                np.testing.assert_allclose(
                    got[f"float32/cache/{g}/{leaf}"],
                    got[f"unsharded/cache/{g}/{leaf}"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got["float32/logits"],
                                   got["unsharded/logits"], atol=1e-5,
                                   rtol=1e-5)


def test_sequence_parallel_prefill_matches_unsharded():
    """(2, 2) mesh, 4 ranks: TINY SmolLM (3 heads, 1 KV head: no head TP on
    'model'), S 512, where the steps' rule shards the q blocks over
    'model'; the plain path and the kernel path (the kernels' CPU
    versions, on each rank's rows with their offset)."""
    with tempfile.TemporaryDirectory() as out:
        _run_port("prefill", 2, 2, out)
        got = np.load(f"{out}/port_prefill.npz")
        for impl in ("xla", "pallas"):
            assert str(got[f"{impl}/seq_axis"]) == "model"
            for name in ("logits", "k", "v"):
                np.testing.assert_allclose(got[f"{impl}/sharded/{name}"],
                                           got[f"{impl}/unsharded/{name}"],
                                           atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_kernel_path_on_local_shards_or_raises(mesh):
    """A decode cache sharded on its sequence axis (2 x 2) is not each
    rank's whole attention: the kernel path raises, naming the
    placements.  On a data-only mesh (4 x 1) it runs on the local shards
    and agrees with the unsharded step."""
    with tempfile.TemporaryDirectory() as out:
        _run_port("guard", *mesh, out)
        got = np.load(f"{out}/port_guard_{mesh[0]}x{mesh[1]}.npz")
        if mesh == (2, 2):
            assert "placements" in str(got["raised"])
        else:
            assert str(got["raised"]) == ""
            assert float(got["err"]) <= 1e-5


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
            sys.argv[5])
