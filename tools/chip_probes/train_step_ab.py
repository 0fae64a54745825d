"""The sharded bf16 train step of one tree (argv[1]: its root), SmolLM-360M
at full width, 8 x 256, its default microbatches, on a (1, 1) mesh of one
NCCL rank: 6 steps timed on the host clock (each ended by reading the
loss) and the peak memory they allocate.  To compare two trees on one
card, unpack the other (``git archive``) into a gitignored directory and
run the two in one command, in the order A B B A:

    python3 tools/chip_probes/train_step_ab.py PATH_TO_TREE
"""
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(sys.argv[1], "src"))
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from repro_torch.configs.base import InputShape, get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.training import adamw  # noqa: E402
from repro_torch.training.data import DataConfig, TokenStream  # noqa: E402

assert steps.__file__.startswith(os.path.abspath(sys.argv[1])), steps.__file__
tmp = tempfile.TemporaryDirectory()
torch.cuda.set_device(0)
dist.init_process_group("nccl", store=dist.FileStore(f"{tmp.name}/s", 1),
                        rank=0, world_size=1)
minfo = mesh_lib.make_host_mesh(1, 1)
cfg = get_config("smollm_360m").replace(kernel_impl="pallas")
shape = InputShape("dist", 256, 8, "train")
tokens = torch.from_numpy(next(iter(TokenStream(DataConfig(
    vocab_size=cfg.vocab_size, seq_len=256, batch_size=8, seed=0))))).cuda()
fn, _, t_in, _ = steps.make_train_step(cfg, minfo, shape, lr=3e-4)
params = api.init_params(cfg, seed=0)
args = [shd.distribute_tree(params, t_in[0], minfo),
        shd.distribute_tree(adamw.init(params), t_in[1], minfo),
        shd.distribute_tree({"tokens": tokens}, t_in[2], minfo)]
del params
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
held = torch.cuda.memory_allocated()
ms, losses = [], []
for _ in range(6):
    t0 = time.perf_counter()
    args[0], args[1], m = fn(*args)
    losses.append(m["loss"].full_tensor().item())
    ms.append((time.perf_counter() - t0) * 1e3)
peak = torch.cuda.max_memory_allocated()
print(json.dumps({"tree": sys.argv[1], "step_ms": ms,
                  "median_ms": sorted(ms[1:])[len(ms[1:]) // 2],
                  "losses": losses, "held_gb": held / 1e9,
                  "peak_gb": peak / 1e9}))
dist.destroy_process_group()
