"""Production and host meshes, the counterpart of ``repro.launch.mesh``.

Functions, not module-level constants: a ``DeviceMesh`` needs an
initialised default process group, which the caller makes
(``torch.distributed.init_process_group``, with its address, world size
and rank given explicitly).  Importing this module touches no device.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.distributed.sharding import MeshInfo


def _device_type() -> str:
    """The group's device: ``nccl`` drives CUDA devices; ``gloo`` and the
    dry-run's ``fake`` group stand for host devices."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod.  The
    default group must have exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 512 if multi_pod else 256
    if dist.get_world_size() != want:
        raise ValueError(f"a {'multi' if multi_pod else 'single'}-pod mesh "
                         f"needs {want} ranks, the group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_mesh_info(*, multi_pod: bool = False) -> MeshInfo:
    return MeshInfo(make_production_mesh(multi_pod=multi_pod))


def make_host_mesh(data: int = 1, model: int = 1) -> MeshInfo:
    """A (data, model) mesh over the current group (tests, one card)."""
    return MeshInfo(init_device_mesh(_device_type(), (data, model),
                                     mesh_dim_names=("data", "model")))
