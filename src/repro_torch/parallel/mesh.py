"""The host mesh: one process per card, joined into a ("data", "model")
``DeviceMesh``.

The torch counterpart of ``repro.launch.mesh.make_host_mesh``.  Processes
are started by ``torchrun`` (``python -m torch.distributed.run``), whose
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) says where each one stands; each rank takes
``cuda:LOCAL_RANK`` and NCCL, or the CPU and gloo when the caller asks for
the CPU.  There is no fallback: a missing card, a world the ``model``
axis does not divide or a failed NCCL start fails the run.
"""
from __future__ import annotations

import os
from typing import Dict

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device: str = "cuda") -> torch.device:
    """Join the process group the torchrun environment describes (NCCL on
    ``cuda:LOCAL_RANK``, gloo on the CPU); returns this rank's device."""
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"the distributed trainer needs {missing} in the "
                           f"environment (torchrun sets them)")
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for but CUDA is not "
                               f"available; pass device='cpu' for gloo")
        local, cards = int(os.environ["LOCAL_RANK"]), torch.cuda.device_count()
        if local >= cards:
            raise RuntimeError(f"local rank {local} needs card {local}; this "
                               f"host has {cards}")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device {device!r}: the mesh runs on 'cuda' or "
                         f"'cpu'")
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method="env://",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
            device_id=dev if backend == "nccl" else None)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}; "
                           f"device {device!r} needs {backend}")
    return dev


def make_host_mesh(model_parallel: int = 1, device: str = "cuda"):
    """A ("data", "model") ``DeviceMesh`` of shape (world / model_parallel,
    model_parallel) over every process of the world, as
    ``repro.launch.mesh.make_host_mesh`` reshapes its devices: the ranks
    of one ``model`` group are consecutive."""
    from torch.distributed.device_mesh import init_device_mesh
    world = int(os.environ.get("WORLD_SIZE", "0"))
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the world of {world} processes")
    dev = init_distributed(device)
    world = dist.get_world_size()
    return init_device_mesh(dev.type, (world // model_parallel,
                                       model_parallel),
                            mesh_dim_names=("data", "model"))


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, what ``ShardingRules`` reads."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def param_group(mesh):
    """A second process group over the ranks of this rank's ``data`` group,
    made once per mesh (every rank creates every data group's, in the same
    order): FSDP's parameter gathers and gradient reduce-scatters run on
    it, so that the step's other collectives over ``data`` (the MoE
    layers' expert counts, the token count) do not queue behind a gather
    issued a layer ahead on one communicator."""
    group = getattr(mesh, "_param_group", None)
    if group is None:
        ranks = mesh.mesh.reshape(mesh.size(0), -1)          # (data, model)
        group, _ = dist.new_subgroups_by_enumeration(
            [ranks[:, m].tolist() for m in range(ranks.shape[1])])
        mesh._param_group = group
    return group

