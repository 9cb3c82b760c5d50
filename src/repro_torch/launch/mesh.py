"""Device mesh construction: the port of ``repro.launch.mesh``.

Functions, not module state: importing this module initializes no process
group and touches no device.  A mesh spans the ranks of the process group,
one card a rank (``torchrun --nproc-per-node N``): a mesh function starts
the group ``torchrun`` describes in the environment (``WORLD_SIZE``,
``RANK``, ``MASTER_ADDR``) when none is initialized, and
:func:`make_host_mesh` a world of one without ``torchrun`` (NCCL on
``cuda``, gloo on ``cpu``).  A CUDA mesh with no card raises.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

#: the production meshes: (shape, axis names) without and with the pod axis
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _device_type(device: str) -> str:
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a card: pass device='cpu' for a gloo mesh")
    return kind


def world_size() -> int:
    """The ranks of the process group, or of the one ``torchrun`` describes
    before it is initialized; 1 without either."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def init_world(device: str = "cuda") -> None:
    """The process group (NCCL on ``cuda``, gloo on ``cpu``), unless one is
    initialized already: ``torchrun``'s from the environment, else a world
    of this process alone."""
    kind = _device_type(device)
    if dist.is_initialized():
        return
    if kind == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    backend = "nccl" if kind == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def mesh_over(device: str, shape: tuple, names: tuple):
    """A ``DeviceMesh`` of ``shape`` over every rank of the process group."""
    from torch.distributed.device_mesh import DeviceMesh  # noqa: PLC0415

    kind = _device_type(device)
    if math.prod(shape) != world_size():
        raise ValueError(f"a mesh of {shape} over a process group of {world_size()} ranks")
    if kind == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    return DeviceMesh(kind, torch.arange(math.prod(shape)).reshape(shape), mesh_dim_names=names)


def make_production_mesh(multi_pod: bool = False, device: str = "cuda"):
    """16×16 single pod (256 ranks) or 2×16×16 multi-pod (512 ranks), over
    a process group of exactly that many ranks; any other raises."""
    shape, names = PRODUCTION[multi_pod]
    need = math.prod(shape)
    if world_size() != need:
        raise RuntimeError(f"the {'x'.join(map(str, shape))} production mesh needs {need} "
                           f"ranks (torchrun --nproc-per-node ... --nnodes ...), the "
                           f"process group has {world_size()}")
    init_world(device)
    return mesh_over(device, shape, names)


def make_host_mesh(model: int = 1, device: str = "cuda"):
    """``(world // model, model)`` over the ranks that exist, axes
    ``("data", "model")``; starts a world of one when no process group is
    initialized and ``torchrun`` describes none."""
    init_world(device)
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"model axis {model} does not divide the world of {world}")
    return mesh_over(device, (world // model, model), ("data", "model"))
