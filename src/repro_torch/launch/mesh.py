"""Device meshes of the port (counterpart of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
device and starts no process group.  Every mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the process group that
is already initialized; where none is, ``ensure_group`` starts one:

  * a mesh of one device: a one-rank group on an in-memory ``HashStore``
    (``nccl`` on ``"cuda"``, ``gloo`` on ``"cpu"``), so no TCP rendezvous
    is needed on a machine without network;
  * under ``torchrun`` (``WORLD_SIZE`` in the environment): the
    environment's group (``env://``);
  * otherwise, for the production meshes: the fake group of the mesh's
    size, which runs every rank's collectives as no-ops in one process
    (the dry run's view of 256 or 512 devices).

A mesh whose size differs from the group's world size raises.  The device
type is ``"cuda"`` unless the caller asks for ``"cpu"``.
"""
from __future__ import annotations

import math
import os

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: the production meshes: one pod of 16 x 16 devices, two pods
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def start_fake_group(world_size: int):
    """(Re)start the fake process group of ``world_size`` ranks in this
    process (rank 0); an initialized group of another kind raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise ValueError(
                f"a {dist.get_backend()!r} process group is initialized; "
                "the fake group replaces only a fake one")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def ensure_group(world_size: int, device_type: str = "cuda",
                 fake: bool = False):
    """Start a process group for a mesh of ``world_size`` devices unless
    one is initialized (see the module docstring)."""
    if dist.is_initialized():
        return
    if fake:
        start_fake_group(world_size)
    elif world_size == 1:
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    else:
        raise ValueError(
            f"a mesh of {world_size} devices needs a process group: launch "
            "under torchrun, or initialize one before building the mesh")


def make_mesh(shape, axis_names, device_type: str = "cuda",
              fake: bool = False) -> DeviceMesh:
    """A mesh of ``shape`` named ``axis_names`` over the initialized group
    (started by ``ensure_group`` where there is none)."""
    size = math.prod(shape)
    ensure_group(size, device_type, fake=fake)
    world = dist.get_world_size()
    if world != size:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{size} ranks; the process group has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 devices per pod; ``multi_pod`` adds a leading 2-pod
    axis.  With no group initialized, the fake group of that size."""
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes, device_type, fake=True)


def make_dev_mesh(data: int = 1, model: int = 1,
                  device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh for the trainer and the tests."""
    return make_mesh((data, model), ("data", "model"), device_type)
