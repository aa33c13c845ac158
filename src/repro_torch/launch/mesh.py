"""Device meshes (twin of ``repro.launch.mesh``) over
``torch.distributed.device_mesh.init_device_mesh``.

Functions, never module-level meshes: importing this module touches no
process group.  A mesh needs an initialized process group whose world
size is the mesh's device count and whose backend serves the mesh's
device type (NCCL for "cuda", gloo for "cpu"), or the "fake" backend
of :func:`fake_group` for either; anything else raises.

Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2,
data=16, model=16) = 512 ranks; "pod" is an outer data-parallel dim.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}
FAKE = "fake"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """The counterpart of the reference's ``compat_make_mesh``."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} / axes {axes} mismatch")
    need = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(f"a {shape} mesh needs an initialized process "
                         f"group of {need} ranks; there is none")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"a {shape} mesh needs {need} ranks; the process "
                         f"group has {world}")
    backend = str(dist.get_backend()).lower()
    if device_type not in _BACKEND or (_BACKEND[device_type] not in backend
                                       and backend != FAKE):
        raise ValueError(f"a {device_type!r} mesh needs the "
                         f"{_BACKEND.get(device_type, '?')} or {FAKE} "
                         f"backend; the process group runs {backend}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def fake_group(world: int, rank: int = 0) -> None:
    """Start a process group of ``world`` ranks on the "fake" backend of
    ``torch.testing._internal.distributed.fake_pg``, this process as
    ``rank``: every collective returns at once and moves nothing, so
    one process runs one rank's code of a mesh of any size (the
    dry-run's 256 and 512 ranks, on tensors that hold no data).
    Refuses to start inside a process that already holds a process
    group: run it in a process of its own, and end it with
    ``torch.distributed.destroy_process_group``."""
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available")
    if dist.is_initialized():
        raise RuntimeError(
            f"a fake process group cannot start here: this process already "
            f"holds a {dist.get_backend()} group of "
            f"{dist.get_world_size()} ranks; run it in a process of its own")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not one of {world}")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group(FAKE, store=FakeStore(), rank=rank,
                            world_size=world)


def production_shape(multi_pod: bool = False):
    """(shape, axes) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    return make_mesh(*production_shape(multi_pod), device_type)


def make_host_mesh(device_type: str = "cuda"):
    """A one-device (1, 1) mesh over a one-rank process group."""
    return make_mesh((1, 1), ("data", "model"), device_type)


def axis_size(mesh, name: str) -> int:
    """The size of mesh dim ``name`` (a ``DeviceMesh``, or a stub whose
    ``shape`` maps names to sizes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return int(mesh.shape[name])
    return int(mesh.size(tuple(names).index(name)))


def mesh_devices(mesh) -> int:
    """Devices of a ``DeviceMesh`` (or of a stub with ``devices.size``)."""
    if hasattr(mesh, "devices"):
        return int(mesh.devices.size)
    return int(mesh.size())
