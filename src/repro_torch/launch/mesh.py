"""Device meshes: the production mesh, a local mesh, and the dry run's
abstract mesh.

Counterpart of ``src/repro/launch/mesh.py``.  Single pod: (data=16,
model=16), 256 devices; multi-pod: (pod=2, data=16, model=16), 512, the
``pod`` axis extending data parallelism.

A ``torch.distributed`` mesh has one device a rank, so the devices there are
the world of the initialised process group.  :func:`make_local_mesh`
builds its ``DeviceMesh`` as ``repro_torch.api`` builds the sharded fit's
(``init_device_mesh``); with no process group initialised it first joins
the world a launcher (``torchrun``) started this rank in or, without one,
starts a world of one in this process (an in-process ``HashStore``: no
port, no file).  The dry run needs no devices: :class:`AbstractMesh`
carries axis names and sizes only, which is all the sharding rules read.

Functions, not module constants: importing this module touches no device
and starts no process group.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import torch

from .. import _device


class AbstractMesh:
    """A mesh of axis names and sizes, without devices: ``axis_names``,
    ``shape[axis]`` and ``size()``, as the sharding rules read them."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, map(int, shape)))

    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def production_mesh_shape(*, multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's axes without devices (the dry run's)."""
    return AbstractMesh(*production_mesh_shape(multi_pod=multi_pod))


def _launched() -> bool:
    """This process is one of several ranks a launcher (``torchrun``:
    ``WORLD_SIZE`` > 1 in the environment) started."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def _world(device_type: str) -> int:
    """The initialised process group's world size, after joining the world
    a launcher started this rank in (:func:`_launched`), or else starting
    a world of one, when none is initialised."""
    dist = torch.distributed
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        if _launched():
            if device_type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            dist.init_process_group(backend)  # the launcher's env:// rendezvous
        else:
            if device_type == "cuda":
                torch.cuda.set_device(0)
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production ``DeviceMesh``; raises, as the reference does, when
    the world has fewer devices than the mesh needs."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    need = math.prod(shape)
    dist = torch.distributed
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} devices, have {have} "
            "(the dry run takes launch.mesh.abstract_production_mesh, which needs none)")
    return init_device_mesh(_device.resolve(device).type, shape, mesh_dim_names=axes)


def make_local_mesh(model_parallel: int = 1, device=None):
    """A (data, model) ``DeviceMesh`` over the world's devices, ``model``
    of size ``model_parallel``; on the card unless ``device`` says
    otherwise (``"cpu"``: gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = _device.resolve(device).type
    if device_type == "meta":
        raise ValueError("a DeviceMesh needs devices; use AbstractMesh for the dry run")
    n = _world(device_type)
    if n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide {n} devices")
    return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def launcher_mesh(device=None, model_parallel: int = 1):
    """The launcher's ranks as :func:`make_local_mesh`'s mesh (``model`` of
    size ``model_parallel``) when a launcher started this process as one of
    several, else ``None`` (one device)."""
    return make_local_mesh(model_parallel, device=device) if _launched() else None
