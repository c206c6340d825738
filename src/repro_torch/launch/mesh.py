"""Production meshes (the JAX package's ``launch/mesh.py``).

Single pod  : (16, 16)    -> axes ("data", "model")          = 256 chips
Multi-pod   : (2, 16, 16) -> axes ("pod", "data", "model")   = 512 chips

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default process group, with the reference's axis names as
its ``mesh_dim_names``. :func:`make_mesh` wants that group to exist
(``torch.distributed.init_process_group``, or ``torchrun``) with exactly
as many ranks as the mesh has devices; its ``device_type`` is ``"cuda"``
unless the caller asks for ``"cpu"`` (gloo ranks), and without a card a
``"cuda"`` mesh raises.

:class:`MeshShape` is a mesh's names and sizes without any process group:
the partition rules (:mod:`repro_torch.sharding.partition`) accept it as
well as a live ``DeviceMesh``, so the production meshes can be reasoned
about without 256 or 512 ranks (the reference's tests build a fake mesh
object for the same purpose).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

__all__ = [
    "MeshShape",
    "SINGLE_POD",
    "MULTI_POD",
    "make_mesh",
    "make_production_mesh",
    "production_shape",
]

SINGLE_POD: Tuple[int, ...] = (16, 16)
MULTI_POD: Tuple[int, ...] = (2, 16, 16)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, picklable and free of devices."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "sizes", tuple(int(s) for s in self.sizes))
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for {len(self.sizes)} sizes")

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def _axes_for(shape: Sequence[int]) -> Tuple[str, ...]:
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh's names and sizes, without its 256/512 ranks."""
    shape = MULTI_POD if multi_pod else SINGLE_POD
    return MeshShape(_axes_for(shape), shape)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production mesh over the default process group's ranks."""
    shape = production_shape(multi_pod=multi_pod)
    return make_mesh(shape.sizes, shape.axis_names, device_type)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group, whose world size must equal the mesh's size (one rank per
    device). ``device_type="cuda"`` (the default) raises without a card:
    a mesh never falls back to the CPU."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh {shape} with axes {axes}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; a CPU mesh needs device_type='cpu' (gloo ranks)"
        )
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {shape} needs a process group of {math.prod(shape)} ranks: "
            "run under torchrun or call torch.distributed.init_process_group first"
        )
    need, have = math.prod(shape), dist.get_world_size()
    if need != have:
        raise RuntimeError(f"mesh {shape} needs {need} ranks, the process group has {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
