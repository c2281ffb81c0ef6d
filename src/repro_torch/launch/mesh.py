"""Production meshes — the counterpart of ``repro.launch.mesh``.

``make_production_mesh(multi_pod)`` is the reference's mesh, (16, 16)
over ``("data", "model")`` or (2, 16, 16) over ``("pod", "data",
"model")``, as an ``AbstractMesh``: axis names and sizes, and no process
group, since one card cannot hold 256 ranks. The sharding rules, the
programs and the dry run read only its sizes.

``device_mesh(shape, axes)`` (and ``make_test_mesh``) is a real
``torch.distributed.DeviceMesh`` (``init_device_mesh``) over the ranks of
the default process group, which the caller starts
(``torch.distributed.init_process_group``, as ``core/shard.py`` does);
the world size must be the mesh's size. On one card that is the (1, 1)
mesh of one rank.

``axis_sizes(mesh)`` reads either kind as ``{axis name: size}``.

The reference keeps its roofline's rates here, a TPU's. The port's are
the H100's, in one place, ``analysis.roofline.PEAKS["H100"]`` (bf16
tensor cores 989 TFLOP/s, HBM3 3.35 TB/s, NVLink 450 GB/s each way),
which the dry run reads.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices behind it."""
    axis_sizes_: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes_) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes_} and {self.axis_names} "
                             f"differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes_))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes_)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_size(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def device_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` on the default process
    group's ranks, whose number must be the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError(
            "device_mesh needs a started process group: call "
            "torch.distributed.init_process_group first")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(
            f"a {shape} mesh needs {math.prod(shape)} ranks, the process "
            f"group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cuda"):
    """A small real mesh (``device_mesh``)."""
    return device_mesh(shape, axes, device_type)
