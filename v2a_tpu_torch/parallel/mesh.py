"""Device mesh construction on `torch.distributed`.

Counterpart of `v2a_tpu/parallel/mesh.py`. JAX lays its mesh over the
devices of one controller; here every rank is one process holding one
device, and a mesh names the axes of the world's ranks: `init_device_mesh`
gives one process group per axis, and `Mesh` adds the joint group of several
axes (the hybrid mesh's two dp axes) and this rank's coordinates. With the
default single 'dp' axis the mesh is 1-D over the world.

The device is `cuda:LOCAL_RANK` over NCCL unless the caller asks for
`device="cpu"` (gloo), as every entry point of the port does
(`v2a_tpu_torch/device.py`). Where no process group exists and the world is
one rank, `make_mesh` starts a one-rank group on an in-memory store, so a
single process with no cluster environment still runs a mesh.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from v2a_tpu_torch.device import DeviceLike, resolve_device


def backend_of(device: torch.device) -> str:
    """The collective backend of a device type: NCCL on the card, gloo on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: `cuda:LOCAL_RANK` (made current) or the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


class Mesh:
    """Named axes over the world's ranks (the counterpart of
    `jax.sharding.Mesh`): `axis_names`, `shape` (name -> size, in axis
    order), the rank's `device`, and per axis set its process group
    (`group`), its size (`size`) and this rank's index in it (`index`, row
    major over the axes in mesh order, as JAX splits a dim over several
    axes)."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self._coord = dict(zip(self.axis_names, device_mesh.get_coordinate()))
        self._groups = {(n,): device_mesh.get_group(n) for n in self.axis_names}
        dp = tuple(n for n in self.axis_names if n.startswith("dp"))
        if len(dp) > 1:  # every rank builds every joint group, in one order
            self._groups[dp] = self._joint_group(dp)

    def _joint_group(self, axes: Tuple[str, ...]):
        ranks = self.device_mesh.mesh
        keep = [i for i, n in enumerate(self.axis_names) if n in axes]
        other = [i for i in range(ranks.ndim) if i not in keep]
        flat = ranks.permute(*other, *keep).reshape(-1, math.prod(self.shape[a] for a in axes))
        mine, _ = dist.new_subgroups_by_enumeration([row.tolist() for row in flat])
        return mine

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"mesh {self.axis_names} has no axis {a!r}")
        return axes

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes) -> int:
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self._coord[a]
        return i

    def group(self, axes):
        axes = self._axes(axes)
        if axes not in self._groups:
            raise ValueError(f"no joint process group over {axes}")
        return self._groups[axes]

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(
    axis_names: Tuple[str, ...] = ("dp",),
    shape: Optional[Tuple[int, ...]] = None,
    device: DeviceLike = None,
) -> Mesh:
    """Build a mesh over the world's ranks.

    With the default single 'dp' axis the mesh is 1-D over the world;
    `shape` lays the ranks out over several axes, e.g.
    ``make_mesh(("dp", "tp"), (4, 2))`` on 8 ranks. A shape whose product
    is not the world size raises `ValueError`."""
    axis_names = tuple(axis_names)
    world = dist.get_world_size() if dist.is_initialized() else int(
        os.environ.get("WORLD_SIZE", 1))
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not name its axes {axis_names}")
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} != #ranks {world}")
    dev = rank_device(device)
    if not dist.is_initialized():
        if world != 1:
            raise RuntimeError("a mesh over several ranks needs an initialized process group "
                               "(parallel.multihost.initialize_distributed)")
        dist.init_process_group(backend_of(dev), store=dist.HashStore(), rank=0, world_size=1)
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(init_device_mesh(dev.type, shape, mesh_dim_names=axis_names), dev)


def local_batch_multiple(mesh: Mesh, axis: str = "dp") -> int:
    """Global batch sizes must be divisible by this."""
    return mesh.shape[axis]


def check_mesh(mesh) -> Optional[Mesh]:
    """`mesh` itself when it is a `Mesh` or None; anything else raises
    `TypeError` (a JAX mesh, a device list)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"expected a parallel.mesh.Mesh (make_mesh), got {type(mesh).__name__}")
    return mesh
