"""Meshes for the pod backend on ``torch.distributed``.

The counterpart of ``repro/launch/mesh.py``.  One process drives one
device; a mesh is a :class:`torch.distributed.device_mesh.DeviceMesh`
over the ranks of the default process group, with the JAX package's
axis names — ``("data", "model")`` for one pod, ``("pod", "data",
"model")`` across pods.  :class:`Mesh` wraps it with what the sharding
rules read (``axis_names``, ``devices`` — the ranks laid out in the mesh
shape — and the ``shape`` dict, as on a JAX mesh) and with what the pod
backend needs: this rank's coordinates, the device it drives, and the
process group of each axis.

Nothing here tells a program of a cluster: a multi-rank caller starts
its processes itself and calls ``torch.distributed.init_process_group``
with an address, a world size and a rank before :func:`make_mesh`.
:func:`make_host_mesh` builds the one-rank mesh; when no process group
exists yet it first makes one (``nccl`` for CUDA, ``gloo`` for the CPU)
over a ``file://`` store in a fresh temporary directory, so a single
device runs the same code path as a multi-rank run.

:func:`make_production_mesh` gives the JAX package's production meshes,
16×16 ``("data", "model")`` and 2×16×16 ``("pod", "data", "model")``,
as a stand-in that only names the axes (:class:`AbstractMesh`, what the
sharding rules read).  For the compile analysis
(``repro_torch.launch.dryrun``), :func:`make_fake_mesh` gives a
:class:`Mesh` of the same shape over a ``fake`` process group of 256 or
512 ranks seen from rank 0, whose collectives move nothing.  The roofline constants are the H100 SXM's (the counterpart of
the JAX package's TPU v5e figures).
"""
from __future__ import annotations

import dataclasses
import math
import os
import tempfile
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.utils.device import Device, resolve_device

# the roofline's rates per card: the H100 SXM's dense bf16 tensor-core
# peak, its HBM3 bandwidth, and NVLink 4's bandwidth each way (the
# counterpart of the JAX package's per-link ICI_BW)
PEAK_FLOPS_BF16 = 989e12      # FLOP/s
HBM_BW = 3.35e12              # B/s
NVLINK_BW = 450e9             # B/s each way


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    name: str
    shape: tuple
    axes: tuple

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)


SINGLE_POD = MeshSpec("pod", (16, 16), ("data", "model"))
MULTI_POD = MeshSpec("multipod", (2, 16, 16), ("pod", "data", "model"))


class AbstractMesh:
    """What the sharding rules read of a mesh (``axis_names``, ``devices``
    — the ranks in the mesh shape — and the ``shape`` dict), with no
    process group."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.devices = np.arange(math.prod(shape)).reshape(tuple(shape))
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


class Mesh:
    """A DeviceMesh with the JAX axis names, seen from one rank.

    ``axis_names``, ``devices`` (an array of ranks in the mesh shape) and
    ``shape`` (axis → size) are what ``repro_torch.sharding.rules``
    reads; ``coords`` is this rank's coordinate on each axis.  Meshes
    compare by identity, so they can key caches."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.devices = np.asarray(device_mesh.mesh.cpu().numpy())
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))
        self.device = device
        self.rank = dist.get_rank()
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names, device_mesh.get_coordinate()))
        self._groups: Dict[Tuple[str, ...], object] = {}

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device})")

    def axis_size(self, axis: str) -> int:
        """Size of a named axis (1 when the mesh has no such axis)."""
        return self.shape.get(axis, 1)

    def group(self, axes: Union[str, Sequence[str]]):
        """The process group of the ranks that differ from this one only
        on ``axes`` (one axis name, or several).  A group's ranks are in
        row-major order over ``axes`` in mesh order, so a rank's place in
        it is its shard of a dim tiled by them.  Groups over several
        axes are made on first use, by every rank at once (the pod's
        collectives run in one order on every rank): all of the mesh's
        axes is the default group."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in self.axis_names if a in axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes == self.axis_names:
            return dist.group.WORLD
        if axes not in self._groups:
            moved = np.moveaxis(self.devices, [self.axis_names.index(a)
                                               for a in axes],
                                range(-len(axes), 0))
            lists = [sorted(int(r) for r in block.reshape(-1))
                     for block in moved.reshape((-1,) + tuple(
                         self.shape[a] for a in axes))]
            self._groups[axes], _ = dist.new_subgroups_by_enumeration(lists)
        return self._groups[axes]

    def index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes`` (absent axes count
        as size 1) — its shard of an axis sharded over them."""
        i = 0
        for a in axes:
            i = i * self.axis_size(a) + self.coords.get(a, 0)
        return i


def _ensure_process_group(dev: torch.device) -> None:
    """A one-rank default process group when none exists: ``nccl`` for
    CUDA, ``gloo`` for the CPU, over a ``file://`` store in a fresh
    temporary directory (no network)."""
    if dist.is_initialized():
        return
    store = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"file://{store}", world_size=1, rank=0)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: Device = None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes`` over the default
    process group, whose world size must be ``prod(shape)``.  Each rank
    drives ``device`` (default CUDA; a CUDA device without an index
    becomes ``cuda:<rank mod device count>``).  With no process group
    yet, a one-rank group is made first (see the module doc)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    dev = resolve_device(device)
    if math.prod(shape) == 1:
        _ensure_process_group(dev)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh over more than one rank needs "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"process group has {world}")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", dist.get_rank() %
                               torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    return Mesh(dm, dev)


# The pod's two tensor collectives, by the names torch 2.13 gives them
# (``all_gather_single``, ``reduce_scatter_single``; it deprecates the
# ``*_tensor`` names) or, where those are absent, by torch 2.11's.  gloo
# takes CUDA tensors for both and for ``all_reduce``, in f32 and bf16, on
# torch 2.11 (checked on an H100): the tensors go to it as they are.

def all_gather_into(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """``out`` ← every rank's ``t`` of ``group``, concatenated in group
    rank order."""
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, t, group=group)


def reduce_scatter_into(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """``out`` ← the sum over ``group`` of block i of every rank's ``t``,
    i this rank's place in the group."""
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, t, group=group)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The 16×16 pod mesh, or with ``multi_pod`` the 2×16×16 one, as an
    :class:`AbstractMesh` (no process group).  The compile analysis runs
    over :func:`make_fake_mesh` of the same shape and axes."""
    spec = MULTI_POD if multi_pod else SINGLE_POD
    return AbstractMesh(spec.shape, spec.axes)


def make_fake_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A :class:`Mesh` on the CPU over a ``fake`` process group of
    ``prod(shape)`` ranks, seen from rank 0.  The group is made when none
    exists and made anew when the fake group has another size; a real
    group raises (a fake one needs a process of its own)."""
    world = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a fake mesh needs a process with no "
                               "process group (or a fake one)")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return make_mesh(shape, axes, "cpu")


def make_host_mesh(device: Device = None) -> Mesh:
    """The one-rank ``(1, 1)`` mesh with the pod's axis names."""
    return make_mesh((1, 1), ("data", "model"), device)


def destroy() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
