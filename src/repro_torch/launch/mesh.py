"""Meshes of the port, on ``torch.distributed.device_mesh`` -- the
reference package's ``launch/mesh.py``.

A mesh needs a default process group.  Torch has no fake devices like the
reference's 512 XLA host devices, so the production meshes are built on a
``fake`` process group (``torch.testing``'s ``FakeStore``): one process
plays rank 0 of a world of 256 or 512 ranks that do not exist, and every
collective returns at once without moving data.  The dry run
(``launch/dryrun.py``) builds its steps on such a mesh under fake tensors.
The default group is process-global, so a production mesh and a real
one-rank group cannot live in one process: the dry run runs in a process
of its own, and tests create and :func:`release` the group around each
use.

:func:`make_host_mesh` is the mesh over the ranks that exist: a one-rank
group that it starts itself when there is none (from a ``HashStore``, so
no launcher, ``MASTER_ADDR`` or port is needed), on the CUDA card unless
``device="cpu"`` is asked for, as every entry point of the port.

Each function builds a mesh when it is called, never when the module is
imported.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve_device

# the default group this module started, if it did (the one it may release)
_owned: list = []


def _start_group(world: int, backend: str, store, rank: int = 0) -> None:
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    _owned.append(dist.group.WORLD)


def start_fake_group(world: int, rank: int = 0) -> None:
    """The default group as rank ``rank`` of ``world`` fake ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    _start_group(world, "fake", FakeStore(), rank)


def release() -> None:
    """Destroy the default process group if this module started it."""
    if _owned and dist.is_initialized() and dist.group.WORLD is _owned[-1]:
        dist.destroy_process_group()
    _owned.clear()


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    """A mesh of ``shape`` over the default group, which must hold
    ``prod(shape)`` ranks; without a default group (or with a group of
    another size that this module started), over a fake one of that size
    (host tensors, no collective moves data)."""
    world = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != world:
        release()          # a fake group of another size, if it is ours
    if not dist.is_initialized():
        start_fake_group(world)
    if dist.get_world_size() != world:
        raise RuntimeError(f"a {shape} mesh needs {world} ranks; the default "
                           f"process group has {dist.get_world_size()}")
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_host_mesh(data: int = 1, model: int = 1,
                   device: DeviceLike = None) -> DeviceMesh:
    """Mesh over the ranks that exist (one, unless a launcher started
    more), on ``device``: the CUDA card by default, ``"cpu"`` on request.
    Starts a one-rank group (NCCL on the card, gloo on the CPU) when there
    is no default group."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        _start_group(1, "nccl" if dev.type == "cuda" else "gloo",
                     dist.HashStore())
    n = dist.get_world_size()
    model = min(model, n)
    data = max(1, min(data, n // model))
    ranks = torch.arange(data * model).view(data, model)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=("data", "model"))


def batch_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """Axes the global batch shards over (everything except 'model')."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")
