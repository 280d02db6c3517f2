"""Meshes of ranks on ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

A ``Mesh`` lays the initialised world out as a ("data", "model")
``DeviceMesh`` (``init_device_mesh``), rank ``r`` at (r // model,
r % model), as the reference's ``make_host_mesh`` lays out its devices, and
gives the process group of each ordered subset of its axes (``group``): the
ranks that share every other coordinate, in row-major order of the subset's
coordinates.

The transport is an argument, never a fallback:

* ``gloo``: ranks on the CPU (the tests), or several ranks sharing one card.
  NCCL refuses two ranks on one device, and gloo takes CUDA tensors only for
  ``all_reduce`` and ``broadcast``, so the port's other collectives copy a
  CUDA tensor to a host buffer and back (``Group.stage``).
* ``nccl``: one rank per card, each on ``cuda:LOCAL_RANK``.

The world is initialised from ``torchrun``'s environment (``env://``: RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK), the counterpart of the
JAX trainer taking ``jax.devices()``; a spawner that starts ranks itself
sets the same variables (``spawn_env``).
"""
from __future__ import annotations

import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..nn.module import resolve_device

AXES = ("data", "model")
BACKENDS = ("gloo", "nccl")


@dataclass(frozen=True, eq=False)
class Group:
    """The process group of one ordered subset of mesh axes, as this rank
    sees it: the global ranks in group order and this rank's index there.
    ``stage``: CUDA tensors cross through host buffers (gloo)."""

    pg: object
    ranks: tuple[int, ...]
    index: int
    stage: bool

    @property
    def size(self) -> int:
        return len(self.ranks)


class Mesh:
    """The world as a ("data", "model") grid; ``shape`` maps each axis to its
    extent, as a JAX mesh's does."""

    def __init__(self, data: int, model: int, *, backend: str,
                 device: torch.device):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: the port takes "
                             f"{BACKENDS}")
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised; call "
                               "init_from_env (torchrun sets its variables)")
        world, rank = dist.get_world_size(), dist.get_rank()
        if data * model != world:
            raise ValueError(f"mesh {data}x{model} does not cover the world "
                             f"of {world} ranks")
        if dist.get_backend() != backend:
            raise ValueError(f"the world runs {dist.get_backend()}, not "
                             f"{backend}")
        self.shape = {"data": data, "model": model}
        self.size = world
        self.rank = rank
        self.backend = backend
        self.device = device
        self._coords = {"data": rank // model, "model": rank % model}
        # gloo moves CUDA tensors through the host, so its mesh is a host
        # mesh (which also keeps DeviceMesh from picking a card per rank)
        self.device_mesh = init_device_mesh(
            "cuda" if backend == "nccl" else "cpu", (data, model),
            mesh_dim_names=AXES)
        stage = backend == "gloo" and device.type == "cuda"
        self._groups = {AXES: Group(dist.group.WORLD, tuple(range(world)),
                                    rank, stage)}
        for axis in AXES:
            pg = self.device_mesh.get_group(axis)
            ranks = tuple(dist.get_process_group_ranks(pg))
            self._groups[(axis,)] = Group(pg, ranks, ranks.index(rank), stage)
        self._regrids = {(data, model): self}

    @property
    def host_device(self) -> torch.device:
        """Where small host-side values (timings, rates) cross the mesh:
        the CPU under gloo, the rank's card under nccl."""
        return torch.device("cpu") if self.backend == "gloo" else self.device

    def coord(self, axis: str) -> int:
        return self._coords[axis]

    def group(self, axes) -> Group:
        """The group over ``axes`` (a name or a tuple of names in mesh
        order)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes not in self._groups:
            raise ValueError(f"no group over {axes}: the mesh's axes are "
                             f"{AXES}, taken in that order")
        return self._groups[axes]

    def regrid(self, data: int, model: int) -> "Mesh":
        """The same world as a (data, model) grid of another split, made on
        the first call for that split and kept (a new grid makes process
        groups: every rank calls this, in the same order)."""
        if (data, model) not in self._regrids:
            mesh = Mesh(data, model, backend=self.backend, device=self.device)
            mesh._regrids = self._regrids
            self._regrids[data, model] = mesh
        return self._regrids[data, model]

    def __repr__(self):
        return (f"Mesh(data={self.shape['data']}, "
                f"model={self.shape['model']}, backend={self.backend}, "
                f"device={self.device})")


def default_split(n: int, model: int | None = None) -> tuple[int, int]:
    """(data, model) for ``n`` ranks: the reference's default puts 2 on the
    model axis where n is even and above 1."""
    model = model or (2 if n % 2 == 0 and n > 1 else 1)
    if n % model:
        raise ValueError(f"model={model} does not divide {n} ranks")
    return n // model, model


def rank_device(backend: str, device: str | torch.device) -> torch.device:
    """This rank's device: under nccl the card ``LOCAL_RANK`` names; under
    gloo ``device`` itself (the CPU, or the card every rank shares)."""
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("nccl runs on CUDA devices")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    return dev


def make_host_mesh(n: int | None = None, model: int | None = None, *,
                   backend: str, device: str | torch.device) -> Mesh:
    """The (data, model) mesh over the initialised world of ``n`` ranks
    (default: all of them), split as ``default_split``."""
    n = n or dist.get_world_size()
    data, model = default_split(n, model)
    return Mesh(data, model, backend=backend,
                device=rank_device(backend, device))


def init_from_env(backend: str, timeout=None) -> None:
    """``init_process_group`` from torchrun's variables (``env://``);
    ``timeout`` (a ``timedelta``) bounds each collective."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the port takes {BACKENDS}")
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method="env://", **kw)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_env(rank: int, world: int, port: int) -> None:
    """Sets the variables torchrun would set for ``rank`` of ``world`` ranks
    on this host (for a spawner that starts the ranks itself)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
