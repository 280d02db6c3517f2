"""Meshes of ranks on ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

A ``Mesh`` lays the initialised world out as a ("data", "model") grid,
rank ``r`` at (r // model, r % model), as the reference's
``make_host_mesh`` lays out its devices, and gives the process group of
each ordered subset of its axes (``group``): the ranks that share every
other coordinate, in row-major order of the subset's coordinates. Every
group is made when the mesh is (``torch.distributed.new_group``, which
every rank calls in the same order). ``make_grid_mesh`` lays the same
world out as the ("data", "model_r", "model_c") grid of the 2-D SUMMA
strategy (``parallel/summa.py``), the counterpart of the reference's
``make_grid_mesh(p1, p2r, p2c)``: rank ``r`` at row-major coordinates
again, and a group for each axis and each ordered tuple of axes.
``mesh_for_plan`` shapes the mesh an auto-tuned plan deploys on.

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

import itertools
import math
import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..nn.module import resolve_device

AXES = ("data", "model")
GRID_AXES = ("data", "model_r", "model_c")
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
    """The world as a grid over ``axes`` (("data", "model") unless told
    otherwise); ``shape`` maps each axis to its extent, as a JAX mesh's
    does."""

    def __init__(self, *dims: int, backend: str, device: torch.device,
                 axes: tuple[str, ...] = AXES):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: the port takes "
                             f"{BACKENDS}")
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised; call "
                               "init_from_env (torchrun sets its variables)")
        if len(dims) != len(axes):
            raise ValueError(f"extents {dims} for axes {axes}")
        world, rank = dist.get_world_size(), dist.get_rank()
        if math.prod(dims) != world:
            raise ValueError(f"mesh {'x'.join(map(str, dims))} does not "
                             f"cover the world of {world} ranks")
        if dist.get_backend() != backend:
            raise ValueError(f"the world runs {dist.get_backend()}, not "
                             f"{backend}")
        self.axes = tuple(axes)
        self.shape = dict(zip(self.axes, dims))
        self.size = world
        self.rank = rank
        self.backend = backend
        self.device = device
        coords = list(itertools.product(*(range(n) for n in dims)))
        self._coords = dict(zip(self.axes, coords[rank]))
        stage = backend == "gloo" and device.type == "cuda"
        self._groups = {self.axes: Group(dist.group.WORLD,
                                         tuple(range(world)), rank, stage)}
        for n in range(1, len(self.axes)):
            for sub in itertools.combinations(range(len(self.axes)), n):
                # the ranks that share every other coordinate, one new_group
                # each (every rank makes every group, in the same order)
                parts: dict[tuple, list[int]] = {}
                for r, c in enumerate(coords):
                    rest = tuple(c[i] for i in range(len(dims))
                                 if i not in sub)
                    parts.setdefault(rest, []).append(r)
                for ranks in parts.values():
                    pg = dist.new_group(ranks)
                    if rank in ranks:
                        self._groups[tuple(self.axes[i] for i in sub)] = \
                            Group(pg, tuple(ranks), ranks.index(rank), stage)
        self._regrids = {(self.axes, tuple(dims)): self}

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
                             f"{self.axes}, taken in that order")
        return self._groups[axes]

    def _regridded(self, dims: tuple[int, ...], axes: tuple[str, ...]
                   ) -> "Mesh":
        key = (axes, tuple(int(n) for n in dims))
        if key not in self._regrids:
            mesh = Mesh(*key[1], backend=self.backend, device=self.device,
                        axes=axes)
            mesh._regrids = self._regrids
            self._regrids[key] = mesh
        return self._regrids[key]

    def regrid(self, data: int, model: int) -> "Mesh":
        """The same world as a (data, model) grid of another split, made on
        the first call for that split and kept (a new grid makes process
        groups: every rank calls this, in the same order)."""
        return self._regridded((data, model), AXES)

    def __repr__(self):
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({dims}, backend={self.backend}, device={self.device})"


def make_grid_mesh(mesh: Mesh, p1: int, p2r: int, p2c: int) -> Mesh:
    """``mesh``'s world as the (data, model_r, model_c) = (p1, p2r, p2c)
    grid of the SUMMA strategy, made on the first call for that split and
    kept, as ``Mesh.regrid`` keeps its grids (every rank calls it, in the
    same order)."""
    return mesh._regridded((p1, p2r, p2c), GRID_AXES)


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


def mesh_for_plan(plan, *, backend: str,
                  device: str | torch.device) -> Mesh:
    """The mesh an auto-tuned ``core.autotune.TunedPlan`` deploys on, over
    the initialised world (counterpart of the reference's
    ``mesh_for_plan``): the (data, model_r, model_c) grid of
    ``plan.mesh_spec()`` for a summa plan (``make_grid_mesh``), the
    (data, model) = (p1, p2) mesh otherwise."""
    if plan.p != dist.get_world_size():
        raise ValueError(f"the plan is for p={plan.p}, the world has "
                         f"{dist.get_world_size()} ranks")
    mesh = make_host_mesh(model=plan.p2, backend=backend, device=device)
    shape, axes = plan.mesh_spec()
    if axes == GRID_AXES:
        return make_grid_mesh(mesh, *shape)
    return mesh


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
