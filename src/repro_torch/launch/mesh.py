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
A mesh may also cover an ordered subset of the world: ``Mesh.shrink``
lays the first p' ranks out as a new grid, the survivors of a lost slice
(``runtime/elastic.py``); at the mesh's own size it is the mesh an
auto-tuned plan deploys on (``runtime.elastic.bind_plan`` shrinks to the
plan's ``mesh_spec()``). Its whole group is a ``new_group`` of those
ranks, not WORLD, and so is every axis group; ``Group.ranks`` keeps
global ranks (what ``dist.broadcast`` and the point-to-point calls take)
and ``Mesh.rank`` is the index inside the mesh. The serving entry point
(``launch/serve.py``) reads the world's size and rank directly: serving is
not elastic, and its mesh is always the world.

The transport is an argument, never a fallback:

* ``gloo``: ranks on the CPU (the tests), or several ranks sharing one card.
  NCCL refuses two ranks on one device, and gloo takes CUDA tensors only for
  ``all_reduce`` and ``broadcast``, so the port's other collectives copy a
  CUDA tensor to a host buffer and back (``Group.stage``).
* ``nccl``: one rank per card, each on ``cuda:LOCAL_RANK``.

The world is initialised from ``torchrun``'s environment (``env://``: RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK), the counterpart of the
JAX trainer taking ``jax.devices()``; a spawner that starts ranks itself
sets the rank variables (``spawn_env``) and initialises the world itself
(``launch.spawn``: a file store).
"""
from __future__ import annotations

import itertools
import math
import os
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
    """The world, or an ordered subset of its ranks (``ranks``, increasing:
    the survivors of a lost slice, ``shrink``), as a grid over ``axes``
    (("data", "model") unless told otherwise); ``shape`` maps each axis to
    its extent, as a JAX mesh's does. ``rank`` is this rank's index in the
    grid; every ``Group`` names its members by their global ranks, which
    ``torch.distributed`` takes."""

    def __init__(self, *dims: int, backend: str, device: torch.device,
                 axes: tuple[str, ...] = AXES, ranks=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: the port takes "
                             f"{BACKENDS}")
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised; call "
                               "init_from_env (torchrun sets its variables)")
        if len(dims) != len(axes):
            raise ValueError(f"extents {dims} for axes {axes}")
        ranks = _ranks(dims, ranks)
        if dist.get_rank() not in ranks:
            raise ValueError(f"rank {dist.get_rank()} is not one of the "
                             f"mesh's ranks {list(ranks)}")
        if dist.get_backend() != backend:
            raise ValueError(f"the world runs {dist.get_backend()}, not "
                             f"{backend}")
        self.axes = tuple(axes)
        self.shape = dict(zip(self.axes, dims))
        self.ranks = ranks
        self.size = len(ranks)
        self.rank = ranks.index(dist.get_rank())
        self.backend = backend
        self.device = device
        coords = list(itertools.product(*(range(n) for n in dims)))
        self._coords = dict(zip(self.axes, coords[self.rank]))
        stage = backend == "gloo" and device.type == "cuda"
        self._groups = {
            tuple(self.axes[i] for i in sub): Group(
                pg, members, members.index(dist.get_rank()), stage)
            for sub, pg, members in _new_groups(dims, ranks)}
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
                        axes=axes, ranks=self.ranks)
            mesh._regrids = self._regrids
            self._regrids[key] = mesh
        return self._regrids[key]

    def regrid(self, data: int, model: int) -> "Mesh":
        """The same ranks as a (data, model) grid of another split, made on
        the first call for that split and kept (a new grid makes process
        groups: every rank calls this, in the same order)."""
        return self._regridded((data, model), AXES)

    def shrink(self, *dims: int, axes: tuple[str, ...] = AXES
               ) -> "Mesh | None":
        """The first prod(dims) ranks of this mesh as a grid of ``dims``
        over ``axes`` (the survivors of a lost slice: the reference
        re-meshes on ``devices[:p]``, so rank 0 always survives), or None
        on a rank outside it. Every rank of this mesh calls it, in the
        same order: ``new_group`` is a call every rank still running makes
        (a rank left out makes each group with the others and gets none);
        ranks that left earlier are members of no later group. All ranks:
        ``regrid``'s grid, kept."""
        n = math.prod(dims)
        if not 1 <= n <= self.size:
            raise ValueError(f"a grid of {dims} over a mesh of {self.size} "
                             f"ranks")
        if n == self.size:
            return self._regridded(tuple(dims), tuple(axes))
        ranks = self.ranks[:n]
        if dist.get_rank() in ranks:
            return Mesh(*dims, backend=self.backend, device=self.device,
                        axes=tuple(axes), ranks=ranks)
        for _ in _new_groups(dims, ranks):
            pass
        return None

    def __repr__(self):
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        some = "" if self.ranks == tuple(range(dist.get_world_size())) \
            else f", ranks={list(self.ranks)}"
        return (f"Mesh({dims}, backend={self.backend}, "
                f"device={self.device}{some})")


def _ranks(dims, ranks) -> tuple[int, ...]:
    """The global ranks of a grid of ``dims``: the world's, or ``ranks``
    (increasing, so every group lists its members in the order
    ``new_group`` ranks them)."""
    world = dist.get_world_size()
    ranks = tuple(range(world)) if ranks is None else tuple(
        int(r) for r in ranks)
    if math.prod(dims) != len(ranks):
        raise ValueError(f"mesh {'x'.join(map(str, dims))} does not cover "
                         f"its {len(ranks)} ranks")
    if list(ranks) != sorted(set(ranks)) or ranks[0] < 0 or \
            ranks[-1] >= world:
        raise ValueError(f"mesh ranks {list(ranks)}: increasing ranks of "
                         f"the world of {world}")
    return ranks


def _new_groups(dims, ranks):
    """Makes the process group of every ordered subset of a grid's axes
    over global ``ranks`` (rank ``ranks[i]`` at row-major position i):
    the ranks that share every other coordinate, one ``new_group`` each,
    the whole grid's first (WORLD where it is the world). Every rank that
    makes them calls this with the same arguments, in the same order;
    yields (axis indices, process group, global members) of the groups
    this rank is in."""
    coords = list(itertools.product(*(range(n) for n in dims)))
    me = dist.get_rank()
    whole = dist.group.WORLD if ranks == tuple(range(
        dist.get_world_size())) else dist.new_group(list(ranks))
    if me in ranks:
        yield tuple(range(len(dims))), whole, ranks
    for n in range(1, len(dims)):
        for sub in itertools.combinations(range(len(dims)), n):
            parts: dict[tuple, list[int]] = {}
            for i, c in enumerate(coords):
                rest = tuple(c[j] for j in range(len(dims)) if j not in sub)
                parts.setdefault(rest, []).append(ranks[i])
            for members in parts.values():
                pg = dist.new_group(members)
                if me in members:
                    yield sub, pg, tuple(members)


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


def init_from_env(backend: str, timeout=None) -> None:
    """``init_process_group`` from torchrun's variables (``env://``);
    ``timeout`` (a ``timedelta``) bounds each collective."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the port takes {BACKENDS}")
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method="env://", **kw)


def spawn_env(rank: int, world: int) -> None:
    """Sets the rank variables torchrun would set for ``rank`` of ``world``
    ranks on this host (for a spawner that starts the ranks itself and
    initialises their world; the entry points read WORLD_SIZE)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
