"""``Sharded``: one rank's block of a global tensor, and where the rest lies.

PyTorch has no partitioner for these layers (DTensor's convolution rule
ignores a sharded weight, and the conv kernel is a ctypes call it cannot
dispatch), so the port carries each activation as its local block plus its
*placement*: per dim, the mesh axes it is split over (major first; ``()``
for a whole dim). A dim split over axes (a1, a2) holds block
``coord(a1)·size(a2) + coord(a2)``, as a JAX ``PartitionSpec`` entry
("a1", "a2") does. Every rank of a group over the axes a tensor is not split
over holds the same block.

The layers read a ``Sharded`` input's placement and choose their
collectives (``nn/layers.py``, ``parallel/halo.py``); ``relayout`` moves a
tensor between placements (all-gather the dims that lose axes, then split
the dims that gain them), which is what ``ShardingCtx.constrain`` does at the
reference's constraint points. Elementwise activations and the residual add
act on the local blocks (``__torch_function__``), as does any elementwise
function through ``map`` (the LMs' SiLU gate); any other torch function on
a ``Sharded`` raises.

Parameters carry their placement too (``shard_params``): ``p.place``,
``p.global_shape`` and ``p.shard_index``, the slices of the global tensor
that the local block holds (``bridge.load_jax_params`` copies those). A
parameter split over a mesh axis that the activation it meets splits too
(ZeRO-3's weights on "data" beside a batch on "data") is all-gathered on
that axis where it is used (``param_for``); the gather's adjoint
reduce-scatters its gradient, so ``replicas`` (the axes its placement does
not use) still names every axis its gradient must be summed over.
"""
from __future__ import annotations

import copy
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from . import collectives as C

Placement = tuple[tuple[str, ...], ...]


def placement(mesh, pspec: Sequence) -> Placement:
    """A ``spec_to_pspec`` result as a placement: each entry a tuple of the
    mesh axes of extent > 1 that split the dim (an axis of extent 1 splits
    nothing)."""
    out = []
    for entry in pspec:
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        out.append(tuple(a for a in axes if mesh.shape[a] > 1))
    return tuple(out)


def replicated(ndim: int) -> Placement:
    return ((),) * ndim


def without(place: Placement, axes) -> Placement:
    """``place`` with ``axes`` taken out of every dim."""
    return tuple(tuple(a for a in dim if a not in axes) for dim in place)


def axes_of(mesh, place) -> tuple[str, ...]:
    """The mesh axes that split any of the dims of ``place``, in mesh
    order (the order ``Mesh.group`` takes)."""
    used = {a for axes in place for a in axes}
    return tuple(a for a in mesh.shape if a in used)


def _parts(mesh, axes: tuple[str, ...]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def local_shape(mesh, shape, place: Placement) -> tuple[int, ...]:
    out = []
    for n, axes in zip(shape, place):
        k = _parts(mesh, axes)
        if n % k:
            raise ValueError(f"a dim of {n} does not split over {axes} "
                             f"({k} parts)")
        out.append(n // k)
    return tuple(out)


def block_index(mesh, shape, place: Placement) -> tuple[slice, ...]:
    """The slices of the global tensor that this rank's block holds."""
    idx = []
    for n, axes in zip(shape, place):
        k, b = 1, 0
        for a in axes:
            k, b = k * mesh.shape[a], b * mesh.shape[a] + mesh.coord(a)
        size = n // k
        idx.append(slice(b * size, (b + 1) * size))
    return tuple(idx)


# what the CNNs do between layers: their activations and the residual add
_ELEMENTWISE = {torch.relu, F.leaky_relu, torch.add}


class Sharded:
    """The local block ``local`` of a global tensor of ``shape``, split as
    ``place`` over ``mesh``."""

    __slots__ = ("local", "shape", "place", "mesh")

    def __init__(self, local: torch.Tensor, shape: Sequence[int],
                 place: Placement, mesh):
        shape, place = tuple(int(n) for n in shape), tuple(place)
        if len(shape) != len(place):
            raise ValueError(f"shape {shape} / placement {place} rank "
                             f"mismatch")
        if tuple(local.shape) != local_shape(mesh, shape, place):
            raise ValueError(f"local block {tuple(local.shape)} is not the "
                             f"block of {shape} split as {place}")
        self.local, self.shape, self.place, self.mesh = \
            local, shape, place, mesh

    @classmethod
    def of(cls, full: torch.Tensor, place: Placement, mesh) -> "Sharded":
        """This rank's block of a tensor every rank holds whole (the data a
        loader draws on every rank; not differentiated)."""
        idx = block_index(mesh, full.shape, place)
        return cls(full[idx].contiguous(), full.shape, place, mesh)

    def dim(self) -> int:
        return len(self.shape)

    def __repr__(self):
        return (f"Sharded(shape={self.shape}, place={self.place}, "
                f"local={tuple(self.local.shape)})")

    def relayout(self, place: Placement) -> "Sharded":
        """The same tensor split as ``place``: every dim that loses axes is
        all-gathered first, then every dim that gains axes split (the
        adjoint pair of ``collectives``, so autograd follows)."""
        place = tuple(place)
        if place == self.place:
            return self
        local_shape(self.mesh, self.shape, place)      # checks divisibility
        x = self.local
        for d, (src, dst) in enumerate(zip(self.place, place)):
            if src and src != dst:
                x = C.all_gather(x, d, self.mesh.group(src))
        for d, (src, dst) in enumerate(zip(self.place, place)):
            if dst and src != dst:
                x = C.split(x, d, self.mesh.group(dst))
        return Sharded(x, self.shape, place, self.mesh)

    def full(self) -> torch.Tensor:
        """The whole tensor on every rank (autograd follows)."""
        return self.relayout(replicated(self.dim())).local

    def __add__(self, other):
        return torch.add(self, other)

    def map(self, fn, *others: "Sharded") -> "Sharded":
        """``fn`` of the local blocks of ``self`` and of ``others`` (of
        the same shape, re-laid out as ``self`` first), in ``self``'s
        placement: ``fn`` keeps the block's shape and acts elementwise, or
        along dims that ``self``'s placement leaves whole (the LMs' SiLU
        gate; attention on local heads over whole sequences)."""
        for o in others:
            if o.shape != self.shape:
                raise ValueError(f"elementwise map on shapes {self.shape} "
                                 f"and {o.shape}")
        y = fn(self.local, *(o.relayout(self.place).local for o in others))
        return Sharded(y, self.shape, self.place, self.mesh)

    @property
    def T(self) -> "Sharded":
        """A 2-D tensor transposed (a view of the local block)."""
        return Sharded(self.local.t(), self.shape[::-1], self.place[::-1],
                       self.mesh)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _ELEMENTWISE:
            raise TypeError(f"{getattr(func, '__name__', func)} on a Sharded "
                            f"tensor: only elementwise activations and adds "
                            f"act on the local blocks; the layers handle the "
                            f"rest")
        first = next(a for a in args if isinstance(a, Sharded))
        local = []
        for a in args:
            if isinstance(a, Sharded):
                if a.shape != first.shape:
                    raise ValueError(f"elementwise op on shapes {a.shape} "
                                     f"and {first.shape}")
                a = a.relayout(first.place).local
            elif isinstance(a, torch.Tensor):
                raise TypeError("an elementwise op takes a Sharded tensor "
                                "with another Sharded one or a number")
            local.append(a)
        return Sharded(func(*local, **kwargs), first.shape, first.place,
                       first.mesh)


def param_block(p: torch.Tensor, mesh) -> Sharded:
    """A parameter as a ``Sharded``: its recorded placement, or replicated
    where it has none."""
    place = getattr(p, "place", None)
    if place is None:
        return Sharded(p, p.shape, replicated(p.dim()), mesh)
    return Sharded(p, p.global_shape, place, mesh)


def param_for(p, x: Sharded, lead: int) -> Sharded:
    """Parameter ``p`` (or a ``Sharded`` view of one) as it meets
    activation ``x``: gathered whole on every mesh axis that splits one of
    ``x``'s first ``lead`` dims, which no other dim may use."""
    w = p if isinstance(p, Sharded) else param_block(p, x.mesh)
    return w.relayout(without(w.place, axes_of(x.mesh, x.place[:lead])))


def replicas(p: torch.Tensor, mesh) -> tuple[str, ...]:
    """The mesh axes (extent > 1) over which ``p`` is replicated: the ones
    its placement does not use."""
    used = {a for axes in getattr(p, "place", ()) for a in axes}
    return tuple(a for a in mesh.shape if mesh.shape[a] > 1 and a not in used)


@torch.no_grad()
def shard_param(p: torch.nn.Parameter, ctx, where: str = "a parameter"
                ) -> torch.nn.Parameter:
    """This rank's block of a whole parameter, placed by ``spec_to_pspec``
    of its logical axes under ``ctx``'s rules."""
    axes = getattr(p, "axes", None)
    if axes is None:
        raise ValueError(f"{where} records no logical axes; it cannot be "
                         f"placed")
    mesh = ctx.mesh
    place = placement(mesh, ctx.pspec(axes, p.shape))
    idx = block_index(mesh, p.shape, place)
    q = torch.nn.Parameter(p[idx].contiguous(), p.requires_grad)
    q.axes, q.place, q.global_shape, q.shard_index = \
        axes, place, tuple(p.shape), idx
    return q


def shard_params(model: torch.nn.Module, ctx) -> torch.nn.Module:
    """Replaces every parameter of ``model`` (held whole on every rank, drawn
    from one seed) by this rank's block (``shard_param``), in place, but
    those already placed; returns ``model``."""
    for mod in model.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            if not hasattr(p, "place"):
                setattr(mod, name, shard_param(
                    p, ctx, f"{type(mod).__name__}.{name}"))
    return model


def sharded_copy(model: torch.nn.Module, ctx) -> torch.nn.Module:
    """A copy of a whole model, its parameters replaced by this rank's blocks
    under ``ctx`` (``model`` itself stays whole)."""
    clone = copy.deepcopy(model)
    # deepcopy makes new Parameters without their attributes
    for p, q in zip(model.parameters(), clone.parameters()):
        q.axes = p.axes
    return shard_params(clone, ctx)
