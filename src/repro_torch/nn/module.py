"""Execution context, logical axes and parameter init (counterpart of
``repro.nn.module``).

The JAX package declares parameters as ``ParamSpec`` trees and initialises
each from a key folded with its tree path; PyTorch modules own their
parameters, so the port keeps the rest:

* ``LOGICAL_AXES``, ``Rules`` and ``spec_to_pspec``, copied from the
  reference: a parallel strategy is a table from logical axes ("batch",
  "spatial", "conv_out", ...) to mesh axes, and ``spec_to_pspec`` resolves a
  tensor's logical axes to the mesh axes of each dim, with the reference's
  fallbacks (a mesh axis is used at most once; a dim that no requested axis
  divides replicates). Every parameter records its logical axes
  (``p.axes``), so its placement comes from the same function.
* ``ShardingCtx`` carries the device, ``use_pallas`` (which routes the CNN
  convs, the LM's RMSNorms and its prompt-pass attention through the
  hand-written kernels), and, for a run across ranks, the mesh
  (``launch.mesh.Mesh``) and the strategy's rules. ``constrain`` re-lays a
  sharded activation (``parallel.sharded.Sharded``) out at the placement the
  rules give; with no mesh, or a mesh of one rank, it is a no-op.
* ``fan_in_normal`` draws LeCun-normal weights over the same fan axes as
  ``fan_in_init``, from a ``torch.Generator``, where the generator lives.
  JAX's path-keyed draws cannot be reproduced, so parity tests carry JAX's
  weights over (``bridge.py``). Inside ``placing(fn)`` every parameter made
  passes through ``fn`` as soon as it is drawn (``launch.build`` cuts it
  to a rank's block there, so a rank never holds a whole large model).
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np
import torch

# Logical axis vocabulary (the reference's; anything else is rejected early).
LOGICAL_AXES = frozenset(
    {
        # activations
        "batch", "seq", "act_embed", "act_mlp", "act_heads", "act_kv",
        # parameters
        "embed", "mlp", "heads", "kv_heads", "head_dim", "vocab", "layers",
        "experts", "state", "conv_k", "conv_in", "conv_out", "spatial",
        "qk_rank", "kv_rank",  # MLA low-rank dims
        "unsharded",
    }
)


@dataclass(frozen=True)
class Rules:
    """Mapping from logical axes to mesh axes for one parallel strategy."""

    table: tuple[tuple[str, Any], ...]

    @staticmethod
    def of(mapping: Mapping[str, Any]) -> "Rules":
        for k in mapping:
            if k not in LOGICAL_AXES:
                raise ValueError(f"unknown logical axis {k!r} in rules")
        return Rules(tuple(sorted(mapping.items())))

    def get(self, axis: str | None):
        if axis is None:
            return None
        for k, v in self.table:
            if k == axis:
                return v
        return None

    def merged(self, extra: Mapping[str, Any]) -> "Rules":
        d = dict(self.table)
        d.update(extra)
        return Rules.of(d)


def spec_to_pspec(spec_axes: Sequence[str | None], rules: Rules, mesh,
                  shape: Sequence[int] | None = None) -> tuple:
    """Resolve logical axes to the mesh axes of each dim: a tuple with, per
    dim, None (replicated), a mesh axis name, or a tuple of them (the first
    the major one), as the reference's PartitionSpec. ``mesh`` is anything
    with a ``shape`` mapping from mesh-axis name to extent.

    Guarantees validity: a mesh axis is used at most once, and sharded dims
    must divide evenly by the mesh-axis size (otherwise that dim falls back
    to a prefix of the requested axes that divides, or to replication)."""
    used: set[str] = set()
    out = []
    for i, ax in enumerate(spec_axes):
        mesh_axes = rules.get(ax)
        if mesh_axes is None:
            out.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        picked = []
        size = 1
        for m in mesh_axes:
            if m in used or m not in mesh.shape:
                continue
            picked.append(m)
            size *= mesh.shape[m]
        if not picked:
            out.append(None)
            continue
        if shape is not None and shape[i] % size != 0:
            # try a prefix of the requested axes that divides
            picked2, size2 = [], 1
            for m in picked:
                if shape[i] % (size2 * mesh.shape[m]) == 0:
                    picked2.append(m)
                    size2 *= mesh.shape[m]
            picked = picked2
            if not picked:
                out.append(None)
                continue
        used.update(picked)
        out.append(tuple(picked) if len(picked) > 1 else picked[0])
    return tuple(out)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device to run on; ``cuda`` unless the caller asks for the CPU.

    There is no fallback: asking for CUDA where it is absent raises. On CUDA,
    fp32 stays fp32 as in the reference: cuDNN's TF32 convolutions (on by
    default) and TF32 matmuls are switched off for the process. ``meta``
    holds shapes only (``launch.build.build_cell``'s stand-ins); nothing
    runs there."""
    dev = torch.device(device)
    if dev.type == "meta":
        return dev
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


EMPTY_RULES = Rules.of({})


@dataclass(frozen=True)
class ShardingCtx:
    """Device + ``use_pallas`` (the name the JAX package gives the switch that
    sends every 2-D ``HaloConv`` through the implicit-GEMM kernel; in the
    port it also sends ``RMSNorm`` and ``Attention.forward`` through
    theirs), and for a run across ranks the mesh and the strategy's rules.

    With a mesh the device must be the mesh's (the rank's own card, or the
    card its ranks share). A mesh of one rank is kept, but nothing is
    sharded on it: ``sharded`` is false and the models take their
    single-device path."""

    device: torch.device | str = "cuda"
    use_pallas: bool = False
    mesh: Any = None
    rules: Rules = EMPTY_RULES

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        if self.mesh is not None and self.mesh.device != self.device:
            raise ValueError(f"the ctx's device {self.device} is not the "
                             f"mesh's {self.mesh.device}")

    @property
    def sharded(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def pspec(self, axes: Sequence[str | None],
              shape: Sequence[int] | None = None) -> tuple:
        return spec_to_pspec(tuple(axes), self.rules, self.mesh, shape)

    def constrain(self, x, axes: Sequence[str | None]):
        """``x`` re-laid out at the placement the rules give ``axes`` for its
        global shape (the reference's ``with_sharding_constraint``). A plain
        tensor (no mesh, or one rank) is returned as it is."""
        if not self.sharded:
            return x
        from ..parallel.sharded import Sharded, placement
        if not isinstance(x, Sharded):
            raise TypeError("constrain on a mesh takes a Sharded activation")
        return x.relayout(placement(self.mesh, self.pspec(axes, x.shape)))


def fan_in_normal(shape: Sequence[int], fan_axes: Sequence[int],
                  generator: torch.Generator | None, device: torch.device,
                  dtype: torch.dtype = torch.float32,
                  axes: Sequence[str | None] | None = None
                  ) -> torch.nn.Parameter:
    """LeCun normal: N(0, 1/fan_in), fan_in = prod(shape[a] for a in fan_axes).

    Drawn in ``dtype`` on the generator's device, then moved to ``device``:
    a CPU generator gives the same weights on every device, one on the
    target device draws a large model where it lives, with no host copy.
    On the ``meta`` device (shapes only) nothing is drawn and ``generator``
    may be None. ``axes`` are the parameter's logical axes (``p.axes``)."""
    fan = int(np.prod([shape[a] for a in fan_axes]))
    w = torch.empty(tuple(shape), dtype=dtype,
                    device=device if generator is None else generator.device)
    if w.device.type != "meta":
        w.normal_(0.0, 1.0 / np.sqrt(max(fan, 1)), generator=generator)
    return with_axes(torch.nn.Parameter(w.to(device)), axes)


def constant(shape: Sequence[int], value: float, device: torch.device,
             dtype: torch.dtype = torch.float32,
             axes: Sequence[str | None] | None = None) -> torch.nn.Parameter:
    return with_axes(torch.nn.Parameter(torch.full(
        tuple(shape), value, dtype=dtype, device=device)), axes)


_PLACE = []   # the innermost ``placing`` function, if any


@contextmanager
def placing(fn):
    """Every parameter ``with_axes`` records inside the block is replaced by
    ``fn(p)`` (a parameter too) as soon as it is made."""
    _PLACE.append(fn)
    try:
        yield
    finally:
        _PLACE.pop()


def with_axes(p: torch.nn.Parameter, axes) -> torch.nn.Parameter:
    """Records the logical axes on the parameter (as the reference's
    ``ParamSpec.axes``), checked against LOGICAL_AXES; returns ``p`` (inside
    ``placing(fn)``, ``fn(p)``)."""
    if axes is not None:
        axes = tuple(axes)
        if len(axes) != p.dim():
            raise ValueError(f"shape {tuple(p.shape)} / axes {axes} rank "
                             f"mismatch")
        for a in axes:
            if a is not None and a not in LOGICAL_AXES:
                raise ValueError(f"unknown logical axis {a!r}")
        p.axes = axes
    return _PLACE[-1](p) if _PLACE else p


def zeros_like_spec(spec, device: torch.device | str,
                    ctx: ShardingCtx | None = None):
    """Zeros of every meta tensor's shape and dtype in a nested dict/list
    spec (``TransformerLM.cache_spec``, ``serve.kv_cache.pool_spec``), on
    ``device``. With a sharded ``ctx`` each leaf is this rank's block of
    zeros, a ``parallel.sharded.Sharded`` placed by the rules from the
    logical axes the leaf records (``t.axes``), as the reference's
    ``tree_init`` places a cache under a mesh."""
    if isinstance(spec, dict):
        return {k: zeros_like_spec(v, device, ctx) for k, v in spec.items()}
    if isinstance(spec, list):
        return [zeros_like_spec(v, device, ctx) for v in spec]
    if ctx is None or not ctx.sharded:
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    from ..parallel.sharded import Sharded, local_shape, placement
    axes = getattr(spec, "axes", None)
    if axes is None:
        raise ValueError(f"a leaf {tuple(spec.shape)} records no logical "
                         f"axes; it cannot be placed across ranks")
    place = placement(ctx.mesh, ctx.pspec(axes, spec.shape))
    return Sharded(torch.zeros(local_shape(ctx.mesh, spec.shape, place),
                               dtype=spec.dtype, device=device),
                   spec.shape, place, ctx.mesh)
