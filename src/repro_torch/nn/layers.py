"""Core layers: Dense, Embedding, RMSNorm, Conv (1/2/3-D), BatchNorm, pooling.

Counterparts of ``repro.nn.layers`` with the same layouts and numerics:
activations channels-last (N, *spatial, C), conv weights (*K, C, F), dense
weights (in, out), embedding tables (vocab, features), so parameters carry
over from JAX without a transpose. Every module takes ``forward(x, ctx)``;
the CNN stack and the LM build on these.

Where PyTorch's defaults differ from XLA's, the port pads by hand: SAME
padding is XLA's asymmetric split (``kernels.util.same_pads``), for the
convolutions with zeros and for ``max_pool`` with −inf.

Every parameter records the reference's logical axes (``p.axes``). Across
ranks, the CNN layers take a ``parallel.sharded.Sharded`` activation and
follow its placement and their parameters' (``shard_params``):

* ``Conv``/``Dense``: a weight split on its out axis (filter-/column-
  parallel) gives an output split on its channels; one split on its in axis
  (channel-/row-parallel) takes its input split the same way and all-reduces
  the partial sums. A leading spatial dim split over the mesh stays split
  where no window crosses a block edge (a 1×1 or 2×2 window at its own
  stride); otherwise it is gathered, computed whole, and re-split at the
  model's next ``constrain``. (The stride-1 SAME sites run as
  ``HaloConv``'s halo exchange instead.)
* ``BatchNorm``: μ and E[x²] in fp32 over the whole batch and image, summed
  over the ranks that split the reduced dims, as the reference's
  unsharded-semantics ``jnp.mean`` does under GSPMD.
* ``max_pool`` as a conv window; ``global_avg_pool`` sums over the ranks
  that split the image; ``flatten`` gathers every dim but the batch.

and so do the LM layers:

* ``project``: the last n dims of an activation contracted with the first
  n of a weight (``Dense``, and the LMs' (B, S, D) projections): a weight
  split on an out dim gives an output split there (column-parallel), one
  split on a contracted dim all-reduces the partial sums (row-parallel);
* ``Embedding``: a table split on ``vocab`` looks up the ids in its rows
  and all-reduces (rows it does not hold give zeros), one split on
  ``embed`` gives an output split there;
* ``RMSNorm``: where the normed dim is split (the SSD's gated norm over
  ``d_inner``), the sum of squares is all-reduced over the ranks that split
  it and divided by the whole dim.

A weight split on an axis that also splits the activation's leading
(batch, sequence) dims is gathered on that axis first (``param_for``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rmsnorm.ref import rmsnorm_ref
from ..kernels.rmsnorm.rmsnorm import rmsnorm
from ..kernels.util import cdiv, conv_weight, same_pads
from ..parallel import collectives as C
from ..parallel.sharded import (Sharded, axes_of, block_index, param_block,
                                param_for)
from .module import ShardingCtx, constant, fan_in_normal

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _channels_last(y: torch.Tensor) -> torch.Tensor:
    # channels-last in gives channels-last out, so this is normally a no-op
    return y.permute(0, *range(2, y.dim()), 1).contiguous()


def _spatial_pads(shape: Sequence[int], window: Sequence[int],
                  strides: Sequence[int], padding: str) -> list[tuple[int, int]]:
    if padding == "SAME":
        return [same_pads(n, k, s) for n, k, s in zip(shape, window, strides)]
    if padding == "VALID":
        return [(0, 0)] * len(window)
    raise ValueError(f"padding {padding!r}: the port takes 'SAME' or 'VALID'")


def _pad(xc: torch.Tensor, pads: list[tuple[int, int]],
         value: float = 0.0) -> torch.Tensor:
    """Pad the spatial dims of a channels-first view (F.pad lists the last
    dim first)."""
    if not any(lo or hi for lo, hi in pads):
        return xc
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return F.pad(xc, flat, value=value)


class Dense(nn.Module):
    """y = x @ w (+ b), w: (in_dim, out_dim); logical axes (in_axis,
    out_axis) for column/row parallelism, as the reference's."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = False, *,
                 device: torch.device, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32,
                 in_axis: str | None = "embed", out_axis: str | None = "mlp"):
        super().__init__()
        self.use_bias = use_bias
        self.w = fan_in_normal((in_dim, out_dim), (0,), generator, device,
                               dtype, axes=(in_axis, out_axis))
        if use_bias:
            self.b = constant((out_dim,), 0.0, device, dtype,
                              axes=(out_axis,))

    def forward(self, x, ctx: ShardingCtx):
        if isinstance(x, Sharded):
            return self._sharded(x)
        y = x @ self.w
        return y + self.b if self.use_bias else y

    def _sharded(self, x: Sharded) -> Sharded:
        y = project(x, self.w)
        if self.use_bias:
            b = param_for(self.b, y, y.dim() - 1).relayout(y.place[-1:])
            y = Sharded(y.local + b.local, y.shape, y.place, y.mesh)
        return y


def project(x: Sharded, w, n: int = 1,
            dtype: torch.dtype | None = None) -> Sharded:
    """``x``'s last ``n`` dims contracted with the first ``n`` of weight
    ``w`` (a parameter, or a ``Sharded`` view of one), as the unsharded
    ``x.flatten(-n) @ w.flatten(0, n-1)``; ``dtype``: the operands cast to
    it first. ``x``'s contracted dims are re-laid out as ``w``'s; where
    those are split, the partial products are all-reduced in fp32 and
    rounded once after, as the unsharded product rounds its fp32
    accumulator once (partial sums rounded to bf16 each move the smoke
    bf16 Qwen's loss by ~3e-5)."""
    mesh = x.mesh
    lead = x.place[:-n]
    w = param_for(w, x, len(lead))
    cin = w.place[:n]
    x = x.relayout(lead + cin)
    xl, wl = x.local, w.local
    out = dtype or torch.promote_types(xl.dtype, wl.dtype)
    red = axes_of(mesh, cin)
    acc = torch.promote_types(out, torch.float32) if red else out
    y = (xl.to(acc).flatten(-n) @ wl.to(acc).flatten(0, n - 1).flatten(1)
         ).unflatten(-1, wl.shape[n:])
    if red:
        y = C.all_reduce(y, mesh.group(red)).to(out)
    return Sharded(y, x.shape[:-n] + w.shape[n:], lead + w.place[n:], mesh)


class Embedding(nn.Module):
    """``table[ids]``, table: (vocab_size, features), LeCun normal over the
    features as in the reference."""

    def __init__(self, vocab_size: int, features: int, *,
                 device: torch.device, generator: torch.Generator | None,
                 dtype: torch.dtype):
        super().__init__()
        self.table = fan_in_normal((vocab_size, features), (1,), generator,
                                   device, dtype, axes=("vocab", "embed"))

    def forward(self, ids, ctx: ShardingCtx):
        if isinstance(ids, Sharded):
            return self._sharded(ids)
        return self.table[ids]

    def _sharded(self, ids: Sharded) -> Sharded:
        mesh = ids.mesh
        t = param_for(self.table, ids, ids.dim())
        rows, cols = t.place
        if rows:
            lo = block_index(mesh, t.shape, t.place)[0].start
            ix = ids.local.long() - lo
            mine = (ix >= 0) & (ix < t.local.shape[0])
            y = t.local[torch.where(mine, ix, 0)]
            y = torch.where(mine[..., None], y, torch.zeros(
                (), dtype=y.dtype, device=y.device))
            y = C.all_reduce(y, mesh.group(axes_of(mesh, (rows,))))
        else:
            y = t.local[ids.local]
        return Sharded(y, ids.shape + t.shape[1:], ids.place + (cols,), mesh)


class RMSNorm(nn.Module):
    """x·rsqrt(mean(x²) + eps)·scale over the last dim, in fp32, cast back to
    x's dtype; the scale is fp32, as the reference's tree default makes it,
    on the logical axis ``axis_name`` ("embed", or "mlp" for the SSD's
    gated norm over d_inner). With ``ctx.use_pallas`` it runs the fused
    kernel, else its plain version."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device: torch.device,
                 axis_name: str | None = "embed"):
        super().__init__()
        self.eps = eps
        self.scale = constant((dim,), 1.0, device, axes=(axis_name,))

    def forward(self, x, ctx: ShardingCtx):
        norm = rmsnorm if ctx.use_pallas else rmsnorm_ref
        if not isinstance(x, Sharded):
            return norm(x, self.scale, eps=self.eps)
        cols = x.place[-1]
        scale = param_for(self.scale, x, x.dim() - 1).relayout((cols,)).local
        if not cols:
            return x.map(lambda t: norm(t, scale, eps=self.eps))
        xf = x.local.float()
        ss = C.all_reduce((xf * xf).sum(-1, keepdim=True),
                          x.mesh.group(axes_of(x.mesh, (cols,))))
        y = xf * torch.rsqrt(ss / x.shape[-1] + self.eps) * scale.float()
        return Sharded(y.to(x.local.dtype), x.shape, x.place, x.mesh)


class BatchNorm(nn.Module):
    """BatchNorm over every axis but the last, always with batch statistics.

    As in the reference (``repro.nn.layers.BatchNorm``): no running
    statistics (``train`` is accepted and ignored), fp32 math, variance as
    E[x²] − μ², eps 1e-5, result cast back to x's dtype. On a ``Sharded``
    input the sums run over the whole batch and image (all-reduced over the
    ranks that split them); the channels stay as the input splits them."""

    def __init__(self, dim: int, eps: float = 1e-5, *, device: torch.device):
        super().__init__()
        self.eps = eps
        self.scale = constant((dim,), 1.0, device, axes=("conv_out",))
        self.bias = constant((dim,), 0.0, device, axes=("conv_out",))

    def forward(self, x, ctx: ShardingCtx, train: bool = True):
        if isinstance(x, Sharded):
            return self._sharded(x)
        xf = x.float()
        axes = tuple(range(x.dim() - 1))
        mu = xf.mean(axes)
        var = (xf * xf).mean(axes) - mu * mu
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)

    def _sharded(self, x: Sharded) -> Sharded:
        mesh, xl = x.mesh, x.local
        xf = xl.float()
        axes = tuple(range(xl.dim() - 1))
        split = axes_of(mesh, x.place[:-1])
        if split:
            sums = torch.stack([xf.sum(axes), (xf * xf).sum(axes)])
            sums = C.all_reduce(sums, mesh.group(split))
            n = 1
            for d in x.shape[:-1]:
                n *= d
            mu, ex2 = sums[0] / n, sums[1] / n
        else:                 # the whole batch and image here: as unsharded
            mu, ex2 = xf.mean(axes), (xf * xf).mean(axes)
        var = ex2 - mu * mu
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        ch = (x.place[-1],)
        scale = param_block(self.scale, mesh).relayout(ch).local
        bias = param_block(self.bias, mesh).relayout(ch).local
        y = (y * scale.float() + bias.float()).to(xl.dtype)
        return Sharded(y, x.shape, x.place, mesh)


def conv_local(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int],
               pads: Sequence[tuple[int, int]],
               groups: int = 1) -> torch.Tensor:
    """Channels-last N-D conv of one tensor with explicit zero pads (lo, hi)
    per spatial dim."""
    nd = w.dim() - 2
    xc = _pad(_channels_first(x), list(pads))
    strides = tuple(strides)
    if set(w.shape[:nd]) == {1}:
        # a strided 1×1 conv reads every s-th pixel: take those first and
        # run it at stride 1. Same values and gradients, and it keeps off
        # PyTorch 2.13's CPU backward for strided 1×1 convs, which
        # corrupts the heap (abort or segfault in most runs of a loop).
        xc = xc[(slice(None), slice(None)) + tuple(slice(None, None, s)
                                                   for s in strides)]
        strides = (1,) * nd
    y = _CONV[nd](xc, conv_weight(w), stride=strides, groups=groups)
    return _channels_last(y)


def _out_extent(n: int, k: int, s: int, padding: str) -> int:
    return cdiv(n, s) if padding == "SAME" else (n - k) // s + 1


def _window_place(x: Sharded, k: int, s: int) -> tuple:
    """``x``'s placement for a window op (width ``k``, stride ``s`` on the
    leading spatial dim): the leading spatial dim stays split where no
    window crosses a block edge (k ≤ s and the block a whole number of
    strides); it and every other spatial dim are whole otherwise."""
    place = list(x.place)
    if place[1] and not (k <= s and x.local.shape[1] % s == 0):
        place[1] = ()
    for d in range(2, x.dim() - 1):
        place[d] = ()
    return tuple(place)


class Conv(nn.Module):
    """N-D convolution, channels-last: x[N, *spatial, C] → y[N, *spatial', F],
    weight w[*K, C/groups, F] (HWIO), logical axes (conv_k, None, ...,
    conv_in, conv_out)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: tuple[int, ...], strides: tuple[int, ...] | None = None,
                 padding: str = "SAME", use_bias: bool = True,
                 feature_group_count: int = 1, *, device: torch.device,
                 generator: torch.Generator, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = tuple(kernel)
        self.strides = tuple(strides) if strides else None
        self.padding = padding
        self.use_bias = use_bias
        self.feature_group_count = feature_group_count
        nd = len(self.kernel)
        self.w = fan_in_normal(
            self.kernel + (in_channels // feature_group_count, out_channels),
            tuple(range(nd + 1)), generator, device, dtype,
            axes=("conv_k",) + (None,) * (nd - 1) + ("conv_in", "conv_out"))
        if use_bias:
            self.b = constant((out_channels,), 0.0, device, dtype,
                              axes=("conv_out",))

    def forward(self, x, ctx: ShardingCtx):
        if isinstance(x, Sharded):
            return self._sharded(x, ctx)
        nd = len(self.kernel)
        strides = self.strides or (1,) * nd
        pads = _spatial_pads(x.shape[1:-1], self.kernel, strides, self.padding)
        y = conv_local(x, self.w, strides, pads, self.feature_group_count)
        return y + self.b if self.use_bias else y

    def _local(self, x: torch.Tensor, w: torch.Tensor, strides, pads,
               ctx: ShardingCtx, whole: bool) -> torch.Tensor:
        """The conv of one rank's block (``whole``: its spatial dims are the
        whole image's); ``HaloConv`` runs it on the kernel."""
        return conv_local(x, w, strides, pads, self.feature_group_count)

    def _sharded(self, x: Sharded, ctx: ShardingCtx) -> Sharded:
        if self.feature_group_count != 1:
            raise NotImplementedError("a grouped conv across ranks is not "
                                      "ported (no CNN of the paper has one)")
        mesh, nd = x.mesh, len(self.kernel)
        strides = self.strides or (1,) * nd
        w = param_block(self.w, mesh)
        w = w.relayout(((),) * nd + w.place[nd:])
        cin, cout = w.place[nd], w.place[nd + 1]
        place = _window_place(x, self.kernel[0], strides[0])
        x = x.relayout(place[:-1] + (cin,))
        pads = _spatial_pads(x.shape[1:-1], self.kernel, strides, self.padding)
        if place[1]:          # no window crosses a block edge: no padding
            pads[0] = (0, 0)
        y = self._local(x.local, w.local, strides, pads, ctx,
                        whole=not place[1])
        if cin:
            y = C.all_reduce(y, mesh.group(cin))
        if self.use_bias:
            y = y + param_block(self.b, mesh).relayout((cout,)).local
        shape = (x.shape[0],) + tuple(
            _out_extent(n, k, s, self.padding)
            for n, k, s in zip(x.shape[1:-1], self.kernel, strides)) + (
            w.shape[-1],)
        return Sharded(y, shape, place[:-1] + (cout,), mesh)


def max_pool(x, window: tuple[int, ...], strides: tuple[int, ...] | None = None,
             padding: str = "SAME"):
    """Max over windows of a channels-last tensor; SAME pads with −inf."""
    strides = strides or window
    if isinstance(x, Sharded):
        place = _window_place(x, window[0], strides[0])
        x = x.relayout(place)
        pads = _spatial_pads(x.shape[1:-1], window, strides, padding)
        if place[1]:
            pads[0] = (0, 0)
        y = _max_pool_local(x.local, window, strides, pads)
        shape = (x.shape[0],) + tuple(
            _out_extent(n, k, s, padding)
            for n, k, s in zip(x.shape[1:-1], window, strides)) + (
            x.shape[-1],)
        return Sharded(y, shape, place, x.mesh)
    pads = _spatial_pads(x.shape[1:-1], window, strides, padding)
    return _max_pool_local(x, window, strides, pads)


def _max_pool_local(x, window, strides, pads):
    xc = _pad(_channels_first(x), pads, value=float("-inf"))
    return _channels_last(_MAX_POOL[len(window)](xc, window, strides))


def global_avg_pool(x):
    """Mean over the spatial dims; on a ``Sharded`` input the sums are
    all-reduced over the ranks that split the image."""
    if isinstance(x, Sharded):
        mesh, dims = x.mesh, tuple(range(1, x.dim() - 1))
        s = x.local.sum(dim=dims)
        split = axes_of(mesh, x.place[1:-1])
        if split:
            s = C.all_reduce(s, mesh.group(split))
        n = 1
        for d in x.shape[1:-1]:
            n *= d
        return Sharded(s / n, (x.shape[0], x.shape[-1]),
                       (x.place[0], x.place[-1]), mesh)
    return x.mean(dim=tuple(range(1, x.dim() - 1)))


def flatten(x):
    """(B, ...) → (B, prod(...)) in row-major order, as ``reshape`` (on a
    ``Sharded`` input every dim but the batch is gathered first)."""
    if isinstance(x, Sharded):
        x = x.relayout((x.place[0],) + ((),) * (x.dim() - 1))
        n = 1
        for d in x.shape[1:]:
            n *= d
        return Sharded(x.local.reshape(x.local.shape[0], n), (x.shape[0], n),
                       (x.place[0], ()), x.mesh)
    return x.reshape(x.shape[0], -1)
