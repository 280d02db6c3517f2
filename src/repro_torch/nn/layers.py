"""Core layers: Dense, Embedding, RMSNorm, Conv (1/2/3-D), BatchNorm, pooling.

Counterparts of ``repro.nn.layers`` with the same layouts and numerics:
activations channels-last (N, *spatial, C), conv weights (*K, C, F), dense
weights (in, out), embedding tables (vocab, features), so parameters carry
over from JAX without a transpose. Every module takes ``forward(x, ctx)``;
the CNN stack and the LM build on these.

Where PyTorch's defaults differ from XLA's, the port pads by hand: SAME
padding is XLA's asymmetric split (``kernels.util.same_pads``), for the
convolutions with zeros and for ``max_pool`` with −inf.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rmsnorm.ref import rmsnorm_ref
from ..kernels.rmsnorm.rmsnorm import rmsnorm
from ..kernels.util import conv_weight, same_pads
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
    """y = x @ w (+ b), w: (in_dim, out_dim)."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = False, *,
                 device: torch.device, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_bias = use_bias
        self.w = fan_in_normal((in_dim, out_dim), (0,), generator, device, dtype)
        if use_bias:
            self.b = constant((out_dim,), 0.0, device, dtype)

    def forward(self, x, ctx: ShardingCtx):
        y = x @ self.w
        return y + self.b if self.use_bias else y


class Embedding(nn.Module):
    """``table[ids]``, table: (vocab_size, features), LeCun normal over the
    features as in the reference."""

    def __init__(self, vocab_size: int, features: int, *,
                 device: torch.device, generator: torch.Generator | None,
                 dtype: torch.dtype):
        super().__init__()
        self.table = fan_in_normal((vocab_size, features), (1,), generator,
                                   device, dtype)

    def forward(self, ids, ctx: ShardingCtx):
        return self.table[ids]


class RMSNorm(nn.Module):
    """x·rsqrt(mean(x²) + eps)·scale over the last dim, in fp32, cast back to
    x's dtype; the scale is fp32, as the reference's tree default makes it.
    With ``ctx.use_pallas`` it runs the fused kernel, else its plain
    version."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device: torch.device):
        super().__init__()
        self.eps = eps
        self.scale = constant((dim,), 1.0, device)

    def forward(self, x, ctx: ShardingCtx):
        norm = rmsnorm if ctx.use_pallas else rmsnorm_ref
        return norm(x, self.scale, eps=self.eps)


class BatchNorm(nn.Module):
    """BatchNorm over every axis but the last, always with batch statistics.

    As in the reference (``repro.nn.layers.BatchNorm``): no running
    statistics (``train`` is accepted and ignored), fp32 math, variance as
    E[x²] − μ², eps 1e-5, result cast back to x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, *, device: torch.device):
        super().__init__()
        self.eps = eps
        self.scale = constant((dim,), 1.0, device)
        self.bias = constant((dim,), 0.0, device)

    def forward(self, x, ctx: ShardingCtx, train: bool = True):
        xf = x.float()
        axes = tuple(range(x.dim() - 1))
        mu = xf.mean(axes)
        var = (xf * xf).mean(axes) - mu * mu
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)


class Conv(nn.Module):
    """N-D convolution, channels-last: x[N, *spatial, C] → y[N, *spatial', F],
    weight w[*K, C/groups, F] (HWIO)."""

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
            tuple(range(nd + 1)), generator, device, dtype)
        if use_bias:
            self.b = constant((out_channels,), 0.0, device, dtype)

    def forward(self, x, ctx: ShardingCtx):
        nd = len(self.kernel)
        strides = self.strides or (1,) * nd
        pads = _spatial_pads(x.shape[1:-1], self.kernel, strides, self.padding)
        xc = _pad(_channels_first(x), pads)
        if set(self.kernel) == {1}:
            # a strided 1×1 conv reads every s-th pixel: take those first and
            # run it at stride 1. Same values and gradients, and it keeps off
            # PyTorch 2.13's CPU backward for strided 1×1 convs, which
            # corrupts the heap (abort or segfault in most runs of a loop).
            xc = xc[(slice(None), slice(None)) + tuple(slice(None, None, s)
                                                       for s in strides)]
            strides = (1,) * nd
        y = _CONV[nd](xc, conv_weight(self.w), stride=strides,
                      groups=self.feature_group_count)
        y = _channels_last(y)
        return y + self.b if self.use_bias else y


def max_pool(x, window: tuple[int, ...], strides: tuple[int, ...] | None = None,
             padding: str = "SAME"):
    """Max over windows of a channels-last tensor; SAME pads with −inf."""
    strides = strides or window
    pads = _spatial_pads(x.shape[1:-1], window, strides, padding)
    xc = _pad(_channels_first(x), pads, value=float("-inf"))
    return _channels_last(_MAX_POOL[len(window)](xc, window, strides))


def global_avg_pool(x):
    return x.mean(dim=tuple(range(1, x.dim() - 1)))
