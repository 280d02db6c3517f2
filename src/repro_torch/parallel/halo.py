"""Spatial parallelism with overlapped halo exchange — paper §3.2 / [13]
(counterpart of ``repro.parallel.halo``).

Convolutions whose input is split along its leading spatial dim need
boundary rows from the neighbouring ranks. ``spatial_conv2d`` starts the
exchange first (``isend``/``irecv`` between ring neighbours of the mesh
axis, zero rows at the global edges, as the unsharded op's SAME padding),
enqueues the interior conv — the output rows whose windows touch only local
data — before it waits for the rows, then computes just the boundary rows
from the received halos and stitches. Every output row is the same
reduction over the same window as the unsharded SAME conv. The exchange is
an autograd function pair whose backward is the transposed exchange: each
rank sends the gradients of the halo rows it received back to their owner,
which adds them to its boundary rows (and that transfer, too, is started
before the interior conv's backward and waited on after it).

``HaloConv`` deploys this through the strategy rules: a ``Conv`` whose
forward takes the halo path when the rules split the "spatial" logical axis
onto one mesh axis that evenly divides the input's leading spatial dim (the
``spatial``/``ds`` tables), and the plain (placement-following) ``Conv``
otherwise: strides, grouped convs, non-SAME padding, thin shards, a
multi-axis or non-dividing split. With ``ctx.use_pallas`` its 2-D local
convs run on the implicit-GEMM CUDA kernel: the boundary and interior tiles
through its halo-aware ``pad_h=False`` entry, a whole image through the
SAME entry; the kernel has no backward, so training runs the plain conv.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..kernels import conv2d_gemm
from ..nn.layers import Conv, conv_local
from ..nn.module import ShardingCtx
from .sharded import Sharded, param_block, placement


def _halo_sizes(kh: int) -> tuple[int, int]:
    """(rows needed from the upper neighbour, rows from the lower) for a
    SAME conv of width kh — XLA's SAME convention: pad_lo = (kh−1)//2,
    pad_hi = kh//2, so even widths split asymmetrically."""
    return (kh - 1) // 2, kh // 2


class _Transfer:
    """The pending sends and receives of one exchange (forward or
    backward), shared by the two halves of the autograd pair."""

    def __init__(self, group, device):
        self.group, self.device = group, device
        self.works, self.recv = [], {}

    def post(self, sends: dict, recvs: dict):
        """``sends``/``recvs``: {neighbour index in the group: tensor}."""
        with record_function("comm.halo_post"):
            self._post(sends, recvs)

    def _post(self, sends: dict, recvs: dict):
        g = self.group
        for j, t in sends.items():
            buf = t.detach().cpu().contiguous() if g.stage else \
                t.detach().contiguous()
            self.works.append(dist.isend(buf, g.ranks[j], group=g.pg))
            self.recv.setdefault("_keep", []).append(buf)
        for j, like in recvs.items():
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device="cpu" if g.stage else like.device)
            self.works.append(dist.irecv(buf, g.ranks[j], group=g.pg))
            self.recv[j] = buf

    def wait(self) -> dict:
        with record_function("comm.halo_wait"):
            for w in self.works:
                w.wait()
            self.works = []
            self.recv.pop("_keep", None)
            out = {j: b.to(self.device) for j, b in self.recv.items()}
            self.recv = {}
            return out


class _Start(torch.autograd.Function):
    """Posts the forward transfers; returns an empty token that orders
    ``_Finish`` after it. Its backward waits for the transposed transfers
    ``_Finish.backward`` posted and adds the returned gradients to the
    boundary rows."""

    @staticmethod
    def forward(ctx, x, lo, hi, box):
        g, i = box.group, box.group.index
        sends, recvs = {}, {}
        if lo and i + 1 < g.size:        # my bottom rows → the lower one
            sends[i + 1] = x[:, x.shape[1] - lo:]
        if hi and i > 0:                  # my top rows → the upper one
            sends[i - 1] = x[:, :hi]
        if lo and i > 0:
            recvs[i - 1] = x[:, :lo]
        if hi and i + 1 < g.size:
            recvs[i + 1] = x[:, :hi]
        box.post(sends, recvs)
        ctx.lo, ctx.hi, ctx.box, ctx.shape = lo, hi, box, x.shape
        return x.new_empty(0)

    @staticmethod
    def backward(ctx, _token):
        got = ctx.box.wait()
        i, lo, hi = ctx.box.group.index, ctx.lo, ctx.hi
        gx = torch.zeros(ctx.shape, dtype=_token.dtype,
                         device=ctx.box.device)
        if i + 1 in got:        # gradients of my bottom rows, from below
            gx[:, ctx.shape[1] - lo:] += got[i + 1]
        if i - 1 in got:        # gradients of my top rows, from above
            gx[:, :hi] += got[i - 1]
        return gx, None, None, None


class _Finish(torch.autograd.Function):
    """Waits for the forward transfers: (rows from the upper neighbour,
    rows from the lower), zeros at the global edges. Its backward posts the
    transposed transfers."""

    @staticmethod
    def forward(ctx, token, x_shape_like, lo, hi, box):
        got = box.wait()
        i = box.group.index
        like = x_shape_like
        up = got.get(i - 1) if lo else None
        down = got.get(i + 1) if hi else None
        if up is None:
            up = like.new_zeros((like.shape[0], lo) + tuple(like.shape[2:]))
        if down is None:
            down = like.new_zeros((like.shape[0], hi) + tuple(like.shape[2:]))
        ctx.lo, ctx.hi, ctx.box = lo, hi, box
        return up, down

    @staticmethod
    def backward(ctx, g_up, g_down):
        box, i = ctx.box, ctx.box.group.index
        sends, recvs = {}, {}
        if ctx.lo and i > 0:
            sends[i - 1] = g_up          # to the owner of those rows
        if ctx.hi and i + 1 < box.group.size:
            sends[i + 1] = g_down
        if ctx.lo and i + 1 < box.group.size:
            recvs[i + 1] = g_up          # my bottom rows' gradients
        if ctx.hi and i > 0:
            recvs[i - 1] = g_down        # my top rows' gradients
        box.post(sends, recvs)
        return g_up.new_empty(0), None, None, None, None


def _exchange_start(x: torch.Tensor, lo: int, hi: int, group):
    box = _Transfer(group, x.device)
    return _Start.apply(x, lo, hi, box), box


def _exchange_finish(token, x: torch.Tensor, lo: int, hi: int, box):
    return _Finish.apply(token, x.detach(), lo, hi, box)


def halo_exchange(x: torch.Tensor, halo: int | tuple[int, int], group):
    """Exchange halo rows (dim 1) with ring neighbours of ``group``.

    ``halo`` is (lo, hi) — rows fetched from the upper / lower neighbour —
    or a single int for a symmetric exchange. x: (B, H_local, ..., C), this
    rank's block; returns (B, lo + H_local + hi, ..., C) with zeros at the
    global boundary (= the unsharded op's SAME zero padding)."""
    lo, hi = (halo, halo) if isinstance(halo, int) else halo
    if lo == 0 and hi == 0:
        return x
    if x.shape[1] < max(lo, hi):
        raise ValueError(
            f"shard too thin for the halo: H_local={x.shape[1]} < "
            f"halo={max(lo, hi)} (p={group.size}) — one-hop neighbour "
            f"exchange cannot serve this kernel; use fewer spatial shards")
    token, box = _exchange_start(x, lo, hi, group)
    up, down = _exchange_finish(token, x, lo, hi, box)
    return torch.cat([up, x, down], dim=1)


def _local_conv(xl, w, trail_pads, use_pallas: bool):
    """VALID-over-dim-1 conv of a local tile (trailing spatial dims SAME).
    The kernel path is 2-D only and takes the tile through the halo-aware
    entry (H pre-padded by the exchange)."""
    if use_pallas and xl.dim() == 4:
        return conv2d_gemm(xl.contiguous(), w.contiguous(), pad_h=False)
    nd = xl.dim() - 2
    return conv_local(xl, w, (1,) * nd, [(0, 0)] + list(trail_pads))


def spatial_conv2d(x: Sharded, w: torch.Tensor, mesh, axis: str = "model",
                   bias: torch.Tensor | None = None, *,
                   strides: Sequence[int] | None = None, overlap: bool = True,
                   use_pallas: bool = False) -> Sharded:
    """N-D conv (stride 1, SAME) with the leading spatial dim split over
    ``axis``.

    x: a ``Sharded`` (B, H, *spatial, C), re-laid out (if it is not) with H
    split over ``axis``, its batch split as it is, the rest whole; w: the
    whole (kh, *k, C, F) weight; bias: the whole (F,). Matches the unsharded
    SAME conv — including even kernel widths (asymmetric halos) and p = 1
    (degenerates to the serial conv).

    ``overlap=True`` (default) computes the interior rows while the halo
    transfers are in flight; ``overlap=False`` keeps the serial
    exchange-then-conv pipeline (same values, reference for parity checks).
    Spatial parallelism cannot stride the split dim (block boundaries would
    fall between stride phases), so any stride ≠ 1 raises."""
    nd = x.dim() - 2
    if strides is not None and tuple(strides) != (1,) * nd:
        raise ValueError(
            f"spatial_conv2d is stride-1 only (got strides={tuple(strides)});"
            f" strided convs cannot split the sharded spatial dim — keep "
            f"them on the unsharded path (HaloConv falls back automatically)")
    group = mesh.group(axis)
    place = (x.place[0],) + placement(mesh, (axis,)) + ((),) * nd
    x = x.relayout(place)
    kh = w.shape[0]
    lo, hi = _halo_sizes(kh)
    trail_pads = tuple(_halo_sizes(k) for k in w.shape[1:nd])
    xl = x.local
    H = xl.shape[1]

    def conv(t):
        return _local_conv(t, w, trail_pads, use_pallas)

    if not overlap or H <= lo + hi:
        # serial reference path (also the thin-shard fallback where the
        # interior would be empty — H == lo+hi included: a zero-row
        # interior is illegal for the kernel): full exchange, one conv
        y = conv(halo_exchange(xl, (lo, hi), group))
    else:
        # 1. start the halo transfers
        token, box = _exchange_start(xl, lo, hi, group)
        # 2. interior rows [lo, H−hi) depend only on local data: enqueued
        #    before the transfers are waited on
        interior = conv(xl)
        # 3. boundary rows from the received halos, then stitch. An even
        #    kernel has lo = 0 (XLA SAME pads below only): that side
        #    contributes no rows and must not reach the conv — a zero-row
        #    tile is illegal for the kernel.
        up, down = _exchange_finish(token, xl, lo, hi, box)
        pieces = [interior]
        if lo:
            pieces.insert(0, conv(torch.cat([up, xl[:, :lo + hi]], dim=1)))
        if hi:
            pieces.append(conv(torch.cat([xl[:, H - (lo + hi):], down],
                                         dim=1)))
        y = torch.cat(pieces, dim=1) if len(pieces) > 1 else interior
    if bias is not None:
        y = y + bias
    return Sharded(y, x.shape[:-1] + (w.shape[-1],), place, mesh)


class HaloConv(Conv):
    """``Conv`` that executes as the overlapped halo pipeline when sharded.

    Same parameters; ``forward`` inspects the ctx: when the rules split the
    model's "spatial" logical axis onto ONE mesh axis that evenly divides
    the input's leading spatial dim (the ``spatial``/``ds`` tables), the
    conv runs as ``spatial_conv2d``. Anything the explicit path cannot take
    falls back to the plain conv, so the layer is always safe to deploy."""

    overlap: bool = True

    def _spatial_sharding(self, ctx: ShardingCtx, x: Sharded):
        """The mesh axis when the explicit halo path applies, else None."""
        nd = len(self.kernel)
        if nd < 2 or self.feature_group_count != 1 or self.kernel[0] <= 1:
            return None
        if self.padding != "SAME":   # the halo exchange IS the SAME padding
            return None
        if self.strides is not None and tuple(self.strides) != (1,) * nd:
            return None
        axes = ("batch", "spatial") + (None,) * (nd - 1) + ("conv_out",)
        sp = ctx.pspec(axes, x.shape)[1]
        if sp is None or isinstance(sp, tuple):
            return None
        p = ctx.mesh.shape[sp]
        lo, hi = _halo_sizes(self.kernel[0])
        if p <= 1 or x.shape[1] % p or x.shape[1] // p < max(lo, hi):
            return None
        return sp

    def _kernel_ok(self, ctx: ShardingCtx) -> bool:
        return ctx.use_pallas and len(self.kernel) == 2 \
            and self.feature_group_count == 1 and self.padding == "SAME"

    def forward(self, x, ctx: ShardingCtx):
        if isinstance(x, Sharded):
            axis = self._spatial_sharding(ctx, x)
            if axis is None:
                return self._sharded(x, ctx)
            w = param_block(self.w, x.mesh).full()
            b = param_block(self.b, x.mesh).full() if self.use_bias else None
            return spatial_conv2d(
                x, w, x.mesh, axis, bias=b, overlap=self.overlap,
                use_pallas=ctx.use_pallas and len(self.kernel) == 2)
        if self._kernel_ok(ctx):
            y = conv2d_gemm(x, self.w, strides=tuple(self.strides or (1, 1)))
            return y + self.b if self.use_bias else y
        return super().forward(x, ctx)

    def _local(self, x, w, strides, pads, ctx, whole):
        if whole and self._kernel_ok(ctx):
            return conv2d_gemm(x.contiguous(), w.contiguous(),
                               strides=tuple(strides))
        return super()._local(x, w, strides, pads, ctx, whole)
