"""``HaloConv``: the conv that ``models/cnn.py`` uses for its K>1 sites.

Counterpart of ``repro.parallel.halo.HaloConv``, unsharded branch only
(``halo.py:247-262``): with ``ctx.use_pallas`` a 2-D, group-1, SAME conv
runs on the implicit-GEMM CUDA kernel (``kernels/conv2d_gemm``) and the bias
is added afterwards; anything else falls back to the plain ``Conv``. The
sharded halo-exchange path comes with the spatial-parallel slice.
"""
from __future__ import annotations

from ..kernels import conv2d_gemm
from ..nn.layers import Conv
from ..nn.module import ShardingCtx


class HaloConv(Conv):
    def forward(self, x, ctx: ShardingCtx):
        if ctx.use_pallas and len(self.kernel) == 2 \
                and self.feature_group_count == 1 and self.padding == "SAME":
            y = conv2d_gemm(x, self.w, strides=tuple(self.strides or (1, 1)))
            return y + self.b if self.use_bias else y
        return super().forward(x, ctx)
