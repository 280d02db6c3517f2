"""Plain PyTorch version of ``conv2d_gemm``: SAME 2-D convolution, any
stride, channels-last (the counterpart of the JAX package's ``lax.conv``
oracle). The kernel wrapper sends CPU tensors here; ``chip_smoke.py`` holds
the CUDA kernel against it on the card."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..util import conv_weight, same_pads


def conv2d_padded(x: torch.Tensor, w: torch.Tensor, strides: tuple[int, int],
                  pads_h: tuple[int, int],
                  pads_w: tuple[int, int]) -> torch.Tensor:
    """x: (B, H, W, C); w: (kh, kw, C, F) → (B, Ho, Wo, F), zero padding
    (top, bottom) × (left, right) given explicitly."""
    xc = x.permute(0, 3, 1, 2)                  # NHWC viewed as NCHW
    if any(pads_h + pads_w):
        xc = F.pad(xc, (*pads_w, *pads_h))
    y = F.conv2d(xc, conv_weight(w), stride=tuple(strides))
    # channels-last in gives channels-last out, so this is normally a no-op;
    # the kernel takes only NHWC-contiguous inputs
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, strides=(1, 1)) -> torch.Tensor:
    """x: (B, H, W, C); w: (kh, kw, C, F) → (B, ⌈H/sh⌉, ⌈W/sw⌉, F)."""
    sh, sw = (strides, strides) if isinstance(strides, int) else strides
    return conv2d_padded(x, w, (sh, sw), same_pads(x.shape[1], w.shape[0], sh),
                         same_pads(x.shape[2], w.shape[1], sw))
