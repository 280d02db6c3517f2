"""Wrapper of the implicit-GEMM conv2d CUDA kernel (``csrc/conv2d_gemm.cu``).

Same contract as the JAX package's ``kernels/conv2d_gemm/conv2d_gemm.py``:
SAME conv, NHWC × HWIO → NHWC, any stride, output in x's dtype, and the
halo-aware entry ``pad_h=False`` (H already carries its kh−1 boundary rows:
VALID over H, SAME over W, stride 1 only). The TPU tile ``block_f`` is not
carried over: the CUDA kernel uses fixed tiles and masks the ragged edges.

A CPU tensor goes to the plain version (``ref.conv2d_padded``); a CUDA
tensor launches the kernel or raises. There is no backward kernel yet, so a
call that autograd would have to differentiate raises, as ``jax.grad``
through the Pallas kernel does.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load
from ..util import cdiv, same_pads
from .ref import conv2d_padded

_ENTRY = {torch.float32: "conv2d_gemm_f32", torch.bfloat16: "conv2d_gemm_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [ctypes.c_void_p]


def _kernel_fn(dtype: torch.dtype):
    fn = getattr(load("conv2d_gemm"), _ENTRY[dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def conv2d_gemm(x: torch.Tensor, w: torch.Tensor, *, strides=(1, 1),
                pad_h: bool = True) -> torch.Tensor:
    """SAME conv with arbitrary strides. x: (B,H,W,C); w: (kh,kw,C,F).

    ``pad_h=False`` is the halo-aware variant: the output has H − kh + 1
    rows (VALID over H, SAME over W), stride 1 only."""
    sh, sw = (strides, strides) if isinstance(strides, int) else strides
    if not pad_h and (sh, sw) != (1, 1):
        raise ValueError(f"halo-aware conv2d_gemm is stride-1 only, "
                         f"got strides={(sh, sw)}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv2d_gemm takes x (B,H,W,C) and w (kh,kw,C,F), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    B, H, W, C = x.shape
    kh, kw, Cw, F = w.shape
    if C != Cw:
        raise ValueError(f"conv2d_gemm: x has {C} channels, w expects {Cw}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "conv2d_gemm has no backward kernel (ROADMAP: differentiable "
            "conv2d_gemm, dgrad/wgrad kernels); train through the plain conv "
            "(use_pallas=False) or call it under torch.no_grad()")
    if not pad_h and H < kh:
        raise ValueError(f"halo-aware conv2d_gemm: H={H} < kh={kh}")
    Ho = H - kh + 1 if not pad_h else cdiv(H, sh)
    Wo = cdiv(W, sw)
    pads_h = same_pads(H, kh, sh) if pad_h else (0, 0)
    pads_w = same_pads(W, kw, sw)

    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv2d_padded(x, w, (sh, sw), pads_h, pads_w)

    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"conv2d_gemm: x on {x.device}, w on {w.device}; "
                         f"both must be on one CUDA device")
    if x.dtype not in _ENTRY or w.dtype != x.dtype:
        raise TypeError(f"conv2d_gemm takes float32 or bfloat16 x and w of "
                        f"one dtype, got {x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d_gemm takes contiguous NHWC x and HWIO w")
    if max(x.numel(), w.numel(), B * Ho * Wo * F) >= 2 ** 31:
        raise ValueError("conv2d_gemm indexes with 32-bit ints: every tensor "
                         "must hold fewer than 2^31 elements")
    y = torch.empty((B, Ho, Wo, F), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel_fn(x.dtype)(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                 B, H, W, C, F, kh, kw, sh, sw, Ho, Wo,
                                 pads_h[0], pads_w[0], stream)
    if rc != 0:
        raise RuntimeError(f"conv2d_gemm kernel launch failed: CUDA error {rc}")
    conv2d_gemm.launches += 1
    return y


conv2d_gemm.launches = 0   # kernel launches since the caller last reset it
