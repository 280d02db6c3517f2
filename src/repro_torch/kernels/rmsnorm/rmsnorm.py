"""Wrapper of the fused RMSNorm CUDA kernel (``csrc/rmsnorm.cu``).

Same contract as the JAX package's ``kernels/rmsnorm/rmsnorm.py``: x
(..., D) in float32 or bfloat16, a (D,) float32 scale, the result in x's
dtype. The TPU row block (``block_rows``, padded for prime row counts) is
not carried over: the CUDA kernel gives each row its own block, so any row
count runs as it is.

A CPU tensor goes to the plain version (``ref.rmsnorm_ref``); a CUDA tensor
launches the kernel or raises. There is no backward kernel, so a call that
autograd would have to differentiate raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import load
from .ref import rmsnorm_ref

_ENTRY = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                          ctypes.c_int,
                                                          ctypes.c_void_p]


@functools.cache
def _kernel_fn(dtype: torch.dtype):
    fn = getattr(load("rmsnorm"), _ENTRY[dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); scale: (D,) → x·rsqrt(mean(x²) + eps)·scale, row-wise."""
    if x.dim() == 0 or tuple(scale.shape) != (x.shape[-1],):
        raise ValueError(f"rmsnorm takes x (..., D) and scale (D,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        raise NotImplementedError(
            "rmsnorm has no backward kernel; differentiate through the plain "
            "version (use_pallas=False) or call it under torch.no_grad()")

    if x.device.type == "cpu" and scale.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)

    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, scale on {scale.device}; "
                         f"both must be on one CUDA device")
    if x.dtype not in _ENTRY or scale.dtype != torch.float32:
        raise TypeError(f"rmsnorm takes float32 or bfloat16 x and a float32 "
                        f"scale, got {x.dtype} and {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm takes a contiguous x and scale")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    D = x.shape[-1]
    rows = x.numel() // D
    if rows >= 2 ** 31:
        raise ValueError("rmsnorm launches one block per row: fewer than "
                         "2^31 rows")
    # 16-byte vector loads where every row starts on a 16-byte boundary
    vec = all(t.data_ptr() % 16 == 0 for t in (x, scale, y)) \
        and (D * x.element_size()) % 16 == 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel_fn(x.dtype)(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                                 rows, D, eps, int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0   # kernel launches since the caller last reset it
