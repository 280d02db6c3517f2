"""Wrapper of the FlashAttention-2 forward CUDA kernels
(``csrc/flash_attention.cu``).

Same contract as the JAX package's ``flash_attention_fwd``: q, k, v of one
shape (B, H, S, D) in float32 or bfloat16, causal or not, the result in q's
dtype. The TPU tiles (``block_q``, ``block_k``, cut to divisors of S) are
not carried over: the CUDA kernels use fixed tiles and mask the ragged last
ones. bfloat16 runs on the tensor cores (``wgmma``, 128-row q tiles, P·V
with P split into two bf16 parts so it keeps the reference's fp32
accuracy); float32 on the FMA pipes (64-row q tiles). Both take D ≤ 128, a
multiple of 8, and any strides whose rows start on 16 bytes with the last
dim unit-stride: the model passes (B, H, S, D) views of its (B, S, H, D)
activations, and the result has q's layout.

A CPU tensor goes to the plain version (``ref.attention_ref``); a CUDA
tensor launches the kernel or raises. There is no backward kernel, so a call
that autograd would have to differentiate raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..build import load
from .ref import attention_ref

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p]
MAX_HEAD_DIM = 128
# q rows per block of each kernel; the grid holds at most 65535 q tiles
_Q_TILE = {torch.float32: 64, torch.bfloat16: 128}


@functools.cache
def _kernel_fn(dtype: torch.dtype):
    fn = getattr(load("flash_attention"), _ENTRY[dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _rows_aligned(t: torch.Tensor) -> bool:
    size = t.element_size()
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and \
        all(st * size % 16 == 0 for st in t.stride()[:3])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q, k, v: (B, H, S, D) → softmax(q·kᵀ/√D [causal mask])·v."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention takes q, k, v of one shape "
                         f"(B, H, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward kernel; differentiate through "
            "the plain attention (use_pallas=False) or call it under "
            "torch.no_grad()")

    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attention_ref(q, k, v, causal=causal)

    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}, "
                         f"v on {v.device}; all must be on one CUDA device")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, S, D = q.shape
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"flash_attention takes a head dim ≤ {MAX_HEAD_DIM} "
                         f"that is a multiple of 8, got {D}")
    o = torch.empty_like(q)          # q's strides when q is dense
    if not all(_rows_aligned(t) for t in (q, k, v, o)):
        raise ValueError("flash_attention takes tensors whose last dim is "
                         "contiguous and whose rows start on 16 bytes")
    tile = _Q_TILE[q.dtype]
    if S > 65535 * tile or B * H >= 2 ** 31:
        raise ValueError(f"flash_attention: S at most 65535 tiles of {tile}, "
                         f"B·H below 2^31")
    if o.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, o)
                                         for st in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel_fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), B, H, S, D, strides,
                                 1.0 / math.sqrt(D), int(causal), stream)
    if rc != 0:
        what = f"cuTensorMapEncodeTiled returned CUresult {rc - 10000}" \
            if rc >= 10000 else f"CUDA error {rc}"
        raise RuntimeError(f"flash_attention kernel launch failed: {what}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0   # kernel launches since the caller last reset it
