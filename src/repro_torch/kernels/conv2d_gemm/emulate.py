"""The arithmetic of the tensor-core ``conv2d_gemm`` kernel
(``csrc/conv2d_gemm.cu``) in plain torch, on any device: for holding the
kernel's numerics against references where the kernel cannot run, and for
telling its own error apart from its reference's on the card.

A is the im2col matrix of x in HWIO's K order (di, dj, c), K zero-padded to
whole k-tiles; each operand is split into hi = TF32 rounded to nearest, ties
away from zero (``cvt.rna.tf32.f32``, done on the int32 bits) and lo = x −
hi, which the tensor core reads as TF32 by dropping its low 13 bits; every
k-step of 8 adds lo_a·hi_b, hi_a·lo_b, then hi_a·hi_b to an fp32
accumulator (each product of two TF32 values is exact in fp32); where the
wrapper splits K, each range of k-tiles has its own accumulator and the
ranges are added in order."""
from __future__ import annotations

import torch

from ..util import cdiv, same_pads
from .conv2d_gemm import BLOCK_K

K_STEP = 8          # K of one wgmma .tf32


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: the 13 low mantissa bits rounded off, ties away
    from zero (adding half of their range to the sign-magnitude bits)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """x as a tensor core reads an fp32 register as TF32: low 13 bits off."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _truncated_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 x to fp32 rounded toward zero."""
    r = x.float()
    return torch.where(r.double().abs() > x.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def im2col(x: torch.Tensor, kh: int, kw: int, s: int):
    """(M, K) matrix of SAME patches of NHWC x, K ordered (di, dj, c)."""
    B, H, W, C = x.shape
    Ho, Wo = cdiv(H, s), cdiv(W, s)
    xp = torch.nn.functional.pad(x, (0, 0, *same_pads(W, kw, s),
                                     *same_pads(H, kh, s)))
    taps = [xp[:, di:di + s * (Ho - 1) + 1:s, dj:dj + s * (Wo - 1) + 1:s]
            for di in range(kh) for dj in range(kw)]
    return torch.stack(taps, 3).reshape(B * Ho * Wo, kh * kw * C), (B, Ho, Wo)


def operands(x: torch.Tensor, w: torch.Tensor, s: int):
    """(A, W, (B, Ho, Wo)): the GEMM's fp32 operands, K padded to whole
    k-tiles as the kernel reads them."""
    kh, kw, C, F = w.shape
    A, out = im2col(x.float(), kh, kw, s)
    K = A.shape[1]
    Kp = cdiv(K, BLOCK_K) * BLOCK_K
    return (torch.nn.functional.pad(A, (0, Kp - K)),
            torch.nn.functional.pad(w.float().reshape(K, F),
                                    (0, 0, 0, Kp - K)), out)


def emulate(x: torch.Tensor, w: torch.Tensor, s: int, *, split: int = 1,
            products: int = 3, truncate: bool = False) -> torch.Tensor:
    """The kernel's fp32 arithmetic on NHWC x, HWIO w, on x's device (fp32
    matmuls there must not use TF32). ``products=1`` keeps hi·hi alone (one
    TF32 pass); ``truncate`` rounds every addition into the accumulator
    toward zero instead of to nearest."""
    A, Wm, (B, Ho, Wo) = operands(x, w, s)
    a_hi, w_hi = tf32_rna(A), tf32_rna(Wm)
    a_lo, w_lo = tf32_trunc(A - a_hi), tf32_trunc(Wm - w_hi)
    terms = [(a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)][3 - products:]
    k_tiles = A.shape[1] // BLOCK_K
    per = cdiv(k_tiles, split)
    y = None
    for z in range(split):
        acc = A.new_zeros((A.shape[0], Wm.shape[1]))
        for k0 in range(z * per * BLOCK_K,
                        min(k_tiles, (z + 1) * per) * BLOCK_K, K_STEP):
            ks = slice(k0, k0 + K_STEP)
            for a, b in terms:
                if truncate:
                    acc = _truncated_f32(acc.double()
                                         + a[:, ks].double() @ b[ks].double())
                else:
                    acc = acc + a[:, ks] @ b[ks]
        y = acc if y is None else y + acc
    return y.reshape(B, Ho, Wo, -1)
