"""Wrapper of the implicit-GEMM conv2d CUDA kernel (``csrc/conv2d_gemm.cu``).

Same contract as the JAX package's ``kernels/conv2d_gemm/conv2d_gemm.py``:
SAME conv, NHWC × HWIO → NHWC, any stride, output in x's dtype, and the
halo-aware entry ``pad_h=False`` (H already carries its kh−1 boundary rows:
VALID over H, SAME over W, stride 1 only). The TPU tile ``block_f`` is not
carried over: the CUDA kernel picks its own tiles and masks the ragged edges.

The kernel runs on the tensor cores: fp32 as 3×TF32 (each operand split
into a TF32 high part and its remainder, three products summed in fp32),
bf16 as one exact TF32 product. Each call runs up to three kernels: a prep
that writes w transposed (K-major, as ``wgmma`` takes TF32 operands) and
split into scratch, the GEMM over ``split`` ranges of K, and, where
``split > 1``, a reduce that adds the ranges' fp32 partial sums in a fixed
order (``split_plan`` chooses the tiles and the split from the shape). The
launch counter counts calls: one per conv.

A CPU tensor goes to the plain version (``ref.conv2d_padded``); a CUDA
tensor launches the kernel or raises. There is no backward kernel yet, so a
call that autograd would have to differentiate raises, as ``jax.grad``
through the Pallas kernel does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import load
from ..util import cdiv, same_pads
from .ref import conv2d_padded

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 16 + (ctypes.c_void_p,)
# the prep's (w, wt, K, F, Kp) and the reduce's (ws, y, split, M·F), then
# the stream
_PREP_ARGTYPES = (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 3 + (
    ctypes.c_void_p,)
_REDUCE_ARGTYPES = (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 2 + (
    ctypes.c_void_p,)

# the kernel's output-pixel tile and k-tile (BM and BK in the .cu, which
# checks the scratch's row length Kp the wrapper passes against K)
BLOCK_M, BLOCK_K = 128, 32
MAX_SPLIT = 16


def split_plan(M: int, N: int, K: int, sms: int) -> tuple[int, int]:
    """``(block_n, split)`` for an (M × K)·(K × N) conv GEMM on ``sms`` SMs.

    Tiles are 128 output pixels × ``block_n`` filters (64 where N ≤ 64).
    Where the tiles alone cannot fill the SMs (ResNet-50's stages 2–4), K is
    cut into ``split`` ranges of whole k-tiles, each a block of its own, one
    block per SM at a time. The split is the smallest of least cost, counted
    in k-tiles: waves × (k-tiles per range + 1 for the block's prologue and
    epilogue), + 1 for the reduce where split > 1; no range is left empty.
    On an H100 this picks the fastest of splits 1–6, or one within 0.6 %
    of it, at each of ResNet-50's shapes (``scripts/conv_gemm_study.py``)."""
    block_n = 64 if N <= 64 else 128
    tiles = cdiv(M, BLOCK_M) * cdiv(N, block_n)
    k_tiles = cdiv(K, BLOCK_K)
    best = (float("inf"), 1)
    for split in range(1, min(k_tiles, MAX_SPLIT) + 1):
        per = cdiv(k_tiles, split)
        if cdiv(k_tiles, per) != split:
            continue
        cost = cdiv(tiles * split, sms) * (per + 1) + (split > 1)
        if cost < best[0]:
            best = (cost, split)
    return block_n, best[1]


@functools.cache
def _fn(name: str, argtypes: tuple):
    fn = getattr(load("conv2d_gemm"), name)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


@functools.cache
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``, for ``split_plan``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(rc: int, what: str):
    if rc >= 10000:
        raise RuntimeError(f"conv2d_gemm {what} failed: B's tensor map, "
                           f"CUresult {rc - 10000}")
    if rc != 0:
        raise RuntimeError(f"conv2d_gemm {what} failed: CUDA error {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _scratch_w(w: torch.Tensor) -> torch.Tensor:
    """(parts, F, Kp) fp32: w transposed, K padded to whole k-tiles; two
    parts (hi, lo) for fp32 w, one for bf16."""
    kh, kw, C, F = w.shape
    parts = 2 if w.dtype == torch.float32 else 1
    return torch.empty((parts, F, cdiv(kh * kw * C, BLOCK_K) * BLOCK_K),
                       dtype=torch.float32, device=w.device)


def weight_prep(w: torch.Tensor) -> torch.Tensor:
    """The prep kernel alone, as ``conv2d_gemm`` runs it first: w (kh, kw,
    C, F) on the card → the scratch of ``_scratch_w``. For timing; not a
    conv, so not counted."""
    wt = _scratch_w(w)
    kh, kw, C, F = w.shape
    with torch.cuda.device(w.device):
        _check(_fn(f"conv2d_gemm_prep_{_SUFFIX[w.dtype]}", _PREP_ARGTYPES)(
            w.data_ptr(), wt.data_ptr(), kh * kw * C, F, wt.shape[-1],
            _stream(w)), "prep launch")
    return wt


def split_reduce(ws: torch.Tensor, y: torch.Tensor):
    """The reduce kernel alone: y = ws.sum(0) in range order, cast to y's
    dtype; ws (split, M, F) fp32. For timing; not counted."""
    with torch.cuda.device(y.device):
        fn = _fn(f"conv2d_gemm_reduce_{_SUFFIX[y.dtype]}", _REDUCE_ARGTYPES)
        _check(fn(ws.data_ptr(), y.data_ptr(), ws.shape[0], y.numel(),
                  _stream(y)), "reduce launch")


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
    if x.dtype not in _SUFFIX or w.dtype != x.dtype:
        raise TypeError(f"conv2d_gemm takes float32 or bfloat16 x and w of "
                        f"one dtype, got {x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d_gemm takes contiguous NHWC x and HWIO w")
    M, K = B * Ho * Wo, kh * kw * C
    block_n, split = split_plan(M, F, K, sm_count(x.device.index or 0))
    if max(x.numel(), w.numel(), split * M * F,
           2 * F * cdiv(K, BLOCK_K) * BLOCK_K) >= 2 ** 31:
        raise ValueError("conv2d_gemm indexes with 32-bit ints: every tensor "
                         "and scratch must hold fewer than 2^31 elements")
    y = torch.empty((B, Ho, Wo, F), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    wt = _scratch_w(w)
    ws = torch.empty((split, M, F), dtype=torch.float32, device=x.device) \
        if split > 1 else None
    with torch.cuda.device(x.device):
        rc = _fn(f"conv2d_gemm_{_SUFFIX[x.dtype]}", _ARGTYPES)(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), wt.data_ptr(),
            None if ws is None else ws.data_ptr(), B, H, W, C, F, kh, kw, sh,
            sw, Ho, Wo, pads_h[0], pads_w[0], wt.shape[-1], block_n, split,
            _stream(x))
    _check(rc, "kernel launch")
    conv2d_gemm.launches += 1
    return y


conv2d_gemm.launches = 0   # calls that launched the kernel since the reset
