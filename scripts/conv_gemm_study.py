#!/usr/bin/env python3
"""Two questions about the tensor-core ``conv2d_gemm`` on one CUDA card, at
the fp32 conv cases of ``chip_smoke.py`` (ResNet-50's shapes at batch 32,
the same seeded inputs):

  split  the wrapper's whole call (prep, GEMM, reduce) timed at every split
         of K from 1 to 6 that leaves no range empty, and at the split
         ``split_plan`` picks; each output also held to the fp32 bar.
  error  where the kernel's distance from the plain conv comes from: the
         kernel, the plain conv (cuDNN fp32, TF32 off) and the kernel's
         arithmetic emulated in torch on the card (``emulate``: accumulation
         rounded to nearest, and rounded toward zero) each against an fp64
         GEMM of the same im2col, as ratios to the bar 1e-4 + 1e-4·|ref|;
         ``eq_*`` is the share of outputs bitwise equal to the kernel's.

    python3 scripts/conv_gemm_study.py

Needs a CUDA card; builds the kernel from the checkout at first use.
"""
from __future__ import annotations

import importlib
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels.conv2d_gemm.emulate import (emulate,  # noqa: E402
                                                     operands)
from repro_torch.kernels.conv2d_gemm.ref import conv2d_padded  # noqa: E402
from repro_torch.kernels.util import cdiv, same_pads  # noqa: E402

cg = importlib.import_module("repro_torch.kernels.conv2d_gemm.conv2d_gemm")
TOL = smoke.TOL[torch.float32]
MAX_SWEPT = 6


def ratio(out, ref) -> float:
    return smoke._bar_ratio(out.double(), ref.double(), TOL, TOL)


def splits(K: int, planned: int) -> list[int]:
    k_tiles = cdiv(K, cg.BLOCK_K)
    valid = [z for z in range(1, min(MAX_SWEPT, k_tiles) + 1)
             if cdiv(k_tiles, cdiv(k_tiles, z)) == z]
    return sorted(set(valid) | {planned})


def study(name, x, w, s, pad_h, dev):
    B, H, W, C = x.shape
    k, F = w.shape[0], w.shape[-1]
    pads_h = same_pads(H, k, s) if pad_h else (0, 0)
    y_p = conv2d_padded(x, w, (s, s), pads_h, same_pads(W, k, s))
    M, K = y_p.shape[0] * y_p.shape[1] * y_p.shape[2], k * k * C
    block_n, planned = cg.split_plan(M, F, K, cg.sm_count(dev.index or 0))
    plan = cg.split_plan
    times = {}
    try:
        for z in splits(K, planned):
            cg.split_plan = lambda *_, z=z: (block_n, z)

            def call():
                return cg.conv2d_gemm(x, w, strides=(s, s), pad_h=pad_h)
            bar = ratio(call(), y_p)
            if bar > 1.0:
                smoke.fail(f"{name} split {z}: {bar} times the bar")
            times[z] = smoke.kernel_ms(call)
    finally:
        cg.split_plan = plan
    best = min(times, key=times.get)
    print(f"[split] {name} M={M} F={F} K={K} block_n={block_n} "
          f"planned={planned} best={best} planned_over_best="
          f"{times[planned] / times[best]:.4f} "
          + " ".join(f"ms[{z}]={t:.5f}" for z, t in times.items()),
          flush=True)
    if not pad_h:       # the emulation covers the SAME entry only
        return
    y_k = cg.conv2d_gemm(x, w, strides=(s, s))
    A, Wm, _ = operands(x, w, s)
    y64 = (A.double() @ Wm.double()).reshape(y_p.shape)
    del A, Wm
    rn = emulate(x, w, s, split=planned)
    tr = emulate(x, w, s, split=planned, truncate=True)
    eq = {n: float((e == y_k).double().mean()) for n, e in
          (("rn", rn), ("trunc", tr))}
    print(f"[error] {name} kernel_vs_plain={ratio(y_k, y_p):.5f} "
          f"kernel_vs_fp64={ratio(y_k, y64):.5f} "
          f"plain_vs_fp64={ratio(y_p, y64):.5f} "
          f"emul_rn_vs_fp64={ratio(rn, y64):.5f} "
          f"emul_trunc_vs_fp64={ratio(tr, y64):.5f} "
          f"emul_rn_vs_plain={ratio(rn, y_p):.5f} "
          f"emul_trunc_vs_plain={ratio(tr, y_p):.5f} "
          f"kernel_vs_emul_rn={ratio(y_k, rn):.5f} "
          f"kernel_vs_emul_trunc={ratio(y_k, tr):.5f} "
          f"eq_rn={eq['rn']:.4f} eq_trunc={eq['trunc']:.4f}", flush=True)


def main():
    if not torch.cuda.is_available():
        smoke.fail("CUDA is not available")
    print(smoke.nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)    # chip_smoke's fp32 inputs
    with torch.no_grad():
        for (name, H, W, C, Fo, k, s, pad_h, _) in smoke.CONV_CASES:
            x = torch.randn((smoke.BATCH, H, W, C), generator=gen).to(dev)
            w = (torch.randn((k, k, C, Fo), generator=gen)
                 / math.sqrt(k * k * C)).to(dev)
            study(name, x, w, s, pad_h, dev)


if __name__ == "__main__":
    main()
