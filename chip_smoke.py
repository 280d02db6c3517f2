#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing lines of numbers; any failure exits non-zero:
  1. device  CUDA must be present; the card's name and power limit.
  2. build   nvcc builds every kernel from src/repro_torch/kernels/csrc.
  3. kernels conv2d_gemm on ResNet-50's 8 distinct HaloConv shapes at
             batch 32, a pad_h=False (halo) case and an odd shape, in fp32
             and bf16, held against its plain version (TF32 off); the
             kernel's, the plain version's and one F.conv2d call's times
             (the library yardstick, which the port never calls).
  4. eval    the ResNet-50 eval forward at batch 32, 224², with use_pallas
             on and off, same weights: the kernel launches exactly 17 times
             and the logits agree to 1e-3.
  5. train   repro_torch.launch.train.main: ResNet-50, batch 32, 3 steps.
Then a JSON line for the kernels, the nvidia-smi line, and the result line.
It imports nothing of jax or of the JAX package.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import Loader  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.conv2d_gemm.conv2d_gemm import conv2d_gemm  # noqa: E402
from repro_torch.kernels.conv2d_gemm.ref import conv2d_padded  # noqa: E402
from repro_torch.kernels.util import same_pads  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.build import build_model  # noqa: E402
from repro_torch.nn.module import ShardingCtx  # noqa: E402
from repro_torch.training.steps import make_eval_step  # noqa: E402

BATCH = 32
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): fp32 outside the
# tensor cores, bf16 on them, and HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}

# (name, H, W, C, F, k, stride, pad_h, sites in the ResNet-50 forward)
CONV_CASES = [
    ("stem_224_7x7_s2", 224, 224, 3, 64, 7, 2, True, 1),
    ("s1_56_c64", 56, 56, 64, 64, 3, 1, True, 3),
    ("s2_56to28_c128", 56, 56, 128, 128, 3, 2, True, 1),
    ("s1_28_c128", 28, 28, 128, 128, 3, 1, True, 3),
    ("s2_28to14_c256", 28, 28, 256, 256, 3, 2, True, 1),
    ("s1_14_c256", 14, 14, 256, 256, 3, 1, True, 5),
    ("s2_14to7_c512", 14, 14, 512, 512, 3, 2, True, 1),
    ("s1_7_c512", 7, 7, 512, 512, 3, 1, True, 2),
    ("halo_30x28_c128", 30, 28, 128, 128, 3, 1, False, 0),
    ("odd_17_c5_f12_s3", 17, 17, 5, 12, 3, 3, True, 0),
]
SOURCE = "src/repro_torch/kernels/csrc/conv2d_gemm.cu"
REPLACES = "src/repro/kernels/conv2d_gemm/conv2d_gemm.py:83"


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call (CUDA events), after warm-up."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} | {smi}",
          flush=True)
    return name, smi


def phase_build():
    t0 = time.perf_counter()
    report = build.build_all()
    print(f"[build] {time.perf_counter() - t0:.2f} s "
          + " ".join(f"{k}: {v}" for k, v in report.items()), flush=True)


def conv_case(name, H, W, C, Fo, k, s, pad_h, dtype, gen, dev):
    """Kernel vs plain version on one shape; returns the measured numbers."""
    x = torch.randn((BATCH, H, W, C), generator=gen).to(dev, dtype)
    w = (torch.randn((k, k, C, Fo), generator=gen) / math.sqrt(k * k * C)
         ).to(dev, dtype)
    pads_h = same_pads(H, k, s) if pad_h else (0, 0)
    pads_w = same_pads(W, k, s)

    def kernel():
        return conv2d_gemm(x, w, strides=(s, s), pad_h=pad_h)

    def plain():
        return conv2d_padded(x, w, (s, s), pads_h, pads_w)

    y_k = kernel()
    torch.cuda.synchronize()
    y_p = plain()
    if y_k.shape != y_p.shape:
        fail(f"{name}: kernel shape {tuple(y_k.shape)} != {tuple(y_p.shape)}")
    diff = (y_k.float() - y_p.float()).abs()
    err = float(diff.max())
    tol = TOL[dtype]
    if not bool(torch.isfinite(y_k).all()) or \
            bool((diff > tol + tol * y_p.float().abs()).any()):
        fail(f"conv2d_gemm {name} {dtype}: max abs err {err} over tolerance "
             f"{tol}")
    # the library yardstick: one cuDNN call on an input padded beforehand
    xp = F.pad(x.permute(0, 3, 1, 2), (*pads_w, *pads_h)).contiguous(
        memory_format=torch.channels_last)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    ms = time_ms(kernel)
    plain_ms = time_ms(plain)
    library_ms = time_ms(lambda: F.conv2d(xp, w_oihw, stride=s))
    Ho, Wo = y_k.shape[1], y_k.shape[2]
    flops = 2.0 * BATCH * Ho * Wo * Fo * k * k * C
    nbytes = (x.numel() + w.numel() + y_k.numel()) * x.element_size()
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    row = {"case": name, "dtype": str(dtype).removeprefix("torch."),
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "gflop": flops / 1e9, "tflops": flops / (ms * 1e-3) / 1e12,
           "max_abs_err": err, "tol": tol}
    print("[kernel] conv2d_gemm " + " ".join(
        f"{k_}={v:.6g}" if isinstance(v, float) else f"{k_}={v}"
        for k_, v in row.items()), flush=True)
    return row, t_ops * 1e3, t_bytes * 1e3


def phase_kernels(dev) -> dict:
    """Every case in fp32 and bf16; returns the kernels-line entry, summed
    over the 17 fp32 sites of one ResNet-50 forward."""
    gen = torch.Generator().manual_seed(0)
    total = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                           "ops_ms", "bytes_ms"), 0.0)
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for (name, H, W, C, Fo, k, s, pad_h, sites) in CONV_CASES:
            row, ops_ms, bytes_ms = conv_case(name, H, W, C, Fo, k, s, pad_h,
                                              dtype, gen, dev)
            if dtype != torch.float32:
                continue
            max_err = max(max_err, row["max_abs_err"])
            row.update(ops_ms=ops_ms, bytes_ms=bytes_ms)
            for key in total:
                total[key] += sites * row[key]
    bound_by = "operations" if total["ops_ms"] >= total["bytes_ms"] \
        else "bytes"
    return {"name": "conv2d_gemm", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": None, "max_abs_err": max_err,
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"], "bound_by": bound_by,
            "library_ms": total["library_ms"]}


def phase_eval() -> int:
    ctx_k = ShardingCtx("cuda", use_pallas=True)
    ctx_p = ShardingCtx("cuda")
    cfg = get_config("resnet50")
    model = build_model(cfg, ctx_k, seed=0)
    batch = Loader(train.data_config_for(cfg.model, BATCH, seed=0),
                   ctx_k.device).batch_at(0)
    eval_k, eval_p = make_eval_step(model, ctx_k), make_eval_step(model, ctx_p)

    conv2d_gemm.launches = 0
    out_k = eval_k(batch)
    torch.cuda.synchronize()
    launches = conv2d_gemm.launches
    if launches != 17:
        fail(f"the use_pallas forward launched conv2d_gemm {launches} times, "
             f"not 17")
    out_p = eval_p(batch)
    logits_k, logits_p = out_k["outputs"], out_p["outputs"]
    if tuple(logits_k.shape) != (BATCH, 1000) or \
            not bool(torch.isfinite(logits_k).all()):
        fail(f"eval logits: shape {tuple(logits_k.shape)} or not finite")
    diff = (logits_k - logits_p).abs()
    if bool((diff > 1e-3 + 1e-3 * logits_p.abs()).any()):
        fail(f"eval logits kernel vs plain: max abs diff {float(diff.max())}")
    ms_k = time_ms(lambda: eval_k(batch), reps=10, warmup=2)
    ms_p = time_ms(lambda: eval_p(batch), reps=10, warmup=2)
    print(f"[eval] resnet50 batch={BATCH} launches={launches} "
          f"max_abs_diff={float(diff.max()):.3g} loss_kernel="
          f"{float(out_k['loss']):.7g} loss_plain={float(out_p['loss']):.7g} "
          f"ms_kernel={ms_k:.4g} ms_plain={ms_p:.4g}", flush=True)
    return launches


def phase_train():
    torch.cuda.reset_peak_memory_stats()
    out = train.main(["--arch", "resnet50", "--batch", str(BATCH),
                      "--steps", "3", "--log-every", "1", "--device", "cuda"])
    losses = out["losses"]
    if len(losses) != 3 or not all(math.isfinite(v) for v in losses):
        fail(f"training losses {losses}")
    step_ms = statistics.mean(out["step_s"][1:]) * 1e3   # after the first
    print(f"[train] resnet50 batch={BATCH} steps=3 losses="
          f"{','.join(f'{v:.5g}' for v in losses)} ms_per_step={step_ms:.4g} "
          f"first_step_ms={out['step_s'][0] * 1e3:.4g} "
          f"images_per_s={BATCH / step_ms * 1e3:.4g} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}",
          flush=True)


def main():
    name, smi = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ShardingCtx(dev)          # TF32 off for the plain versions
    phase_build()
    entry = phase_kernels(dev)
    entry["launches"] = phase_eval()
    phase_train()
    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
