#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing lines of numbers; any failure exits non-zero:
  1. device  CUDA must be present; the card's name and power limit.
  2. build   nvcc builds every kernel from src/repro_torch/kernels/csrc,
             one nvcc per source, all at once.
  3. kernels conv2d_gemm on ResNet-50's 8 distinct HaloConv shapes at
             batch 32, a pad_h=False (halo) case and an odd shape, in fp32
             and bf16; rmsnorm on the Qwen1.5-4B prompt (8192 x 2560) and
             decode (4 x 2560) shapes in bf16 and a prime row count in
             fp32; flash_attention on the Qwen1.5-4B prompt shape
             (4, 20, 2048, 128) in bf16, causal, in the layout the model
             passes, a ragged S = 1000, a non-causal and an fp32 case. Each
             held against its plain version (TF32 off), with the kernel's,
             the plain version's and one library call's times (F.conv2d,
             F.rms_norm, F.scaled_dot_product_attention: yardsticks the
             port never calls). Three faults planted in the plain attention
             must each fail the bf16 bar.
  4. eval    the ResNet-50 eval forward at batch 32, 224², with use_pallas
             on and off, same weights: the kernel launches exactly 17 times
             and the logits agree to 1e-3.
  5. train   repro_torch.launch.train.main: ResNet-50, batch 32, 3 steps.
  6. serve   Qwen1.5-4B at full width in bf16, random weights from seed 0:
             a prompt pass over 4 prompts of 2048 tokens, then 32 greedy
             decode steps into a cache of 2080 positions, with use_pallas:
             rmsnorm launches 81 times and flash_attention 40 times in the
             prompt pass, rmsnorm 81 times and flash_attention never in each
             decode step. The same prompt pass and the first decode steps
             again on the plain path, fed the same tokens: the logits agree
             within the bar stated at SERVE_TOL.
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
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm  # noqa: E402
from repro_torch.kernels.util import same_pads  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.build import build_model  # noqa: E402
from repro_torch.nn.module import ShardingCtx, zeros_like_spec  # noqa: E402
from repro_torch.training.steps import (make_decode_step,  # noqa: E402
                                        make_eval_step, make_prefill_step)

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

# (name, rows, D, dtype): the Qwen1.5-4B norms of a prompt pass (4 x 2048
# tokens) and of a decode step (4 tokens), and a prime row count.
# Bars: fp32 1e-5 (the sum of squares in another order, rsqrt to 2 ulp);
# bf16 one bf16 ulp of the output (8 significant bits: 2^-7 relative, atol
# 2^-8 for values near 0), since a last-bit fp32 difference can flip the
# final rounding.
RMS_CASES = [("prompt_8192x2560", 8192, 2560, torch.bfloat16),
             ("decode_4x2560", 4, 2560, torch.bfloat16),
             ("prime_8191x2560_fp32", 8191, 2560, torch.float32)]
RMS_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7, 2 ** -8)}
# (name, B, H, S, D, causal, dtype, model_layout): the Qwen1.5-4B prompt
# pass's attention, on (B, H, S, D) views of (B, S, H, D) tensors as the
# model passes them; the same on contiguous (B, H, S, D) tensors, and a
# ragged S, a non-causal and an fp32 case.
FLASH_CASES = [("prompt_4x20x2048x128", 4, 20, 2048, 128, True,
                torch.bfloat16, True),
               ("prompt_contiguous", 4, 20, 2048, 128, True, torch.bfloat16,
                False),
               ("ragged_S1000", 4, 20, 1000, 128, True, torch.bfloat16,
                False),
               ("noncausal_S2048", 4, 20, 2048, 128, False, torch.bfloat16,
                False),
               ("fp32_S2048", 4, 20, 2048, 128, True, torch.float32, False)]
# Bars (rtol, atol) on |kernel - plain| <= atol + rtol·|plain|. fp32: 1e-4
# (online softmax and sums in another order over up to 2048 keys). bf16:
# the kernel and the plain version both work in fp32 from the same bf16
# inputs and round only the output, so a last-bit fp32 difference flips
# that rounding by one bf16 ulp (≤ 2^-7 relative); atol 1e-3 covers the
# fp32 sums' error where o is near 0. An absolute bar alone would be blind
# here: on N(0, 1) inputs the late causal rows' outputs are ~0.04 rms. So
# the run plants three faults in the plain version (the scale 1 % off, the
# KV tile [1024, 1088) dropped from the rows past it, 2e-3 added to o) and
# fails unless the bar rejects each. On an H100 the kernel read 0.61 of
# this bar at the prompt shape (max abs err 0.0020; 0.72-0.79 and 0.0039
# at S = 1000), the faults 10.9, 138 and 2.0 times it.
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2 ** -7, 1e-3)}
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/{}.cu"
KERNEL_REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm/rmsnorm.py:43",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:80"}

# The serve phase: Qwen1.5-4B, 4 prompts of 2048 tokens, 32 decode steps.
SERVE_B, SERVE_S, SERVE_STEPS, SERVE_CMP_STEPS = 4, 2048, 32, 4
# Bar on max |logits_kernel - logits_plain| / max |logits_plain| over the
# prompt pass and the first decode steps, the same tokens fed to both. The
# plain path's chunked attention rounds the scores (|q·k| up to ~16, bf16
# ulp 2^-4) and the softmax weights to bf16 before P·V, the kernel keeps
# them in fp32; through 40 layers that moves the logits by ~2 % of their
# scale (2.3 % measured on an H100). 5 % leaves room for that and still
# fails a kernel with a wrong mask or scale, which moves them by O(1).
SERVE_TOL = 5e-2


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


def kernel_ms(fn, reps: int = 20, warmup: int = 3, replays: int = 5) -> float:
    """Device time of one call: after warm-up, ``reps`` calls captured in a
    CUDA graph; the median over ``replays`` replays, each between two CUDA
    events, divided by ``reps``. The graph leaves out the host's cost of
    launching each call (tens of µs, more than a small kernel takes)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    pairs = []
    for _ in range(replays):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    del graph
    return statistics.median(s.elapsed_time(e) for s, e in pairs) / reps


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
    ms = kernel_ms(kernel)
    plain_ms = kernel_ms(plain)
    library_ms = kernel_ms(lambda: F.conv2d(xp, w_oihw, stride=s))
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


def _bound(flops: float, nbytes: float, dtype: torch.dtype) -> dict:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _print_row(kernel: str, row: dict):
    print(f"[kernel] {kernel} " + " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in row.items()), flush=True)


def phase_rmsnorm(dev) -> dict:
    """rmsnorm on every case; returns the kernels-line entry, timed at the
    prompt-pass shape (80 of a prompt pass's 81 launches)."""
    gen = torch.Generator().manual_seed(1)
    rows_out, max_err = {}, 0.0
    for name, rows, D, dtype in RMS_CASES:
        x = torch.randn((rows, D), generator=gen).to(dev, dtype)
        scale = (1 + 0.1 * torch.randn(D, generator=gen)).to(dev)
        y_k = rmsnorm(x, scale)
        torch.cuda.synchronize()
        y_p = rmsnorm_ref(x, scale)
        rtol, atol = RMS_TOL[dtype]
        diff = (y_k.float() - y_p.float()).abs()
        err = float(diff.max())
        if bool((diff > atol + rtol * y_p.float().abs()).any()):
            fail(f"rmsnorm {name}: max abs err {err} over rtol {rtol}, "
                 f"atol {atol}")
        max_err = max(max_err, err)
        w_lib = scale.to(dtype)       # F.rms_norm takes x's dtype
        row = {"case": name, "dtype": str(dtype).removeprefix("torch."),
               "ms": kernel_ms(lambda: rmsnorm(x, scale), reps=50),
               "plain_ms": kernel_ms(lambda: rmsnorm_ref(x, scale),
                                     reps=50),
               "library_ms": kernel_ms(lambda: F.rms_norm(x, (D,), w_lib,
                                                          1e-6), reps=50),
               **_bound(4.0 * rows * D,
                        2 * x.numel() * x.element_size() + 4 * D, dtype),
               "max_abs_err": err, "rtol": rtol, "atol": atol}
        _print_row("rmsnorm", row)
        rows_out[name] = row
    main = rows_out["prompt_8192x2560"]
    return {"name": "rmsnorm", "route": "cuda",
            "source": KERNEL_SOURCE.format("rmsnorm"),
            "replaces": KERNEL_REPLACES["rmsnorm"], "launches": None,
            "max_abs_err": max_err,
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}}


def _bar_ratio(out: torch.Tensor, ref: torch.Tensor, rtol: float,
               atol: float) -> float:
    """max |out - ref| / (atol + rtol·|ref|): the bar fails above 1."""
    ref = ref.float()
    return float(((out.float() - ref).abs() / (atol + rtol * ref.abs())
                  ).max())


def _faulty_attention(q, k, v, mul: float = 1.0, drop=None):
    """Causal attention in fp32 with the scores times ``mul`` and, with
    ``drop = (lo, hi)``, keys lo..hi-1 hidden from the queries past them."""
    S = q.shape[2]
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    if drop is not None:
        keep[drop[1]:, drop[0]:drop[1]] = False
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * (mul / math.sqrt(q.shape[-1]))
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), -1)
    return (p @ v.float()).to(q.dtype)


def _planted_faults(q, k, v, o_p, rtol, atol) -> dict:
    """Bar ratios of three faulty versions against the plain output; a bar
    that lets one of them pass (ratio ≤ 1) fails the run."""
    faults = {"fault_scale_1pct": _faulty_attention(q, k, v, mul=1.01),
              "fault_drop_tile": _faulty_attention(q, k, v, drop=(1024, 1088)),
              "fault_offset_2e-3": (o_p.float() + 2e-3).to(o_p.dtype)}
    ratios = {n: _bar_ratio(o, o_p, rtol, atol) for n, o in faults.items()}
    missed = [n for n, r in ratios.items() if r <= 1.0]
    if missed:
        fail(f"flash_attention bar (rtol {rtol}, atol {atol}) does not "
             f"reject the planted faults {missed}: {ratios}")
    return ratios


def phase_flash(dev) -> dict:
    """flash_attention on every case; returns the kernels-line entry, timed
    at the prompt-pass shape."""
    gen = torch.Generator().manual_seed(2)
    rows_out, max_err = {}, 0.0
    for name, B, H, S, D, causal, dtype, model_layout in FLASH_CASES:
        shape = (B, S, H, D) if model_layout else (B, H, S, D)
        q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype)
                   for _ in range(3))
        if model_layout:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        o_k = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        o_p = attention_ref(q, k, v, causal=causal)
        rtol, atol = FLASH_TOL[dtype]
        err = float((o_k.float() - o_p.float()).abs().max())
        ratio = _bar_ratio(o_k, o_p, rtol, atol)
        if not bool(torch.isfinite(o_k).all()) or ratio > 1.0:
            fail(f"flash_attention {name}: max abs err {err}, {ratio} times "
                 f"the bar (rtol {rtol}, atol {atol})")
        if o_k.stride() != q.stride():
            fail(f"flash_attention {name}: output strides {o_k.stride()} "
                 f"are not q's {q.stride()}")
        faults = _planted_faults(q, k, v, o_p, rtol, atol) \
            if dtype == torch.bfloat16 and causal and S > 1088 else {}
        max_err = max(max_err, err)
        del o_p
        pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
        row = {"case": name, "dtype": str(dtype).removeprefix("torch."),
               "ms": kernel_ms(lambda: flash_attention(q, k, v,
                                                       causal=causal),
                               reps=10, warmup=2),
               "plain_ms": kernel_ms(lambda: attention_ref(q, k, v,
                                                           causal=causal),
                                     reps=3, warmup=1),
               "library_ms": kernel_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=causal), reps=10, warmup=2),
               **_bound(4.0 * D * pairs, 4 * q.numel() * q.element_size(),
                        dtype),
               "max_abs_err": err, "rtol": rtol, "atol": atol,
               "bar_ratio": ratio, **faults}
        row["tflops"] = 4.0 * D * pairs / (row["ms"] * 1e-3) / 1e12
        _print_row("flash_attention", row)
        rows_out[name] = row
        del q, k, v, o_k
        torch.cuda.empty_cache()
    main = rows_out["prompt_4x20x2048x128"]
    return {"name": "flash_attention", "route": "cuda",
            "source": KERNEL_SOURCE.format("flash_attention"),
            "replaces": KERNEL_REPLACES["flash_attention"], "launches": None,
            "max_abs_err": max_err,
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}}


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


def _logit_diff(kernel: torch.Tensor, plain: torch.Tensor) -> dict:
    if kernel.shape != plain.shape or not bool(torch.isfinite(kernel).all()):
        fail(f"serve logits: shape {tuple(kernel.shape)} vs "
             f"{tuple(plain.shape)}, or not finite")
    d = float((kernel - plain).abs().max())
    scale = float(plain.abs().max())
    agree = float((kernel.argmax(-1) == plain.argmax(-1)).float().mean())
    return {"max_abs_diff": d, "logit_scale": scale, "rel": d / scale,
            "argmax_agree": agree}


def _reset_counts():
    rmsnorm.launches = flash_attention.launches = 0


def _counts() -> tuple[int, int]:
    return rmsnorm.launches, flash_attention.launches


def phase_serve(dev) -> tuple[int, int]:
    """Qwen1.5-4B: prompt pass and greedy decode with use_pallas, then the
    same on the plain path; returns (rmsnorm, flash_attention) launches of
    the kernel run."""
    cfg = get_config("qwen1.5-4b")
    mc = cfg.model
    ctx_k, ctx_p = ShardingCtx(dev, use_pallas=True), ShardingCtx(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, ctx_k, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    tokens = torch.randint(0, mc.vocab, (SERVE_B, SERVE_S), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    spec = model.cache_spec(SERVE_B, SERVE_S + SERVE_STEPS)
    cache = zeros_like_spec(spec, dev)
    cache_bytes = sum(t.numel() * t.element_size()
                      for c in cache["blocks"] for t in c.values())
    prefill_k = make_prefill_step(model, ctx_k)
    decode_k = make_decode_step(model, ctx_k)

    # warm-up (cuBLAS picks its algorithms); the run below rewrites these
    # cache positions before it reads them
    prefill_k({"tokens": tokens}, cache)
    decode_k(tokens[:, :1], cache, SERVE_S)
    torch.cuda.synchronize()

    _reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill_k({"tokens": tokens}, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if _counts() != (81, 40):
        fail(f"prompt pass launched (rmsnorm, flash_attention) {_counts()}, "
             f"not (81, 40)")
    total = list(_counts())
    if tuple(logits.shape) != (SERVE_B, 1, mc.vocab) or \
            logits.dtype != torch.float32:
        fail(f"prompt logits {tuple(logits.shape)} {logits.dtype}")
    kernel_logits, fed, step_s = [logits.clone()], [], []
    tok = logits.argmax(-1)
    for i in range(SERVE_STEPS):
        fed.append(tok)
        _reset_counts()
        t0 = time.perf_counter()
        logits, cache = decode_k(tok, cache, SERVE_S + i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if _counts() != (81, 0):
            fail(f"decode step {i} launched (rmsnorm, flash_attention) "
                 f"{_counts()}, not (81, 0)")
        total[0] += rmsnorm.launches
        if not bool(torch.isfinite(logits).all()):
            fail(f"decode step {i}: logits not finite")
        if i < SERVE_CMP_STEPS:
            kernel_logits.append(logits.clone())
        tok = logits.argmax(-1)
    peak = torch.cuda.max_memory_allocated()

    # the plain path on the card, fed the same tokens
    del cache
    cache = zeros_like_spec(spec, dev)
    prefill_p = make_prefill_step(model, ctx_p)
    decode_p = make_decode_step(model, ctx_p)
    _reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill_p({"tokens": tokens}, cache)
    torch.cuda.synchronize()
    plain_prefill_s = time.perf_counter() - t0
    diffs = [_logit_diff(kernel_logits[0], logits)]
    for i in range(SERVE_CMP_STEPS):
        logits, cache = decode_p(fed[i], cache, SERVE_S + i)
        diffs.append(_logit_diff(kernel_logits[i + 1], logits))
    if _counts() != (0, 0):
        fail(f"the plain path launched kernels {_counts()}")
    for i, d in enumerate(diffs):
        print(f"[serve] logits kernel vs plain, "
              f"{'prompt' if i == 0 else f'decode step {i - 1}'}: "
              + " ".join(f"{k}={v:.6g}" for k, v in d.items()), flush=True)
    decode_ms = statistics.mean(step_s) * 1e3
    print(f"[serve] qwen1.5-4b params={model.num_params()} "
          f"weights_bytes={weight_bytes} cache_bytes={cache_bytes} "
          f"build_s={build_s:.4g} batch={SERVE_B} prompt={SERVE_S} "
          f"steps={SERVE_STEPS} prefill_ms={prefill_s * 1e3:.6g} "
          f"plain_prefill_ms={plain_prefill_s * 1e3:.6g} "
          f"prefill_tokens_per_s={SERVE_B * SERVE_S / prefill_s:.6g} "
          f"decode_ms_per_step={decode_ms:.6g} "
          f"decode_ms_median={statistics.median(step_s) * 1e3:.6g} "
          f"decode_tokens_per_s={SERVE_B / decode_ms * 1e3:.6g} "
          f"launches_rmsnorm={total[0]} launches_flash={total[1]} "
          f"max_memory_allocated={peak}", flush=True)
    worst = max(d["rel"] for d in diffs)
    if worst > SERVE_TOL:
        fail(f"serve logits kernel vs plain: relative diff {worst} over "
             f"{SERVE_TOL}")
    del model, cache
    torch.cuda.empty_cache()
    return total[0], total[1]


def main():
    name, smi = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ShardingCtx(dev)          # TF32 off for the plain versions
    phase_build()
    conv = phase_kernels(dev)
    rms = phase_rmsnorm(dev)
    flash = phase_flash(dev)
    conv["launches"] = phase_eval()
    phase_train()
    rms["launches"], flash["launches"] = phase_serve(dev)
    print(json.dumps({"kernels": [conv, rms, flash]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
