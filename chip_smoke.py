#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing lines of numbers; any failure exits non-zero:
  1. device  CUDA must be present; the card's name and power limit.
  2. build   nvcc builds every kernel from src/repro_torch/kernels/csrc,
             one nvcc per source, all at once; conv2d_gemm's GEMM kernels
             and the ssd_chunk kernel must hold HGMMA (wgmma) instructions
             (cuobjdump -sass).
  3. kernels conv2d_gemm on ResNet-50's 8 distinct HaloConv shapes at
             batch 32, a pad_h=False (halo) case and an odd shape, in fp32
             and bf16, and on VGG16's 9 distinct shapes (its 13 sites) at
             batch 32, 224², in fp32, with its prep and split-K reduce
             passes timed apart;
             on every fp32 case the plain conv run once more through cuDNN
             with TF32 on (one TF32 pass, a planted fault the fp32 bar must
             reject wherever K >= 576), and a stage-3 and a stage-4 case run
             twice, bitwise equal; rmsnorm on the Qwen1.5-4B prompt
             (8192 x 2560) and decode (4 x 2560) shapes in bf16 and a prime
             row count in
             fp32, and on the Mamba-2 780m norm shapes (8192 and 4 rows of
             1536 and 3072) in bf16; flash_attention on the Qwen1.5-4B
             prompt shape (4, 20, 2048, 128) in bf16, causal, in the layout
             the model passes, a ragged S = 1000, a non-causal and an fp32
             case; ssd_chunk on the Mamba-2 780m prompt pass's SSD
             (4, 2048, 48, 64), N 128, Q 256, fp32, with B and C as stride-0
             views over the heads and per head, a ragged S = 1000 and a
             nonzero initial state, the first two run twice, bitwise
             equal, its prep pass timed apart. Each held against its plain
             version
             (TF32 off), with the kernel's, the plain version's and, where
             one PyTorch call computes the same function, that call's time
             (F.conv2d, F.rms_norm, F.scaled_dot_product_attention:
             yardsticks the port never calls). Four faults planted in the
             plain attention must each fail the bf16 bar (one of them P
             rounded once to bf16 before P·V, as a tensor-core kernel
             without the hi/lo split of P would), four in the plain SSD
             the ssd_chunk bar (one of them the SSD with one TF32 pass in
             each contraction, emulated on the card, as a tensor-core kernel
             without the hi/lo split of its operands would).
  4. eval    the ResNet-50 and the VGG16 eval forward at batch 32, 224²,
             with use_pallas on and off, same weights: the kernel launches
             exactly 17 and 13 times and the logits agree within EVAL_TOL of
             their scale.
  5. train   repro_torch.launch.train.main, 3 steps each: ResNet-50 and
             VGG16 at batch 32, CosmoFlow (128³, 4 channels) at batch 8.
  5b. oracle the paper's Fig. 3 at p = 1: ResNet-50, ResNet-152, VGG16
             (batch 32) and CosmoFlow (batch 8), fp32, one after another;
             each measured train step against the oracle's projection,
             self-calibrated and calibrated on ResNet-50 (two accuracy
             tables and their means), and the projected memory beside the
             step's peak.
  6. serve   Qwen1.5-4B at full width in bf16, random weights from seed 0:
             a prompt pass over 4 prompts of 2048 tokens, then 32 greedy
             decode steps into a cache of 2080 positions, with use_pallas:
             rmsnorm launches 81 times and flash_attention 40 times in the
             prompt pass, rmsnorm 81 times and flash_attention never in each
             decode step. The same prompt pass and the first decode steps
             again on the plain path, fed the same tokens: the logits agree
             within the bar stated at SERVE_TOL.
  7. serve   Mamba-2 780m the same way (bf16, random weights from seed 0,
             the SSM cache zeroed before every prompt pass): rmsnorm 97 and
             ssd_chunk 48 launches in the prompt pass, rmsnorm 97 in each
             decode step; logits against the plain path within the bar
             stated at SERVE_TOL. Then the whole model in fp32, kernel path
             against plain path, within FP32_SERVE_TOL.
Then a JSON line for the kernels, the nvidia-smi line, and the result line.
It imports nothing of jax or of the JAX package.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.configs.cnn_archs import ORACLE_BATCH  # noqa: E402
from repro_torch.core.calibration import calibrate_host_system  # noqa: E402
from repro_torch.core.cluster import ClusterSpec  # noqa: E402
from repro_torch.core.layer_stats import stats_for  # noqa: E402
from repro_torch.core.oracle import (OracleConfig, TimeModel,  # noqa: E402
                                     project)
from repro_torch.core.validation import (accuracy_report,  # noqa: E402
                                         validate)
from repro_torch.data.pipeline import Loader  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.conv2d_gemm.conv2d_gemm import (  # noqa: E402
    BLOCK_M, conv2d_gemm, sm_count, split_plan, split_reduce, weight_prep)
from repro_torch.kernels.conv2d_gemm.ref import conv2d_padded  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm  # noqa: E402
from repro_torch.kernels.ssd_scan.emulate import emulate  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_ref,  # noqa: E402
                                              ssd_combine)
from repro_torch.kernels.ssd_scan.ssd_scan import (  # noqa: E402
    chunk_outputs, operand_prep, ssd_chunk)
from repro_torch.kernels.util import (cdiv, largest_divisor,  # noqa: E402
                                      same_pads)
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.build import build_model  # noqa: E402
from repro_torch.nn.module import ShardingCtx, zeros_like_spec  # noqa: E402
from repro_torch.training.steps import (make_decode_step,  # noqa: E402
                                        make_eval_step, make_prefill_step)

BATCH = 32
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): fp32 outside the
# tensor cores, bf16 on them, and HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32 = 495e12       # TF32 on the tensor cores
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# conv2d_gemm's route: fp32 as three TF32 products per multiply-add (3xTF32),
# bf16 as one exact TF32 product. Its fp32 bound counts that tensor work, the
# least time at the accuracy the fp32 bar demands; its bf16 bound is the
# bf16 tensor cores'. The [kernel] lines print beside it the floor of the
# useful work as one TF32 product, tf32_floor_ms (the convention of the
# other kernels' bounds, which count useful FLOP only), and, for fp32, the
# FMA pipes' bound, fma_bound_ms. The planted fault fault_tf32_once (cuDNN
# with TF32 on) must fail the fp32 bar on every case with K = k·k·C of at
# least FAULT_MIN_K.
FP32_TF32_PRODUCTS = 3
FAULT_MIN_K = 576
# cases run twice, the two outputs bitwise equal (split K, reduced in order)
DETERMINISM_CASES = ("s1_14_c256", "s1_7_c512")
# the kernels whose SASS must hold HGMMA: library -> a word of the kernels'
# names (conv2d_gemm's prep and reduce kernels have none)
TENSOR_CORE_KERNELS = {"conv2d_gemm": "conv_tc_kernel",
                       "ssd_chunk": "ssd_chunk_kernel"}

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
# VGG16's 13 HaloConv sites at 224², the same fields; fp32 only (the model's
# dtype). conv0 gathers 3 channels, K = 27, less than one k-tile; the 224²
# sites are the largest M (1.6 M rows) the kernel is given.
VGG_CONV_CASES = [
    ("vgg_224_c3_f64", 224, 224, 3, 64, 3, 1, True, 1),
    ("vgg_224_c64", 224, 224, 64, 64, 3, 1, True, 1),
    ("vgg_112_c64_f128", 112, 112, 64, 128, 3, 1, True, 1),
    ("vgg_112_c128", 112, 112, 128, 128, 3, 1, True, 1),
    ("vgg_56_c128_f256", 56, 56, 128, 256, 3, 1, True, 1),
    ("vgg_56_c256", 56, 56, 256, 256, 3, 1, True, 2),
    ("vgg_28_c256_f512", 28, 28, 256, 512, 3, 1, True, 1),
    ("vgg_28_c512", 28, 28, 512, 512, 3, 1, True, 2),
    ("vgg_14_c512", 14, 14, 512, 512, 3, 1, True, 3),
]
# the eval phases: (arch, conv2d_gemm launches in one use_pallas forward)
EVAL_SITES = {"resnet50": 17, "vgg16": 13}
# eval logits, kernel path vs plain path: |Δ| ≤ EVAL_TOL·(|plain| +
# min(max|plain|, 1)). ResNet's BatchNorm keeps its logits at unit scale or
# above, where this is the absolute 1e-3 + 1e-3·|plain|; VGG16's shrink
# through 16 layers without it (LeCun-normal weights, ReLU), to where an
# absolute 1e-3 would pass almost anything, so there the bar scales with
# the logits.
EVAL_TOL = 1e-3
# the training phases: (arch, batch)
TRAIN_RUNS = (("resnet50", 32), ("vgg16", 32), ("cosmoflow", 8))
# the oracle phase (paper Fig. 3 at p = 1): (arch, batch), one after another;
# the first is also the model the oracle is calibrated on for the others
ORACLE_RUNS = tuple(ORACLE_BATCH.items())
SOURCE = "src/repro_torch/kernels/csrc/conv2d_gemm.cu"
REPLACES = "src/repro/kernels/conv2d_gemm/conv2d_gemm.py:83"

# (name, rows, D, dtype): the Qwen1.5-4B norms of a prompt pass (4 x 2048
# tokens) and of a decode step (4 tokens), a prime row count, and the
# Mamba-2 780m norms (48 over d_model 1536 and 48 over d_inner 3072 in each
# prompt pass and each decode step).
# Bars: fp32 1e-5 (the sum of squares in another order, rsqrt to 2 ulp);
# bf16 one bf16 ulp of the output (8 significant bits: 2^-7 relative, atol
# 2^-8 for values near 0), since a last-bit fp32 difference can flip the
# final rounding.
RMS_CASES = [("prompt_8192x2560", 8192, 2560, torch.bfloat16),
             ("decode_4x2560", 4, 2560, torch.bfloat16),
             ("prime_8191x2560_fp32", 8191, 2560, torch.float32),
             ("mamba_prompt_8192x1536", 8192, 1536, torch.bfloat16),
             ("mamba_prompt_8192x3072", 8192, 3072, torch.bfloat16),
             ("mamba_decode_4x1536", 4, 1536, torch.bfloat16),
             ("mamba_decode_4x3072", 4, 3072, torch.bfloat16)]
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
# inputs (the tensor-core kernel's P·V through P split into two bf16 parts,
# 16 significant bits) and round only the output, so a last-bit fp32
# difference flips that rounding by one bf16 ulp (≤ 2^-7 relative); atol
# 1e-3 covers the fp32 sums' error where o is near 0. An absolute bar alone
# would be blind here: on N(0, 1) inputs the late causal rows' outputs are
# ~0.04 rms. So the run plants four faults in the plain version (the scale
# 1 % off, the KV tile [1024, 1088) dropped from the rows past it, 2e-3
# added to o, P rounded once to bf16 before P·V) and fails unless the bar
# rejects each. On an H100 the tensor-core kernel read 0.79 of this bar at
# the prompt shape (max abs err 0.0039; 0.76 and 0.0078 at S = 1000), the
# faults 10.9, 138, 2.0 and 2.3 times it.
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2 ** -7, 1e-3)}
# (name, B, S, H, P, N, chunk, per-head B and C, initial state): the
# Mamba-2 780m prompt pass's SSD (its one group of B and C passed as
# stride-0 views over the 48 heads, as SSDBlock passes them), the same with
# per-head B and C (the JAX function's contract), a ragged S (Q = 250 for
# chunk 256) and a nonzero initial state. Inputs follow the model's init:
# dt = softplus(N(0, 0.5) + dt_bias), dt_bias from softplus⁻¹ of [1e-3,
# 0.1] log-uniform, A = -(1 .. 48), so cum = cumsum(dt·A) falls to ~-10^3
# within a chunk.
SSD_CASES = [("prompt_4x2048x48x64_N128", 4, 2048, 48, 64, 128, 256, False,
              False),
             ("per_head_BC", 4, 2048, 48, 64, 128, 256, True, False),
             ("ragged_S1000", 4, 1000, 48, 64, 128, 256, False, False),
             ("init_state", 4, 2048, 48, 64, 128, 256, False, True)]
# Bar, stated before the first chip run: max |kernel - plain| ≤ 1e-4 ·
# max |plain| for each of y_intra, the chunk states, the chunk decays, and
# (through the inter-chunk recurrence) y and the final state. Both sides are
# fp32 from the same inputs; the sums over N = 128 and over a chunk's ≤ 256
# positions run in another order (~1e-6 relative), and the kernel's
# in-block cumsum in another order than torch.cumsum: at |cum| ~ 10^3 a
# last-bit difference (6e-5) moves exp(cum_i - cum_j) by that much, but
# only in heads whose terms decay within a few positions, where |y| is a
# small share of its max. 1e-4 as the fp32 flash bar. The run plants three
# faults in the plain version (the causal mask admitting j = i + 1, every
# decay taken from position j - 1, chunk 3's state dropped from the
# inter-chunk recurrence) and fails unless the bar rejects each. Since the
# kernel moved onto the tensor cores (3×TF32 in each of its three
# contractions), a fourth: the SSD with one TF32 pass (hi·hi alone) in each
# contraction, the arithmetic of a tensor-core kernel that does not split its
# operands, emulated on the card (kernels/ssd_scan/emulate.py; 2–6× the bar
# on the CPU at the Mamba-2 780m chunk). Its bound counts the work of that
# route, 3 TF32 products per useful multiply-add at 495 TFLOP/s, as the fp32
# conv's does; the row prints beside it the useful work as one TF32 product
# (tf32_floor_ms) and on the FMA pipes (fma_bound_ms). The prompt and
# per-head cases run twice, bitwise equal (no atomics).
SSD_TOL = 1e-4
SSD_DETERMINISM_CASES = ("prompt_4x2048x48x64_N128", "per_head_BC")
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/{}.cu"
KERNEL_REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm/rmsnorm.py:43",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:80",
    "ssd_chunk": "src/repro/kernels/ssd_scan/ssd_scan.py:69"}

# The serve phases: 4 prompts of 2048 tokens, 32 decode steps.
SERVE_B, SERVE_S, SERVE_STEPS, SERVE_CMP_STEPS = 4, 2048, 32, 4
# Bars on max |logits_kernel - logits_plain| / max |logits_plain| over the
# prompt pass and the first decode steps, the same tokens fed to both.
# Qwen1.5-4B: the plain path's chunked attention rounds the scores (|q·k|
# up to ~16, bf16 ulp 2^-4) and the softmax weights to bf16 before P·V, the
# kernel keeps them in fp32; through 40 layers that moves the logits by ~2 %
# of their scale (2.3 % measured on an H100). 5 % leaves room for that and
# still fails a kernel with a wrong mask or scale, which moves them by O(1).
# Mamba-2 780m: the bar was first set at 5 %, from the belief that only
# last-bit flips of the bf16 roundings differ (1-2 % expected); the first
# run on an H100 read 5.1-5.8 % and failed. ``repro_torch.launch.
# serve_drift`` shows why: the plain path against itself with chunk 128
# instead of 256 (the same function, its sums in another order) differs by
# 4.8 % of the logit scale on an H100, as much as the kernel path does; the
# random-weight model carries a one-ulp bf16 flip in its first layer (0.6 %
# of the hidden scale) to ~5 % over 48 layers, whatever path computes it.
# So 10 %, twice that floor; a wrong mask or decay moves the logits by O(1).
# The kernel path's accuracy at full width is held in fp32 below.
SERVE_TOL = {"qwen1.5-4b": 5e-2, "mamba2-780m": 1e-1}
# The Mamba-2 780m prompt pass and first decode steps again with the whole
# model in fp32, kernel path against plain path, fed the same tokens: the
# logits agree to 1e-4 of their scale (serve_drift --dtype float32 on an
# H100: 3.1e-5 kernel vs plain, 2.7e-5 plain against itself at chunk 128).
FP32_SERVE_TOL = 1e-4
# launches of (rmsnorm, flash_attention, ssd_chunk) in each prompt pass and
# in each decode step
SERVE_LAUNCHES = {"qwen1.5-4b": ((81, 40, 0), (81, 0, 0)),
                  "mamba2-780m": ((97, 0, 48), (97, 0, 0))}


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
    for lib, marker in TENSOR_CORE_KERNELS.items():
        counts = sass_counts(lib, marker)
        print(f"[build] {lib} {marker} SASS (cuobjdump -sass): "
              + " ".join(f"{k}={v}" for k, v in counts.items()), flush=True)
        if counts["kernels"] == 0 or counts["HGMMA"] == 0:
            fail(f"{lib}'s {marker} holds no HGMMA: not on the tensor cores")


def sass_counts(lib: str, marker: str) -> dict:
    """Instructions by opcode in the kernels of library ``lib`` whose names
    hold ``marker``: HGMMA (wgmma on the tensor cores) against FFMA (fp32
    FMA pipes)."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(lib))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, inside = {"kernels": 0, "HGMMA": 0, "FFMA": 0}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = marker in line
            counts["kernels"] += inside
            continue
        words = [w for w in line.split() if not w.startswith(("/*", "@"))]
        if inside and words:
            op = words[0].split(".")[0]
            if op in counts:
                counts[op] += 1
    return counts


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
    err = float((y_k.float() - y_p.float()).abs().max())
    tol = TOL[dtype]
    ratio = _bar_ratio(y_k, y_p, tol, tol)
    if not bool(torch.isfinite(y_k).all()) or ratio > 1.0:
        fail(f"conv2d_gemm {name} {dtype}: max abs err {err}, {ratio} times "
             f"the bar {tol}")
    det = {}
    if name in DETERMINISM_CASES and dtype == torch.float32:
        det["deterministic"] = all(torch.equal(kernel(), y_k)
                                   for _ in range(2))
        if not det["deterministic"]:
            fail(f"conv2d_gemm {name}: two calls on the same inputs differ")
    # the library yardstick: one cuDNN call on an input padded beforehand
    xp = F.pad(x.permute(0, 3, 1, 2), (*pads_w, *pads_h)).contiguous(
        memory_format=torch.channels_last)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    Ho, Wo = y_k.shape[1], y_k.shape[2]
    M, K = BATCH * Ho * Wo, k * k * C
    block_n, split = split_plan(M, Fo, K, sm_count(dev.index or 0))
    row = {"case": name, "dtype": str(dtype).removeprefix("torch."),
           "ms": kernel_ms(kernel), "plain_ms": kernel_ms(plain),
           "library_ms": kernel_ms(lambda: F.conv2d(xp, w_oihw, stride=s)),
           "prep_ms": kernel_ms(lambda: weight_prep(w)), "reduce_ms": 0.0,
           "block_n": block_n, "split": split,
           "units": cdiv(M, BLOCK_M) * cdiv(Fo, block_n) * split}
    if split > 1:    # the reduce alone, on a workspace of the kernel's shape
        ws = torch.zeros((split, M, Fo), dtype=torch.float32, device=dev)
        row["reduce_ms"] = kernel_ms(lambda: split_reduce(ws, y_k))
        del ws
    fault = {}
    if dtype == torch.float32:
        # planted fault: one TF32 pass (cuDNN with TF32 on), a less exact
        # computation; its time is a yardstick of that, not of this function
        allow = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            fault["fault_tf32_once"] = _bar_ratio(plain(), y_p, tol, tol)
            fault["tf32_library_ms"] = kernel_ms(
                lambda: F.conv2d(xp, w_oihw, stride=s))
        finally:
            torch.backends.cudnn.allow_tf32 = allow
        if K >= FAULT_MIN_K and fault["fault_tf32_once"] <= 1.0:
            fail(f"conv2d_gemm {name}: the fp32 bar {tol} does not reject one "
                 f"TF32 pass (cuDNN with TF32 on): {fault}")
    flops = 2.0 * M * Fo * K
    nbytes = (x.numel() + w.numel() + y_k.numel()) * x.element_size()
    t_ops = FP32_TF32_PRODUCTS * flops / PEAK_TF32 \
        if dtype == torch.float32 else flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    row.update({"bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "tf32_floor_ms": max(flops / PEAK_TF32, t_bytes) * 1e3})
    if dtype == torch.float32:
        row["fma_bound_ms"] = max(flops / PEAK_FLOPS[dtype], t_bytes) * 1e3
    row.update({"gflop": flops / 1e9,
                "tflops": flops / (row["ms"] * 1e-3) / 1e12,
                "max_abs_err": err, "tol": tol, "bar_ratio": ratio, **fault,
                **det})
    row["ms_over_bound"] = row["ms"] / row["bound_ms"]
    row["ms_over_tf32_floor"] = row["ms"] / row["tf32_floor_ms"]
    _print_row("conv2d_gemm", row)
    return row, t_ops * 1e3, t_bytes * 1e3


CONV_SUM_KEYS = ("ms", "plain_ms", "library_ms", "tf32_library_ms",
                 "prep_ms", "reduce_ms", "bound_ms", "tf32_floor_ms",
                 "fma_bound_ms", "ops_ms", "bytes_ms")


def _conv_sites(model: str, cases, dtypes, gen, dev) -> dict:
    """Every case in each of ``dtypes``; returns the fp32 rows summed over
    the sites of one ``model`` forward, with the largest fp32 error."""
    total = dict.fromkeys(CONV_SUM_KEYS, 0.0)
    total["max_abs_err"], n_sites = 0.0, 0
    for dtype in dtypes:
        for (name, H, W, C, Fo, k, s, pad_h, sites) in cases:
            row, ops_ms, bytes_ms = conv_case(name, H, W, C, Fo, k, s, pad_h,
                                              dtype, gen, dev)
            if dtype != torch.float32:
                continue
            total["max_abs_err"] = max(total["max_abs_err"],
                                       row["max_abs_err"])
            row.update(ops_ms=ops_ms, bytes_ms=bytes_ms)
            for key in CONV_SUM_KEYS:
                total[key] += sites * row[key]
            n_sites += sites
    print(f"[kernel] conv2d_gemm {n_sites} fp32 sites of a {model} forward: "
          + " ".join(f"{k}={total[k]:.6g}" for k in CONV_SUM_KEYS[:-2])
          + f" ms_over_bound={total['ms'] / total['bound_ms']:.6g}"
          f" ms_over_tf32_floor={total['ms'] / total['tf32_floor_ms']:.6g}"
          f" below_library={total['ms'] < total['library_ms']}", flush=True)
    return total


def phase_kernels(dev) -> dict:
    """ResNet-50's cases in fp32 and bf16, VGG16's in fp32; returns the
    kernels-line entry, summed over the fp32 sites of one ResNet-50 and one
    VGG16 forward (17 + 13), the sites the eval phases launch."""
    gen = torch.Generator().manual_seed(0)
    sums = [_conv_sites("ResNet-50", CONV_CASES,
                        (torch.float32, torch.bfloat16), gen, dev),
            _conv_sites("VGG16", VGG_CONV_CASES, (torch.float32,), gen, dev)]
    total = {k: sum(t[k] for t in sums) for k in CONV_SUM_KEYS}
    bound_by = "operations" if total["ops_ms"] >= total["bytes_ms"] \
        else "bytes"
    return {"name": "conv2d_gemm", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": None,
            "max_abs_err": max(t["max_abs_err"] for t in sums),
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


def _faulty_attention(q, k, v, mul: float = 1.0, drop=None,
                      p_bf16: bool = False):
    """Causal attention in fp32 with the scores times ``mul``; with ``drop =
    (lo, hi)``, keys lo..hi-1 hidden from the queries past them; with
    ``p_bf16``, the unnormalised weights exp(s - max) rounded once to bf16
    before P·V (their sum taken in fp32), as a tensor-core kernel that does
    not split P would."""
    S = q.shape[2]
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    if drop is not None:
        keep[drop[1]:, drop[0]:drop[1]] = False
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * (mul / math.sqrt(q.shape[-1]))
    s = s.masked_fill(~keep, float("-inf"))
    if p_bf16:
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = p.to(torch.bfloat16).float() @ v.float()
        return (o / p.sum(-1, keepdim=True)).to(q.dtype)
    return (torch.softmax(s, -1) @ v.float()).to(q.dtype)


def _planted_faults(q, k, v, o_p, rtol, atol) -> dict:
    """Bar ratios of four faulty versions against the plain output; a bar
    that lets one of them pass (ratio ≤ 1) fails the run."""
    faults = {"fault_scale_1pct": _faulty_attention(q, k, v, mul=1.01),
              "fault_drop_tile": _faulty_attention(q, k, v, drop=(1024, 1088)),
              "fault_offset_2e-3": (o_p.float() + 2e-3).to(o_p.dtype),
              "fault_p_bf16": _faulty_attention(q, k, v, p_bf16=True)}
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
        row["ms_over_bound"] = row["ms"] / row["bound_ms"]
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


def _ssd_inputs(B, S, H, P, N, per_head, gen, dev):
    """x, dt, A, Bm, Cm as the model's init makes them (see SSD_CASES)."""
    x = torch.randn((B, S, H, P), generator=gen, device=dev)
    u = torch.rand(H, generator=gen, device=dev)
    dt_bias = torch.log(torch.expm1(torch.exp(
        u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))))
    dt = F.softplus(0.5 * torch.randn((B, S, H), generator=gen, device=dev)
                    + dt_bias)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    G = H if per_head else 1
    Bm, Cm = (torch.randn((B, S, G, N), generator=gen, device=dev).expand(
        B, S, H, N) for _ in range(2))
    return x, dt, A, Bm, Cm


def _faulty_chunk_ref(x, dt, A, Bm, Cm, Q, diag=0, shift=False):
    """``ssd_chunk_ref`` with one planted fault: the causal mask widened to
    j ≤ i + diag, or (shift) every decay taken from position j - 1."""
    Bsz, S, H, P = x.shape
    N, nC = Bm.shape[-1], S // Q
    xc, dtc = x.reshape(Bsz, nC, Q, H, P), dt.reshape(Bsz, nC, Q, H)
    Bc, Cc = Bm.reshape(Bsz, nC, Q, H, N), Cm.reshape(Bsz, nC, Q, H, N)
    cum = torch.cumsum(dtc * A, dim=2)
    cj = F.pad(cum, (0, 0, 1, 0))[:, :, :-1] if shift else cum
    diff = cum.transpose(2, 3)[..., :, None] - cj.transpose(2, 3)[..., None, :]
    keep = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril(diag)
    w = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc) \
        * torch.where(keep, torch.exp(diff), 0.0) \
        * dtc.transpose(2, 3)[..., None, :]
    y = torch.einsum("bchij,bcjhp->bcihp", w, xc).reshape(Bsz, S, H, P)
    states = torch.einsum("bcjh,bcjhn,bcjhp->bchpn",
                          torch.exp(cum[:, :, -1:] - cj) * dtc, Bc, xc)
    return y, states, torch.exp(cum[:, :, -1])


def _ssd_outputs(chunks, dt, A, Cm, init, drop=None) -> dict:
    """The per-chunk outputs and, through the inter-chunk recurrence (with
    chunk ``drop``'s state left out), y and the final state."""
    y_intra, states, decays = chunks
    carried = states
    if drop is not None:
        carried = states.clone()
        carried[:, drop] = 0
    y, final = ssd_combine(y_intra, carried, decays, dt, A, Cm, init)
    return {"y_intra": y_intra, "states": states, "decays": decays, "y": y,
            "final_state": final}


def _ssd_ratio(out: dict, ref: dict) -> float:
    """max over the outputs of max |out - ref| / (SSD_TOL · max |ref|): the
    bar fails above 1."""
    return max(float((out[k] - r).abs().max())
               / (SSD_TOL * max(float(r.abs().max()), 1e-30))
               for k, r in ref.items())


def phase_ssd(dev) -> dict:
    """ssd_chunk on every case; returns the kernels-line entry, timed at the
    Mamba-2 780m prompt pass's shape."""
    gen = torch.Generator(dev).manual_seed(3)
    rows_out, max_err = {}, 0.0
    for name, B, S, H, P, N, chunk, per_head, with_init in SSD_CASES:
        x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, per_head, gen, dev)
        Q = largest_divisor(S, chunk)
        init = 0.3 * torch.randn((B, H, P, N), generator=gen, device=dev) \
            if with_init else None
        plain = _ssd_outputs(ssd_chunk_ref(x, dt, A, Bm, Cm, Q), dt, A, Cm,
                             init)
        chunks = chunk_outputs(x, dt, A, Bm, Cm, Q)
        got = _ssd_outputs(chunks, dt, A, Cm, init)
        torch.cuda.synchronize()
        y, final = ssd_chunk(x, dt, A, Bm, Cm, chunk=chunk, init_state=init)
        if not (torch.equal(y, got["y"])
                and torch.equal(final, got["final_state"])):
            fail(f"ssd_chunk {name}: the wrapper differs from its kernel's "
                 f"outputs carried through ssd_combine")
        err = max(float((got[k] - plain[k]).abs().max()) for k in plain)
        ratio = _ssd_ratio(got, plain)
        if not all(bool(torch.isfinite(t).all()) for t in got.values()) \
                or ratio > 1.0:
            fail(f"ssd_chunk {name}: max abs err {err}, {ratio} times the "
                 f"bar ({SSD_TOL} of max |plain|)")
        det = {}
        if name in SSD_DETERMINISM_CASES:
            det["deterministic"] = all(
                all(torch.equal(a, b) for a, b in
                    zip(chunk_outputs(x, dt, A, Bm, Cm, Q), chunks))
                for _ in range(2))
            if not det["deterministic"]:
                fail(f"ssd_chunk {name}: two calls on the same inputs differ")
        faults = {}
        if name == SSD_CASES[0][0]:
            faults = {
                "fault_mask_j_eq_i+1": _ssd_ratio(_ssd_outputs(
                    _faulty_chunk_ref(x, dt, A, Bm, Cm, Q, diag=1), dt, A,
                    Cm, init), plain),
                "fault_decay_shift": _ssd_ratio(_ssd_outputs(
                    _faulty_chunk_ref(x, dt, A, Bm, Cm, Q, shift=True), dt,
                    A, Cm, init), plain),
                "fault_drop_chunk3_state": _ssd_ratio(_ssd_outputs(
                    ssd_chunk_ref(x, dt, A, Bm, Cm, Q), dt, A, Cm, init,
                    drop=3), plain),
                "fault_tf32_once": _ssd_ratio(_ssd_outputs(
                    emulate(x, dt, A, Bm, Cm, Q, products=(1, 1, 1)), dt, A,
                    Cm, init), plain)}
            missed = [n for n, r in faults.items() if r <= 1.0]
            if missed:
                fail(f"ssd_chunk bar ({SSD_TOL} of max |plain|) does not "
                     f"reject the planted faults {missed}: {faults}")
            # the same arithmetic with the split, for the kernel's own share
            faults["emulated_3xtf32"] = _ssd_ratio(_ssd_outputs(
                emulate(x, dt, A, Bm, Cm, Q), dt, A, Cm, init), plain)
        max_err = max(max_err, err)
        del plain, got, chunks
        nC = S // Q
        pairs = Q * (Q + 1) // 2
        flops = B * nC * H * (pairs * 2 * N + pairs * 2 * P + 2 * Q * P * N)
        bc_bytes = 2 * B * S * (H if per_head else 1) * N * 4
        nbytes = 4 * (2 * B * S * H * P + B * S * H + H + B * nC * H * P * N
                      + B * nC * H) + bc_bytes
        t_ops = FP32_TF32_PRODUCTS * flops / PEAK_TF32
        t_bytes = nbytes / PEAK_BYTES
        row = {"case": name, "Q": Q,
               "ms": kernel_ms(lambda: chunk_outputs(x, dt, A, Bm, Cm, Q),
                               reps=10, warmup=2),
               "prep_ms": kernel_ms(lambda: operand_prep(x, dt, A, Bm, Cm,
                                                         Q),
                                    reps=10, warmup=2),
               "wrapper_ms": kernel_ms(lambda: ssd_chunk(
                   x, dt, A, Bm, Cm, chunk=chunk, init_state=init),
                   reps=10, warmup=2),
               "plain_ms": kernel_ms(lambda: ssd_chunk_ref(x, dt, A, Bm, Cm,
                                                           Q),
                                     reps=3, warmup=1),
               "library_ms": None,
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "tf32_floor_ms": max(flops / PEAK_TF32, t_bytes) * 1e3,
               "fma_bound_ms": max(flops / PEAK_FLOPS[torch.float32],
                                   t_bytes) * 1e3,
               "gflop": flops / 1e9, "max_abs_err": err, "bar_ratio": ratio,
               **faults, **det}
        row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
        row["ms_over_bound"] = row["ms"] / row["bound_ms"]
        _print_row("ssd_chunk", row)
        rows_out[name] = row
        del x, dt, A, Bm, Cm, init
        torch.cuda.empty_cache()
    main = rows_out[SSD_CASES[0][0]]
    return {"name": "ssd_chunk", "route": "cuda",
            "source": KERNEL_SOURCE.format("ssd_chunk"),
            "replaces": KERNEL_REPLACES["ssd_chunk"], "launches": None,
            "max_abs_err": max_err,
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}}


def phase_eval(arch: str) -> int:
    """``arch``'s eval forward at batch 32, 224², with use_pallas on and off,
    same weights: the kernel launches EVAL_SITES[arch] times and the logits
    agree within EVAL_TOL of their scale. Returns the launches."""
    ctx_k = ShardingCtx("cuda", use_pallas=True)
    ctx_p = ShardingCtx("cuda")
    cfg = get_config(arch)
    model = build_model(cfg, ctx_k, seed=0)
    batch = Loader(train.data_config_for(cfg.model, BATCH, seed=0),
                   ctx_k.device).batch_at(0)
    eval_k, eval_p = make_eval_step(model, ctx_k), make_eval_step(model, ctx_p)

    conv2d_gemm.launches = 0
    out_k = eval_k(batch)
    torch.cuda.synchronize()
    launches = conv2d_gemm.launches
    if launches != EVAL_SITES[arch]:
        fail(f"the {arch} use_pallas forward launched conv2d_gemm {launches} "
             f"times, not {EVAL_SITES[arch]}")
    out_p = eval_p(batch)
    logits_k, logits_p = out_k["outputs"], out_p["outputs"]
    if tuple(logits_k.shape) != (BATCH, 1000) or \
            not bool(torch.isfinite(logits_k).all()):
        fail(f"{arch} eval logits: shape {tuple(logits_k.shape)} or not "
             f"finite")
    scale = float(logits_p.abs().max())
    ratio = _bar_ratio(logits_k, logits_p, EVAL_TOL,
                       EVAL_TOL * min(scale, 1.0))
    if ratio > 1.0:
        fail(f"{arch} eval logits kernel vs plain: {ratio} times the bar "
             f"{EVAL_TOL}·(|plain| + {min(scale, 1.0)})")
    ms_k = time_ms(lambda: eval_k(batch), reps=10, warmup=2)
    ms_p = time_ms(lambda: eval_p(batch), reps=10, warmup=2)
    diff = float((logits_k - logits_p).abs().max())
    print(f"[eval] {arch} batch={BATCH} launches={launches} "
          f"max_abs_diff={diff:.3g} logit_scale={scale:.4g} "
          f"bar_ratio={ratio:.3g} loss_kernel={float(out_k['loss']):.7g} "
          f"loss_plain={float(out_p['loss']):.7g} "
          f"ms_kernel={ms_k:.4g} ms_plain={ms_p:.4g}", flush=True)
    del model, eval_k, eval_p, out_k, out_p, batch
    torch.cuda.empty_cache()
    return launches


def phase_train(arch: str, batch: int):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = train.main(["--arch", arch, "--batch", str(batch),
                      "--steps", "3", "--log-every", "1", "--device", "cuda"])
    losses = out["losses"]
    if len(losses) != 3 or not all(math.isfinite(v) for v in losses):
        fail(f"{arch} training losses {losses}")
    step_ms = statistics.mean(out["step_s"][1:]) * 1e3   # after the first
    print(f"[train] {arch} batch={batch} steps=3 losses="
          f"{','.join(f'{v:.5g}' for v in losses)} ms_per_step={step_ms:.4g} "
          f"first_step_ms={out['step_s'][0] * 1e3:.4g} "
          f"samples_per_s={batch / step_ms * 1e3:.4g} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}",
          flush=True)
    torch.cuda.empty_cache()


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
    rmsnorm.launches = flash_attention.launches = ssd_chunk.launches = 0


def _counts() -> tuple[int, int, int]:
    return rmsnorm.launches, flash_attention.launches, ssd_chunk.launches


def _zero(cache):
    """The SSM's prompt pass starts from the state in its cache, so every
    prompt pass starts from a zeroed cache (for attention a no-op: every
    position it reads is rewritten first)."""
    for layer in cache["blocks"]:
        for t in layer.values():
            t.zero_()


def phase_serve(dev, arch: str) -> tuple[int, int, int]:
    """``arch`` at full width: prompt pass and greedy decode with use_pallas,
    then the same on the plain path; returns the (rmsnorm, flash_attention,
    ssd_chunk) launches of the kernel run."""
    cfg = get_config(arch)
    mc = cfg.model
    prompt_counts, step_counts = SERVE_LAUNCHES[arch]
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

    # warm-up (cuBLAS picks its algorithms)
    prefill_k({"tokens": tokens}, cache)
    decode_k(tokens[:, :1], cache, SERVE_S)
    _zero(cache)
    torch.cuda.synchronize()

    _reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill_k({"tokens": tokens}, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    names = "(rmsnorm, flash_attention, ssd_chunk)"
    if _counts() != prompt_counts:
        fail(f"{arch} prompt pass launched {names} {_counts()}, not "
             f"{prompt_counts}")
    total = list(_counts())
    if tuple(logits.shape) != (SERVE_B, 1, mc.vocab) or \
            logits.dtype != torch.float32:
        fail(f"{arch} prompt logits {tuple(logits.shape)} {logits.dtype}")
    kernel_logits, fed, step_s = [logits.clone()], [], []
    tok = logits.argmax(-1)
    for i in range(SERVE_STEPS):
        fed.append(tok)
        _reset_counts()
        t0 = time.perf_counter()
        logits, cache = decode_k(tok, cache, SERVE_S + i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if _counts() != step_counts:
            fail(f"{arch} decode step {i} launched {names} {_counts()}, not "
                 f"{step_counts}")
        total = [a + b for a, b in zip(total, _counts())]
        if not bool(torch.isfinite(logits).all()):
            fail(f"{arch} decode step {i}: logits not finite")
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
    if _counts() != (0, 0, 0):
        fail(f"{arch}: the plain path launched kernels {_counts()}")
    for i, d in enumerate(diffs):
        print(f"[serve] {arch} logits kernel vs plain, "
              f"{'prompt' if i == 0 else f'decode step {i - 1}'}: "
              + " ".join(f"{k}={v:.6g}" for k, v in d.items()), flush=True)
    decode_ms = statistics.mean(step_s) * 1e3
    print(f"[serve] {arch} params={model.num_params()} "
          f"weights_bytes={weight_bytes} cache_bytes={cache_bytes} "
          f"build_s={build_s:.4g} batch={SERVE_B} prompt={SERVE_S} "
          f"steps={SERVE_STEPS} prefill_ms={prefill_s * 1e3:.6g} "
          f"plain_prefill_ms={plain_prefill_s * 1e3:.6g} "
          f"prefill_tokens_per_s={SERVE_B * SERVE_S / prefill_s:.6g} "
          f"decode_ms_per_step={decode_ms:.6g} "
          f"decode_ms_median={statistics.median(step_s) * 1e3:.6g} "
          f"decode_tokens_per_s={SERVE_B / decode_ms * 1e3:.6g} "
          f"launches_rmsnorm={total[0]} launches_flash={total[1]} "
          f"launches_ssd={total[2]} max_memory_allocated={peak}", flush=True)
    worst = max(d["rel"] for d in diffs)
    if worst > SERVE_TOL[arch]:
        fail(f"{arch} serve logits kernel vs plain: relative diff {worst} "
             f"over {SERVE_TOL[arch]}")
    del model, cache
    torch.cuda.empty_cache()
    return tuple(total)


def phase_fp32_serve(dev, arch: str) -> float:
    """``arch`` at full width with every weight in fp32: the prompt pass and
    the first decode steps on the kernel path and on the plain path, fed
    the same tokens; returns the largest logit distance over the logit
    scale, and fails above FP32_SERVE_TOL."""
    cfg = get_config(arch)
    mc = cfg.model
    mc = dataclasses.replace(mc, dtype=torch.float32, ssm=dataclasses.replace(
        mc.ssm, dtype=torch.float32))
    model = build_model(dataclasses.replace(cfg, model=mc),
                        ShardingCtx(dev), seed=0)
    tokens = torch.randint(0, mc.vocab, (SERVE_B, SERVE_S), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    runs, fed = [], []
    for use_pallas in (True, False):
        ctx = ShardingCtx(dev, use_pallas=use_pallas)
        cache = zeros_like_spec(
            model.cache_spec(SERVE_B, SERVE_S + SERVE_CMP_STEPS), dev)
        logits, cache = make_prefill_step(model, ctx)({"tokens": tokens},
                                                      cache)
        decode = make_decode_step(model, ctx)
        seq = [logits]
        for i in range(SERVE_CMP_STEPS):
            if use_pallas:
                fed.append(seq[-1].argmax(-1))
            logits, cache = decode(fed[i], cache, SERVE_S + i)
            seq.append(logits)
        runs.append(seq)
        del cache
    diffs = [_logit_diff(k, p) for k, p in zip(*runs)]
    worst = max(d["rel"] for d in diffs)
    print(f"[serve] {arch} fp32 logits kernel vs plain: rel_prompt="
          f"{diffs[0]['rel']:.6g} rel_worst={worst:.6g} "
          f"argmax_agree_min={min(d['argmax_agree'] for d in diffs):.4g}",
          flush=True)
    if worst > FP32_SERVE_TOL:
        fail(f"{arch} fp32 logits kernel vs plain: relative diff {worst} "
             f"over {FP32_SERVE_TOL}")
    del model
    torch.cuda.empty_cache()
    return worst


def _oracle_rows(block: str, rows: list) -> float:
    """Prints ``accuracy_report`` of (arch, point) rows, one [oracle] line
    each, the model's name before the row; returns the mean accuracy."""
    lines = accuracy_report([pt for _, pt in rows]).splitlines()
    print(f"[oracle] {block} {'model':10s} {lines[0]}", flush=True)
    for (arch, _), line in zip(rows, lines[1:-1]):
        print(f"[oracle] {block} {arch:10s} {line}", flush=True)
    print(f"[oracle] {block} {'':10s} {lines[-1]}", flush=True)
    return statistics.mean(pt.accuracy for _, pt in rows)


def phase_oracle(dev):
    """The paper's Fig. 3 at p = 1 on the card: for each of ORACLE_RUNS in
    turn (each freed before the next), fp32 with TF32 off, the measured
    train step (SGD) against the oracle's projection, in two blocks:
    self-calibrated (calibrated on the model it projects, the reference's
    default) and calibrated on ResNet-50 (``calibrate_host_system`` on
    ResNet-50 → a ClusterSpec on ``cuda_device_model``, then
    ``validate(..., cluster=)`` for the other models). ResNet-50 is
    calibrated once: its self-calibrated point is ``validate`` with its own
    cluster, which at p = 1 is ``validate`` without one. Then, per model,
    the oracle's projected memory (fp32 values, δ = 4 bytes, SGD's one
    momentum: 4 bytes a parameter) beside the peak of the measured step of
    ``validate(..., cluster=)``. Reports only; no accuracy is gated."""
    ctx = ShardingCtx(dev)
    self_rows, cross_rows, cluster = [], [], None
    for arch, batch_size in ORACLE_RUNS:
        cfg = get_config(arch)
        mc = cfg.model
        torch.cuda.empty_cache()
        model = build_model(cfg, ctx, seed=0)
        batch = Loader(train.data_config_for(mc, batch_size, seed=0),
                       dev).batch_at(0)
        stats = stats_for(mc)
        fps = float(sum(st.flops_fwd for st in stats))
        if cluster is None:
            sysm = calibrate_host_system(lambda b: model.loss_fn(b, ctx),
                                         model.parameters(), batch,
                                         fps * batch_size)
            cluster = ClusterSpec.from_system(sysm)
            print(f"[oracle] calibrated on {arch} batch={batch_size}: "
                  f"{sysm.name} peak_flops={sysm.peak_flops:.6g} "
                  f"hbm_bw={sysm.hbm_bw:.6g} "
                  f"mem_capacity={sysm.mem_capacity:.6g}", flush=True)
            rows = self_rows
        else:
            (pt,) = validate(model, mc, batch, ctx, ["data"],
                             flops_per_sample=fps, B=batch_size)
            self_rows.append((arch, pt))
            rows = cross_rows
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (pt,) = validate(model, mc, batch, ctx, ["data"],
                         flops_per_sample=fps, B=batch_size, cluster=cluster)
        peak = torch.cuda.max_memory_allocated()
        rows.append((arch, pt))
        proj = project("data", stats, TimeModel(cluster.system),
                       OracleConfig(B=batch_size, D=batch_size, delta=4.0,
                                    opt_bytes_per_param=4.0), 1)
        print(f"[oracle] {arch} batch={batch_size} "
              f"gflop_fwd_per_sample={fps / 1e9:.6g} "
              f"params={model.num_params()} "
              f"projected_mem_bytes={proj.mem_bytes:.6g} "
              f"max_memory_allocated={peak}", flush=True)
        del model, batch, pt
        torch.cuda.empty_cache()
    for arch, pt in self_rows + cross_rows:
        if not all(math.isfinite(t) and t > 0 for t in (
                pt.measured_s, pt.projected_s, pt.projected_serial_s)):
            fail(f"[oracle] {arch}: measured {pt.measured_s} s, projected "
                 f"{pt.projected_s} s, serial {pt.projected_serial_s} s")
    mean_self = _oracle_rows("self-calibrated", self_rows)
    mean_cross = _oracle_rows("calibrated-on-resnet50", cross_rows)
    print(f"[oracle] mean accuracy: self-calibrated={mean_self * 100:.4g}% "
          f"calibrated-on-resnet50={mean_cross * 100:.4g}% "
          f"(paper: 86.74% on 1024 V100s)", flush=True)


def main():
    name, smi = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ShardingCtx(dev)          # TF32 off for the plain versions
    phase_build()
    conv = phase_kernels(dev)
    rms = phase_rmsnorm(dev)
    flash = phase_flash(dev)
    ssd = phase_ssd(dev)
    conv["launches"] = sum(phase_eval(arch) for arch in EVAL_SITES)
    for arch, batch in TRAIN_RUNS:
        phase_train(arch, batch)
    phase_oracle(dev)
    qwen = phase_serve(dev, "qwen1.5-4b")
    mamba = phase_serve(dev, "mamba2-780m")
    phase_fp32_serve(dev, "mamba2-780m")
    # rmsnorm runs on both LM paths: its launches are the two runs' sum
    rms["launches"] = qwen[0] + mamba[0]
    flash["launches"], ssd["launches"] = qwen[1], mamba[2]
    print(json.dumps({"kernels": [conv, rms, flash, ssd]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
