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
  5c. parallel  the paper's CNN strategies across ranks: PAR_RANKS ranks
             share the card over gloo on a (2, 2) (data, model) mesh,
             spawned after the build. The ds-sharded ResNet-50 and VGG16
             eval with use_pallas (batch 32, 224²): conv2d_gemm launches per
             rank against the count the site list gives (a stride-1 site
             whose image splits runs the pad_h=False entry on its interior
             and two boundary tiles), logits gathered and held against the
             single-process kernel path within EVAL_TOL; 2 SGD steps of
             ResNet-50 under data, filter, channel, ds and df and of
             CosmoFlow under data and ds, the first loss, the first
             step's gradient norm and the second loss against two
             single-process steps within PAR_LOSS_TOL and PAR_STEP_TOL;
             Fig. 3 at p = 4 (calibrate_cluster on the mesh, then
             validate; reported, gated on finiteness only) and the
             phase's wall time.
  5d. pipeline  the paper's layer strategy (§3.4) on the same spawn: the
             PAR_RANKS ranks as the stages of a (1, PAR_RANKS) regrid of
             the [parallel] world. 2 SGD steps of each PIPE_TRAIN case
             (ResNet-50 at batch 32, S = 8, under gpipe, one_f_one_b and
             interleaved with v = 2; VGG16 at batch 32, S = 8, under
             gpipe; CosmoFlow at batch 8, S = 4, under gpipe and
             one_f_one_b), the first loss, the first step's gradient norm
             and the second loss against two single-process steps at the
             microbatch size (make_train_step(accum=S); CosmoFlow, which
             has no BatchNorm, the plain step) within PAR_LOSS_TOL and
             PAR_STEP_TOL, with pipeline_segments, the cuts, the step ms
             and each rank's peak memory; measure_schedule_bubble for
             ResNet-50 at microbatch 2, S 4 and 8, under each schedule,
             beside the oracle's schedule_winner at p = 4 (reported, not
             gated); Fig. 3's pipeline row at p = 4 for the PAR_ORACLE
             models under the cluster [parallel] calibrated, and the mean
             accuracy at p = 4 with and without it (gated on finiteness
             only).
  5e. lm-parallel  the LMs under the paper's strategies on the same spawn
             and (2, 2) mesh: Qwen1.5-4B at its published widths with 2 of
             its 40 layers, fp32, batch 4 x 512, and Mamba-2 780m the same
             way at batch 4 x 1024 (configs.lm_archs.LM_PARALLEL_SHAPE),
             weights from seed 0. 2 SGD steps: the Qwen under data,
             filter, df, df_zero1 and df_zero3, Mamba under data, filter,
             channel, df and ds (the spatial table is ds's, so it is not
             run again; the Qwen's channel and ds are cut for time, see
             LM_PAR): the
             first loss, the first step's gradient norm and the second loss
             against two single-process steps (computed first, released
             before the spawn) within PAR_LOSS_TOL and PAR_STEP_TOL, with
             the step ms and every rank's peak memory; Fig. 3's LM rows at
             p = 4 (the Qwen, validate self-calibrated, as the
             reference's check_oracle_validation: data, filter and df,
             and the mean, each the median of 2 steps after 1 warm-up
             step; channel, spatial and ds are left out for time, see
             LM_PAR; gated on finiteness only); the kernel
             launches per rank (none: no kernel has a backward, so LM
             training runs the plain norms, attention and SSD) and the
             phase's wall time.
  5f. lm-pipeline  the LM pipeline on the same spawn, the ranks as the
             stages of the (1, PAR_RANKS) regrid, fp32, full widths,
             weights from seed 0 (configs.lm_archs.LM_PIPELINE_SHAPE):
             Qwen1.5-4B with 4 of its 40 layers at batch 4 x 512, S = 4,
             under gpipe and one_f_one_b; Mamba-2 780m (its table tied:
             read by the first and the last stage) with 8 of its 48 layers
             at 4 x 1024, S = 4, under gpipe, one_f_one_b and interleaved
             (v = 2); cut on the oracle's per-layer costs. 2 SGD steps a
             case: the first loss, the first gradient norm and the second
             loss against two single-process steps within PAR_LOSS_TOL
             and PAR_STEP_TOL, with the cuts, pipeline_segments, the step
             ms and every rank's peak memory; Fig. 3's pipeline row for
             the Qwen at p = 4 (validate, self-calibrated; gated on
             finiteness only) and the phase's wall time.
  5g. summa  the 2-D SUMMA grid on the same spawn: the world as the
             (1, 2, 2) (data, model_r, model_c) grid
             (launch.mesh.make_grid_mesh), Qwen1.5-4B at LM_PARALLEL_SHAPE
             under the "summa" rules, 2 SGD steps held against the
             single-process steps [lm-parallel] computed for that shape,
             at the same bars; the summa_matmul calls a rank (> 0, or the
             grid never engaged), the step ms and every rank's peak; Fig.
             3's summa row at p = 4 (validate(grid=(2, 2)),
             self-calibrated; gated on finiteness only) and the phase's
             wall time.
  5h. serve-sharded  the serving engine across the same ranks on the
             (1, PAR_RANKS) regrid: Qwen1.5-4B at full width with
             SHARDED_LAYERS of its 40 layers, fp32, use_pallas, weights
             from seed 0 (each rank cuts every weight to its block as it is
             drawn); 8 requests of TrafficModel(rate 8, prompt 128, gen
             16), seed 0, closed loop, 8 slots, 16-token blocks, prefill
             chunk 64, max_len 256, replayed by
             core.validation.measure_serving under serve_tp (kv_shards 1)
             and serve_seqkv (kv_shards PAR_RANKS). Every request's tokens
             on every rank equal the single-process engine's (computed
             before the spawn); request 0's first prompt chunk's logits
             within SHARDED_LOGIT_TOL in relative L2; rmsnorm launches
             2·L + 1 times and flash_attention and ssd_chunk never in
             every cell call on every rank. Per layout the collectives a
             decode_step call and a cell, the host ms inside comm.* a
             cell, tok/s, TTFT and latency p50/p99 and every rank's peak,
             beside price_serving at p1 = 1, p2 = PAR_RANKS on the cluster
             the [parallel] phase calibrated (gated on finiteness only);
             the winners by tok/s, printed, not gated.
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
  8. lm-train repro_torch.launch.train.main, 3 AdamW steps each, bf16 at
             full width, on the plain path (no kernel has a backward):
             Qwen1.5-4B at batch 2, seq 512, and Mamba-2 780m at batch 2,
             seq 1024 (configs.lm_archs.LM_TRAIN_SHAPE); ms/step, tokens/s and the peak memory; every loss
             finite. Then the fp32 smoke Qwen and Mamba take two AdamW
             steps on the card and on the CPU from the same weights (drawn
             on the CPU from seed 0) and batches: the first loss, the first
             gradient norm and the second loss within LM_CPU_TOL.
  9. engine  Qwen1.5-4B at full width in bf16 (seed 0) behind the serving
             engine with use_pallas: 16 requests of TrafficModel(rate 8,
             prompt_len 256, gen_len 32), seed 0, max_batch 8, block_tokens
             16, prefill_chunk 64 (launch.profile_serve.engine_cell), max_len from the trace as launch/serve.py
             reckons it (448), replayed closed-loop by
             core.validation.measure_serving (a warm-up replay, reset, the
             measured one). Every request returns gen_len tokens and every
             block is free after; rmsnorm launches 81 times and
             flash_attention never in every cell call (prefill chunk or
             decode batch). Requests ENGINE_CHECKED again through an engine:
             their logits at the first generated token against a solo
             dense-cache greedy decode of the same prompt within SERVE_TOL
             of their scale (the share of their tokens that match is
             printed, not gated: bf16 GEMMs at batch 8 and 1 may round
             differently). The report's tok/s, TTFT and latency p50/p99 and
             the peak memory, beside price_serving("serve_tp", p1 = p2 = 1,
             max_batch 8, the same traffic) on cuda_device_model with phase
             5b's HBM rate and the bf16 peak: reported, gated on finiteness.
  10. auto  the oracle deploys its own plan (launch.train --strategy
             auto, core.autotune). The cluster the [oracle] phase calibrated
             on ResNet-50 (cuda_device_model with the measured HBM rate and
             FLOP/s) is written to a ClusterSpec JSON and passed as
             --cluster to every auto run. On one card: ResNet-50 at batch
             32 and the LMs at LM_TRAIN_SHAPE, 3 steps each: the plan (at
             p = 1), ms/step, samples or tokens a second and the peak
             memory; every loss finite. The remat switch: Mamba-2 780m at
             full width, bf16, at the reference's 4 x 1024 (REMAT_RUNS; the
             batch LM_TRAIN_SHAPE cut, its plain SSD saving 97.9 GB without
             remat), and Qwen1.5-4B at 2 x 512, 3 AdamW steps each through
             make_train_step(remat=True): ms/step, tokens/s and the peak,
             beside the tuner's projected memory for that point. The fp32
             smoke Qwen and Mamba with remat on and off from the same
             weights and batches: the first loss equal, the first gradient
             norm and the second loss within LM_CPU_TOL. On the [parallel]
             spawn's 4 ranks: ResNet-50 (full depth, batch 32, as [parallel]
             trains it) under --strategy auto, the plan at p = 4, the mesh
             it deployed, the losses (finite), ms/step and every rank's peak.
  11. serve-auto  the data axis in serving, in the [parallel] spawn next
             to serve-sharded, on its cut (Qwen1.5-4B fp32, SHARDED_LAYERS
             of 40 layers), trace and single-process tokens:
             launch.serve.main --strategy auto with the [oracle] cluster's
             JSON (the plan and the mesh deployed printed; every rank's
             tokens equal), then serve_tp and serve_seqkv (kv_shards 2) on
             the spawn's (2, 2) mesh, each decode batch's rows split over
             "data": every request's tokens on every rank equal to the
             single-process engine's, 2·L + 1 rmsnorm launches a cell call
             on every rank; tok/s, TTFT and latency p50/p99, collectives
             and host ms in comm.* a cell, every rank's peak, beside
             price_serving(p1=2, p2=2).
  12. api   the session (repro_torch.api.Oracle) on one card. The [oracle]
             phase's ResNet-50 calibration goes through Oracle.calibrate;
             its ClusterSpec JSON reads back equal and the session's
             projection equals the direct call's. Oracle("resnet50",
             "train_4k", cluster).build(None): the built cell's plan and 2
             steps at the shape's global batch (256 at 224²; ms/step, the
             peak); .validate(ctx, ("data",), use_cluster=True): one Fig. 3
             row at p = 1 (the smoke model); the Qwen1.5-4B and Mamba-2
             780m serving cells at prefill_32k and decode_32k built on
             meta: their strategy and argument shapes (not run).
  13. ckpt  checkpointing through launch.train.main --ckpt-dir: ResNet-50
             at batch 32, 4 steps straight against 2 steps and a fresh run
             resumed to step 4 (cuDNN in its deterministic mode for the
             phase), then Qwen1.5-4B cut to CKPT_LM_LAYERS layers in bf16
             the same way: the resumed steps' losses equal the straight
             run's bit for bit; every save's host-copy and write ms and its
             bytes on disk (async and blocking); a torn step directory
             (no .complete) is skipped.
  14. elastic  the elastic runtime (runtime/elastic.py) in a spawn of its
             own: PAR_RANKS ranks share the card over gloo, ResNet-50 at
             full width and depth, batch 32 at 224², fp32, AdamW, cuDNN
             deterministic, on the [oracle] cluster with a (2, 2) torus
             whose model axis may ring only in dim 1 (ELASTIC). A
             baseline through launch.train --strategy auto --elastic, 4
             steps, a checkpoint every 2; a chaos run through run_elastic
             with torus dim 0 lost before step 3: the survivors (ranks 0
             and 1) re-tune on the degraded cluster, lay themselves out
             as the new plan's mesh, restore the checkpoint at 2 onto it
             and resume; a planned continuation (bind_plan on the degraded
             cluster with the first 2 ranks, the baseline's checkpoint at
             2 restored, plain steps 2-3). Gates: steps 0-1 equal the
             baseline's bit for bit, steps 2-3 the planned continuation's,
             the final parameters (gathered whole) equal it; the event
             reads p 4 → 2, resumed from 2, ranks 2 and 3 left out; the
             re-tuned (p1, p2) passes the degraded torus's split_mask.
             Printed: the plan before and after, ms/step on 4 and on 2
             ranks, every save's host-copy and write ms, the recovery
             seconds (SliceLost to the end of the first resumed step) and
             a restore's ms, every rank's peak.
Then a JSON line for the kernels, the nvidia-smi line, and the result line.
It imports nothing of jax or of the JAX package.
"""
from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import io
import json
import math
import statistics
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.cnn_archs import ORACLE_BATCH  # noqa: E402
from repro_torch.configs.lm_archs import (LM_PARALLEL_SHAPE,  # noqa: E402
                                          LM_PIPELINE_SHAPE, LM_TRAIN_SHAPE,
                                          lm_parallel_arch)
from repro_torch.core.cluster import ClusterSpec  # noqa: E402
from repro_torch.core.hardware import cuda_device_model  # noqa: E402
from repro_torch.core.layer_stats import stats_for  # noqa: E402
from repro_torch.core.oracle import (OracleConfig, TimeModel,  # noqa: E402
                                     project)
from repro_torch.core.validation import (accuracy_report,  # noqa: E402
                                         measure_serving, validate)
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
from repro_torch.launch.profile_serve import engine_cell  # noqa: E402
from repro_torch.nn.module import ShardingCtx, zeros_like_spec  # noqa: E402
from repro_torch.optim.optimizers import OptimizerConfig  # noqa: E402
from repro_torch.serve import Engine, price_serving  # noqa: E402
from repro_torch.training.steps import (make_decode_step,  # noqa: E402
                                        make_eval_step, make_prefill_step,
                                        make_train_step, train_state)

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

# The parallel phase: PAR_RANKS ranks share cuda:0 over gloo (NCCL refuses
# two ranks on one device) on a (PAR_RANKS / PAR_MODEL, PAR_MODEL) mesh.
PAR_RANKS, PAR_MODEL = 4, 2
# sharded eval with the kernel: (arch, the image's height at each HaloConv
# site, in order, and the site's stride), batch 32, 224², under ds
PAR_EVAL_SITES = {
    "resnet50": [(224, 7, 2)] + [(56, 3, 1)] * 3
    + [(56, 3, 2)] + [(28, 3, 1)] * 3
    + [(28, 3, 2)] + [(14, 3, 1)] * 5
    + [(14, 3, 2)] + [(7, 3, 1)] * 2,
    "vgg16": [(224, 3, 1)] * 2 + [(112, 3, 1)] * 2 + [(56, 3, 1)] * 3
    + [(28, 3, 1)] * 3 + [(14, 3, 1)] * 3,
}
# sharded training, 2 SGD steps each: (arch, global batch, strategies)
PAR_TRAIN = (("resnet50", 32, ("data", "filter", "channel", "ds", "df")),
             ("cosmoflow", 8, ("data", "ds")))
# each strategy's two steps against two single-process steps from the same
# weights and batch, relative: the first loss (the forward) within
# PAR_LOSS_TOL; the first step's whole-model gradient norm before clipping
# (the backward: the collectives' adjoints, the halo's returned rows, the
# replica sums and the sharded norm) and the second loss (the update)
# within PAR_STEP_TOL. Both sides are the same fp32 function with its sums
# in another order (cuDNN picks its algorithm per local shape; BatchNorm's
# statistics are all-reduced sums; the loss a sum over the ranks' rows):
# the CPU tests read ≤ 1.7e-6 for the smoke models' losses. The backward
# carries those roundings further (BatchNorm's backward subtracts means of
# products; a ReLU input near zero rounds to the other side), hence the
# second bar: on an H100 the five ResNet-50 strategies read 1.4e-5 to
# 1.7e-4 in the norm (data, which splits no weight, 7.2e-5), and the
# phase prints the same function's own spread beside them (the
# single-process steps on the batch with its rows permuted). A gradient p
# times too large reads p − 1 in the norm, a replicated gradient left
# unsummed over two replicas about 0.3 to 0.5, and either moves the second
# loss by percents; a statistic wrong by a factor moves the first loss by
# O(1).
PAR_LOSS_TOL = 1e-5
PAR_STEP_TOL = 1e-3
# The pipeline phase: the same ranks as the stages of a (1, PAR_RANKS) mesh
# (Mesh.regrid over the [parallel] world). Training, 2 SGD steps each:
# (arch, global batch, requested S, ((schedule, interleaved v), ...)).
# CosmoFlow's 6 blocks hold no v = 2 (8 chunks on 4 ranks), as the
# reference's own check says. Each case is held against two single-process
# steps at the bars above: the same fp32 function at the microbatch size
# (ResNet-50's and VGG16's BatchNorm-free or per-microbatch statistics:
# make_train_step(accum=S) for ResNet-50, whose BatchNorm takes per-
# microbatch statistics under the pipe, and VGG16; the plain step for
# CosmoFlow), with the loss summed over the microbatches on the last stage
# and the gradients accumulated in the schedule's order (the CPU tests
# read ≤ 1.3e-7 in the loss and 1.7e-6 in the update). BatchNorm over the
# whole batch instead moves the smoke ResNet's loss by 19 % (the CPU
# tests), and a gradient lost at a stage boundary moves the norm by O(1).
PIPE_TRAIN = (("resnet50", 32, 8, (("gpipe", 1), ("one_f_one_b", 1),
                                   ("interleaved", 2))),
              ("vgg16", 32, 8, (("gpipe", 1),)),
              ("cosmoflow", 8, 4, (("gpipe", 1), ("one_f_one_b", 1))))
# the bubble fit (measure_schedule_bubble): (arch, microbatch, S_small,
# S_large), every schedule, interleaved at v = 2; reported, not gated
PIPE_BUBBLE = ("resnet50", 2, 4, 8)
# Fig. 3 at p = 4: (arch, global batch, oracle strategies); "spatial" is
# measured under the ds rules, as the reference does. At ResNet-50's batch
# 32 its points took 113 s on an H100 (filter and channel move whole
# activations through host-staged collectives at every layer: 6.4 and 5.5 s
# a step), which pushed the phase past 3 minutes; so ResNet-50 runs at
# global batch 16, and CosmoFlow at its own ORACLE_BATCH of 8.
PAR_ORACLE = (("resnet50", 16, ("data", "filter", "channel", "spatial",
                                "df", "ds")),
              ("cosmoflow", ORACLE_BATCH["cosmoflow"], ("data", "spatial")))
# The lm-parallel phase on the same spawn: (arch, rules tables), each model
# at LM_PARALLEL_SHAPE (layers, global batch, seq), 2 SGD steps a table,
# held against two single-process steps at the bars above (the CPU tests
# read <= 1.5e-7 in the smoke LMs' losses and <= 1.3e-6 in their
# gradients' relative L2); then Fig. 3's LM rows for LM_PAR_ORACLE. Cut
# for the time the serve-sharded phase needs: the "spatial" table is the
# "ds" table (the same rules), so "ds" trains and "spatial" does not;
# Fig. 3's LM rows run data, filter and df (channel's step is filter's in
# time, 10.2 s against 10.3 on an H100, and the oracle projects both at
# 733.28 ms; spatial is measured under the ds rules; the five rows with
# channel and ds took 271 s on an H100). Cut again for the elastic phase:
# the Qwen's channel and ds tables do not train here (channel's 2 steps
# take filter's time, 10.2 against 10.3 s a step; ds's 9.2 s a step), so
# the Qwen's attention under channel and ds runs on the CPU only, on the
# smoke LMs of tests/test_torch_lm_parallel.py; Mamba-2 780m keeps all
# five. Fig. 3's LM rows measure each point over 2 steps after 1 warm-up
# (LM_PAR_ORACLE_STEPS) where validate takes 4 after 2 (6 steps took 73 s
# of the three rows' 166 under filter on an H100).
LM_PAR = (("qwen1.5-4b", ("data", "filter", "df", "df_zero1",
                          "df_zero3")),
          ("mamba2-780m", ("data", "filter", "channel", "df", "ds")))
LM_PAR_ORACLE = ("qwen1.5-4b", ("data", "filter", "df"))
LM_PAR_ORACLE_STEPS = dict(iters=2, warmup=1)
# The lm-pipeline phase on the same spawn, the ranks as the stages of the
# (1, PAR_RANKS) regrid: (arch, requested S, ((schedule, interleaved v),
# ...)) at LM_PIPELINE_SHAPE (layers, global batch, seq), 2 SGD steps a
# case, cut on the oracle's per-layer costs, held against two
# single-process steps at the bars above (the CPU tests read ~1e-7 in the
# smoke LMs' losses and ~1e-9 in their updated parameters). Then Fig. 3's
# pipeline row for LM_PIPE_ORACLE at the same shape.
LM_PIPE = (("qwen1.5-4b", 4, (("gpipe", 1), ("one_f_one_b", 1))),
           ("mamba2-780m", 4, (("gpipe", 1), ("one_f_one_b", 1),
                               ("interleaved", 2))))
LM_PIPE_ORACLE = "qwen1.5-4b"
# The summa phase on the same spawn: (arch, the (data, model_r, model_c)
# grid) at LM_PARALLEL_SHAPE, 2 SGD steps held against the lm-parallel
# phase's single-process steps, then Fig. 3's summa row at (r, c).
SUMMA_RUN = ("qwen1.5-4b", (1, 2, 2))
# The serve-sharded phase on the same spawn, the ranks on the (1, PAR_RANKS)
# regrid: the engine serving SHARDED_ARCH at full width and depth in fp32
# (bf16 moves some request's tokens under serve_tp against one device; the
# reference's own serving check builds an fp32 model for that reason), with
# use_pallas, weights from seed 0, under each (layout, kv_shards): the trace
# TrafficModel(**SHARDED_TRAFFIC), SHARDED_REQUESTS requests, seed 0, closed
# loop, max_len as launch.serve aligns it to prefill_chunk x kv_shards for
# the widest layout (256). Gates: every request's tokens on every rank equal
# the single-process engine's (computed before the spawn); the logits of
# request 0's first prompt chunk within SHARDED_LOGIT_TOL of the single-
# process ones in relative L2 (the CPU tests read ~1e-7 at the smoke width;
# fp32 sums in another order; 2.0e-6 at 40 layers on an H100); the
# launches a cell call on every rank 2·L + 1 rmsnorm, as
# ENGINE_CELL_LAUNCHES at 40 layers. The serving oracle's projection at
# p1 = 1, p2 = PAR_RANKS is printed beside the measurement, gated on
# finiteness only.
SHARDED_ARCH = "qwen1.5-4b"
# 4 of its 40 layers: every collective waits on the card's time slices
# among the 4 rank processes (8.5-12 ms each on an H100; 81 a serve_tp
# decode cell, 281 a serve_seqkv one at 40 layers). At 40 layers the phase
# took 438.5 s (every gate held), at 8 112.4 s and the script 1152.5 s of
# its 1200, at 4 45.9 s
SHARDED_LAYERS = 4
SHARDED_LAYOUTS = (("serve_tp", 1), ("serve_seqkv", PAR_RANKS))
SHARDED_TRAFFIC = dict(rate=8.0, prompt_len=128, gen_len=16)
SHARDED_REQUESTS = 8
SHARDED_CFG = dict(max_batch=8, block_tokens=16, prefill_chunk=64)
SHARDED_LOGIT_TOL = 1e-4

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

# The lm-train phase: 3 AdamW steps of each LM at full width, at its
# (batch, seq) in LM_TRAIN_SHAPE (Mamba-2 780m at batch 2: see there).
# Card against CPU, fp32 smoke configs, TF32 off, the same weights and
# batches (LM_CPU_BATCH sequences of LM_CPU_SEQ tokens): bars on the
# relative distance of (first loss, first gradient norm, second loss). The
# two devices sum each matmul and reduction in another order (~1e-7 of a
# loss is typical), and exp/log round differently in the last bit: 1e-5
# for the loss, 1e-4 for the norm (a sum of squares over every gradient,
# some of them sums with cancellation: the CPU tests read 6e-6 between the
# packages for one Mamba tensor). AdamW's first update is lr·g/(|g| + eps),
# which turns gradients near eps (1e-8) into updates that differ by up to
# lr between devices, so the second loss gets 1e-3, the bar of the
# parallel phase's second loss.
LM_CPU_TOL = (1e-5, 1e-4, 1e-3)
LM_CPU_BATCH, LM_CPU_SEQ = 4, 32
# The engine phase: Qwen1.5-4B, bf16, full width, in launch.profile_serve's
# engine_cell; requests held against a solo dense-cache greedy decode
ENGINE_CHECKED = (0, 1)
# launches of (rmsnorm, flash_attention, ssd_chunk) in every engine cell
# call: 2 norms a layer and the final one, the attention in plain torch
ENGINE_CELL_LAUNCHES = (81, 0, 0)
# The auto phase: (arch, batch, seq or None) trained by launch.train
# --strategy auto on one card, on the cluster [oracle] calibrated
AUTO_RUNS = (("resnet50", BATCH, None),) + tuple(
    (arch, b, seq) for arch, (b, seq) in LM_TRAIN_SHAPE.items())
# the remat switch at full width, bf16: (arch, batch, seq); Mamba-2 780m at
# the reference's 4 x 1024, the shape LM_TRAIN_SHAPE cut for memory
REMAT_RUNS = (("mamba2-780m", 4, 1024), ("qwen1.5-4b", 2, 512))
# --strategy auto on the [parallel] spawn's ranks: ResNet-50 as [parallel]
# trains it (full depth, global batch 32)
AUTO_PAR = ("resnet50", BATCH)
# serve-auto: the layouts on the spawn's (2, 2) mesh, (layout, kv_shards)
SERVE_AUTO_LAYOUTS = (("serve_tp", 1), ("serve_seqkv", PAR_MODEL))
# the api phase's serving cells, built on meta and not run
API_SERVE_CELLS = tuple((arch, shape) for arch in ("qwen1.5-4b",
                                                   "mamba2-780m")
                        for shape in ("prefill_32k", "decode_32k"))
# each shape's cell kind
SHAPES_KIND = {"prefill_32k": "prefill", "decode_32k": "decode"}
# ckpt: ResNet-50 at BATCH, and the Qwen1.5-4B cut to this many layers in
# bf16 at LM_TRAIN_SHAPE (its checkpoint ~9.4 GB: the embedding and the
# head, and AdamW's two fp32 moments)
CKPT_LM_LAYERS = 2
# elastic: (arch, global batch, steps, checkpoint every, the step before
# which torus dim 0 dies) on PAR_RANKS ranks sharing the card over gloo, a
# (2, 2) torus whose model axis may ring only in dim 1 (the [oracle]
# cluster's levels and compute)
ELASTIC = ("resnet50", BATCH, 4, 2, 3)
ELASTIC_TORUS = ("2x2", "1")


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
    default) and calibrated on ResNet-50 (the session's
    ``Oracle.calibrate`` on ResNet-50 → a ClusterSpec on
    ``cuda_device_model``, ``_session_calibration``, then
    ``validate(..., cluster=)`` for the other models). ResNet-50 is
    calibrated once: its self-calibrated point is ``validate`` with its own
    cluster, which at p = 1 is ``validate`` without one. Then, per model,
    the oracle's projected memory (fp32 values, δ = 4 bytes, SGD's one
    momentum: 4 bytes a parameter) beside the peak of the measured step of
    ``validate(..., cluster=)``. Reports only; no accuracy is gated.
    Returns the session whose calibration (``Oracle.calibrate``) fitted
    the cluster on ResNet-50 (its system holds the card's HBM rate as
    measured for the calibration)."""
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
            ses = _session_calibration(cfg, batch_size, dev)
            cluster = ses.cluster
            sysm = cluster.system
            print(f"[oracle] calibrated on {arch} batch={batch_size} "
                  f"(Oracle.calibrate on one card): "
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
    return ses


def _halo_launches(sites, m: int) -> int:
    """conv2d_gemm launches of one sharded forward on each rank, from the
    site list: a stride-1 site whose image splits over the m model ranks
    takes the halo path, 3 launches (interior, top and bottom tiles; 1, the
    serial tile, where the block is no taller than the halo), every other
    site 1 (the whole image, its H gathered)."""
    n = 0
    for h, k, s in sites:
        lo, hi = (k - 1) // 2, k // 2
        if s == 1 and m > 1 and h % m == 0 and h // m >= max(lo, hi):
            n += 3 if h // m > lo + hi else 1
        else:
            n += 1
    return n


def _parallel_rank(mesh, hbm_bw: float, cluster_json: str):
    """One rank of the parallel phase; rank 0 returns what the parent
    checks and prints (the others their launch counts and the auto run's
    plan and mesh)."""
    from repro_torch.core.calibration import calibrate_cluster
    from repro_torch.core.hardware import cuda_device_model
    from repro_torch.launch.build import shard_batch
    from repro_torch.parallel.strategies import make_rules
    dev = mesh.device
    out = {"launches": {}, "logits": {}, "train": {}, "oracle": {}}
    for arch in PAR_EVAL_SITES:
        ctx = ShardingCtx(dev, use_pallas=True, mesh=mesh,
                          rules=make_rules("ds"))
        cfg = get_config(arch)
        model = build_model(cfg, ctx, seed=0)
        batch = shard_batch(Loader(train.data_config_for(
            cfg.model, BATCH, seed=0), dev).batch_at(0), ctx)
        conv2d_gemm.launches = 0
        res = make_eval_step(model, ctx)(batch)
        torch.cuda.synchronize(dev)
        out["launches"][arch] = conv2d_gemm.launches
        out["logits"][arch] = res["outputs"].full().cpu()
        del model, batch, res
        torch.cuda.empty_cache()
    for arch, batch_size, strategies in PAR_TRAIN:
        cfg = get_config(arch)
        whole = Loader(train.data_config_for(cfg.model, batch_size, seed=0),
                       dev).batch_at(0)
        for s in strategies:
            ctx = ShardingCtx(dev, mesh=mesh, rules=make_rules(s))
            model = build_model(cfg, ctx, seed=0)
            opt = OptimizerConfig(name="sgd", lr=3e-3)
            step = make_train_step(model, opt, ctx)
            state, batch = train_state(model, opt), shard_batch(whole, ctx)
            losses, norms, ms = [], [], []
            for _ in range(2):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                ms.append((time.perf_counter() - t0) * 1e3)
            out["train"][arch, s] = (losses, norms, ms,
                                     torch.cuda.max_memory_allocated(dev))
            del model, state, step, batch
            torch.cuda.empty_cache()
        del whole
    whole_ctx = ShardingCtx(dev)
    cluster = None
    for arch, batch_size, strategies in PAR_ORACLE:
        cfg = get_config(arch)
        model = build_model(cfg, whole_ctx, seed=0)
        batch = Loader(train.data_config_for(cfg.model, batch_size, seed=0),
                       dev).batch_at(0)
        fps = float(sum(st.flops_fwd for st in stats_for(cfg.model)))
        t0 = time.perf_counter()
        if cluster is None:
            base = ClusterSpec.from_system(cuda_device_model(
                dev, hbm_bw=hbm_bw, flops=0.0))
            cluster, ms = calibrate_cluster(
                mesh, base=base, loss_fn=lambda b: model.loss_fn(
                    b, whole_ctx), params=model.parameters(), batch=batch,
                flops_per_step=fps * batch_size)
            out["cluster"] = (cluster, [m.to_json() for m in ms],
                              time.perf_counter() - t0)
            t0 = time.perf_counter()
        pts = validate(model, cfg.model, batch, ShardingCtx(dev, mesh=mesh),
                       list(strategies), flops_per_sample=fps, B=batch_size,
                       cluster=cluster)
        out["oracle"][arch] = (batch_size, pts, time.perf_counter() - t0)
        del model, batch
        torch.cuda.empty_cache()
    out["pipeline"] = _pipeline_rank(mesh, cluster)
    out["lm"] = _lm_parallel_rank(mesh)
    out["lm_pipe"] = _lm_pipeline_rank(mesh)
    out["summa"] = _summa_rank(mesh)
    out["serve_sharded"] = _serve_sharded_rank(mesh)
    out["serve_auto"] = _serve_auto_rank(mesh, cluster_json)
    out["auto"] = _auto_rank(mesh, cluster_json)
    if mesh.rank == 0:
        return out
    return {"launches": out["launches"], "auto": out["auto"],
            "pipeline": {"peaks": out["pipeline"]["peaks"]},
            "lm": {"peaks": out["lm"]["peaks"],
                   "kernels": out["lm"]["kernels"]},
            "lm_pipe": {"peaks": out["lm_pipe"]["peaks"]},
            "summa": {"peaks": out["summa"]["peaks"],
                      "calls": out["summa"]["calls"]},
            "serve_sharded": out["serve_sharded"],
            "serve_auto": out["serve_auto"]}


def _auto_rank(mesh, cluster_json: str) -> dict:
    """launch.train --strategy auto on the spawn's world (AUTO_PAR): the
    trainer tunes for the world's size on the card's cluster and shapes
    its own mesh from the plan (every rank makes its groups in the same
    order)."""
    arch, batch = AUTO_PAR
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(mesh.device)
    t0 = time.perf_counter()
    out = train.main(["--arch", arch, "--batch", str(batch), "--steps", "3",
                      "--log-every", "1", "--device", "cuda", "--backend",
                      "gloo", "--strategy", "auto", "--cluster",
                      cluster_json])
    torch.cuda.empty_cache()
    return dict(out, seconds=time.perf_counter() - t0)


def _report_auto_ranks(results):
    """The [auto] lines of the 4-rank run: the plan, the mesh deployed,
    the losses, ms/step and every rank's peak."""
    arch, batch = AUTO_PAR
    r0 = results[0]["auto"]
    plan = r0["plan"]
    print(f"[auto] p={PAR_RANKS} {arch} batch={batch} {plan.describe()} "
          f"exec={r0['strategy']} mesh={r0['mesh']} "
          f"switches={plan.switch_str()}", flush=True)
    losses = r0["losses"]
    step_ms = statistics.mean(r0["step_s"][1:]) * 1e3
    print(f"[auto] p={PAR_RANKS} {arch} losses="
          f"{','.join(f'{v:.6g}' for v in losses)} ms_per_step={step_ms:.6g} "
          f"first_step_ms={r0['step_s'][0] * 1e3:.6g} "
          f"samples_per_s={batch / step_ms * 1e3:.6g} "
          f"projected_ms_per_step={plan.per_iter_s * 1e3:.6g} "
          f"max_memory_allocated_per_rank={r0['peak_bytes']} "
          f"projected_mem_bytes={plan.mem_bytes:.6g} "
          f"run_s={r0['seconds']:.4g}", flush=True)
    for rank, r in enumerate(results):
        a = r["auto"]
        if a["plan"] != plan or a["mesh"] != r0["mesh"]:
            fail(f"[auto] rank {rank} deployed {a['plan']} on {a['mesh']}, "
                 f"rank 0 {plan} on {r0['mesh']}")
    if plan.p != PAR_RANKS or r0["mesh"] is None or \
            math.prod(r0["mesh"].values()) != PAR_RANKS:
        fail(f"[auto] p={PAR_RANKS}: plan {plan}, mesh {r0['mesh']}")
    if len(losses) != 3 or not all(math.isfinite(v) for v in losses):
        fail(f"[auto] p={PAR_RANKS} {arch} losses {losses}")


def _lm_batch(arch: str, dev) -> dict:
    """The whole token batch of ``arch``'s lm-parallel cell (seed 0)."""
    _, batch_size, seq = LM_PARALLEL_SHAPE[arch]
    return Loader(train.data_config_for(lm_parallel_arch(arch).model,
                                        batch_size, seq, seed=0),
                  dev).batch_at(0)


def _lm_parallel_rank(mesh) -> dict:
    """One rank of the lm-parallel phase: per LM_PAR case the losses,
    norms and step ms of 2 SGD steps and this rank's peak memory; Fig. 3's
    LM rows; the kernel launches of the phase on this rank."""
    from repro_torch.launch.build import shard_batch
    from repro_torch.parallel.strategies import make_rules
    t_phase = time.perf_counter()
    dev = mesh.device
    _reset_counts()
    conv2d_gemm.launches = 0
    out = {"train": {}, "peaks": {}}
    for arch, strategies in LM_PAR:
        cfg, seq = lm_parallel_arch(arch), LM_PARALLEL_SHAPE[arch][2]
        whole = _lm_batch(arch, dev)
        for s in strategies:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            ctx = ShardingCtx(dev, mesh=mesh, rules=make_rules(s))
            model = build_model(cfg, ctx, seed=0)
            opt = OptimizerConfig(name="sgd", lr=3e-3, zero1="zero1" in s)
            step = make_train_step(model, opt, ctx, q_chunk=min(256, seq))
            state = train_state(model, opt, ctx)
            batch = shard_batch(whole, ctx)
            losses, norms, ms = [], [], []
            for _ in range(2):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                ms.append((time.perf_counter() - t0) * 1e3)
            out["train"][arch, s] = (losses, norms, ms)
            out["peaks"][arch, s] = torch.cuda.max_memory_allocated(dev)
            del model, state, step, batch
        del whole
    torch.cuda.empty_cache()
    arch, strategies = LM_PAR_ORACLE
    cfg = lm_parallel_arch(arch)
    _, batch_size, seq = LM_PARALLEL_SHAPE[arch]
    model = build_model(cfg, ShardingCtx(dev), seed=0)
    batch = _lm_batch(arch, dev)
    fps = float(sum(st.flops_fwd for st in stats_for(cfg.model, seq)))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pts = validate(model, cfg.model, batch, ShardingCtx(dev, mesh=mesh),
                   list(strategies), flops_per_sample=fps, B=batch_size,
                   S=seq, **LM_PAR_ORACLE_STEPS)
    out["fig3"] = (pts, time.perf_counter() - t0)
    out["peaks"]["fig3"] = torch.cuda.max_memory_allocated(dev)
    del model, batch
    torch.cuda.empty_cache()
    out["kernels"] = _counts() + (conv2d_gemm.launches,)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _lm_parallel_refs(dev) -> dict:
    """Two single-process SGD steps per LM_PAR model at its lm-parallel
    shape (first loss, first gradient norm, second loss), before the
    spawn; every tensor released after."""
    refs, ctx = {}, ShardingCtx(dev)
    for arch, _ in LM_PAR:
        seq = LM_PARALLEL_SHAPE[arch][2]
        refs[arch] = _two_sgd_steps(lm_parallel_arch(arch), ctx,
                                    _lm_batch(arch, dev),
                                    q_chunk=min(256, seq))
        torch.cuda.empty_cache()
    return refs


def _report_lm_parallel(results, refs, seconds):
    """Prints and gates the lm-parallel phase (see the module docstring,
    5e)."""
    r0 = results[0]["lm"]
    print(f"[lm-parallel] mesh (data={PAR_RANKS // PAR_MODEL}, "
          f"model={PAR_MODEL}), the [parallel] spawn's ranks sharing the "
          f"card over gloo; "
          + "; ".join(f"{a}: {l} layers at full width, fp32, batch {b} x "
                      f"seq {q}" for a, (l, b, q) in LM_PARALLEL_SHAPE.items()),
          flush=True)
    bars = (PAR_LOSS_TOL, PAR_STEP_TOL, PAR_STEP_TOL)
    for (arch, s), (losses, norms, ms) in r0["train"].items():
        got = (losses[0], norms[0], losses[1])
        want = refs[arch]
        rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        peaks = [r["lm"]["peaks"][arch, s] / 2 ** 30 for r in results]
        print(f"[lm-parallel] train {arch} {s} losses="
              f"{','.join(f'{v:.7g}' for v in losses)} grad_norm_step1="
              f"{norms[0]:.7g} single_process: loss1={want[0]:.7g} "
              f"grad_norm1={want[1]:.7g} loss2={want[2]:.7g} rel_diff: "
              f"loss1={rel[0]:.3g} (bar {bars[0]}) grad_norm1={rel[1]:.3g} "
              f"loss2={rel[2]:.3g} (bar {bars[1]}) step_ms="
              f"{','.join(f'{v:.5g}' for v in ms)} peak_GiB_per_rank="
              f"{','.join(f'{v:.4g}' for v in peaks)}", flush=True)
        if not all(math.isfinite(v) for v in got) or any(
                r > bar for r, bar in zip(rel, bars)):
            fail(f"[lm-parallel] {arch} {s}: (loss1, grad_norm1, loss2) "
                 f"{got} against the single-process {want}: {rel} relative "
                 f"(bars {bars})")
    arch, _ = LM_PAR_ORACLE
    pts, t_val = r0["fig3"]
    _, batch_size, seq = LM_PARALLEL_SHAPE[arch]
    tag = f"[lm-parallel] fig3 p={PAR_RANKS} {arch} batch={batch_size} " \
          f"seq={seq}"
    lines = accuracy_report(pts).splitlines()
    print(f"{tag} self-calibrated ({t_val:.4g} s) {lines[0]}", flush=True)
    for line in lines[1:]:
        print(f"{tag} {line}", flush=True)
    for pt in pts:
        if not all(math.isfinite(t) and t > 0 for t in (
                pt.measured_s, pt.projected_s, pt.projected_serial_s)):
            fail(f"[lm-parallel] {arch} {pt.strategy}: measured "
                 f"{pt.measured_s} s, projected {pt.projected_s} s")
    peaks = [r["lm"]["peaks"]["fig3"] / 2 ** 30 for r in results]
    print(f"{tag} mean accuracy {statistics.mean(pt.accuracy for pt in pts) * 100:.4g}% "
          f"(serial-comm "
          f"{statistics.mean(pt.accuracy_serial for pt in pts) * 100:.4g}%; "
          f"reported, not gated) peak_GiB_per_rank="
          f"{','.join(f'{v:.4g}' for v in peaks)}", flush=True)
    print(f"[lm-parallel] kernel launches per rank (rmsnorm, "
          f"flash_attention, ssd_chunk, conv2d_gemm): "
          f"{[r['lm']['kernels'] for r in results]} (LM training runs the "
          f"plain norms, attention and SSD: no kernel has a backward)",
          flush=True)
    print(f"[lm-parallel] phase wall time {seconds:.4g} s (single-process "
          f"references and the spawn's lm-parallel part)", flush=True)


def _pipeline_rank(mesh22, cluster) -> dict:
    """One rank of the pipeline phase, on the [parallel] spawn: the ranks
    as the stages of a (1, PAR_RANKS) regrid of its mesh. Returns the
    training cases' losses, norms, segments, cuts, step ms and this rank's
    peak memory per case, the bubble fits and Fig. 3's pipeline row."""
    from repro_torch.core.validation import measure_schedule_bubble
    from repro_torch.parallel.schedules import (SCHEDULE_NAMES,
                                                make_pipeline_train_step)
    t_phase = time.perf_counter()
    dev = mesh22.device
    ctx = ShardingCtx(dev, mesh=mesh22.regrid(1, PAR_RANKS))
    ctx22, whole = ShardingCtx(dev, mesh=mesh22), ShardingCtx(dev)
    out = {"train": {}, "peaks": {}, "bubble": {}, "fig3": {}}
    for arch, batch_size, segments, schedules in PIPE_TRAIN:
        cfg = get_config(arch)
        batch = Loader(train.data_config_for(cfg.model, batch_size, seed=0),
                       dev).batch_at(0)
        for schedule, v in schedules:
            model = build_model(cfg, whole, seed=0)
            opt = OptimizerConfig(name="sgd", lr=3e-3)
            step = make_pipeline_train_step(
                model, opt, ctx, segments=segments, schedule=schedule,
                virtual_stages=v)
            state = train_state(model, opt)
            torch.cuda.reset_peak_memory_stats(dev)
            losses, norms, ms = [], [], []
            for _ in range(2):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                ms.append((time.perf_counter() - t0) * 1e3)
            out["train"][arch, schedule] = (losses, norms, ms,
                                            m["pipeline_segments"],
                                            step.bounds)
            out["peaks"][arch, schedule] = torch.cuda.max_memory_allocated(
                dev)
            del model, state, step
            torch.cuda.empty_cache()
        del batch
    arch, mb, s_small, s_large = PIPE_BUBBLE
    cfg = get_config(arch)
    model = build_model(cfg, whole, seed=0)
    for schedule in SCHEDULE_NAMES:
        out["bubble"][schedule] = measure_schedule_bubble(
            model, lambda n: Loader(train.data_config_for(
                cfg.model, n, seed=0), dev).batch_at(0), ctx22,
            schedule=schedule, virtual_stages=2, S_small=s_small,
            S_large=s_large, microbatch=mb)
    del model
    torch.cuda.empty_cache()
    for arch, batch_size, _ in PAR_ORACLE:
        cfg = get_config(arch)
        model = build_model(cfg, whole, seed=0)
        batch = Loader(train.data_config_for(cfg.model, batch_size, seed=0),
                       dev).batch_at(0)
        fps = float(sum(st.flops_fwd for st in stats_for(cfg.model)))
        out["fig3"][arch] = (batch_size, validate(
            model, cfg.model, batch, ctx22, ["pipeline"],
            flops_per_sample=fps, B=batch_size, cluster=cluster))
        del model, batch
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _lm_pipe_arch(arch: str):
    """``arch`` at LM_PIPELINE_SHAPE's layers, fp32; its whole batch."""
    layers, batch_size, seq = LM_PIPELINE_SHAPE[arch]
    return lm_parallel_arch(arch, layers), batch_size, seq


def _lm_pipe_batch(arch: str, dev) -> dict:
    cfg, batch_size, seq = _lm_pipe_arch(arch)
    return Loader(train.data_config_for(cfg.model, batch_size, seq, seed=0),
                  dev).batch_at(0)


def _lm_pipeline_rank(mesh22) -> dict:
    """One rank of the lm-pipeline phase: per LM_PIPE case the losses,
    norms, step ms, segments and cuts of 2 SGD steps and this rank's peak
    memory; Fig. 3's pipeline row for LM_PIPE_ORACLE."""
    from repro_torch.parallel.schedules import (make_pipeline_train_step,
                                                pipeline_block_costs)
    t_phase = time.perf_counter()
    dev = mesh22.device
    ctx = ShardingCtx(dev, mesh=mesh22.regrid(1, PAR_RANKS))
    whole = ShardingCtx(dev)
    out = {"train": {}, "peaks": {}}
    for arch, segments, schedules in LM_PIPE:
        cfg, _, seq = _lm_pipe_arch(arch)
        batch = _lm_pipe_batch(arch, dev)
        for schedule, v in schedules:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            model = build_model(cfg, whole, seed=0)
            opt = OptimizerConfig(name="sgd", lr=3e-3)
            step = make_pipeline_train_step(
                model, opt, ctx, segments=segments, schedule=schedule,
                virtual_stages=v, q_chunk=min(256, seq),
                block_costs=pipeline_block_costs(model, stats_for(
                    cfg.model, seq)))
            state = train_state(model, opt)
            losses, norms, ms = [], [], []
            for _ in range(2):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                ms.append((time.perf_counter() - t0) * 1e3)
            out["train"][arch, schedule] = (losses, norms, ms,
                                            m["pipeline_segments"],
                                            step.bounds)
            out["peaks"][arch, schedule] = torch.cuda.max_memory_allocated(
                dev)
            del model, state, step
        del batch
    torch.cuda.empty_cache()
    cfg, batch_size, seq = _lm_pipe_arch(LM_PIPE_ORACLE)
    model = build_model(cfg, whole, seed=0)
    batch = _lm_pipe_batch(LM_PIPE_ORACLE, dev)
    fps = float(sum(st.flops_fwd for st in stats_for(cfg.model, seq)))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out["fig3"] = (validate(model, cfg.model, batch,
                            ShardingCtx(dev, mesh=mesh22), ["pipeline"],
                            flops_per_sample=fps, B=batch_size, S=seq),
                   time.perf_counter() - t0)
    out["peaks"]["fig3"] = torch.cuda.max_memory_allocated(dev)
    del model, batch
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _lm_pipeline_refs(dev) -> dict:
    """Two single-process SGD steps per LM_PIPE model at its pipeline
    shape, before the spawn; every tensor released after."""
    refs, ctx = {}, ShardingCtx(dev)
    for arch, _, _ in LM_PIPE:
        cfg, _, seq = _lm_pipe_arch(arch)
        refs[arch] = _two_sgd_steps(cfg, ctx, _lm_pipe_batch(arch, dev),
                                    q_chunk=min(256, seq))
        torch.cuda.empty_cache()
    return refs


def _report_lm_pipeline(results, refs, seconds):
    """Prints and gates the lm-pipeline phase (see the module docstring,
    5f)."""
    r0 = results[0]["lm_pipe"]
    print(f"[lm-pipeline] mesh (data=1, model={PAR_RANKS}): the [parallel] "
          f"world regridded, every rank a stage, sharing the card over gloo; "
          + "; ".join(f"{a}: {n} layers at full width, fp32, batch {b} x "
                      f"seq {q}"
                      for a, (n, b, q) in LM_PIPELINE_SHAPE.items()),
          flush=True)
    bars = (PAR_LOSS_TOL, PAR_STEP_TOL, PAR_STEP_TOL)
    for (arch, schedule), (losses, norms, ms, S, bounds) in r0[
            "train"].items():
        got, want = (losses[0], norms[0], losses[1]), refs[arch]
        rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        segments = next(s for a, s, _ in LM_PIPE if a == arch)
        peaks = [r["lm_pipe"]["peaks"][arch, schedule] / 2 ** 30
                 for r in results]
        print(f"[lm-pipeline] train {arch} {schedule} pipeline_segments={S} "
              f"cuts={bounds} losses={','.join(f'{v:.7g}' for v in losses)} "
              f"grad_norm_step1={norms[0]:.7g} single_process: "
              f"loss1={want[0]:.7g} grad_norm1={want[1]:.7g} "
              f"loss2={want[2]:.7g} rel_diff: loss1={rel[0]:.3g} (bar "
              f"{bars[0]}) grad_norm1={rel[1]:.3g} loss2={rel[2]:.3g} (bar "
              f"{bars[1]}) step_ms={','.join(f'{v:.5g}' for v in ms)} "
              f"peak_GiB_per_rank={','.join(f'{v:.4g}' for v in peaks)}",
              flush=True)
        if S != segments or not all(math.isfinite(v) for v in got) or any(
                r > bar for r, bar in zip(rel, bars)):
            fail(f"[lm-pipeline] {arch} {schedule}: S={S} (want "
                 f"{segments}), (loss1, grad_norm1, loss2) {got} against "
                 f"the single-process {want}: {rel} relative (bars {bars})")
    pts, t_val = r0["fig3"]
    _, batch_size, seq = LM_PIPELINE_SHAPE[LM_PIPE_ORACLE]
    tag = f"[lm-pipeline] fig3 p={PAR_RANKS} {LM_PIPE_ORACLE} " \
          f"batch={batch_size} seq={seq}"
    lines = accuracy_report(pts).splitlines()
    print(f"{tag} self-calibrated ({t_val:.4g} s) {lines[0]}", flush=True)
    for line in lines[1:-1]:
        print(f"{tag} {line}", flush=True)
    if [pt.strategy for pt in pts] != ["pipeline"] or not all(
            math.isfinite(t) and t > 0 for pt in pts for t in (
                pt.measured_s, pt.projected_s, pt.projected_serial_s)):
        fail(f"[lm-pipeline] fig3: {pts}")
    peaks = [r["lm_pipe"]["peaks"]["fig3"] / 2 ** 30 for r in results]
    print(f"{tag} peak_GiB_per_rank={','.join(f'{v:.4g}' for v in peaks)} "
          f"(reported, not gated)", flush=True)
    print(f"[lm-pipeline] phase wall time {seconds:.4g} s (single-process "
          f"references and the spawn's lm-pipeline part)", flush=True)


def _summa_rank(mesh22) -> dict:
    """One rank of the summa phase: the losses, norms and step ms of 2 SGD
    steps on the grid, this rank's summa_matmul calls and peak memory;
    Fig. 3's summa row."""
    from repro_torch.launch.build import shard_batch
    from repro_torch.launch.mesh import make_grid_mesh
    from repro_torch.parallel import summa
    from repro_torch.parallel.strategies import make_rules
    t_phase = time.perf_counter()
    dev = mesh22.device
    arch, grid = SUMMA_RUN
    cfg, seq = lm_parallel_arch(arch), LM_PARALLEL_SHAPE[arch][2]
    ctx = ShardingCtx(dev, mesh=make_grid_mesh(mesh22, *grid),
                      rules=make_rules("summa"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, ctx, seed=0)
    opt = OptimizerConfig(name="sgd", lr=3e-3)
    step = make_train_step(model, opt, ctx, q_chunk=min(256, seq))
    state, batch = train_state(model, opt), shard_batch(_lm_batch(arch, dev),
                                                        ctx)
    summa.summa_matmul.calls = 0
    losses, norms, ms = [], [], []
    for _ in range(2):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    out = {"train": (losses, norms, ms), "calls": summa.summa_matmul.calls,
           "peaks": {"train": torch.cuda.max_memory_allocated(dev)}}
    del model, state, step, batch
    torch.cuda.empty_cache()
    model = build_model(cfg, ShardingCtx(dev), seed=0)
    fps = float(sum(st.flops_fwd for st in stats_for(cfg.model, seq)))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out["fig3"] = (validate(model, cfg.model, _lm_batch(arch, dev),
                            ShardingCtx(dev, mesh=mesh22), ["summa"],
                            flops_per_sample=fps,
                            B=LM_PARALLEL_SHAPE[arch][1], S=seq,
                            grid=grid[1:]), time.perf_counter() - t0)
    out["peaks"]["fig3"] = torch.cuda.max_memory_allocated(dev)
    del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _report_summa(results, refs, seconds):
    """Prints and gates the summa phase (see the module docstring, 5g):
    the steps against the lm-parallel phase's single-process steps."""
    r0 = results[0]["summa"]
    arch, grid = SUMMA_RUN
    layers, batch_size, seq = LM_PARALLEL_SHAPE[arch]
    losses, norms, ms = r0["train"]
    got, want = (losses[0], norms[0], losses[1]), refs[arch]
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    bars = (PAR_LOSS_TOL, PAR_STEP_TOL, PAR_STEP_TOL)
    calls = [r["summa"]["calls"] for r in results]
    peaks = [r["summa"]["peaks"]["train"] / 2 ** 30 for r in results]
    print(f"[summa] grid (data, model_r, model_c)={grid}, the [parallel] "
          f"world regridded, sharing the card over gloo; {arch}: {layers} "
          f"layers at full width, fp32, batch {batch_size} x seq {seq}, "
          f"summa rules", flush=True)
    print(f"[summa] train {arch} losses={','.join(f'{v:.7g}' for v in losses)}"
          f" grad_norm_step1={norms[0]:.7g} single_process: loss1="
          f"{want[0]:.7g} grad_norm1={want[1]:.7g} loss2={want[2]:.7g} "
          f"rel_diff: loss1={rel[0]:.3g} (bar {bars[0]}) grad_norm1="
          f"{rel[1]:.3g} loss2={rel[2]:.3g} (bar {bars[1]}) step_ms="
          f"{','.join(f'{v:.5g}' for v in ms)} summa_matmul_calls_per_rank="
          f"{calls} peak_GiB_per_rank={','.join(f'{v:.4g}' for v in peaks)}",
          flush=True)
    if min(calls) <= 0 or not all(math.isfinite(v) for v in got) or any(
            r > bar for r, bar in zip(rel, bars)):
        fail(f"[summa] {arch}: summa_matmul calls {calls}, (loss1, "
             f"grad_norm1, loss2) {got} against the single-process {want}: "
             f"{rel} relative (bars {bars})")
    pts, t_val = r0["fig3"]
    tag = f"[summa] fig3 p={PAR_RANKS} {arch} grid={grid[1:]} " \
          f"batch={batch_size} seq={seq}"
    lines = accuracy_report(pts).splitlines()
    print(f"{tag} self-calibrated ({t_val:.4g} s) {lines[0]}", flush=True)
    for line in lines[1:-1]:
        print(f"{tag} {line}", flush=True)
    if [pt.strategy for pt in pts] != ["summa"] or not all(
            math.isfinite(t) and t > 0 for pt in pts for t in (
                pt.measured_s, pt.projected_s, pt.projected_serial_s)):
        fail(f"[summa] fig3: {pts}")
    peaks = [r["summa"]["peaks"]["fig3"] / 2 ** 30 for r in results]
    print(f"{tag} peak_GiB_per_rank={','.join(f'{v:.4g}' for v in peaks)} "
          f"(reported, not gated)", flush=True)
    print(f"[summa] phase wall time {seconds:.4g} s (the spawn's summa part; "
          f"its references are [lm-parallel]'s)", flush=True)


def _sharded_cell(vocab: int):
    """(traffic, trace, max_len) of the serve-sharded phase."""
    from repro_torch.launch.serve import trace_max_len
    from repro_torch.serve import TrafficModel
    traffic = TrafficModel(**SHARDED_TRAFFIC)
    trace = traffic.trace(SHARDED_REQUESTS, vocab, seed=0)
    widest = max(shards for _, shards in SHARDED_LAYOUTS)
    return traffic, trace, trace_max_len(
        trace, SHARDED_CFG["prefill_chunk"], traffic.gen_len, widest)


def _first_chunk_logits(model, ctx, trace, max_len: int, shards: int):
    """The logits (1, C, vocab) of request 0's first prompt chunk (padded as
    the engine pads it) on a fresh dense cache, whole, on the host."""
    C = SHARDED_CFG["prefill_chunk"]
    chunk = torch.zeros((1, C), dtype=torch.int32)
    prompt = torch.from_numpy(trace[0].prompt[:C])
    chunk[0, :len(prompt)] = prompt
    cache = zeros_like_spec(model.cache_spec(1, max_len, shards=shards,
                                             dtype=torch.float32),
                            ctx.device, ctx)
    with torch.no_grad():
        logits, _ = model.decode_step(chunk.to(ctx.device), cache,
                                      torch.zeros(1, dtype=torch.int64,
                                                  device=ctx.device), ctx)
    logits = logits.full() if ctx.sharded else logits
    return logits.cpu()


def _serve_sharded_refs(dev) -> dict:
    """The single-process engine on the serve-sharded cell, before the
    spawn: measure_serving's tokens and report, request 0's first-chunk
    logits, the peak; every tensor released after."""
    from repro_torch.serve import ServeConfig
    t_ref = time.perf_counter()
    cfg = lm_parallel_arch(SHARDED_ARCH, SHARDED_LAYERS)
    ctx = ShardingCtx(dev, use_pallas=True)
    traffic, trace, max_len = _sharded_cell(cfg.model.vocab)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, ctx, seed=0)
    logits = _first_chunk_logits(model, ctx, trace, max_len, 1)
    report = measure_serving(model, ctx, "serve_tp", ServeConfig(
        max_len=max_len, dtype=torch.float32, **SHARDED_CFG), trace)
    out = {"tokens": [r.tokens for r in report.requests], "logits": logits,
           "summary": report.summary(), "max_len": max_len,
           "peak": torch.cuda.max_memory_allocated(dev)}
    del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_ref
    return out


def _serve_sharded_rank(mesh22) -> dict:
    """One rank of the serve-sharded phase, on the (1, PAR_RANKS) regrid:
    per layout the tokens, the report's summary, the first-chunk logits,
    per cell call its (chunk, rmsnorm, flash, ssd launches, collectives,
    host s inside comm.*), the replays' collectives and comm seconds and
    this rank's peak."""
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.strategies import make_rules
    from repro_torch.serve import ServeConfig
    t_phase = time.perf_counter()
    dev = mesh22.device
    mesh = mesh22.regrid(1, PAR_RANKS)
    cfg = lm_parallel_arch(SHARDED_ARCH, SHARDED_LAYERS)
    traffic, trace, max_len = _sharded_cell(cfg.model.vocab)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    # both serving tables place the weights alike: one build serves both
    model = build_model(cfg, ShardingCtx(dev, use_pallas=True, mesh=mesh,
                                         rules=make_rules("serve_tp")),
                        seed=0)
    torch.cuda.synchronize(dev)
    out = {"build_s": time.perf_counter() - t0, "layouts": {},
           "peaks": {"build": torch.cuda.max_memory_allocated(dev)}}
    for s, shards in SHARDED_LAYOUTS:
        ctx = ShardingCtx(dev, use_pallas=True, mesh=mesh,
                          rules=make_rules(s))
        scfg = ServeConfig(max_len=max_len, kv_shards=shards,
                           dtype=torch.float32, **SHARDED_CFG)
        logits = _first_chunk_logits(model, ctx, trace, max_len, shards)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        per_call, decode_step = [], model.decode_step

        def counted(tokens, *args):
            before = _counts()
            c0, s0 = coll.STATS["calls"], coll.STATS["seconds"]
            y = decode_step(tokens, *args)
            per_call.append((tokens.shape[1],) + tuple(
                a - b for a, b in zip(_counts(), before)) + (
                coll.STATS["calls"] - c0, coll.STATS["seconds"] - s0))
            return y

        model.decode_step = counted
        c0, s0 = coll.STATS["calls"], coll.STATS["seconds"]
        t0 = time.perf_counter()
        report = measure_serving(model, ctx, s, scfg, trace)
        seconds = time.perf_counter() - t0
        del model.decode_step
        out["layouts"][s] = {
            "tokens": [r.tokens for r in report.requests],
            "summary": report.summary(),
            "logits": logits if mesh.rank == 0 else None,
            "per_call": per_call, "seconds": seconds,
            "comm": (coll.STATS["calls"] - c0, coll.STATS["seconds"] - s0)}
        out["peaks"][s] = torch.cuda.max_memory_allocated(dev)
    del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _report_serve_sharded(results, refs, seconds, cluster, hbm_bw):
    """Prints and gates the serve-sharded phase (see the module docstring,
    5h): tokens, first-chunk logits and launches against the single-process
    engine's; the serving oracle's projection beside the measurement."""
    mc = lm_parallel_arch(SHARDED_ARCH, SHARDED_LAYERS).model
    want = (2 * mc.n_layers + 1, 0, 0)
    traffic, trace, max_len = _sharded_cell(mc.vocab)
    single = refs["summary"]
    print(f"[serve-sharded] mesh (data=1, model={PAR_RANKS}): the [parallel] "
          f"world regridded, sharing the card over gloo; {SHARDED_ARCH} "
          f"{mc.n_layers} layers at full width, fp32, use_pallas; "
          f"{len(trace)} requests of TrafficModel({SHARDED_TRAFFIC}) seed 0, "
          f"closed loop, {SHARDED_CFG}, max_len={max_len}; weights built "
          f"per rank in "
          f"{max(r['serve_sharded']['build_s'] for r in results):.4g} s "
          f"(peak_GiB_per_rank="
          + ",".join(f"{r['serve_sharded']['peaks']['build'] / 2 ** 30:.4g}"
                     for r in results) + ")", flush=True)
    print(f"[serve-sharded] single_process (one card, measure_serving "
          f"serve_tp): tok_per_s={single['tok_per_s']:.6g} "
          f"wall_s={single['wall_s']:.6g} "
          f"ttft_p50_ms={single['ttft_p50_s'] * 1e3:.6g} "
          f"ttft_p99_ms={single['ttft_p99_s'] * 1e3:.6g} "
          f"latency_p50_ms={single['latency_p50_s'] * 1e3:.6g} "
          f"latency_p99_ms={single['latency_p99_s'] * 1e3:.6g} "
          f"peak_GiB={refs['peak'] / 2 ** 30:.4g} "
          f"({refs['seconds']:.4g} s with the build)", flush=True)
    system = cluster if cluster is not None else cuda_device_model(
        torch.device("cuda", 0), hbm_bw=hbm_bw,
        flops=PEAK_FLOPS[torch.float32])
    rates = {}
    for s, shards in SHARDED_LAYOUTS:
        got = [r["serve_sharded"]["layouts"][s] for r in results]
        r0 = got[0]
        rel = float((r0["logits"] - refs["logits"]).norm()
                    / refs["logits"].norm())
        same = [g["tokens"] == refs["tokens"] for g in got]
        calls = [g["per_call"] for g in got]
        launches = sorted({c[1:4] for rank in calls for c in rank})
        colls = {c[0]: c[4] for c in calls[0]}
        n_cells = len(calls[0])
        comm_calls, comm_s = r0["comm"]
        summ = r0["summary"]
        peaks = [r["serve_sharded"]["peaks"][s] / 2 ** 30 for r in results]
        print(f"[serve-sharded] {s} kv_shards={shards}: tokens equal to the "
              f"single-process engine's on every rank={same} first-chunk "
              f"logits rel_l2={rel:.3g} (bar {SHARDED_LOGIT_TOL}) "
              f"cell_calls={n_cells} launches (rmsnorm, flash_attention, "
              f"ssd_chunk) per cell call on every rank={launches} (want "
              f"{want})", flush=True)
        print(f"[serve-sharded] {s} collectives per decode_step call by "
              f"chunk length {colls}; per cell (greedy and clock included, "
              f"rank 0) {comm_calls / n_cells:.5g}; host_ms_in_comm per cell "
              f"{comm_s / n_cells * 1e3:.5g} (rank 0, both replays: "
              f"{comm_calls} collectives, {comm_s:.5g} s of "
              f"{r0['seconds']:.5g} s)", flush=True)
        print(f"[serve-sharded] {s} measured (closed loop, rank 0): "
              f"tok_per_s={summ['tok_per_s']:.6g} wall_s={summ['wall_s']:.6g} "
              f"ttft_p50_ms={summ['ttft_p50_s'] * 1e3:.6g} "
              f"ttft_p99_ms={summ['ttft_p99_s'] * 1e3:.6g} "
              f"latency_p50_ms={summ['latency_p50_s'] * 1e3:.6g} "
              f"latency_p99_ms={summ['latency_p99_s'] * 1e3:.6g} "
              f"peak_GiB_per_rank={','.join(f'{v:.4g}' for v in peaks)}",
              flush=True)
        proj = price_serving(mc, system, s, 1, PAR_RANKS, shards,
                             SHARDED_CFG["max_batch"], traffic,
                             max_len=max_len, dtype_bytes=4,
                             prefill_chunk=SHARDED_CFG["prefill_chunk"])
        on = "the cluster [parallel] calibrated" if cluster else system.name
        print(f"[serve-sharded] {s} projected (price_serving p1=1 p2="
              f"{PAR_RANKS} kv_shards={shards} on {on}): "
              f"tok_per_s={proj.tok_per_s:.6g} "
              f"t_prefill_ms={proj.t_prefill * 1e3:.6g} "
              f"t_decode_ms={proj.t_decode * 1e3:.6g} rho={proj.rho:.4g} "
              f"ttft_p99_ms={proj.ttft_p99 * 1e3:.6g} "
              f"latency_p99_ms={proj.latency_p99 * 1e3:.6g} "
              f"feasible={proj.feasible} {proj.limit} (reported, gated on "
              f"finiteness)", flush=True)
        rates[s] = (summ["tok_per_s"], proj.tok_per_s)
        if not all(same):
            bad = [i for i, ok in enumerate(same) if not ok]
            fail(f"[serve-sharded] {s}: tokens differ from the single-process "
                 f"engine's on ranks {bad}")
        if not rel <= SHARDED_LOGIT_TOL:
            fail(f"[serve-sharded] {s}: first-chunk logits {rel} relative "
                 f"L2 over {SHARDED_LOGIT_TOL}")
        if launches != [want] or not n_cells:
            fail(f"[serve-sharded] {s}: launches a cell call {launches}, not "
                 f"{want}")
        if not all(math.isfinite(v) for v in (proj.tok_per_s, proj.t_prefill,
                                              proj.t_decode)):
            fail(f"[serve-sharded] {s}: projection not finite: {proj}")
    measured = max(rates, key=lambda s: rates[s][0])
    oracle = max(rates, key=lambda s: rates[s][1])
    launched = sum(c[1] for r in results for layout in r["serve_sharded"][
        "layouts"].values() for c in layout["per_call"])
    print(f"[serve-sharded] winner by tok/s: measured {measured}, oracle "
          f"{oracle} (reported, not gated: {PAR_RANKS} ranks sharing one "
          f"card over gloo are not {PAR_RANKS} cards)", flush=True)
    print(f"[serve-sharded] phase wall time {seconds:.4g} s (the "
          f"single-process reference and the spawn's serve-sharded part); "
          f"rmsnorm launches over every rank's cell calls {launched}",
          flush=True)
    return launched


def _serve_auto_rank(mesh22, cluster_json: str) -> dict:
    """One rank of the serve-auto phase: launch.serve.main --strategy auto
    on the spawn's world (its launches, what it returned and printed), then
    each of SERVE_AUTO_LAYOUTS on the spawn's (2, 2) mesh through
    measure_serving, as _serve_sharded_rank records the (1, 4) ones."""
    from repro_torch.launch import serve
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.strategies import make_rules
    from repro_torch.serve import ServeConfig
    t_phase = time.perf_counter()
    dev = mesh22.device
    cfg = lm_parallel_arch(SHARDED_ARCH, SHARDED_LAYERS)
    traffic, trace, max_len = _sharded_cell(cfg.model.vocab)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    text = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        cli = serve.main([
            "--arch", SHARDED_ARCH, "--device", "cuda", "--backend", "gloo",
            "--strategy", "auto", "--cluster", cluster_json, "--closed-loop",
            "--requests", str(SHARDED_REQUESTS),
            "--prompt-len", str(traffic.prompt_len),
            "--gen", str(traffic.gen_len), "--rate", str(traffic.rate),
            "--max-batch", str(SHARDED_CFG["max_batch"]),
            "--block-tokens", str(SHARDED_CFG["block_tokens"]),
            "--prefill-chunk", str(SHARDED_CFG["prefill_chunk"])], cfg=cfg)
    out = {"cli": dict(cli, launches=_counts(),
                       seconds=time.perf_counter() - t0,
                       printed=text.getvalue() if mesh22.rank == 0 else "",
                       peak=torch.cuda.max_memory_allocated(dev)),
           "layouts": {}, "peaks": {}}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, ShardingCtx(dev, use_pallas=True, mesh=mesh22,
                                         rules=make_rules("serve_tp")),
                        seed=0)
    for s, shards in SERVE_AUTO_LAYOUTS:
        ctx = ShardingCtx(dev, use_pallas=True, mesh=mesh22,
                          rules=make_rules(s))
        scfg = ServeConfig(max_len=max_len, kv_shards=shards,
                           dtype=torch.float32, **SHARDED_CFG)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        per_call, decode_step = [], model.decode_step

        def counted(tokens, *args):
            before = _counts()
            c0, s0 = coll.STATS["calls"], coll.STATS["seconds"]
            y = decode_step(tokens, *args)
            per_call.append((tokens.shape[1],) + tuple(
                a - b for a, b in zip(_counts(), before)) + (
                coll.STATS["calls"] - c0, coll.STATS["seconds"] - s0))
            return y

        model.decode_step = counted
        c0, s0 = coll.STATS["calls"], coll.STATS["seconds"]
        t0 = time.perf_counter()
        # one replay: the CLI's replay warmed these processes
        report = measure_serving(model, ctx, s, scfg, trace, warmup=False)
        seconds = time.perf_counter() - t0
        del model.decode_step
        out["layouts"][s] = {
            "tokens": [r.tokens for r in report.requests],
            "summary": report.summary(), "per_call": per_call,
            "seconds": seconds,
            "comm": (coll.STATS["calls"] - c0, coll.STATS["seconds"] - s0)}
        out["peaks"][s] = torch.cuda.max_memory_allocated(dev)
    del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _report_serve_auto(results, refs, seconds, cluster, hbm_bw) -> int:
    """Prints and gates the serve-auto phase (11 of the docstring); returns
    the rmsnorm launches of every rank's runs."""
    mc = lm_parallel_arch(SHARDED_ARCH, SHARDED_LAYERS).model
    want = (2 * mc.n_layers + 1, 0, 0)
    traffic, trace, max_len = _sharded_cell(mc.vocab)
    clis = [r["serve_auto"]["cli"] for r in results]
    c0 = clis[0]
    plan_line = c0["printed"].splitlines()[0] if c0["printed"] else ""
    print(f"[serve-auto] launch.serve.main --strategy auto --cluster "
          f"<[oracle]'s JSON> on the {PAR_RANKS} spawned ranks ({SHARDED_ARCH} "
          f"{mc.n_layers} layers fp32, cache bf16, the serve-sharded trace, "
          f"max_batch {SHARDED_CFG['max_batch']}): {plan_line} -> deployed "
          f"{c0['strategy']} on mesh {c0['mesh']}; tok_per_s="
          f"{c0['tok_per_s']:.6g} ttft_p50_ms={c0['ttft_p50_s'] * 1e3:.6g} "
          f"latency_p99_ms={c0['latency_p99_s'] * 1e3:.6g} (one replay, no "
          f"warm-up) launches (rmsnorm, flash_attention, ssd_chunk) per "
          f"rank={[c['launches'] for c in clis]} run_s="
          f"{max(c['seconds'] for c in clis):.4g} peak_GiB_per_rank="
          + ",".join(f"{c['peak'] / 2 ** 30:.4g}" for c in clis), flush=True)
    if not plan_line.startswith("TunedPlan[p=4]"):
        fail(f"[serve-auto] the CLI printed no plan first: {plan_line!r}")
    if any((c["strategy"], c["mesh"]) != (c0["strategy"], c0["mesh"])
           for c in clis) or math.prod(c0["mesh"].values()) != PAR_RANKS:
        fail(f"[serve-auto] the ranks deployed "
             f"{[(c['strategy'], c['mesh']) for c in clis]}")
    if any(c["tokens_by_request"] != c0["tokens_by_request"] for c in clis) \
            or len(c0["tokens_by_request"]) != SHARDED_REQUESTS:
        fail("[serve-auto] the CLI's tokens differ between ranks")
    if any(c["launches"][0] == 0 or c["launches"][1:] != (0, 0)
           for c in clis):
        fail(f"[serve-auto] the CLI's launches "
             f"{[c['launches'] for c in clis]}")
    launched = sum(c["launches"][0] for c in clis)
    system = cluster if cluster is not None else cuda_device_model(
        torch.device("cuda", 0), hbm_bw=hbm_bw,
        flops=PEAK_FLOPS[torch.float32])
    for s, shards in SERVE_AUTO_LAYOUTS:
        got = [r["serve_auto"]["layouts"][s] for r in results]
        r0 = got[0]
        same = [g["tokens"] == refs["tokens"] for g in got]
        calls = [g["per_call"] for g in got]
        launches = sorted({c[1:4] for rank in calls for c in rank})
        colls = {c[0]: c[4] for c in calls[0]}
        n_cells = len(calls[0])
        comm_calls, comm_s = r0["comm"]
        summ = r0["summary"]
        peaks = [r["serve_auto"]["peaks"][s] / 2 ** 30 for r in results]
        launched += sum(c[1] for rank in calls for c in rank)
        print(f"[serve-auto] {s} kv_shards={shards} on (data=2, model=2), "
              f"the decode batch's rows split over data: tokens equal to the "
              f"single-process engine's on every rank={same} cell_calls="
              f"{n_cells} launches (rmsnorm, flash_attention, ssd_chunk) per "
              f"cell call on every rank={launches} (want {want})", flush=True)
        print(f"[serve-auto] {s} collectives per decode_step call by chunk "
              f"length {colls}; per cell (greedy and clock included, rank 0) "
              f"{comm_calls / n_cells:.5g}; host_ms_in_comm per cell "
              f"{comm_s / n_cells * 1e3:.5g} (rank 0, the replay: "
              f"{comm_calls} collectives, {comm_s:.5g} s of "
              f"{r0['seconds']:.5g} s)", flush=True)
        print(f"[serve-auto] {s} measured (closed loop, one replay after the "
              f"CLI's, rank 0): "
              f"tok_per_s={summ['tok_per_s']:.6g} wall_s={summ['wall_s']:.6g} "
              f"ttft_p50_ms={summ['ttft_p50_s'] * 1e3:.6g} "
              f"ttft_p99_ms={summ['ttft_p99_s'] * 1e3:.6g} "
              f"latency_p50_ms={summ['latency_p50_s'] * 1e3:.6g} "
              f"latency_p99_ms={summ['latency_p99_s'] * 1e3:.6g} "
              f"peak_GiB_per_rank={','.join(f'{v:.4g}' for v in peaks)}",
              flush=True)
        proj = price_serving(mc, system, s, 2, PAR_MODEL, shards,
                             SHARDED_CFG["max_batch"], traffic,
                             max_len=max_len, dtype_bytes=4,
                             prefill_chunk=SHARDED_CFG["prefill_chunk"])
        on = "the cluster [parallel] calibrated" if cluster else system.name
        print(f"[serve-auto] {s} projected (price_serving p1=2 p2={PAR_MODEL} "
              f"kv_shards={shards} on {on}: p1 independent replicas at "
              f"rate/p1, where the engine splits one batch): "
              f"tok_per_s={proj.tok_per_s:.6g} "
              f"t_prefill_ms={proj.t_prefill * 1e3:.6g} "
              f"t_decode_ms={proj.t_decode * 1e3:.6g} rho={proj.rho:.4g} "
              f"ttft_p99_ms={proj.ttft_p99 * 1e3:.6g} "
              f"latency_p99_ms={proj.latency_p99 * 1e3:.6g} "
              f"feasible={proj.feasible} {proj.limit} (reported, gated on "
              f"finiteness)", flush=True)
        if not all(same):
            bad = [i for i, ok in enumerate(same) if not ok]
            fail(f"[serve-auto] {s}: tokens differ from the single-process "
                 f"engine's on ranks {bad}")
        if launches != [want] or not n_cells:
            fail(f"[serve-auto] {s}: launches a cell call {launches}, not "
                 f"{want}")
        if not all(math.isfinite(v) for v in (proj.tok_per_s, proj.t_prefill,
                                              proj.t_decode)):
            fail(f"[serve-auto] {s}: projection not finite: {proj}")
    print(f"[serve-auto] phase wall time {seconds:.4g} s (the spawn's "
          f"serve-auto part); rmsnorm launches over every rank's runs "
          f"{launched}", flush=True)
    return launched


def _two_sgd_steps(cfg, ctx, batch, accum: int = 1, **fwd_kw) -> tuple:
    """Two SGD steps of a model from seed 0 (``accum`` microbatches a
    step): (first loss, the first step's gradient norm before clipping,
    second loss)."""
    model = build_model(cfg, ctx, seed=0)
    opt = OptimizerConfig(name="sgd", lr=3e-3)
    step = make_train_step(model, opt, ctx, accum=accum, **fwd_kw)
    state = train_state(model, opt)
    state, m0 = step(state, batch)
    state, m1 = step(state, batch)
    return float(m0["loss"]), float(m0["grad_norm"]), float(m1["loss"])


def phase_parallel(dev, hbm_bw: float, cluster_json: str) -> int:
    """The paper's CNN strategies across ranks on the card: PAR_RANKS ranks
    share it over gloo (spawned after the build, so no rank compiles).
    Sharded eval with the kernel (ResNet-50 and VGG16, batch 32, ds, the
    stride-1 3×3 sites on conv2d_gemm's pad_h=False entry): launches per
    rank against the site list, logits gathered and held against the
    single-process kernel path within EVAL_TOL. Sharded training: 2 SGD
    steps per strategy of PAR_TRAIN, the first loss, the first step's
    gradient norm and the second loss against two single-process steps
    within PAR_LOSS_TOL and PAR_STEP_TOL. Fig. 3 at p = 4:
    calibrate_cluster on the mesh, then validate over PAR_ORACLE; reported,
    gated on finiteness only. Returns the conv kernel's launches over all
    ranks and the rmsnorm kernel's launches of the serve-sharded phase."""
    t_phase = time.perf_counter()
    refs = {"logits": {}, "train": {}, "floor": {}}
    ctx_k = ShardingCtx(dev, use_pallas=True)
    for arch in PAR_EVAL_SITES:
        cfg = get_config(arch)
        model = build_model(cfg, ctx_k, seed=0)
        batch = Loader(train.data_config_for(cfg.model, BATCH, seed=0),
                       dev).batch_at(0)
        refs["logits"][arch] = make_eval_step(model, ctx_k)(batch)[
            "outputs"].cpu()
        del model, batch
    ctx_p = ShardingCtx(dev)
    for arch, batch_size, _ in PAR_TRAIN:
        cfg = get_config(arch)
        batch = Loader(train.data_config_for(cfg.model, batch_size, seed=0),
                       dev).batch_at(0)
        perm = torch.randperm(batch_size, generator=torch.Generator(
            ).manual_seed(1)).to(dev)
        refs["train"][arch] = _two_sgd_steps(cfg, ctx_p, batch)
        refs["floor"][arch] = _two_sgd_steps(
            cfg, ctx_p, {k: v[perm] for k, v in batch.items()})
        del batch
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase
    refs["pipe"] = _pipeline_refs(dev)
    t_pipe_ref = time.perf_counter() - t_phase - t_ref
    t0 = time.perf_counter()
    refs["lm"] = _lm_parallel_refs(dev)
    t_lm_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    refs["lm_pipe"] = _lm_pipeline_refs(dev)
    t_lm_pipe_ref = time.perf_counter() - t0
    refs["serve"] = _serve_sharded_refs(dev)
    from repro_torch.launch.spawn import run_ranks
    t_spawn = time.perf_counter()
    results = run_ranks(_parallel_rank, PAR_RANKS, hbm_bw, cluster_json,
                        backend="gloo", device="cuda", model=PAR_MODEL,
                        timeout_s=900)
    t_spawn = time.perf_counter() - t_spawn
    r0 = results[0]
    note = (f"{PAR_RANKS} ranks timesharing one card over gloo (host-staged "
            f"collectives): the counterpart of the reference's virtual host "
            f"devices, not a {PAR_RANKS}-GPU machine")
    print(f"[parallel] mesh (data={PAR_RANKS // PAR_MODEL}, "
          f"model={PAR_MODEL}); {note}; single-process references "
          f"{t_ref:.3g} s; the spawn's wall time {t_spawn:.4g} s (bound "
          f"900 s)", flush=True)
    total = 0
    for arch, sites in PAR_EVAL_SITES.items():
        want = _halo_launches(sites, PAR_MODEL)
        got = [r["launches"][arch] for r in results]
        total += sum(got)
        logits, ref = r0["logits"][arch], refs["logits"][arch]
        scale = float(ref.abs().max())
        ratio = _bar_ratio(logits, ref, EVAL_TOL, EVAL_TOL * min(scale, 1.0))
        print(f"[parallel] eval {arch} ds use_pallas batch={BATCH} "
              f"conv2d_gemm launches per rank={got} (site list: {want}) "
              f"logits vs single-process kernel path: max_abs_diff="
              f"{float((logits - ref).abs().max()):.3g} "
              f"logit_scale={scale:.4g} bar_ratio={ratio:.3g}", flush=True)
        if got != [want] * PAR_RANKS:
            fail(f"[parallel] {arch}: conv2d_gemm launched {got} times per "
                 f"rank, the site list gives {want}")
        if tuple(logits.shape) != (BATCH, 1000) or ratio > 1.0:
            fail(f"[parallel] {arch} sharded eval logits: shape "
                 f"{tuple(logits.shape)}, {ratio} times the bar")
    for arch, floor in refs["floor"].items():
        rel = [abs(g - w) / abs(w) for g, w in zip(floor,
                                                    refs["train"][arch])]
        print(f"[parallel] train {arch} single_process on the batch's rows "
              f"permuted (the sum-order spread of the same function): "
              f"rel_diff: loss1={rel[0]:.3g} grad_norm1={rel[1]:.3g} "
              f"loss2={rel[2]:.3g}", flush=True)
    for (arch, s), (losses, norms, ms, peak) in r0["train"].items():
        got = (losses[0], norms[0], losses[1])
        want = refs["train"][arch]
        rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        bars = (PAR_LOSS_TOL, PAR_STEP_TOL, PAR_STEP_TOL)
        print(f"[parallel] train {arch} {s} losses="
              f"{','.join(f'{v:.7g}' for v in losses)} grad_norm_step1="
              f"{norms[0]:.7g} single_process: loss1={want[0]:.7g} "
              f"grad_norm1={want[1]:.7g} loss2={want[2]:.7g} rel_diff: "
              f"loss1={rel[0]:.3g} (bar {bars[0]}) grad_norm1={rel[1]:.3g} "
              f"loss2={rel[2]:.3g} (bar {bars[1]}) step_ms="
              f"{','.join(f'{v:.4g}' for v in ms)} "
              f"max_memory_allocated_rank0={peak}", flush=True)
        if not all(math.isfinite(v) for v in got) or any(
                r > bar for r, bar in zip(rel, bars)):
            fail(f"[parallel] {arch} {s}: (loss1, grad_norm1, loss2) {got} "
                 f"against the single-process {want}: {rel} relative (bars "
                 f"{bars})")
    cluster, ms, t_cal = r0["cluster"]
    print(f"[parallel] calibrate_cluster on the mesh ({t_cal:.3g} s): "
          f"peak_flops per rank={cluster.peak_flops:.6g} "
          + " ".join(f"{a}: alpha={cluster.level(a).alpha:.4g} "
                     f"beta={cluster.level(a).beta:.4g}"
                     for a in ("data", "model"))
          + f" phi={dict(cluster.phi or ())} sigma={dict(cluster.sigma or ())}",
          flush=True)
    print(f"[parallel] fig3 runs at global batch "
          f"{ {a: b for a, b, _ in PAR_ORACLE} } (the p = 1 block's: "
          f"{dict(ORACLE_BATCH)}): see PAR_ORACLE", flush=True)
    rows = []
    for arch, (batch_size, pts, t_val) in r0["oracle"].items():
        lines = accuracy_report(pts).splitlines()
        print(f"[parallel] fig3 p={PAR_RANKS} {arch} batch={batch_size} "
              f"({t_val:.3g} s) {lines[0]}", flush=True)
        for line in lines[1:-1]:
            print(f"[parallel] fig3 p={PAR_RANKS} {arch} "
                  f"batch={batch_size} {line}", flush=True)
        for pt in pts:
            if not all(math.isfinite(t) and t > 0 for t in (
                    pt.measured_s, pt.projected_s, pt.projected_serial_s)):
                fail(f"[parallel] {arch} {pt.strategy}: measured "
                     f"{pt.measured_s} s, projected {pt.projected_s} s")
        rows += pts
    print(f"[parallel] mean accuracy at p={PAR_RANKS}: "
          f"{statistics.mean(pt.accuracy for pt in rows) * 100:.4g}% "
          f"(serial-comm {statistics.mean(pt.accuracy_serial for pt in rows) * 100:.4g}%; "
          f"{note}; reported, not gated)", flush=True)
    t_pipe = t_pipe_ref + r0["pipeline"]["seconds"]
    t_lm = t_lm_ref + r0["lm"]["seconds"]
    t_lm_pipe = t_lm_pipe_ref + r0["lm_pipe"]["seconds"]
    t_summa = r0["summa"]["seconds"]
    t_serve = refs["serve"]["seconds"] + r0["serve_sharded"]["seconds"]
    t_serve_auto = r0["serve_auto"]["seconds"]
    own = time.perf_counter() - t_phase - t_pipe - t_lm - t_lm_pipe \
        - t_summa - t_serve - t_serve_auto - r0["auto"]["seconds"]
    print(f"[parallel] phase wall time {own:.4g} s (the pipeline, "
          f"lm-parallel, lm-pipeline, summa, serve-sharded, serve-auto and "
          f"auto phases' parts excluded)", flush=True)
    _report_pipeline(results, refs["pipe"], rows, note, t_pipe, cluster)
    _report_lm_parallel(results, refs["lm"], t_lm)
    _report_lm_pipeline(results, refs["lm_pipe"], t_lm_pipe)
    _report_summa(results, refs["lm"], t_summa)
    rms = _report_serve_sharded(results, refs["serve"], t_serve, cluster,
                                hbm_bw)
    rms += _report_serve_auto(results, refs["serve"], t_serve_auto, cluster,
                              hbm_bw)
    _report_auto_ranks(results)
    return total, rms



def _pipeline_refs(dev) -> dict:
    """Two single-process SGD steps per PIPE_TRAIN model at the step's
    microbatch size (CosmoFlow: the plain step), before the spawn."""
    from repro_torch.parallel.schedules import clip_segments
    refs, ctx = {}, ShardingCtx(dev)
    for arch, batch_size, segments, _ in PIPE_TRAIN:
        cfg = get_config(arch)
        batch = Loader(train.data_config_for(cfg.model, batch_size, seed=0),
                       dev).batch_at(0)
        S = clip_segments(batch_size, segments)
        accum = 1 if arch == "cosmoflow" else S
        refs[arch] = (S, accum, _two_sgd_steps(cfg, ctx, batch, accum))
        del batch
        torch.cuda.empty_cache()
    return refs


def _report_pipeline(results, refs, rows, note, seconds, cluster):
    """Prints and gates the pipeline phase (see the module docstring, 5d)."""
    from repro_torch.core.validation import schedule_winner
    r0 = results[0]["pipeline"]
    print(f"[pipeline] mesh (data=1, model={PAR_RANKS}): the [parallel] "
          f"world regridded, every rank a stage; {note}", flush=True)
    for (arch, schedule), (losses, norms, ms, S, bounds) in r0[
            "train"].items():
        S_want, accum, want = refs[arch]
        got = (losses[0], norms[0], losses[1])
        rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        bars = (PAR_LOSS_TOL, PAR_STEP_TOL, PAR_STEP_TOL)
        peaks = [r["pipeline"]["peaks"][arch, schedule] for r in results]
        batch_size = next(b for a, b, _, _ in PIPE_TRAIN if a == arch)
        print(f"[pipeline] train {arch} {schedule} batch={batch_size} "
              f"pipeline_segments={S} cuts={bounds} losses="
              f"{','.join(f'{v:.7g}' for v in losses)} grad_norm_step1="
              f"{norms[0]:.7g} single_process(accum={accum}): loss1="
              f"{want[0]:.7g} grad_norm1={want[1]:.7g} loss2={want[2]:.7g} "
              f"rel_diff: loss1={rel[0]:.3g} (bar {bars[0]}) grad_norm1="
              f"{rel[1]:.3g} loss2={rel[2]:.3g} (bar {bars[1]}) step_ms="
              f"{','.join(f'{v:.4g}' for v in ms)} "
              f"max_memory_allocated_per_rank={peaks}", flush=True)
        if S != S_want or not all(math.isfinite(v) for v in got) or any(
                r > bar for r, bar in zip(rel, bars)):
            fail(f"[pipeline] {arch} {schedule}: S={S} (want {S_want}), "
                 f"(loss1, grad_norm1, loss2) {got} against the "
                 f"single-process {want}: {rel} relative (bars {bars})")
    arch, mb, s_small, s_large = PIPE_BUBBLE
    cfg = get_config(arch)
    winner = schedule_winner(
        stats_for(cfg.model), TimeModel(cluster.system),
        OracleConfig(B=s_large * mb, D=s_large * mb, segments=s_large,
                     virtual_stages=2, **cluster.oracle_kw()), PAR_RANKS)
    bubbles = r0["bubble"]
    for schedule, b in bubbles.items():
        print(f"[pipeline] bubble {arch} microbatch={mb} {schedule}"
              + (" v=2" if schedule == "interleaved" else "")
              + f": t(S={s_small})={b['t_small_s'] * 1e3:.6g} ms "
              f"t(S={s_large})={b['t_large_s'] * 1e3:.6g} ms "
              f"per_microbatch={b['per_microbatch_s'] * 1e3:.6g} ms "
              f"intercept={b['intercept_s'] * 1e3:.6g} ms "
              f"bubble={b['bubble_s'] * 1e3:.6g} ms "
              f"fraction={b['bubble_fraction']:.4g}", flush=True)
    measured = min(bubbles, key=lambda s: bubbles[s]["t_large_s"])
    print(f"[pipeline] schedule winner at p={PAR_RANKS}, batch "
          f"{s_large * mb}, S={s_large}: measured (least t(S={s_large})) "
          f"{measured}, oracle {winner} (reported, not gated)", flush=True)
    pipe_rows = []
    for arch, (batch_size, pts) in r0["fig3"].items():
        for line in accuracy_report(pts).splitlines()[:-1]:
            print(f"[pipeline] fig3 p={PAR_RANKS} {arch} batch={batch_size} "
                  f"{line}", flush=True)
        if [pt.strategy for pt in pts] != ["pipeline"]:
            fail(f"[pipeline] {arch}: validate gave {pts}, not the pipeline "
                 f"row")
        for pt in pts:
            if not all(math.isfinite(t) and t > 0 for t in (
                    pt.measured_s, pt.projected_s, pt.projected_serial_s)):
                fail(f"[pipeline] {arch}: measured {pt.measured_s} s, "
                     f"projected {pt.projected_s} s")
        pipe_rows += pts
    both = rows + pipe_rows
    serial = statistics.mean(pt.accuracy_serial for pt in both)
    print(f"[pipeline] mean accuracy at p={PAR_RANKS}: without the pipeline "
          f"row {statistics.mean(pt.accuracy for pt in rows) * 100:.4g}%, "
          f"with it {statistics.mean(pt.accuracy for pt in both) * 100:.4g}% "
          f"(serial-comm {serial * 100:.4g}%; reported, not gated)",
          flush=True)
    print(f"[pipeline] phase wall time {seconds:.4g} s (single-process "
          f"references and the spawn's pipeline part)", flush=True)


def _fp32_smoke(arch: str):
    """``arch``'s registered config with the smoke model in fp32."""
    cfg = get_config(arch)
    mc = cfg.smoke_model
    sub = {k: dataclasses.replace(getattr(mc, k), dtype=torch.float32)
           for k in ("attn", "ffn", "ssm") if getattr(mc, k) is not None}
    return dataclasses.replace(cfg, smoke_model=dataclasses.replace(
        mc, dtype=torch.float32, **sub))


def _two_adamw_steps(model, device, **fwd_kw) -> tuple[float, float, float]:
    """(first loss, first gradient norm, second loss) of two AdamW steps
    of ``model`` on ``device``, batches 0 and 1 of the seeded token
    stream."""
    ctx = ShardingCtx(device)
    opt = OptimizerConfig()
    step = make_train_step(model, opt, ctx, q_chunk=LM_CPU_SEQ, **fwd_kw)
    state = train_state(model, opt)
    loader = Loader(train.data_config_for(model.cfg, LM_CPU_BATCH,
                                          LM_CPU_SEQ, seed=0), device)
    state, m0 = step(state, loader.batch_at(0))
    state, m1 = step(state, loader.batch_at(1))
    return float(m0["loss"]), float(m0["grad_norm"]), float(m1["loss"])


def phase_lm_train(dev):
    """The LMs' training steps at full width (LM_TRAIN_SHAPE), then the fp32
    smoke steps on the card against the CPU."""
    for arch, (batch, seq) in LM_TRAIN_SHAPE.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = train.main(["--arch", arch, "--batch", str(batch), "--seq",
                          str(seq), "--steps", "3", "--log-every", "1",
                          "--device", "cuda"])
        losses = out["losses"]
        if len(losses) != 3 or not all(math.isfinite(v) for v in losses):
            fail(f"[lm-train] {arch} losses {losses}")
        step_ms = statistics.mean(out["step_s"][1:]) * 1e3
        print(f"[lm-train] {arch} batch={batch} seq={seq} steps=3 losses="
              f"{','.join(f'{v:.6g}' for v in losses)} "
              f"ms_per_step={step_ms:.6g} "
              f"first_step_ms={out['step_s'][0] * 1e3:.6g} "
              f"tokens_per_s={batch * seq / step_ms * 1e3:.6g} "
              f"peak_gb={torch.cuda.max_memory_allocated() / 1e9:.4g}",
              flush=True)
        del out
        torch.cuda.empty_cache()
    names = ("first_loss", "grad_norm", "second_loss")
    for arch in ("qwen1.5-4b", "mamba2-780m"):
        cpu_model = build_model(_fp32_smoke(arch), ShardingCtx("cpu"),
                                smoke=True, seed=0)
        card_model = copy.deepcopy(cpu_model).to(dev)
        card = _two_adamw_steps(card_model, dev)
        cpu = _two_adamw_steps(cpu_model, torch.device("cpu"))
        rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
        print(f"[lm-train] {arch} fp32 smoke, card vs cpu: "
              + " ".join(f"{n}={a:.9g}/{b:.9g} rel={r:.3g}"
                         for n, a, b, r in zip(names, card, cpu, rel)),
              flush=True)
        for n, r, tol in zip(names, rel, LM_CPU_TOL):
            if not r <= tol:
                fail(f"[lm-train] {arch} fp32 smoke {n}: card vs cpu "
                     f"relative {r} over {tol}")


def _write_cluster(cluster) -> str:
    """The calibrated ClusterSpec as a JSON file (``--cluster``), in the
    temporary directory, removed when the script exits."""
    fd, path = tempfile.mkstemp(prefix="chip_smoke_cluster_", suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(cluster.to_json(), f)
    atexit.register(os.unlink, path)
    return path


def _adamw_steps_ms(arch: str, batch: int, seq: int, dev, **fwd_kw):
    """3 AdamW steps of ``arch`` at full width (seed 0, the seeded token
    stream) through make_train_step: (losses, step ms, peak bytes)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    ctx = ShardingCtx(dev)
    model = build_model(cfg, ctx, seed=0)
    opt = OptimizerConfig(lr=3e-3)
    step = make_train_step(model, opt, ctx, q_chunk=min(256, seq), **fwd_kw)
    state = train_state(model, opt)
    loader = Loader(train.data_config_for(cfg.model, batch, seq, seed=0), dev)
    losses, ms = [], []
    for i in range(3):
        b = loader.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    del model, state, step
    torch.cuda.empty_cache()
    return losses, ms, peak


def phase_auto(dev, cluster, cluster_json: str):
    """Phase 10 of the docstring, its one-card part."""
    from repro_torch.core.autotune import autotune, stats_for_model
    from repro_torch.parallel.schedules import (pipeline_block_count,
                                                pipeline_supported)
    t_phase = time.perf_counter()
    print(f"[auto] cluster {cluster.name}: peak_flops="
          f"{cluster.peak_flops:.6g} hbm_bw={cluster.hbm_bw:.6g} "
          f"mem_capacity={cluster.mem_capacity:.6g}", flush=True)
    for arch, batch, seq in AUTO_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = train.main(["--arch", arch, "--batch", str(batch), "--steps",
                          "3", "--log-every", "1", "--device", "cuda",
                          "--strategy", "auto", "--cluster", cluster_json]
                         + (["--seq", str(seq)] if seq else []))
        run_s = time.perf_counter() - t0
        plan, losses = out["plan"], out["losses"]
        if plan is None or plan.p != 1 or len(losses) != 3 or not all(
                math.isfinite(v) for v in losses):
            fail(f"[auto] {arch}: plan {plan}, losses {losses}")
        step_ms = statistics.mean(out["step_s"][1:]) * 1e3
        rate = (f"tokens_per_s={batch * seq / step_ms * 1e3:.6g}" if seq
                else f"samples_per_s={batch / step_ms * 1e3:.6g}")
        print(f"[auto] p=1 {arch} batch={batch}"
              + (f" seq={seq}" if seq else "")
              + f" {plan.describe()} exec={out['strategy']} "
              f"switches={plan.switch_str()} losses="
              f"{','.join(f'{v:.6g}' for v in losses)} "
              f"ms_per_step={step_ms:.6g} "
              f"first_step_ms={out['step_s'][0] * 1e3:.6g} {rate} "
              f"projected_ms_per_step={plan.per_iter_s * 1e3:.6g} "
              f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
              f"projected_mem_bytes={plan.mem_bytes:.6g} "
              f"run_s={run_s:.4g}", flush=True)
        del out
        torch.cuda.empty_cache()
    for arch, batch, seq in REMAT_RUNS:
        cfg = get_config(arch)
        losses, ms, peak = _adamw_steps_ms(arch, batch, seq, dev, remat=True)
        if not all(math.isfinite(v) for v in losses):
            fail(f"[auto] remat {arch} losses {losses}")
        plan = autotune(stats_for_model(cfg.model, seq),
                        TimeModel(cluster.system),
                        cluster.oracle_config(B=batch, D=batch), 1,
                        fallback=cfg.strategy, cluster=cluster,
                        allow_pipeline=pipeline_supported(cfg.model) is None,
                        max_stages=pipeline_block_count(cfg.model))
        step_ms = statistics.mean(ms[1:])
        print(f"[auto] remat {arch} bf16 batch={batch} seq={seq} steps=3 "
              f"losses={','.join(f'{v:.6g}' for v in losses)} "
              f"ms_per_step={step_ms:.6g} first_step_ms={ms[0]:.6g} "
              f"tokens_per_s={batch * seq / step_ms * 1e3:.6g} "
              f"max_memory_allocated={peak} "
              f"(card {torch.cuda.get_device_properties(dev).total_memory}); "
              f"the tuner at this point: {plan.describe()}", flush=True)
    names = ("first_loss", "grad_norm", "second_loss")
    for arch in ("qwen1.5-4b", "mamba2-780m"):
        base = build_model(_fp32_smoke(arch), ShardingCtx("cpu"),
                           smoke=True, seed=0)
        off = _two_adamw_steps(copy.deepcopy(base).to(dev), dev)
        on = _two_adamw_steps(copy.deepcopy(base).to(dev), dev, remat=True)
        rel = [abs(a - b) / abs(b) for a, b in zip(on, off)]
        print(f"[auto] remat {arch} fp32 smoke, on vs off on the card: "
              + " ".join(f"{n}={a:.9g}/{b:.9g} rel={r:.3g}"
                         for n, a, b, r in zip(names, on, off, rel)),
              flush=True)
        if on[0] != off[0]:
            fail(f"[auto] remat {arch}: first loss {on[0]} with remat, "
                 f"{off[0]} without")
        for n, r, tol in zip(names[1:], rel[1:], LM_CPU_TOL[1:]):
            if not r <= tol:
                fail(f"[auto] remat {arch} fp32 smoke {n}: on vs off "
                     f"relative {r} over {tol}")
    print(f"[auto] phase wall time {time.perf_counter() - t_phase:.4g} s "
          f"(the 4-rank run's part is in the [parallel] spawn)", flush=True)


def _session_calibration(cfg, batch_size: int, dev):
    """The [oracle] phase's calibration through the session:
    ``Oracle.calibrate`` on one card, the arch's full model measured (the
    session measures its config's smoke model: here the full one) at
    ``batch_size`` on cuda_device_model with the card's measured HBM rate,
    as ``calibrate_host_system`` calibrates it; returns the session, bound
    to the fitted cluster."""
    from repro_torch.api import Oracle
    from repro_torch.core.calibration import measure_hbm_bw
    base = ClusterSpec.from_system(cuda_device_model(
        dev, hbm_bw=measure_hbm_bw(dev), flops=0.0))
    ses = Oracle(dataclasses.replace(cfg, smoke_model=cfg.model),
                 "train_4k", base, batch=batch_size)
    ses.calibrate(None, batch_size=batch_size, device=dev)
    return ses


def phase_api(dev, ses, cluster_json: str):
    """The session on one card (12 of the docstring)."""
    from repro_torch.api import Oracle
    from repro_torch.launch.build import shard_batch
    t_phase = time.perf_counter()
    cluster = ses.cluster
    again = ClusterSpec.from_json(cluster_json)
    via = ses.project("data", 1)
    direct = project("data", ses.stats, TimeModel(cluster.system),
                     cluster.oracle_config(B=ses.B, D=ses.D), 1)
    print(f"[api] Oracle.calibrate ([oracle]'s ResNet-50 calibration): "
          f"peak_flops={cluster.peak_flops:.6g} hbm_bw={cluster.hbm_bw:.6g} "
          f"JSON read back equal={again == cluster}; session project(data, "
          f"p=1)={via.total_s!r} s, the direct call's={direct.total_s!r} s",
          flush=True)
    if again != cluster or via.total_s != direct.total_s:
        fail(f"[api] the session's cluster or projection differs from the "
             f"JSON's or the direct call's: {again} / {cluster}, "
             f"{via.total_s} / {direct.total_s}")
    train_ses = Oracle("resnet50", "train_4k", cluster)
    torch.cuda.empty_cache()
    cell = train_ses.build(None, device=dev)
    plan = cell.meta["plan"]
    images = tuple(cell.args[1]["images"].shape)
    batch_size = train_ses.B
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    state = train_state(cell.model, cell.meta["opt"], cell.ctx)
    loader = Loader(train.data_config_for(get_config("resnet50").model,
                                          batch_size, seed=0), dev)
    losses, ms = [], []
    try:
        for i in range(2):
            batch = shard_batch(loader.batch_at(i), cell.ctx)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, m = cell.step_fn(state, batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
    except torch.cuda.OutOfMemoryError as e:
        fail(f"[api] the built train cell runs out of memory at the shape's "
             f"global batch {batch_size}: {e}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[api] Oracle(resnet50, train_4k, cluster).build(None): "
          f"{plan.describe()} strategy={cell.strategy} kind={cell.kind} "
          f"zero1={cell.meta['opt'].zero1} args images={images}; 2 steps "
          f"at batch {batch_size} (the shape's global batch), 224²: losses="
          f"{','.join(f'{v:.6g}' for v in losses)} step_ms="
          f"{','.join(f'{v:.6g}' for v in ms)} "
          f"samples_per_s={batch_size / ms[-1] * 1e3:.6g} "
          f"projected_ms_per_step={plan.per_iter_s * 1e3:.6g} "
          f"(at {train_ses.B}) max_memory_allocated={peak} "
          f"projected_mem_bytes={plan.mem_bytes:.6g}", flush=True)
    if not all(math.isfinite(v) for v in losses) or cell.kind != "train":
        fail(f"[api] built cell {cell.kind}: losses {losses}")
    del cell, state, loader
    torch.cuda.empty_cache()
    (pt,) = train_ses.validate(ShardingCtx(dev), ("data",), use_cluster=True)
    print(f"[api] .validate(ctx, ('data',), use_cluster=True), the smoke "
          f"ResNet-50 at batch 8: measured_ms={pt.measured_s * 1e3:.6g} "
          f"projected_ms={pt.projected_s * 1e3:.6g} "
          f"accuracy={pt.accuracy * 100:.4g}%", flush=True)
    if not all(math.isfinite(t) and t > 0 for t in (pt.measured_s,
                                                    pt.projected_s)):
        fail(f"[api] validate: {pt}")
    for arch, shape in API_SERVE_CELLS:
        c = Oracle(arch, shape, cluster).build(None, device="meta",
                                               use_pallas=True)
        cache = c.args[2]["blocks"]
        first = {k: tuple(v.shape) for k, v in cache[0].items()}
        inputs = (tuple(c.args[1]["tokens"].shape) if c.kind == "prefill"
                  else tuple(c.args[1].shape))
        print(f"[api] {arch} {shape} cell on meta (not run): "
              f"{c.meta['plan'].describe()} strategy={c.strategy} "
              f"kind={c.kind} remat={c.meta['remat']} use_pallas="
              f"{c.ctx.use_pallas} params={len(c.args[0])} tensors, "
              f"tokens={inputs} cache {len(cache)} layers, layer 0 {first}",
              flush=True)
        if c.kind != SHAPES_KIND[shape] or c.strategy != "serve_tp" \
                or c.meta["remat"]:
            fail(f"[api] {arch} {shape}: {c.kind} {c.strategy}")
    print(f"[api] phase wall time {time.perf_counter() - t_phase:.4g} s",
          flush=True)


def phase_ckpt(dev):
    """Checkpointing through the trainer (13 of the docstring)."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    atexit.register(shutil.rmtree, root, True)
    print(f"[ckpt] writing under the temporary directory: "
          f"{shutil.disk_usage(root).free / 1e9:.4g} GB free", flush=True)
    qwen = get_config("qwen1.5-4b")
    b, seq = LM_TRAIN_SHAPE["qwen1.5-4b"]
    runs = (("resnet50", None, ["--batch", str(BATCH), "--ckpt-every", "1"]),
            ("qwen1.5-4b", dataclasses.replace(qwen, model=dataclasses.replace(
                qwen.model, n_layers=CKPT_LM_LAYERS)),
             ["--batch", str(b), "--seq", str(seq), "--ckpt-every", "100"]))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for arch, cfg, extra in runs:
            t0 = time.perf_counter()
            argv = ["--arch", arch, "--device", "cuda", "--log-every", "100"] \
                + extra
            where = os.path.join(root, arch)
            torch.cuda.reset_peak_memory_stats(dev)
            straight = train.main(argv + ["--steps", "4"], cfg=cfg)["losses"]
            first = train.main(argv + ["--steps", "2", "--ckpt-dir", where],
                               cfg=cfg)
            # a step cut before its commit: the resume must skip it
            torn = Path(where) / arch / "step_00000003"
            torn.mkdir()
            (torn / "manifest.json").write_text("{}")
            rest = train.main(argv + ["--steps", "4", "--ckpt-dir", where],
                              cfg=cfg)
            peak = torch.cuda.max_memory_allocated(dev)
            saves = first["ckpt_saves"] + rest["ckpt_saves"]
            print(f"[ckpt] {arch}"
                  + (f" cut to {CKPT_LM_LAYERS} layers, bf16, batch {b} x "
                     f"{seq}" if cfg else f" batch {BATCH}")
                  + f": straight losses="
                  f"{','.join(repr(v) for v in straight)}; resumed from step "
                  f"{rest['start_step']} (the torn step 3 skipped) losses="
                  f"{','.join(repr(v) for v in first['losses'] + rest['losses'])}"
                  f"; equal bit for bit="
                  f"{first['losses'] + rest['losses'] == straight}",
                  flush=True)
            for sv in saves:
                print(f"[ckpt] {arch} save step={sv['step']} "
                      f"{'blocking' if sv['blocking'] else 'async'}: "
                      f"host_copy_ms={sv['copy_s'] * 1e3:.6g} (the train loop "
                      f"waits this long) write_ms={sv['write_s'] * 1e3:.6g} "
                      f"bytes_on_disk={sv['bytes']}", flush=True)
            if rest["start_step"] != 2 or \
                    first["losses"] + rest["losses"] != straight:
                fail(f"[ckpt] {arch}: resumed at {rest['start_step']}, "
                     f"losses {first['losses']} + {rest['losses']} against "
                     f"the straight run's {straight}")
            shutil.rmtree(where)
            print(f"[ckpt] {arch} run_s={time.perf_counter() - t0:.4g} "
                  f"max_memory_allocated={peak}", flush=True)
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.use_deterministic_algorithms(False)
    print(f"[ckpt] phase wall time {time.perf_counter() - t_phase:.4g} s",
          flush=True)


def _elastic_rank(mesh, cluster_json: str, root: str) -> dict:
    """One rank of the elastic phase (14 of the docstring): the baseline
    through launch.train --elastic, the chaos run through run_elastic with
    torus dim 0 lost, the planned continuation on the survivors; the
    comparisons run on the survivors, where the states are."""
    from repro_torch.api import Oracle
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.cluster import Torus
    from repro_torch.runtime.elastic import (planned_continuation,
                                             run_elastic, whole_params)
    from repro_torch.runtime.fault_tolerance import SliceLost
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    arch, batch, steps, every, kill_at = ELASTIC
    dev = mesh.device
    out = {}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    base = train.main(
        ["--arch", arch, "--device", "cuda", "--backend", "gloo", "--batch",
         str(batch), "--steps", str(steps), "--ckpt-every", str(every),
         "--log-every", "100", "--strategy", "auto", "--elastic",
         "--ckpt-dir", f"{root}/base", "--cluster", cluster_json,
         "--topology", ELASTIC_TORUS[0], "--model-dims", ELASTIC_TORUS[1]])
    out["base"] = {k: base.get(k) for k in ("losses", "step_s", "plan",
                                            "mesh", "events", "peak_bytes")}
    out["base"]["saves"] = base["ckpt_saves"]
    out["base"]["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    cfg = get_config(arch)
    topo = Torus.parse(*ELASTIC_TORUS)
    cluster = dataclasses.replace(ClusterSpec.from_json(cluster_json),
                                  topology=topo)
    ses = Oracle(cfg, "train_4k", cluster, batch=batch, seq=128)
    data_cfg = train.data_config_for(cfg.model, batch, 128, 0)
    opt = OptimizerConfig(lr=3e-3)        # the trainer's
    kw = dict(device="cuda", seed=0, cell_kw=dict(q_chunk=128))
    marks, traj, step_s, meshes = {}, {}, {}, []

    def kill(step):
        if step == kill_at and "lost" not in marks:
            marks["lost"] = time.perf_counter()
            raise SliceLost(step, dim=0, reason="injected slice death")

    def on_metrics(s, m):
        traj[s], step_s[s] = float(m["loss"]), m["step_s"]
        if "bound" in marks and "first" not in marks:
            marks["first"] = time.perf_counter()

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ckpt = Checkpointer(f"{root}/chaos", mesh=mesh)
    state, step, events = run_elastic(
        ses, data_cfg, ckpt, n_steps=steps, mesh=mesh, opt=opt,
        ckpt_every=every, straggler_patience=3, inject=kill,
        on_metrics=on_metrics,
        on_event=lambda ev: marks.setdefault("bound", time.perf_counter()),
        on_bind=lambda b: meshes.append((b.plan, b.mesh)), **kw)
    out["chaos"] = {"traj": traj, "step_s": step_s, "events": events,
                    "step": step, "left_out": state is None,
                    "seconds": time.perf_counter() - t0,
                    "peak": torch.cuda.max_memory_allocated(dev),
                    "saves": ckpt.saves, "plans": [p for p, _ in meshes],
                    "marks": {k: v - marks["lost"] for k, v in marks.items()}}
    params = None if state is None else whole_params(state, meshes[-1][1])
    state = None
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ref = planned_continuation(
        ses.with_cluster(cluster.degraded(dim=0)), mesh, 2, data_cfg, opt,
        steps, ckpt=Checkpointer(f"{root}/base/{arch}"), step=every, **kw)
    if ref is not None:
        whole = ref.pop("params")
        out["planned"] = dict(
            ref, params_equal=all(torch.equal(params[k], v)
                                  for k, v in whole.items()),
            params_max_abs_diff=max(float((params[k] - v).abs().max())
                                    for k, v in whole.items()),
            seconds=time.perf_counter() - t0)
        del whole
    del params, ref
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(False)
    return out


def _report_elastic(results, seconds: float) -> None:
    """Prints and gates the elastic phase (14 of the docstring)."""
    from repro_torch.core.cluster import Torus
    arch, batch, steps, every, kill_at = ELASTIC
    r0 = results[0]
    base, chaos, planned = r0["base"], r0["chaos"], r0["planned"]
    print(f"[elastic] {arch} batch {batch}, fp32, AdamW, {PAR_RANKS} ranks "
          f"sharing the card over gloo, torus {ELASTIC_TORUS[0]} (model "
          f"dims {ELASTIC_TORUS[1]}), checkpoint every {every}, torus dim 0 "
          f"lost before step {kill_at} of {steps}; cuDNN deterministic",
          flush=True)
    print(f"[elastic] plan before (launch.train --strategy auto --elastic, "
          f"p={PAR_RANKS}): {base['plan'].describe()} mesh={base['mesh']}",
          flush=True)
    events = chaos["events"]
    if len(events) != 1:
        fail(f"[elastic] events {events}: one expected")
    ev = events[0]
    print(f"[elastic] plan after (re-tuned on the degraded cluster, p="
          f"{ev.p_after}): {chaos['plans'][-1].describe()} (planned "
          f"continuation's: {planned['plan'].describe()}); event "
          f"{ev}", flush=True)
    b_ms = [v * 1e3 for v in base["step_s"]]
    c_ms = {s: v * 1e3 for s, v in sorted(chaos["step_s"].items())}
    p_ms = {s: v * 1e3 for s, v in sorted(planned["step_s"].items())}
    print(f"[elastic] ms/step on {PAR_RANKS} ranks (baseline, steps 0-"
          f"{steps - 1}): {','.join(f'{v:.6g}' for v in b_ms)}; on "
          f"{ev.p_after} ranks (chaos run, steps {ev.resumed_from}-"
          f"{steps - 1}): "
          f"{','.join(f'{v:.6g}' for s, v in c_ms.items() if s >= ev.resumed_from)}"
          f"; planned continuation: "
          f"{','.join(f'{v:.6g}' for v in p_ms.values())}", flush=True)
    for what, saves in (("baseline", base["saves"]),
                        ("chaos", chaos["saves"])):
        for sv in saves:
            print(f"[elastic] {what} save step={sv['step']} "
                  f"{'blocking' if sv['blocking'] else 'async'}: "
                  f"host_copy_ms={sv['copy_s'] * 1e3:.6g} write_ms="
                  f"{sv.get('write_s', float('nan')) * 1e3:.6g} "
                  f"bytes_on_disk={sv.get('bytes')}", flush=True)
    mk = chaos["marks"]
    print(f"[elastic] recovery_s={mk['first']:.6g} (SliceLost → end of the "
          f"first resumed step): rebind_s={mk['bound']:.6g} (wait, "
          f"re-tune, the survivors' groups, the new cell, the restore) + "
          f"first_step_s={mk['first'] - mk['bound']:.6g}; the planned "
          f"continuation's restore of step {every} onto the {ev.p_after} "
          f"ranks: restore_ms={planned['restore_s'] * 1e3:.6g}", flush=True)
    print(f"[elastic] peak bytes per rank (max_memory_allocated): baseline "
          f"{base['peak_bytes']}; chaos run "
          f"{[r['chaos']['peak'] for r in results]} (ranks "
          f"{[i for i, r in enumerate(results) if r['chaos']['left_out']]} "
          f"left out)", flush=True)
    traj = chaos["traj"]
    prefix = [traj[s] == base["losses"][s] for s in range(ev.resumed_from)]
    suffix = [traj[s] == planned["losses"][s]
              for s in range(ev.resumed_from, steps)]
    print(f"[elastic] losses baseline={base['losses']} chaos="
          f"{[traj[s] for s in sorted(traj)]} planned={planned['losses']}; "
          f"prefix equal bit for bit={all(prefix)}, suffix={all(suffix)}, "
          f"final parameters equal={planned['params_equal']} (max abs diff "
          f"{planned['params_max_abs_diff']:.3g})", flush=True)
    degraded = Torus.parse(*ELASTIC_TORUS).without_slice(0)
    p1, p2 = ev.mesh_shape
    valid = bool(degraded.split_mask(ev.p_after, p1, p2, ev.strategy))
    if not (all(prefix) and all(suffix) and planned["params_equal"]):
        fail(f"[elastic] recovery is not the planned reshape bit for bit: "
             f"prefix {prefix}, suffix {suffix}, parameters equal "
             f"{planned['params_equal']}")
    if (ev.p_before, ev.p_after, ev.resumed_from) != (PAR_RANKS, 2, every) \
            or not valid or p1 * p2 != 2:
        fail(f"[elastic] event {ev} (valid on {degraded}: {valid})")
    left = [i for i, r in enumerate(results) if r["chaos"]["left_out"]]
    if left != [2, 3] or any(r["chaos"]["events"] != events
                             for r in results):
        fail(f"[elastic] ranks left out {left}; events per rank "
             f"{[r['chaos']['events'] for r in results]}")
    print(f"[elastic] phase wall time {seconds:.4g} s (baseline "
          f"{base['seconds']:.4g}, chaos {chaos['seconds']:.4g}, planned "
          f"{planned['seconds']:.4g})", flush=True)


def phase_elastic(cluster_json: str):
    """The elastic runtime on the card (14 of the docstring): PAR_RANKS
    ranks share it in a spawn of their own."""
    from repro_torch.launch.spawn import run_ranks
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    atexit.register(shutil.rmtree, root, True)
    results = run_ranks(_elastic_rank, PAR_RANKS, cluster_json, root,
                        backend="gloo", device="cuda", model=PAR_MODEL,
                        timeout_s=600)
    _report_elastic(results, time.perf_counter() - t0)
    shutil.rmtree(root, ignore_errors=True)


class _FirstLogits(Engine):
    """The engine, keeping the logits (vocab,) at the first generated
    token of the requests in ``keep``."""

    def __init__(self, *args, keep=()):
        super().__init__(*args)
        self.keep, self.first_logits = set(keep), {}

    def _first_token(self, stats, logits, last):
        if stats.rid in self.keep:
            self.first_logits[stats.rid] = logits[0, last].clone()
        return super()._first_token(stats, logits, last)


def _solo_greedy(model, ctx, prompt, max_new: int, max_len: int):
    """Dense-cache single-sequence greedy decode: (the logits at the first
    generated token, the tokens)."""
    cache = zeros_like_spec(model.cache_spec(1, max_len), ctx.device)
    tokens = torch.from_numpy(prompt[None]).to(ctx.device)
    logits, cache = make_prefill_step(model, ctx)({"tokens": tokens}, cache)
    first, toks = logits[0, 0].clone(), [int(logits[0, 0].argmax())]
    decode = make_decode_step(model, ctx)
    for i in range(max_new - 1):
        logits, cache = decode(torch.tensor([[toks[-1]]], device=ctx.device),
                               cache, len(prompt) + i)
        toks.append(int(logits[0, 0].argmax()))
    return first, toks


def phase_engine(dev, hbm_bw: float) -> int:
    """Qwen1.5-4B behind the serving engine (phase 9 of the docstring);
    returns the rmsnorm launches of the measure_serving run."""
    cfg = get_config("qwen1.5-4b")
    mc = cfg.model
    ctx = ShardingCtx(dev, use_pallas=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, ctx, seed=0)
    traffic, trace, scfg = engine_cell(mc.vocab)
    max_len = scfg.max_len

    # each cell call runs decode_step once: its launches, call by call
    per_call, decode_step = [], model.decode_step

    def counted(*args):
        before = _counts()
        out = decode_step(*args)
        per_call.append(tuple(a - b for a, b in zip(_counts(), before)))
        return out

    model.decode_step = counted
    _reset_counts()
    t0 = time.perf_counter()
    report = measure_serving(model, ctx, "serve_tp", scfg, trace)
    seconds = time.perf_counter() - t0
    total = _counts()
    del model.decode_step
    peak = torch.cuda.max_memory_allocated()
    if not per_call or any(c != ENGINE_CELL_LAUNCHES for c in per_call):
        bad = sorted(set(per_call) - {ENGINE_CELL_LAUNCHES})
        fail(f"[engine] {len(per_call)} cell calls launched (rmsnorm, "
             f"flash_attention, ssd_chunk) {bad}, not {ENGINE_CELL_LAUNCHES}")
    done = [len(r.tokens) for r in report.requests]
    if done != [traffic.gen_len] * len(trace):
        fail(f"[engine] tokens per request {done}")

    # the checked requests again, their first logits kept, and alone
    eng = _FirstLogits(model, ctx, scfg, keep=ENGINE_CHECKED)
    rep = eng.run([trace[i] for i in ENGINE_CHECKED], honor_arrivals=False)
    if eng.alloc.free_blocks != eng.alloc.capacity:
        fail(f"[engine] {eng.alloc.capacity - eng.alloc.free_blocks} blocks "
             f"still held after the replay")
    for stats in rep.requests:
        first, toks = _solo_greedy(model, ctx, trace[stats.rid].prompt,
                                   traffic.gen_len, max_len)
        d = _logit_diff(eng.first_logits[stats.rid], first)
        match = statistics.mean(a == b for a, b in zip(stats.tokens, toks))
        print(f"[engine] request {stats.rid} (prompt {stats.prompt_len}) "
              f"first-token logits engine vs solo dense decode: "
              + " ".join(f"{k}={v:.6g}" for k, v in d.items())
              + f" tokens_matching={match:.4g}", flush=True)
        if not d["rel"] <= SERVE_TOL["qwen1.5-4b"]:
            fail(f"[engine] request {stats.rid}: first-token logits "
                 f"relative diff {d['rel']} over {SERVE_TOL['qwen1.5-4b']}")

    summ = report.summary()
    sysm = cuda_device_model(dev, hbm_bw=hbm_bw,
                             flops=PEAK_FLOPS[torch.bfloat16])
    proj = price_serving(mc, sysm, "serve_tp", 1, 1, 1, scfg.max_batch,
                         traffic, max_len=max_len,
                         prefill_chunk=scfg.prefill_chunk)
    print(f"[engine] qwen1.5-4b requests={len(trace)} max_len={max_len} "
          f"geometry={eng.geo} cell_calls={len(per_call)} "
          f"launches_rmsnorm={total[0]} launches_flash={total[1]} "
          f"replays_s={seconds:.4g} max_memory_allocated={peak}", flush=True)
    print(f"[engine] measured (closed loop): tok_per_s={summ['tok_per_s']:.6g} "
          f"wall_s={summ['wall_s']:.6g} "
          f"ttft_p50_ms={summ['ttft_p50_s'] * 1e3:.6g} "
          f"ttft_p99_ms={summ['ttft_p99_s'] * 1e3:.6g} "
          f"latency_p50_ms={summ['latency_p50_s'] * 1e3:.6g} "
          f"latency_p99_ms={summ['latency_p99_s'] * 1e3:.6g}", flush=True)
    print(f"[engine] projected (price_serving serve_tp on {sysm.name}, "
          f"hbm_bw={hbm_bw:.6g}, bf16 peak): tok_per_s={proj.tok_per_s:.6g} "
          f"t_prefill_ms={proj.t_prefill * 1e3:.6g} "
          f"t_decode_ms={proj.t_decode * 1e3:.6g} rho={proj.rho:.4g} "
          f"ttft_p99_ms={proj.ttft_p99 * 1e3:.6g} "
          f"latency_p99_ms={proj.latency_p99 * 1e3:.6g} "
          f"feasible={proj.feasible} (reported, gated on finiteness)",
          flush=True)
    if not all(math.isfinite(v) for v in (proj.tok_per_s, proj.latency_p99,
                                          proj.ttft_p99)):
        fail(f"[engine] projection not finite: {proj}")
    del model, eng
    torch.cuda.empty_cache()
    return total[0]


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
    ses = phase_oracle(dev)
    cluster = ses.cluster
    hbm_bw = cluster.system.hbm_bw
    cluster_json = _write_cluster(cluster)
    par_conv, par_rms = phase_parallel(dev, hbm_bw, cluster_json)
    conv["launches"] += par_conv
    qwen = phase_serve(dev, "qwen1.5-4b")
    mamba = phase_serve(dev, "mamba2-780m")
    phase_fp32_serve(dev, "mamba2-780m")
    phase_lm_train(dev)
    phase_auto(dev, cluster, cluster_json)
    phase_api(dev, ses, cluster_json)
    phase_ckpt(dev)
    phase_elastic(cluster_json)
    # rmsnorm runs on both LM serving paths and the engine, on one card and
    # across ranks: its launches are the four runs' sum
    rms["launches"] = qwen[0] + mamba[0] + phase_engine(dev, hbm_bw) \
        + par_rms
    flash["launches"], ssd["launches"] = qwen[1], mamba[2]
    print(json.dumps({"kernels": [conv, rms, flash, ssd]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
