"""The LMs of the JAX package's ``configs/lm_archs.py`` ported so far, copied
field by field: Mamba-2 780m (SSD blocks) and Qwen1.5-4B (attention
blocks). The other LMs register with the slices that port their blocks."""
from __future__ import annotations

import dataclasses

import torch

from ..models.transformer import LMConfig
from ..nn.attention import AttentionConfig
from ..nn.ffn import FFNConfig
from ..nn.ssm import SSMConfig
from .base import ArchConfig, get_config, register

BF16 = torch.bfloat16

# The (batch, seq) at which the LMs' full-width training step is measured
# on one card (chip_smoke.py's lm-train phase, launch.profile_train).
# Mamba-2 780m runs at batch 2: its plain SSD saves ~2.0 GB a layer for the
# backward at 4 x 1024 tokens, ~98 GB over 48 layers, more than an 80 GB
# card holds, and ~1.0 GB a layer at 2 x 1024 (scripts/lm_train_memory.py).
LM_TRAIN_SHAPE = {"qwen1.5-4b": (2, 512), "mamba2-780m": (2, 1024)}

# The LMs across 4 ranks sharing one card (chip_smoke.py's lm-parallel
# phase, launch.profile_train --strategies, scripts/lm_train_memory.py
# --strategies): (layers, global batch, seq) at the published widths, in
# fp32 (as the reference's own LM checks run). The layers are cut for
# memory: under "data" every rank holds the whole model, its fp32
# gradients and SGD momentum, 12 B a parameter; Qwen1.5-4B's 3.95 B would
# need 47 GB a rank, while 2 layers hold 0.94 B (its embedding and head,
# 389 M each, dominate).
LM_PARALLEL_SHAPE = {"qwen1.5-4b": (2, 4, 512), "mamba2-780m": (2, 4, 1024)}

# The LM pipeline across the same 4 ranks (chip_smoke.py's lm-pipeline
# phase, scripts/lm_train_memory.py --pipeline): (layers, global batch,
# seq), fp32, published widths; the layers cut so that 4 stages each run
# at least one (the Mamba's 8 hold interleaved v = 2's 8 chunks). Every
# rank holds the whole model; the layers are cut for time, not memory.
LM_PIPELINE_SHAPE = {"qwen1.5-4b": (4, 4, 512), "mamba2-780m": (8, 4, 1024)}


def lm_parallel_arch(arch: str, layers: int | None = None) -> ArchConfig:
    """``arch`` with its full model cut to ``layers`` (default:
    LM_PARALLEL_SHAPE's) and every dtype fp32."""
    cfg = get_config(arch)
    mc = cfg.model
    sub = {k: dataclasses.replace(getattr(mc, k), dtype=torch.float32)
           for k in ("attn", "ffn", "ssm") if getattr(mc, k) is not None}
    mc = dataclasses.replace(
        mc, n_layers=layers or LM_PARALLEL_SHAPE[arch][0],
        dtype=torch.float32, **sub)
    return dataclasses.replace(cfg, model=mc)


# mamba2-780m — SSD, attention-free [arXiv:2405.21060; unverified]
@register("mamba2-780m")
def mamba2_780m() -> ArchConfig:
    def mk(d_model, n_layers, vocab, d_state, chunk=256):
        return LMConfig(
            name="mamba2-780m", vocab=vocab, d_model=d_model,
            n_layers=n_layers, pattern=("ssm",),
            ssm=SSMConfig(d_model, d_state=d_state, head_dim=64, expand=2,
                          chunk=chunk, dtype=BF16),
            tie_embeddings=True, dtype=BF16)
    return ArchConfig(
        name="mamba2-780m", family="lm",
        model=mk(1536, 48, 50280, 128),
        smoke_model=mk(64, 4, 512, 16, chunk=16),
        source="[arXiv:2405.21060; unverified]", strategy="df_zero1")


# qwen1.5-4b — dense, QKV bias, kv=heads (MHA) [hf:Qwen/Qwen1.5-0.5B; hf]
@register("qwen1.5-4b")
def qwen15_4b() -> ArchConfig:
    def mk(d, L, H, KV, hd, ff, vocab):
        return LMConfig(
            name="qwen1.5-4b", vocab=vocab, d_model=d, n_layers=L,
            attn=AttentionConfig(d, H, KV, hd, use_bias=True, dtype=BF16),
            ffn=FFNConfig(d, ff, activation="silu", dtype=BF16),
            dtype=BF16)
    return ArchConfig(
        name="qwen1.5-4b", family="lm",
        model=mk(2560, 40, 20, 20, 128, 6912, 151936),
        smoke_model=mk(64, 2, 4, 4, 16, 128, 512),
        source="[hf:Qwen/Qwen1.5-0.5B; hf]",
        shape_strategy={"decode_32k": "serve_seqkv"})
