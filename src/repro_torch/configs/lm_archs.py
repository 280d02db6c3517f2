"""The LMs of the JAX package's ``configs/lm_archs.py`` ported so far, copied
field by field: Mamba-2 780m (SSD blocks) and Qwen1.5-4B (attention
blocks). The other LMs register with the slices that port their blocks."""
from __future__ import annotations

import torch

from ..models.transformer import LMConfig
from ..nn.attention import AttentionConfig
from ..nn.ffn import FFNConfig
from ..nn.ssm import SSMConfig
from .base import ArchConfig, register

BF16 = torch.bfloat16

# The (batch, seq) at which the LMs' full-width training step is measured
# on one card (chip_smoke.py's lm-train phase, launch.profile_train).
# Mamba-2 780m runs at batch 2: its plain SSD saves ~2.0 GB a layer for the
# backward at 4 x 1024 tokens, ~98 GB over 48 layers, more than an 80 GB
# card holds, and ~1.0 GB a layer at 2 x 1024 (scripts/lm_train_memory.py).
LM_TRAIN_SHAPE = {"qwen1.5-4b": (2, 512), "mamba2-780m": (2, 1024)}


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
        source="[arXiv:2405.21060; unverified]")


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
        source="[hf:Qwen/Qwen1.5-0.5B; hf]")
