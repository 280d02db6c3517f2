"""The LMs of the JAX package's ``configs/lm_archs.py`` ported so far, copied
field by field: Qwen1.5-4B, whose attention blocks the port runs. The other
LMs register with the slices that port their blocks."""
from __future__ import annotations

import torch

from ..models.transformer import LMConfig
from ..nn.attention import AttentionConfig
from ..nn.ffn import FFNConfig
from .base import ArchConfig, register

BF16 = torch.bfloat16


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
