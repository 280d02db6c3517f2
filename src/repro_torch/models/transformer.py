"""Decoder-only LM (counterpart of ``repro.models.transformer``) for the dense
attention family: pre-norm blocks of kind "attn", each an ``Attention`` and
a dense ``FFN``.

The reference stacks the layers of each pattern position and scans over
them; the port keeps one module per layer and runs them in a Python loop,
so the JAX tree's ``stacks.0.X[l]`` is the port's ``blocks.l.X``
(``bridge.py`` maps one onto the other). ``LMConfig`` holds only what
Qwen1.5-4B sets: SSM, RG-LRU, MLA and MoE blocks, leading dense layers,
multi-token prediction, learned positions, tied embeddings, embedding
scaling and a final softcap come with the slices that port them.

Entry points, as in the reference: ``forward`` (its ``apply``) → (logits,
aux), ``prefill`` → (last-position logits, cache) and ``decode_step`` →
(logits, cache), logits in fp32. A cache is ``{"blocks": [{"k", "v"}, ...]}``
with one entry per layer, made by ``zeros_like_spec(cache_spec(...))`` and
written in place.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..nn.attention import Attention, AttentionConfig
from ..nn.ffn import FFN, FFNConfig
from ..nn.layers import Embedding, RMSNorm
from ..nn.module import ShardingCtx, fan_in_normal


@dataclass(frozen=True)
class LMConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    attn: AttentionConfig
    ffn: FFNConfig
    dtype: torch.dtype = torch.bfloat16


def _fp32_logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h @ w with an fp32 result from operands in the model's dtype (the
    reference's ``preferred_element_type=float32``): on the card one bf16
    GEMM with an fp32 output, elsewhere the operands widened first."""
    if h.is_cuda and h.dtype != torch.float32:
        return torch.mm(h.flatten(0, -2), w, out_dtype=torch.float32
                        ).unflatten(0, h.shape[:-1])
    return h.float() @ w.float()


class Block(nn.Module):
    """h + attn(norm1(h)), then + ffn(norm2(h))."""

    def __init__(self, cfg: LMConfig, *, device: torch.device,
                 generator: torch.Generator | None):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, device=device)
        self.mixer = Attention(cfg.attn, device=device, generator=generator)
        self.norm2 = RMSNorm(cfg.d_model, device=device)
        self.ffn = FFN(cfg.ffn, device=device, generator=generator)

    def forward(self, h, ctx: ShardingCtx, q_chunk: int = 1024,
                kv_chunk: int = 1024):
        h, _ = self.prefill(h, None, ctx, q_chunk, kv_chunk)
        return h

    def prefill(self, h, cache, ctx: ShardingCtx, q_chunk: int = 1024,
                kv_chunk: int = 1024):
        """Forward over the prompt, filling the cache when one is given."""
        y, cache = self.mixer.prefill(self.norm1(h, ctx), cache, ctx,
                                      q_chunk, kv_chunk)
        h = h + y
        return h + self.ffn(self.norm2(h, ctx), ctx), cache

    def decode(self, h, cache, pos, ctx: ShardingCtx):
        y, cache = self.mixer.decode(self.norm1(h, ctx), cache, pos, ctx)
        h = h + y
        return h + self.ffn(self.norm2(h, ctx), ctx), cache


class TransformerLM(nn.Module):
    def __init__(self, cfg: LMConfig, *, device: torch.device,
                 generator: torch.Generator | None):
        super().__init__()
        self.cfg = c = cfg
        self.embed = Embedding(c.vocab, c.d_model, device=device,
                               generator=generator, dtype=c.dtype)
        self.final_norm = RMSNorm(c.d_model, device=device)
        self.head = fan_in_normal((c.d_model, c.vocab), (0,), generator,
                                  device, c.dtype)
        self.blocks = nn.ModuleList(
            Block(c, device=device, generator=generator)
            for _ in range(c.n_layers))

    def _embed(self, tokens, ctx: ShardingCtx):
        return self.embed(tokens, ctx).to(self.cfg.dtype)

    def _logits(self, h, ctx: ShardingCtx):
        return _fp32_logits(self.final_norm(h, ctx), self.head)

    def forward(self, tokens, ctx: ShardingCtx, q_chunk: int = 1024,
                kv_chunk: int = 1024):
        """Full forward → (logits (B, S, vocab), aux loss)."""
        h = self._embed(tokens, ctx)
        for block in self.blocks:
            h = block(h, ctx, q_chunk, kv_chunk)
        return self._logits(h, ctx), torch.zeros((), device=h.device)

    def cache_spec(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        return {"blocks": [b.mixer.cache_spec(batch, max_len, dtype)
                           for b in self.blocks]}

    def prefill(self, tokens, cache, ctx: ShardingCtx, q_chunk: int = 1024,
                kv_chunk: int = 1024):
        """Prompt pass: returns (last-position logits (B, 1, vocab), cache)."""
        h = self._embed(tokens, ctx)
        for block, c in zip(self.blocks, cache["blocks"], strict=True):
            h, _ = block.prefill(h, c, ctx, q_chunk, kv_chunk)
        # contiguous: the norm kernel takes whole rows
        return self._logits(h[:, -1:].contiguous(), ctx), cache

    def decode_step(self, token, cache, pos, ctx: ShardingCtx):
        """token: (B, C) int; pos: an int or (B,) tensor, each sequence's
        first new index. Returns (logits (B, C, vocab), cache)."""
        h = self._embed(token, ctx)
        for block, c in zip(self.blocks, cache["blocks"], strict=True):
            h, _ = block.decode(h, c, pos, ctx)
        return self._logits(h, ctx), cache

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
