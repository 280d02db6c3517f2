"""Decoder-only LM (counterpart of ``repro.models.transformer``) for the
families ported so far: pre-norm blocks of kind "attn" (an ``Attention``
and a dense ``FFN``, Qwen1.5-4B) and "ssm" (a Mamba-2 ``SSDBlock`` and no
FFN, Mamba-2 780m), repeated as ``cfg.pattern`` says.

The reference stacks the layers of each pattern position and scans over
them; the port keeps one module per layer and runs them in a Python loop,
so the JAX tree's ``stacks.p.X[g]`` is the port's ``blocks.(g·period + p).X``
(``bridge.py`` maps one onto the other). ``LMConfig`` holds only what
Qwen1.5-4B and Mamba-2 780m set: the other block kinds ("local_attn",
"mla", "moe", "rec") raise ``NotImplementedError`` at construction, and
leading dense layers, multi-token prediction (``mtp_heads`` raises, ROADMAP
queue 1 item 10), learned positions, embedding scaling and a final softcap
come with the slices that port them. With tied
embeddings the head is the embedding table, as in the reference.

Entry points, as in the reference: ``forward`` (its ``apply``) → (logits,
aux), ``loss_fn`` → (masked next-token cross-entropy + aux, metrics), both
with the reference's per-block ``remat`` switch (off by default here),
``prefill`` → (last-position logits, cache) and ``decode_step`` →
(logits, cache), logits in fp32. A cache is ``{"blocks": [...]}`` with one
entry per layer ({"k", "v"} for attention, {"state", "conv_x", "conv_B",
"conv_C"} in fp32 for the SSM), made by ``zeros_like_spec(cache_spec(...))``
and written in place. The SSM's prompt pass starts from the state in its
cache, so a cache is zeroed (or made anew) before each prompt pass.

Across ranks (``ctx.sharded``: the tokens a ``parallel.sharded.Sharded``
placed ``("batch", None)``, the parameters this rank's blocks) ``forward``
and ``loss_fn`` keep the unsharded meaning, as GSPMD keeps the reference's:
the residual stream is re-laid out as ``("batch", "seq", "act_embed")``
after the embedding and after every block (the reference's constraints);
the head takes the final-normed stream with its sequence whole and the
logits are re-laid out as ``("batch", "seq", "vocab")``, which under the
paper's tables keeps every row's logits whole (batch or seq claims the
model axis before vocab); the loss is sum(ce·mask) / max(sum(mask), 1)
over the whole batch, both sums all-reduced over the ranks that split the
rows. ``prefill`` and ``decode_step`` run across ranks too, as the serving
layouts place them (serve_tp, serve_seqkv): the tokens, whole on every
rank, placed ("batch", None), the cache's leaves ``Sharded`` as the rules
place ``nn.attention.CACHE_AXES``, the same constraint points (under
serve_tp "seq" claims the model axis, so a prefill chunk's residual is
split on its sequence where the chunk divides it and a decode step's one
token stays whole, as ``spec_to_pspec`` falls back); ``greedy`` reads the
next tokens from the vocab- or sequence-split logits. An SSM layer's
cache across ranks is not ported (the engine serves attention caches).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.attention import Attention, AttentionConfig
from ..nn.ffn import FFN, FFNConfig
from ..nn.layers import Embedding, RMSNorm, project
from ..nn.module import ShardingCtx, fan_in_normal
from ..nn.ssm import SSDBlock, SSMConfig
from ..parallel import collectives as C
from ..parallel.sharded import (Sharded, axes_of, block_index, param_block,
                                placement)

# the reference's block kinds; the port builds "attn" and "ssm"
KINDS = ("attn", "local_attn", "mla", "moe", "ssm", "rec")


@dataclass(frozen=True)
class LMConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    pattern: tuple[str, ...] = ("attn",)
    attn: AttentionConfig | None = None
    ffn: FFNConfig | None = None
    ssm: SSMConfig | None = None
    tie_embeddings: bool = False
    mtp_heads: int = 0               # multi-token prediction: not ported
    dtype: torch.dtype = torch.bfloat16

    def block_kinds(self) -> list[str]:
        """Per-layer kind list of length n_layers."""
        return [self.pattern[i % len(self.pattern)]
                for i in range(self.n_layers)]


def _fp32_logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h @ w with an fp32 result from operands in the model's dtype (the
    reference's ``preferred_element_type=float32``): without autograd on the
    card, one bf16 GEMM with an fp32 output; elsewhere the operands widened
    first. mm's ``out_dtype`` form has no derivative, so a training step
    takes the widened product, whose backward is the reference's too: the
    fp32 cotangent times the bf16 operand, exactly, rounded to bf16."""
    if h.is_cuda and h.dtype != torch.float32 and \
            not torch.is_grad_enabled():
        return torch.mm(h.flatten(0, -2), w, out_dtype=torch.float32
                        ).unflatten(0, h.shape[:-1])
    return h.float() @ w.float()


class Block(nn.Module):
    """Kind "attn": h + attn(norm1(h)), then + ffn(norm2(h)). Kind "ssm":
    h + ssd(norm1(h)), no FFN (Mamba-2's d_ff is 0)."""

    def __init__(self, cfg: LMConfig, kind: str, *, device: torch.device,
                 generator: torch.Generator | None):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, device=device)
        if kind == "ssm":
            self.mixer = SSDBlock(cfg.ssm, device=device, generator=generator)
            return
        self.mixer = Attention(cfg.attn, device=device, generator=generator)
        self.norm2 = RMSNorm(cfg.d_model, device=device)
        self.ffn = FFN(cfg.ffn, device=device, generator=generator)

    def forward(self, h, ctx: ShardingCtx, q_chunk: int = 1024,
                kv_chunk: int = 1024):
        if not isinstance(h, Sharded):
            h, _ = self.prefill(h, None, ctx, q_chunk, kv_chunk)
            return h
        kw = {} if isinstance(self.mixer, SSDBlock) else dict(
            q_chunk=q_chunk, kv_chunk=kv_chunk)
        h = self._ffn(h + self.mixer(self.norm1(h, ctx), ctx, **kw), ctx)
        return ctx.constrain(h, ("batch", "seq", "act_embed"))

    def _ffn(self, h, ctx: ShardingCtx):
        if isinstance(self.mixer, SSDBlock):
            return h
        return h + self.ffn(self.norm2(h, ctx), ctx)

    def prefill(self, h, cache, ctx: ShardingCtx, q_chunk: int = 1024,
                kv_chunk: int = 1024):
        """Forward over the prompt, filling the cache when one is given."""
        x = self.norm1(h, ctx)
        if isinstance(self.mixer, SSDBlock):
            y, cache = self.mixer.prefill(x, cache, ctx)
        else:
            y, cache = self.mixer.prefill(x, cache, ctx, q_chunk, kv_chunk)
        return self._residual(h + y, ctx), cache

    def decode(self, h, cache, pos, ctx: ShardingCtx):
        y, cache = self.mixer.decode(self.norm1(h, ctx), cache, pos, ctx)
        return self._residual(h + y, ctx), cache

    def _residual(self, h, ctx: ShardingCtx):
        """The FFN's residual, re-laid out as the residual stream across
        ranks (the reference's constraint at the end of each block)."""
        h = self._ffn(h, ctx)
        if isinstance(h, Sharded):
            h = ctx.constrain(h, ("batch", "seq", "act_embed"))
        return h

    def cache_spec(self, batch: int, max_len: int, shards: int = 1,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        """The layer's cache as meta tensors; ``shards`` cuts an attention
        cache's span where it divides it, else the layer keeps one shard,
        as the reference's ``Block.cache_spec``."""
        if isinstance(self.mixer, SSDBlock):     # fp32, as the reference's
            return self.mixer.cache_spec(batch)
        span = max(max_len, 1)
        sh = shards if span % max(shards, 1) == 0 else 1
        return self.mixer.cache_spec(batch, span, shards=sh, dtype=dtype)


class TransformerLM(nn.Module):
    def __init__(self, cfg: LMConfig, *, device: torch.device,
                 generator: torch.Generator | None):
        super().__init__()
        self.cfg = c = cfg
        if c.mtp_heads:
            raise NotImplementedError(
                "multi-token prediction (mtp_heads) is not ported: it comes "
                "with its first model, ROADMAP queue 1 item 10")
        for kind in set(c.pattern):
            if kind not in KINDS:
                raise ValueError(f"unknown block kind {kind!r}")
            if kind not in ("attn", "ssm"):
                raise NotImplementedError(f"block kind {kind!r} is not "
                                          f"ported yet")
        self.embed = Embedding(c.vocab, c.d_model, device=device,
                               generator=generator, dtype=c.dtype)
        self.final_norm = RMSNorm(c.d_model, device=device)
        if not c.tie_embeddings:
            self.head = fan_in_normal((c.d_model, c.vocab), (0,), generator,
                                      device, c.dtype,
                                      axes=("embed", "vocab"))
        self.blocks = nn.ModuleList(
            Block(c, kind, device=device, generator=generator)
            for kind in c.block_kinds())

    def _embed(self, tokens, ctx: ShardingCtx):
        h = self.embed(tokens, ctx)
        if not isinstance(h, Sharded):
            return h.to(self.cfg.dtype)
        return ctx.constrain(h.map(lambda t: t.to(self.cfg.dtype)),
                             ("batch", "seq", "act_embed"))

    def _logits(self, h, ctx: ShardingCtx):
        h = self.final_norm(h, ctx)
        if not isinstance(h, Sharded):
            w = self.embed.table.t() if self.cfg.tie_embeddings else \
                self.head
            return _fp32_logits(h, w)
        w = param_block(self.embed.table, h.mesh).T \
            if self.cfg.tie_embeddings else self.head
        logits = project(ctx.constrain(h, ("batch", None, "act_embed")), w,
                         dtype=torch.float32)
        return ctx.constrain(logits, ("batch", "seq", "vocab"))

    def forward(self, tokens, ctx: ShardingCtx, q_chunk: int = 1024,
                kv_chunk: int = 1024, remat: bool = False):
        """Full forward → (logits (B, S, vocab), aux loss). ``remat``: each
        block runs under a non-reentrant ``torch.utils.checkpoint`` (the
        reference's ``jax.checkpoint`` of each block): its activations are
        recomputed in the backward instead of saved. Off by default, unlike
        the reference's ``_forward``. The recomputation runs the block's
        collectives again, which ``collectives.STATS`` counts twice."""
        h = self._embed(tokens, ctx)
        for block in self.blocks:
            if remat:
                h = checkpoint(block, h, ctx, q_chunk, kv_chunk,
                               use_reentrant=False)
            else:
                h = block(h, ctx, q_chunk, kv_chunk)
        dev = h.local.device if isinstance(h, Sharded) else h.device
        return self._logits(h, ctx), torch.zeros((), device=dev)

    def loss_fn(self, batch: dict, ctx: ShardingCtx, q_chunk: int = 1024,
                kv_chunk: int = 1024, remat: bool = False):
        """Masked next-token cross-entropy in fp32, the reference's. batch:
        ``tokens`` (B, S) int; optional ``targets`` (B, S) (default: the
        tokens shifted left, 0 at the end) and ``mask`` (B, S) (default:
        ones); ``remat`` as in ``forward``. Returns (loss + aux, {"ce",
        "aux"})."""
        tokens = batch["tokens"]
        targets = batch.get("targets")
        if targets is None:
            targets = _shift(tokens)
        logits, aux = self(tokens, ctx, q_chunk, kv_chunk, remat)
        mask = batch.get("mask")
        if isinstance(logits, Sharded):
            loss = _sharded_loss(logits, targets, mask)
            return loss + aux, {"ce": loss, "aux": aux}
        if mask is None:
            mask = torch.ones(tokens.shape, dtype=torch.float32,
                              device=tokens.device)
        ce = _xent(logits, targets)
        loss = (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss + aux, {"ce": loss, "aux": aux}

    def cache_spec(self, batch: int, max_len: int, shards: int = 1,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        return {"blocks": [b.cache_spec(batch, max_len, shards, dtype)
                           for b in self.blocks]}

    def prefill(self, tokens, cache, ctx: ShardingCtx, q_chunk: int = 1024,
                kv_chunk: int = 1024):
        """Prompt pass: returns (last-position logits (B, 1, vocab), cache)."""
        h = self._embed(self._placed(tokens, ctx), ctx)
        for block, c in zip(self.blocks, cache["blocks"], strict=True):
            h, _ = block.prefill(h, c, ctx, q_chunk, kv_chunk)
        if isinstance(h, Sharded):
            # the last position of every row, the sequence whole first
            h = h.relayout(h.place[:1] + ((),) + h.place[2:])
            return self._logits(Sharded(h.local[:, -1:].contiguous(),
                                        (h.shape[0], 1, h.shape[2]), h.place,
                                        h.mesh), ctx), cache
        # contiguous: the norm kernel takes whole rows
        return self._logits(h[:, -1:].contiguous(), ctx), cache

    def decode_step(self, token, cache, pos, ctx: ShardingCtx):
        """token: (B, C) int; pos: an int or (B,) tensor, each sequence's
        first new index. Returns (logits (B, C, vocab), cache). Across ranks
        the cache's leaves are ``Sharded`` (``zeros_like_spec(spec, device,
        ctx)``), token and pos are whole on every rank, and so are the
        rows of the logits, a ``Sharded`` split as ("batch", "seq",
        "vocab") say (``greedy`` reads its tokens)."""
        h = self._embed(self._placed(token, ctx), ctx)
        for block, c in zip(self.blocks, cache["blocks"], strict=True):
            h, _ = block.decode(h, c, pos, ctx)
        return self._logits(h, ctx), cache

    def _placed(self, tokens, ctx: ShardingCtx):
        """Tokens every rank holds whole, as a ``Sharded`` placed
        ("batch", None) across ranks."""
        if not ctx.sharded or isinstance(tokens, Sharded):
            return tokens
        if any(isinstance(b.mixer, SSDBlock) for b in self.blocks):
            raise NotImplementedError(
                "an SSM layer's cache across ranks is not ported (the "
                "serving engine serves attention caches only): ROADMAP "
                "queue 1 item 6")
        return Sharded.of(tokens, placement(ctx.mesh, ctx.pspec(
            ("batch", None), tokens.shape)), ctx.mesh)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


def greedy(logits) -> torch.Tensor:
    """The greedy next tokens (B, C) of logits (B, C, vocab), whole on every
    rank; the first of equal maxima, as ``argmax``. Of a ``Sharded`` a
    distributed argmax: each rank's (max, index) over its vocab block,
    gathered over the ranks that split the vocab (their blocks in vocab
    order), the first block with the largest max taken; then the rows
    gathered where they are split. It moves 2 numbers a row, not the
    vocab."""
    if not isinstance(logits, Sharded):
        return logits.argmax(-1)
    mesh, vocab = logits.mesh, logits.place[2]
    val, idx = logits.local.max(-1)
    idx = idx + block_index(mesh, logits.shape, logits.place)[2].start
    if vocab:
        group = mesh.group(axes_of(mesh, (vocab,)))
        pair = torch.stack([val.double(), idx.double()], -1)[None]
        pairs = C.gather_blocks(pair, 0, group)         # (n, b, c, 2)
        best = pairs[..., 0].argmax(0, keepdim=True)
        idx = torch.take_along_dim(pairs[..., 1], best, 0)[0].long()
    rows = logits.place[:2]
    return Sharded(idx, logits.shape[:2], rows, mesh).full()


def _shift(tokens):
    """The default targets: the tokens shifted left, 0 at the end (of a
    ``Sharded`` batch, whose sequences are whole, on each block)."""
    if not isinstance(tokens, Sharded):
        return F.pad(tokens[:, 1:], (0, 1))
    if tokens.place[1]:
        raise ValueError("the default targets need whole sequences: place "
                         "the tokens ('batch', None)")
    return tokens.map(lambda t: F.pad(t[:, 1:], (0, 1)))


def _sharded_loss(logits: Sharded, targets: Sharded, mask) -> torch.Tensor:
    """sum(ce·mask) / max(sum(mask), 1) over the whole batch, from each
    rank's rows of whole logits: both sums all-reduced over the ranks that
    split the rows (the numerator differentiably), so every rank holds the
    loss."""
    mesh, rows = logits.mesh, logits.place[:2]
    logits = logits.relayout(rows + ((),))
    ce = _xent(logits.local, targets.relayout(rows).local)
    if mask is None:
        mask = torch.ones_like(ce)
    else:
        mask = mask.relayout(rows).local
    num, den = (ce * mask).sum(), mask.sum()
    split = axes_of(mesh, rows)
    if split:
        group = mesh.group(split)
        num, den = C.all_reduce(num, group), C.all_reduce_sum(den, group)
    return num / torch.clamp(den, min=1.0)


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Token cross-entropy in fp32. logits: (B, S, V); targets: (B, S)."""
    logits = logits.float()
    picked = torch.take_along_dim(logits, targets[..., None].long(),
                                  dim=-1)[..., 0]
    return torch.logsumexp(logits, dim=-1) - picked
