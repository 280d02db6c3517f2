"""Model construction and the batch's placement (counterparts of
``repro.launch.build.build_model``, ``cnn_batch_specs`` and
``batch_specs``' LM leaves; the dry-run's
cells and abstract inputs are not ported, ROADMAP queue 1 item 12).

CNN weights are drawn on the host and moved, so one seed gives the same
weights on every device. LM weights are drawn where they will live, in the
config's dtype, from a generator on that device: the full Qwen1.5-4B holds
3,950,369,280 parameters (7.9 GB in bf16), which a host draw in fp32 would
take tens of seconds and 16 GB to make.

Across ranks (``ctx.sharded``) every rank draws the whole model from the
same seed and keeps its blocks (``shard_params``): a CNN from a host
generator, an LM from a generator on its device (one seed gives the same
weights on every rank of a card, and on cards of one kind). Each parameter
is cut to its block as soon as it is drawn (``nn.module.placing``), so a
rank holds its blocks and one whole parameter at a time: the full fp32
Qwen1.5-4B is 15.8 GB, its block under the serving tables on 4 ranks
~4 GB. Every rank
draws the same whole batch from the seeded stream and keeps its block
(``shard_batch``): a CNN's images on ("batch", "spatial"), an LM's tokens
(and targets and mask) on ("batch", None), as ``batch_specs`` places them.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models.cnn import (CosmoFlow, CosmoFlowConfig, ResNet, ResNetConfig,
                          VGG, VGGConfig)
from ..models.transformer import LMConfig, TransformerLM
from ..nn.module import ShardingCtx, placing
from ..parallel.sharded import Sharded, placement, shard_param, shard_params


def build_model(cfg: ArchConfig, ctx: ShardingCtx, smoke: bool = False,
                seed: int = 0) -> torch.nn.Module:
    """The (smoke or full) model on ``ctx.device``, weights drawn from
    ``seed``."""
    mc = cfg.smoke_model if smoke else cfg.model
    if not ctx.sharded:
        return _build(mc, ctx, seed)
    with placing(lambda p: shard_param(p, ctx)):
        return shard_params(_build(mc, ctx, seed), ctx)


def _build(mc, ctx: ShardingCtx, seed: int) -> torch.nn.Module:
    cnns = {ResNetConfig: ResNet, VGGConfig: VGG, CosmoFlowConfig: CosmoFlow}
    if type(mc) in cnns:
        return cnns[type(mc)](mc, device=ctx.device,
                              generator=torch.Generator().manual_seed(seed))
    if isinstance(mc, LMConfig):
        gen = torch.Generator(device=ctx.device).manual_seed(seed)
        return TransformerLM(mc, device=ctx.device, generator=gen)
    raise TypeError(f"{type(mc).__name__} is not ported yet")


def batch_axes(name: str, ndim: int) -> tuple:
    """The logical axes of a batch leaf: a CNN's images (batch, spatial,
    ...), labels (batch,) and targets (batch, None), as
    ``cnn_batch_specs``; an LM's tokens, targets and mask (batch, None), as
    ``batch_specs``."""
    if name == "images":
        return ("batch", "spatial") + (None,) * (ndim - 2)
    return ("batch",) + (None,) * (ndim - 1)


def shard_batch(batch: dict, ctx: ShardingCtx) -> dict:
    """This rank's blocks of a whole batch that every rank holds, placed by
    the rules (the batch as it is where nothing is sharded)."""
    if not ctx.sharded:
        return batch
    return {k: Sharded.of(v, placement(ctx.mesh, ctx.pspec(
        batch_axes(k, v.dim()), v.shape)), ctx.mesh)
        for k, v in batch.items()}
