"""Model construction (counterpart of ``repro.launch.build.build_model``; cells,
meshes and abstract inputs come with the parallel slice).

CNN weights are drawn on the host and moved, so one seed gives the same
weights on every device. LM weights are drawn where they will live, in the
config's dtype, from a generator on that device: the full Qwen1.5-4B holds
3,950,369,280 parameters (7.9 GB in bf16), which a host draw in fp32 would
take tens of seconds and 16 GB to make.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models.cnn import (CosmoFlow, CosmoFlowConfig, ResNet, ResNetConfig,
                          VGG, VGGConfig)
from ..models.transformer import LMConfig, TransformerLM
from ..nn.module import ShardingCtx


def build_model(cfg: ArchConfig, ctx: ShardingCtx, smoke: bool = False,
                seed: int = 0) -> torch.nn.Module:
    """The (smoke or full) model on ``ctx.device``, weights drawn from
    ``seed``."""
    mc = cfg.smoke_model if smoke else cfg.model
    cnns = {ResNetConfig: ResNet, VGGConfig: VGG, CosmoFlowConfig: CosmoFlow}
    if type(mc) in cnns:
        return cnns[type(mc)](mc, device=ctx.device,
                              generator=torch.Generator().manual_seed(seed))
    if isinstance(mc, LMConfig):
        gen = torch.Generator(device=ctx.device).manual_seed(seed)
        return TransformerLM(mc, device=ctx.device, generator=gen)
    raise TypeError(f"{type(mc).__name__} is not ported yet")
