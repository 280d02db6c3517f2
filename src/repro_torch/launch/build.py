"""Model construction (counterpart of ``repro.launch.build.build_model``; cells,
meshes and abstract inputs come with the parallel slice)."""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models.cnn import ResNet, ResNetConfig
from ..nn.module import ShardingCtx


def build_model(cfg: ArchConfig, ctx: ShardingCtx, smoke: bool = False,
                seed: int = 0) -> torch.nn.Module:
    """The (smoke or full) model on ``ctx.device``, weights drawn from
    ``seed``."""
    mc = cfg.smoke_model if smoke else cfg.model
    gen = torch.Generator().manual_seed(seed)
    if isinstance(mc, ResNetConfig):
        return ResNet(mc, device=ctx.device, generator=gen)
    raise TypeError(f"{type(mc).__name__} is not ported yet")
