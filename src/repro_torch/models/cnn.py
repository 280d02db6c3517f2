"""ResNet-50/152 in PyTorch (counterpart of ``repro.models.cnn``).

Same structure and parameter names as the JAX models, so the JAX parameter
tree maps one-to-one onto ``named_parameters()`` (``bridge.py``): ResNet v1.5
(the stride sits on the 3×3, the projection is a strided 1×1), batch-stat
BatchNorm, SAME padding with XLA's split, a 3×3/2 SAME max-pool padded with
−inf, and a head whose input width is 512·4 as in the reference (so only
``width=64`` runs, there as here). VGG16 and CosmoFlow come with the next
slice.

Each model has ``forward(images, ctx, train)`` → logits,
``loss(logits, batch)`` → (loss, metrics) and ``loss_fn(batch, ctx, train)``,
their composition.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..nn.layers import BatchNorm, Conv, Dense, global_avg_pool, max_pool
from ..nn.module import ShardingCtx
from ..parallel.halo import HaloConv


@dataclass(frozen=True)
class ResNetConfig:
    name: str
    stage_sizes: tuple[int, ...]      # (3,4,6,3) → ResNet-50; (3,8,36,3) → 152
    n_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.float32


RESNET50 = ResNetConfig("resnet50", (3, 4, 6, 3))
RESNET152 = ResNetConfig("resnet152", (3, 8, 36, 3))


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, mid_ch: int, stride: int, dtype: torch.dtype,
                 *, device: torch.device, generator: torch.Generator):
        super().__init__()
        out_ch = mid_ch * 4
        kw = dict(use_bias=False, dtype=dtype, device=device,
                  generator=generator)
        self.conv1 = Conv(in_ch, mid_ch, (1, 1), **kw)
        self.conv2 = HaloConv(mid_ch, mid_ch, (3, 3), strides=(stride, stride),
                              **kw)
        self.conv3 = Conv(mid_ch, out_ch, (1, 1), **kw)
        self.bn1 = BatchNorm(mid_ch, device=device)
        self.bn2 = BatchNorm(mid_ch, device=device)
        self.bn3 = BatchNorm(out_ch, device=device)
        self.proj = self.bn_proj = None
        if stride != 1 or in_ch != out_ch:
            self.proj = Conv(in_ch, out_ch, (1, 1), strides=(stride, stride),
                             **kw)
            self.bn_proj = BatchNorm(out_ch, device=device)

    def forward(self, x, ctx: ShardingCtx, train: bool = True):
        y = torch.relu(self.bn1(self.conv1(x, ctx), ctx, train))
        y = torch.relu(self.bn2(self.conv2(y, ctx), ctx, train))
        y = self.bn3(self.conv3(y, ctx), ctx, train)
        sc = x if self.proj is None else \
            self.bn_proj(self.proj(x, ctx), ctx, train)
        return torch.relu(y + sc)


class ResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig, *, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.cfg = c = cfg
        self.stem = HaloConv(3, c.width, (7, 7), strides=(2, 2), use_bias=False,
                             dtype=c.dtype, device=device, generator=generator)
        self.bn_stem = BatchNorm(c.width, device=device)
        blocks, in_ch = [], c.width
        for stage, n in enumerate(c.stage_sizes):
            mid = c.width * (2 ** stage)
            for b in range(n):
                stride = 2 if (b == 0 and stage > 0) else 1
                blocks.append(Bottleneck(in_ch, mid, stride, c.dtype,
                                         device=device, generator=generator))
                in_ch = mid * 4
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(512 * 4, c.n_classes, use_bias=True, dtype=c.dtype,
                          device=device, generator=generator)

    def forward(self, x, ctx: ShardingCtx, train: bool = True):
        h = torch.relu(self.bn_stem(self.stem(x, ctx), ctx, train))
        h = max_pool(h, (3, 3), (2, 2), "SAME")
        for block in self.blocks:
            h = block(h, ctx, train)
        return self.head(global_avg_pool(h), ctx)

    def loss(self, logits, batch):
        ce = _softmax_xent(logits, batch["labels"])
        return ce, {"ce": ce}

    def loss_fn(self, batch, ctx: ShardingCtx, train: bool = True):
        return self.loss(self(batch["images"], ctx, train), batch)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


def _softmax_xent(logits, labels):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (lse - picked).mean()
