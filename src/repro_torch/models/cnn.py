"""The paper's evaluation CNNs in PyTorch (counterpart of
``repro.models.cnn``): ResNet-50/152, VGG16 and CosmoFlow (3-D).

Same structure and parameter names as the JAX models, so the JAX parameter
tree maps one-to-one onto ``named_parameters()`` (``bridge.py``):

* ResNet v1.5 (the stride sits on the 3×3, the projection is a strided
  1×1), batch-stat BatchNorm, SAME padding with XLA's split, a 3×3/2 SAME
  max-pool padded with −inf, and a head whose input width is 512·4 as in
  the reference (so only ``width=64`` runs, there as here).
* VGG16: 13 biased 3×3 SAME ``HaloConv``s (``convs.{i}``), ReLU, 2×2/2
  VALID max-pools where ``_VGG16_LAYOUT`` has an "M" (the pools hold no
  parameters, so they stay out of ``convs``), then ``fc1``–``fc3``.
* CosmoFlow: ``n_conv`` biased 3×3×3 ``HaloConv``s (a 3-D conv runs on the
  plain ``Conv``, as in the reference), leaky ReLU (slope 0.01), 2×2×2/2
  VALID max-pools, then ``fc1``, ``fc2`` and ``out``; an MSE loss.

Both flatten the channels-last tensor, (H, W, C) order, before ``fc1``.

Each model has ``ordered_blocks()``, its forward as a list of ``Block``
entries, stem through head (the units the pipeline cuts its stages
between, ``parallel/schedules/hetero.py``); ``forward(images, ctx,
train)`` → logits, which applies them in turn; ``loss(logits, batch)`` →
(loss, metrics) and ``loss_fn(batch, ctx, train)``, their composition.
Across ranks (``ctx.sharded``) the images and targets are
``parallel.sharded.Sharded`` blocks, the layers follow the rules
(``nn/layers.py``), ``ctx.constrain`` re-lays the activations out at the
reference's points, and the loss is the mean over the whole batch, held by
every rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import (BatchNorm, Conv, Dense, flatten, global_avg_pool,
                         max_pool)
from ..nn.module import ShardingCtx
from ..parallel import collectives as C
from ..parallel.halo import HaloConv
from ..parallel.sharded import Sharded

# where the reference constrains a CNN activation (batch, image, channels)
ACT_2D = ("batch", "spatial", None, "conv_out")
ACT_3D = ("batch", "spatial", None, None, "conv_out")


class Block(NamedTuple):
    """One unit of a CNN's forward: ``apply(x, ctx, train)``; ``params``:
    the prefixes, in ``named_parameters()``, of the parameters it reads."""
    name: str
    apply: Callable
    params: tuple[str, ...]


def _run(blocks: list[Block], x, ctx: ShardingCtx, train: bool):
    for blk in blocks:
        x = blk.apply(x, ctx, train)
    return x


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
        y = ctx.constrain(y, ACT_2D)
        y = torch.relu(self.bn2(self.conv2(y, ctx), ctx, train))
        y = self.bn3(self.conv3(y, ctx), ctx, train)
        sc = x if self.proj is None else \
            self.bn_proj(self.proj(x, ctx), ctx, train)
        return ctx.constrain(torch.relu(y + sc), ACT_2D)


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
                          device=device, generator=generator, in_axis="mlp",
                          out_axis="vocab")

    def ordered_blocks(self) -> list[Block]:
        """stem (conv, BatchNorm, ReLU, 3×3/2 SAME max-pool), the
        bottlenecks ``s{stage}b{i}``, head (global average pool, dense)."""
        def stem(x, ctx, train):
            h = torch.relu(self.bn_stem(self.stem(x, ctx), ctx, train))
            return max_pool(h, (3, 3), (2, 2), "SAME")

        def head(x, ctx, train):
            return self.head(global_avg_pool(x), ctx)

        out, i = [Block("stem", stem, ("stem.", "bn_stem."))], 0
        for stage, n in enumerate(self.cfg.stage_sizes):
            for b in range(n):
                out.append(Block(f"s{stage}b{b}", self.blocks[i],
                                 (f"blocks.{i}.",)))
                i += 1
        return out + [Block("head", head, ("head.",))]

    def forward(self, x, ctx: ShardingCtx, train: bool = True):
        return _run(self.ordered_blocks(), x, ctx, train)

    def loss(self, logits, batch):
        ce = _softmax_xent(logits, batch["labels"])
        return ce, {"ce": ce}

    def loss_fn(self, batch, ctx: ShardingCtx, train: bool = True):
        return self.loss(self(batch["images"], ctx, train), batch)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


_VGG16_LAYOUT = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                 512, 512, 512, "M", 512, 512, 512, "M")


@dataclass(frozen=True)
class VGGConfig:
    name: str = "vgg16"
    n_classes: int = 1000
    img: int = 224
    dtype: torch.dtype = torch.float32


class VGG(nn.Module):
    def __init__(self, cfg: VGGConfig, *, device: torch.device,
                 generator: torch.Generator | None):
        super().__init__()
        self.cfg = c = cfg
        kw = dict(dtype=c.dtype, device=device, generator=generator)
        convs, in_ch = [], 3
        for v in _VGG16_LAYOUT:
            if v != "M":
                convs.append(HaloConv(in_ch, v, (3, 3), **kw))
                in_ch = v
        self.convs = nn.ModuleList(convs)
        feat = c.img // 32
        self.fc1 = Dense(512 * feat * feat, 4096, use_bias=True,
                         in_axis="mlp", out_axis="embed", **kw)
        self.fc2 = Dense(4096, 4096, use_bias=True, in_axis="embed",
                         out_axis="mlp", **kw)
        self.fc3 = Dense(4096, c.n_classes, use_bias=True, in_axis="mlp",
                         out_axis="vocab", **kw)

    def ordered_blocks(self) -> list[Block]:
        """``conv{i}``: each conv with its ReLU and the max-pool behind it
        where the layout has one; fc: fc1–fc3."""
        pools = [_VGG16_LAYOUT[k + 1:k + 2] == ("M",)
                 for k, v in enumerate(_VGG16_LAYOUT) if v != "M"]

        def conv_block(x, ctx, train, conv, pool):
            h = ctx.constrain(torch.relu(conv(x, ctx)), ACT_2D)
            return max_pool(h, (2, 2), (2, 2), "VALID") if pool else h

        def head(x, ctx, train):
            h = torch.relu(self.fc1(flatten(x), ctx))
            h = torch.relu(self.fc2(h, ctx))
            return self.fc3(h, ctx)

        return [Block(f"conv{i}", partial(conv_block, conv=conv, pool=pool),
                      (f"convs.{i}.",))
                for i, (conv, pool) in enumerate(zip(self.convs, pools))] + [
            Block("fc", head, ("fc1.", "fc2.", "fc3."))]

    def forward(self, x, ctx: ShardingCtx, train: bool = True):
        return _run(self.ordered_blocks(), x, ctx, train)

    def loss(self, logits, batch):
        ce = _softmax_xent(logits, batch["labels"])
        return ce, {"ce": ce}

    def loss_fn(self, batch, ctx: ShardingCtx, train: bool = True):
        return self.loss(self(batch["images"], ctx, train), batch)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


@dataclass(frozen=True)
class CosmoFlowConfig:
    name: str = "cosmoflow"
    img: int = 128               # cube edge
    in_ch: int = 4
    n_targets: int = 4
    width: int = 16
    n_conv: int = 5
    dtype: torch.dtype = torch.float32


class CosmoFlow(nn.Module):
    def __init__(self, cfg: CosmoFlowConfig, *, device: torch.device,
                 generator: torch.Generator | None):
        super().__init__()
        self.cfg = c = cfg
        kw = dict(dtype=c.dtype, device=device, generator=generator)
        convs, in_ch = [], c.in_ch
        for i in range(c.n_conv):
            out = c.width * (2 ** i)
            convs.append(HaloConv(in_ch, out, (3, 3, 3), **kw))
            in_ch = out
        self.convs = nn.ModuleList(convs)
        edge = c.img // (2 ** c.n_conv)
        self.fc1 = Dense(in_ch * edge ** 3, 128, use_bias=True,
                         in_axis="mlp", out_axis="embed", **kw)
        self.fc2 = Dense(128, 64, use_bias=True, in_axis="embed",
                         out_axis="mlp", **kw)
        self.out = Dense(64, c.n_targets, use_bias=True, in_axis="mlp",
                         out_axis=None, **kw)

    def ordered_blocks(self) -> list[Block]:
        """``conv{i}``: each conv with its leaky ReLU and 2×2×2 max-pool;
        fc: fc1, fc2 and out."""
        def conv_block(x, ctx, train, conv):
            h = ctx.constrain(F.leaky_relu(conv(x, ctx), 0.01), ACT_3D)
            return max_pool(h, (2, 2, 2), (2, 2, 2), "VALID")

        def head(x, ctx, train):
            h = F.leaky_relu(self.fc1(flatten(x), ctx), 0.01)
            h = F.leaky_relu(self.fc2(h, ctx), 0.01)
            return self.out(h, ctx)

        return [Block(f"conv{i}", partial(conv_block, conv=conv),
                      (f"convs.{i}.",))
                for i, conv in enumerate(self.convs)] + [
            Block("fc", head, ("fc1.", "fc2.", "out."))]

    def forward(self, x, ctx: ShardingCtx, train: bool = True):
        return _run(self.ordered_blocks(), x, ctx, train)

    def loss(self, pred, batch):
        tgt = batch["targets"]
        if isinstance(pred, Sharded):
            pred = pred.relayout((pred.place[0], ()))
            tgt = tgt.relayout(pred.place)
            mse = _batch_mean(((pred.local - tgt.local) ** 2).sum(), pred,
                              pred.shape[0] * pred.shape[1])
        else:
            mse = ((pred - tgt) ** 2).mean()
        return mse, {"mse": mse}

    def loss_fn(self, batch, ctx: ShardingCtx, train: bool = True):
        return self.loss(self(batch["images"], ctx, train), batch)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


def _softmax_xent(logits, labels):
    if isinstance(logits, Sharded):
        full = logits.relayout((logits.place[0], ()))
        lab = labels.relayout(full.place[:1]).local
        return _batch_mean(_xent_rows(full.local, lab).sum(), full,
                           full.shape[0])
    return _xent_rows(logits, labels).mean()


def _xent_rows(logits, labels):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long()[:, None])[:, 0]
    return lse - picked


def _batch_mean(local_sum, like: Sharded, n: int):
    """The mean of ``n`` terms from this rank's sum of its share (``like``
    split on its batch dim only): all-reduced over the ranks that split the
    batch, so every rank holds it."""
    if like.place[0]:
        local_sum = C.all_reduce(local_sum, like.mesh.group(like.place[0]))
    return local_sum / n


CNN_MODELS = {ResNetConfig: ResNet, VGGConfig: VGG,
              CosmoFlowConfig: CosmoFlow}
