"""The paper's own evaluation models (Table 5) as registered configs:
ResNet-50/152, VGG16 and CosmoFlow."""
from __future__ import annotations

from ..models.cnn import (RESNET50, RESNET152, CosmoFlowConfig, ResNetConfig,
                          VGGConfig)
from .base import ArchConfig, register

# The batch of the training step that the oracle's p = 1 validation (paper
# Fig. 3) measures on one card, per model, in the order it runs them; the
# first is the model the oracle is calibrated on for the others.
# ``chip_smoke.py``'s oracle phase and ``launch.profile_train`` read it.
ORACLE_BATCH = {"resnet50": 32, "resnet152": 32, "vgg16": 32, "cosmoflow": 8}


@register("resnet50")
def resnet50() -> ArchConfig:
    return ArchConfig(
        name="resnet50", family="cnn", model=RESNET50,
        smoke_model=ResNetConfig("resnet50-smoke", (1, 1, 1, 1), n_classes=10),
        source="[paper Table 5; He et al. 2016]", strategy="data")


@register("resnet152")
def resnet152() -> ArchConfig:
    return ArchConfig(
        name="resnet152", family="cnn", model=RESNET152,
        smoke_model=ResNetConfig("resnet152-smoke", (1, 2, 2, 1), n_classes=10),
        source="[paper Table 5; He et al. 2016]", strategy="data")


@register("vgg16")
def vgg16() -> ArchConfig:
    return ArchConfig(
        name="vgg16", family="cnn", model=VGGConfig(),
        smoke_model=VGGConfig(name="vgg16-smoke", n_classes=10, img=32),
        source="[paper Table 5; Simonyan & Zisserman 2015]",
        strategy="data")


@register("cosmoflow")
def cosmoflow() -> ArchConfig:
    return ArchConfig(
        name="cosmoflow", family="cnn", model=CosmoFlowConfig(img=128),
        smoke_model=CosmoFlowConfig(img=16, n_conv=2, width=8),
        source="[paper Table 5; Mathuriya et al. 2018]", strategy="ds")
