"""The paper's evaluation models (Table 5) ported so far, as registered
configs. VGG16 and CosmoFlow register here with the next slice."""
from __future__ import annotations

from ..models.cnn import RESNET50, RESNET152, ResNetConfig
from .base import ArchConfig, register


@register("resnet50")
def resnet50() -> ArchConfig:
    return ArchConfig(
        name="resnet50", family="cnn", model=RESNET50,
        smoke_model=ResNetConfig("resnet50-smoke", (1, 1, 1, 1), n_classes=10),
        source="[paper Table 5; He et al. 2016]")


@register("resnet152")
def resnet152() -> ArchConfig:
    return ArchConfig(
        name="resnet152", family="cnn", model=RESNET152,
        smoke_model=ResNetConfig("resnet152-smoke", (1, 2, 2, 1), n_classes=10),
        source="[paper Table 5; He et al. 2016]")
