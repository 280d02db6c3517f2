"""Deterministic synthetic data (counterpart of ``repro.data.pipeline``).

Batch t of run seed s is a pure function of (s, t), drawn by numpy from the
same ``default_rng((seed, step, 7))`` stream as the JAX package, so both get
bit-identical batches. The ``image`` (ResNet, VGG16) and ``volume``
(CosmoFlow) sources are ported; token and multimodal sources come with the
models that read them.
"""
from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    kind: str                 # "image" | "volume" (the kinds ported so far)
    batch: int
    image: int = 0
    channels: int = 3
    classes: int = 0
    n_targets: int = 0
    seed: int = 0


class SyntheticSource:
    """Gaussian NHWC images with uniform integer labels, or Gaussian NDHWC
    volumes with regression targets."""

    KINDS = ("image", "volume")

    def __init__(self, cfg: DataConfig):
        if cfg.kind not in self.KINDS:
            raise ValueError(f"data kind {cfg.kind!r} is not ported yet; "
                             f"ported: {list(self.KINDS)}")
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, 7))
        if cfg.kind == "image":
            return {"images": rng.standard_normal(
                        (cfg.batch, cfg.image, cfg.image, cfg.channels),
                        dtype=np.float32),
                    "labels": rng.integers(0, cfg.classes, (cfg.batch,),
                                           dtype=np.int32)}
        x = rng.standard_normal(
            (cfg.batch, cfg.image, cfg.image, cfg.image, cfg.channels),
            dtype=np.float32)
        # CosmoFlow-style targets: fixed functionals of the volume
        t = np.stack([x[:, ::2].mean((1, 2, 3, 4)),
                      x[:, :, ::2].std((1, 2, 3, 4)),
                      x.mean((1, 2, 3, 4)),
                      x.std((1, 2, 3, 4))], axis=1)[:, :cfg.n_targets]
        return {"images": x, "targets": t.astype(np.float32)}


class Loader:
    """Iterates (seed, step)-addressable batches, placed on ``device``."""

    def __init__(self, cfg: DataConfig, device: torch.device):
        self.source = SyntheticSource(cfg)
        self.device = device

    def batch_at(self, step: int) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.source.batch_at(step).items()}
